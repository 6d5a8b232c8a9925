"""Mixture-of-Experts FFN with capacity-bounded sort-based dispatch.

The counterpart of ``repro.models.moe``.  Dispatch is scatter/gather (no
(T, E, C) one-hot einsum): assignments are ranked within their expert
via a sorted segment-rank, tokens beyond capacity are dropped (GShard
semantics), and expert FFNs run as one batched einsum over the
(E, C, d) buffer.  Which assignments are kept is decided exactly as the
reference decides it: the top-k puts the lower expert first on tied
router logits, the sort is stable, and the rank is the position within
the expert's run of the sorted assignments.
"""

from __future__ import annotations

import torch

from ..dist.api import constrain, get_option
from .layers import dense_init, silu


def init_moe(gen, cfg, dtype, device, lead=()):
    d, f, E = cfg.d_model, cfg.d_ff, cfg.moe_experts
    lead = tuple(lead)
    p = {
        "router": dense_init(gen, lead + (d, E), torch.float32, device),
        "w_gate": dense_init(gen, lead + (E, d, f), dtype, device),
        "w_up": dense_init(gen, lead + (E, d, f), dtype, device),
        "w_down": dense_init(gen, lead + (E, f, d), dtype, device),
    }
    ax = {
        "router": ("embed", None),
        "w_gate": ("experts", "embed", "ffn"),
        "w_up": ("experts", "embed", "ffn"),
        "w_down": ("experts", "ffn", "embed"),
    }
    return p, ax


def _top_k(logits, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, in
    descending order, the lower index first among equal values.
    ``torch.topk`` does not promise that order on ties; a stable
    descending sort does, on the CPU and on the card."""
    v, i = torch.sort(logits, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def moe_ffn(p, x, cfg, capacity_factor: float = 1.25):
    """x (T, d) -> (T, d).  top_k routing, capacity C = T*k/E * cf.

    With the ``moe_groups`` option set to G (GShard-style grouped
    dispatch), tokens are split into G groups and routing/sort/scatter
    run batched per group."""
    G = get_option("moe_groups") or 0
    if G and x.shape[0] % G == 0:
        return _moe_grouped(p, x, cfg, capacity_factor, G)
    return _moe_dispatch(p, x, cfg, capacity_factor)


def _moe_grouped(p, x, cfg, capacity_factor: float, G: int):
    """GShard grouped dispatch with an EXPLICIT group axis."""
    T, d = x.shape
    E, k = cfg.moe_experts, cfg.moe_top_k
    Tg = T // G
    C = max(int(Tg * k * capacity_factor / E), 1)
    dev = x.device
    xg = constrain(x.reshape(G, Tg, d), "batch", None, None)

    logits = torch.einsum("gtd,de->gte", xg.float(), p["router"])
    topv, topi = _top_k(logits, k)                          # (G,Tg,k)
    gates = torch.softmax(topv, dim=-1)
    N = Tg * k
    flat_e = topi.reshape(G, N)
    flat_t = torch.arange(Tg, device=dev).repeat_interleave(k)[None] \
        .expand(G, N)
    flat_g = gates.reshape(G, N)
    order = torch.sort(flat_e, dim=1, stable=True).indices
    e_sorted = torch.gather(flat_e, 1, order)
    first = torch.searchsorted(
        e_sorted, torch.arange(E, device=dev).expand(G, E).contiguous())
    rank_sorted = torch.arange(N, device=dev)[None] - torch.gather(
        first, 1, e_sorted)
    gi = torch.arange(G, device=dev)[:, None]
    rank = torch.zeros((G, N), dtype=torch.int32, device=dev)
    rank[gi, order] = rank_sorted.to(torch.int32)
    keep = rank < C
    e_idx = torch.where(keep, flat_e, 0)
    r_idx = torch.where(keep, rank, 0).long()
    contrib = torch.where(keep[..., None],
                          torch.gather(xg, 1, flat_t[..., None].expand(
                              G, N, d)), 0)
    buf = torch.zeros((G, E, C, d), dtype=x.dtype, device=dev)
    buf.index_put_((gi, e_idx, r_idx), contrib.to(x.dtype), accumulate=True)
    if get_option("moe_ep"):
        buf = constrain(buf, None, "model", None, None)
    else:
        buf = constrain(buf, "batch", None, None, None)
    wg, wu, wd = p["w_gate"], p["w_up"], p["w_down"]
    if get_option("moe_gather_w"):
        wg = constrain(wg, "model", None, None)
        wu = constrain(wu, "model", None, None)
        wd = constrain(wd, "model", None, None)
    g_ = torch.einsum("gecd,edf->gecf", buf, wg)
    u_ = torch.einsum("gecd,edf->gecf", buf, wu)
    y = torch.einsum("gecf,efd->gecd", silu(g_) * u_, wd)
    if get_option("moe_ep"):
        y = constrain(y, None, "model", None, None)
    else:
        y = constrain(y, "batch", None, None, None)
    out_flat = y[gi, e_idx, r_idx]                          # (G,N,d)
    out_flat = torch.where(keep[..., None], out_flat, 0)
    out_flat = out_flat.float() * flat_g[..., None]
    out = torch.zeros((G, Tg, d), dtype=torch.float32, device=dev)
    out.index_put_((gi, flat_t), out_flat, accumulate=True)
    out = constrain(out.to(x.dtype), "batch", None, None)
    return out.reshape(T, d)


def _moe_dispatch(p, x, cfg, capacity_factor: float = 1.25):
    T, d = x.shape
    E, k = cfg.moe_experts, cfg.moe_top_k
    C = max(int(T * k * capacity_factor / E), 1)
    dev = x.device

    logits = x.float() @ p["router"]
    topv, topi = _top_k(logits, k)                          # (T, k)
    gates = torch.softmax(topv, dim=-1)                     # (T, k)

    flat_e = topi.reshape(-1)                               # (T*k,)
    flat_t = torch.arange(T, device=dev).repeat_interleave(k)
    flat_g = gates.reshape(-1)
    # sort assignments by expert; rank within expert = idx - first idx of e
    order = torch.sort(flat_e, stable=True).indices
    e_sorted = flat_e[order]
    first = torch.searchsorted(e_sorted, torch.arange(E, device=dev))
    rank_sorted = torch.arange(T * k, device=dev) - first[e_sorted]
    rank = torch.zeros(T * k, dtype=torch.int32, device=dev)
    rank[order] = rank_sorted.to(torch.int32)
    keep = rank < C
    # scatter tokens into the (E, C, d) expert buffer; a dropped
    # assignment adds 0 into slot (0, 0), as in the reference
    buf = torch.zeros((E, C, d), dtype=x.dtype, device=dev)
    e_idx = torch.where(keep, flat_e, 0)
    r_idx = torch.where(keep, rank, 0).long()
    contrib = torch.where(keep[:, None], x[flat_t], 0)
    buf.index_put_((e_idx, r_idx), contrib.to(x.dtype), accumulate=True)
    if get_option("moe_ep"):
        buf = constrain(buf, "model", None, None)
    wg, wu, wd = p["w_gate"], p["w_up"], p["w_down"]
    if get_option("moe_gather_w"):
        wg = constrain(wg, "model", None, None)
        wu = constrain(wu, "model", None, None)
        wd = constrain(wd, "model", None, None)
    # expert FFN (SwiGLU), batched over experts
    g = torch.bmm(buf, wg)
    u = torch.bmm(buf, wu)
    y = torch.bmm(silu(g) * u, wd)
    if get_option("moe_ep"):
        y = constrain(y, "model", None, None)
    # gather back with gate weights; the segment sum runs in float32
    out_flat = y[e_idx, r_idx]                              # (T*k, d)
    out_flat = torch.where(keep[:, None], out_flat, 0)
    out_flat = out_flat.float() * flat_g[:, None]
    out = torch.zeros((T, d), dtype=torch.float32, device=dev)
    out.index_add_(0, flat_t, out_flat)
    return out.to(x.dtype)


def aux_load_balance_loss(p, x, cfg):
    """Switch-style auxiliary loss (f_i * P_i * E), for the training loop."""
    logits = x.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    top1 = torch.argmax(logits, dim=-1)
    E = cfg.moe_experts
    f = torch.nn.functional.one_hot(top1, E).float().mean(dim=0)
    P = probs.mean(dim=0)
    return torch.sum(f * P) * E
