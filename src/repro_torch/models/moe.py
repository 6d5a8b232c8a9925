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

from ..dist.api import constrain, get_option, local_apply
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


def _route_grouped(xg, router, E: int, k: int, C: int):
    """Routing and dispatch of each group of ``xg`` (G, Tg, d): the
    (G, E, C, d) expert buffer and what ``_combine_grouped`` needs."""
    G, Tg, d = xg.shape
    dev = xg.device
    logits = torch.einsum("gtd,de->gte", xg.float(), router)
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
    buf = torch.zeros((G, E, C, d), dtype=xg.dtype, device=dev)
    buf.index_put_((gi, e_idx, r_idx), contrib.to(xg.dtype), accumulate=True)
    return buf, e_idx, r_idx, keep, flat_t, flat_g


def _combine_grouped(y, e_idx, r_idx, keep, flat_t, flat_g, Tg: int):
    """Each group's expert outputs gathered back to its tokens, gate
    weighted, summed in float32."""
    G = e_idx.shape[0]
    d = y.shape[-1]
    gi = torch.arange(G, device=y.device)[:, None]
    out_flat = y[gi, e_idx, r_idx]                          # (G,N,d)
    out_flat = torch.where(keep[..., None], out_flat, 0)
    out_flat = out_flat.float() * flat_g[..., None]
    out = torch.zeros((G, Tg, d), dtype=torch.float32, device=y.device)
    out.index_put_((gi, flat_t), out_flat, accumulate=True)
    return out.to(y.dtype)


def _moe_grouped(p, x, cfg, capacity_factor: float, G: int):
    """GShard grouped dispatch with an EXPLICIT group axis: under a mesh
    each rank routes its own groups."""
    T, d = x.shape
    E, k = cfg.moe_experts, cfg.moe_top_k
    Tg = T // G
    C = max(int(Tg * k * capacity_factor / E), 1)
    xg = constrain(x.reshape(G, Tg, d), "batch", None, None)
    g2, g3 = ("batch", None), ("batch", None, None)
    buf, e_idx, r_idx, keep, flat_t, flat_g = local_apply(
        lambda xg, r: _route_grouped(xg, r, E, k, C), (xg, p["router"]),
        [g3, (None, None)], [g3 + (None,), g2, g2, g2, g2, g2])
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
    out = local_apply(lambda *a: _combine_grouped(*a, Tg),
                      (y, e_idx, r_idx, keep, flat_t, flat_g),
                      [g3 + (None,), g2, g2, g2, g2, g2], g3)
    out = constrain(out, "batch", None, None)
    return out.reshape(T, d)


def _route(x, router, E: int, k: int, C: int):
    """Routing and dispatch of the tokens ``x`` (T, d): the (E, C, d)
    expert buffer and what ``_combine`` needs."""
    T, d = x.shape
    dev = x.device
    logits = x.float() @ router
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
    return buf, e_idx, r_idx, keep, flat_t, flat_g


def _combine(y, e_idx, r_idx, keep, flat_t, flat_g, T: int):
    """Expert outputs gathered back to their tokens with gate weights;
    the segment sum runs in float32."""
    out_flat = y[e_idx, r_idx]                              # (T*k, d)
    out_flat = torch.where(keep[:, None], out_flat, 0)
    out_flat = out_flat.float() * flat_g[:, None]
    out = torch.zeros((T, y.shape[-1]), dtype=torch.float32, device=y.device)
    out.index_add_(0, flat_t, out_flat)
    return out.to(y.dtype)


def _moe_dispatch(p, x, cfg, capacity_factor: float = 1.25):
    """Under a mesh the routing and the combine run on every rank over
    all tokens (the capacity is the global batch's), and the expert
    products on DTensors."""
    T, d = x.shape
    E, k = cfg.moe_experts, cfg.moe_top_k
    C = max(int(T * k * capacity_factor / E), 1)
    r1, r2, r3 = (None,), (None, None), (None, None, None)
    buf, e_idx, r_idx, keep, flat_t, flat_g = local_apply(
        lambda x, r: _route(x, r, E, k, C), (x, p["router"]), [r2, r2],
        [r3, r1, r1, r1, r1, r1])
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
    return local_apply(lambda *a: _combine(*a, T),
                       (y, e_idx, r_idx, keep, flat_t, flat_g),
                       [r3, r1, r1, r1, r1, r1], r2)


def aux_load_balance_loss(p, x, cfg):
    """Switch-style auxiliary loss (f_i * P_i * E), for the training loop."""
    logits = x.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    top1 = torch.argmax(logits, dim=-1)
    E = cfg.moe_experts
    f = torch.nn.functional.one_hot(top1, E).float().mean(dim=0)
    P = probs.mean(dim=0)
    return torch.sum(f * P) * E
