"""Mixture-of-Experts FFN with capacity-bounded sort-based dispatch.

The counterpart of ``repro.models.moe``.  Dispatch is scatter/gather (no
(T, E, C) one-hot einsum): assignments are ranked within their expert
via a sorted segment-rank, tokens beyond capacity are dropped (GShard
semantics), and expert FFNs run as one batched einsum over the
(E, C, d) buffer.  Which assignments are kept is decided exactly as the
reference decides it: the top-k puts the lower expert first on tied
router logits, the sort is stable, and the rank is the position within
the expert's run of the sorted assignments.  Under a mesh the keep
decisions stay the global batch's, and each batch rank runs the expert
products of its share of the experts (``_moe_split``).
"""

from __future__ import annotations

import torch

from ..dist.api import (batch_mesh_axes, constrain, current_mesh, exchange,
                        get_option, local_apply)
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
    mesh = current_mesh()
    if mesh is not None and cfg.moe_experts % _batch_ranks(mesh)[0] == 0:
        return _moe_split(p, x, cfg, capacity_factor, mesh)
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


def _assign(logits, E: int, k: int, C: int):
    """Top-k routing of the router logits (T, E) and each assignment's
    expert slot, token-major (T*k,): ``(e_idx, r_idx, keep, flat_g)``.
    A dropped assignment's slot is (0, 0)."""
    T = logits.shape[0]
    dev = logits.device
    topv, topi = _top_k(logits, k)                          # (T, k)
    gates = torch.softmax(topv, dim=-1)                     # (T, k)

    flat_e = topi.reshape(-1)                               # (T*k,)
    flat_g = gates.reshape(-1)
    # sort assignments by expert; rank within expert = idx - first idx of e
    order = torch.sort(flat_e, stable=True).indices
    e_sorted = flat_e[order]
    first = torch.searchsorted(e_sorted, torch.arange(E, device=dev))
    rank_sorted = torch.arange(T * k, device=dev) - first[e_sorted]
    rank = torch.zeros(T * k, dtype=torch.int32, device=dev)
    rank[order] = rank_sorted.to(torch.int32)
    keep = rank < C
    e_idx = torch.where(keep, flat_e, 0)
    r_idx = torch.where(keep, rank, 0).long()
    return e_idx, r_idx, keep, flat_g


def _route(x, router, E: int, k: int, C: int):
    """Routing and dispatch of the tokens ``x`` (T, d): the (E, C, d)
    expert buffer and what ``_combine`` needs."""
    T, d = x.shape
    e_idx, r_idx, keep, flat_g = _assign(x.float() @ router, E, k, C)
    flat_t = torch.arange(T, device=x.device).repeat_interleave(k)
    # scatter tokens into the (E, C, d) expert buffer; a dropped
    # assignment adds 0 into slot (0, 0), as in the reference
    buf = torch.zeros((E, C, d), dtype=x.dtype, device=x.device)
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
    """Without a mesh, the whole dispatch.  Under a mesh whose batch
    ranks do not divide the experts (``_moe_split`` needs them to), the
    routing and the combine run on every rank over all tokens, and the
    expert products on DTensors: every batch rank runs them alike."""
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


def _batch_ranks(mesh) -> tuple[int, int]:
    """``(n, i)``: how many ranks the batch is split over, and this
    rank's place among them (the first batch axis major, as a
    batch-split dim numbers its shards)."""
    n, i = 1, 0
    for a in batch_mesh_axes(mesh):
        size = mesh.size(mesh.mesh_dim_names.index(a))
        n, i = n * size, i * size + mesh.get_local_rank(a)
    return n, i


def _pack(e_idx, keep, n: int, El: int):
    """Where each assignment (token-major, over all T*k) travels: the
    batch rank holding its expert (``dst``; rank i holds experts
    [i*El, (i+1)*El)) and its row ``pos`` among the kept assignments
    that go from its token's rank to ``dst``, in assignment order.  A
    dropped assignment's is (0, 0)."""
    N = e_idx.shape[0]
    dev = e_idx.device
    src = torch.arange(N, device=dev) // (N // n)
    dst = e_idx // El
    key = torch.where(keep, src * n + dst, n * n)
    order = torch.sort(key, stable=True).indices
    k_sorted = key[order]
    first = torch.searchsorted(k_sorted, torch.arange(n * n + 1, device=dev))
    pos = torch.zeros_like(key)
    pos[order] = torch.arange(N, device=dev) - first[k_sorted]
    return dst, torch.where(keep, pos, 0)


def _plan(logits, E: int, k: int, C: int, n: int):
    """``_assign`` and ``_pack`` of all the router logits, on every
    rank alike."""
    e_idx, r_idx, keep, flat_g = _assign(logits, E, k, C)
    dst, pos = _pack(e_idx, keep, n, E // n)
    return e_idx, r_idx, keep, flat_g, dst, pos


def _to_experts(xl, e_idx, r_idx, keep, dst, pos, *, E, C, n, M, me):
    """Batch rank ``me``'s tokens ``xl`` (Tl, d) into the expert buffer:
    each rank packs its kept assignments' rows for each expert rank, in
    blocks of M rows (``exchange``), and each expert rank scatters what
    it receives into its (E/n, C, d) part of the buffer.  Returns it and
    ``slot`` (n, M): the buffer row of each row received (E/n * C for an
    unused one).  A dropped assignment adds 0 into the first row for
    rank 0, as the reference adds it into slot (0, 0)."""
    Tl, d = xl.shape
    per = e_idx.shape[0] // n                  # assignments a rank
    El = E // n
    own = slice(me * per, (me + 1) * per)
    flat_t = torch.arange(Tl, device=xl.device).repeat_interleave(per // Tl)
    contrib = torch.where(keep[own, None], xl[flat_t], 0)
    send = torch.zeros((n, M, d), dtype=xl.dtype, device=xl.device)
    send.index_put_((dst[own], pos[own]), contrib, accumulate=True)
    # the buffer row of every kept assignment that comes here, at the
    # (source rank, row) it arrives in; the rest write a spare column
    mine = keep & (dst == me)
    src = torch.arange(n * per, device=xl.device) // per
    slot = torch.full((n, M + 1), El * C, dtype=torch.long, device=xl.device)
    slot[src, torch.where(mine, pos, M)] = torch.where(
        mine, (e_idx - me * El) * C + r_idx, El * C)
    slot = slot[:, :M].contiguous()
    buf = torch.zeros((El * C + 1, d), dtype=xl.dtype, device=xl.device)
    buf.index_put_((slot.reshape(-1),), exchange(send).reshape(n * M, d),
                   accumulate=True)
    return buf[:El * C].reshape(El, C, d), slot


def _from_experts(yl, slot, keep, flat_g, dst, pos, *, Tl, n, me):
    """Each expert rank's outputs ``yl`` (E/n, C, d) sent back to the
    tokens' ranks in the rows they came in, gate weighted and summed in
    float32 at each token's rank: its (Tl, d) rows."""
    El, C, d = yl.shape
    per = keep.shape[0] // n
    own = slice(me * per, (me + 1) * per)
    back = torch.cat([yl.reshape(El * C, d), yl.new_zeros((1, d))])[slot]
    out_flat = exchange(back)[dst[own], pos[own]]           # (Tl*k, d)
    out_flat = torch.where(keep[own, None], out_flat, 0)
    out_flat = out_flat.float() * flat_g[own, None]
    flat_t = torch.arange(Tl, device=yl.device).repeat_interleave(per // Tl)
    out = torch.zeros((Tl, d), dtype=torch.float32, device=yl.device)
    out.index_add_(0, flat_t, out_flat)
    return out.to(yl.dtype)


def _moe_split(p, x, cfg, capacity_factor: float, mesh):
    """The dispatch under a mesh, its expert products split over the
    batch ranks by experts and over ``model`` by ``d_ff``.

    Each rank takes the router logits of its own tokens; the (T, E)
    float32 logits are gathered, and every rank routes all T*k
    assignments alike (the capacity is the global batch's, so the keep
    decisions are the unsharded ones).  The tokens go to the ranks of
    their experts by one all-to-all over the batch axes
    (``dist.api.exchange``) in blocks of M rows, M the most that can
    travel from one rank to another (a rank's tokens times the experts a
    token can pick there, at most the E/n * C rows there); the outputs
    come back by the reverse one."""
    T, d = x.shape
    E, k = cfg.moe_experts, cfg.moe_top_k
    C = max(int(T * k * capacity_factor / E), 1)
    n, me = _batch_ranks(mesh)
    Tl, El = T // n, E // n
    M = min(Tl * min(k, El), El * C)
    b2, r1, r2 = ("batch", None), (None,), (None, None)
    e3 = ("batch", None, None)
    logits = local_apply(lambda x, r: x.float() @ r, (x, p["router"]),
                         [b2, r2], b2)
    e_idx, r_idx, keep, flat_g, dst, pos = local_apply(
        lambda lg: _plan(lg, E, k, C, n), (logits,), [r2], [r1] * 6)
    buf, slot = local_apply(
        lambda *a: _to_experts(*a, E=E, C=C, n=n, M=M, me=me),
        (x, e_idx, r_idx, keep, dst, pos), [b2] + [r1] * 5, [e3, b2])
    # expert-major over `model` (the levers' layout, as the reference
    # pins it), the slots then over the batch ranks
    ep = get_option("moe_ep") or get_option("moe_gather_w")
    if ep:
        buf = constrain(buf, "model", "batch", None)
    wg, wu, wd = p["w_gate"], p["w_up"], p["w_down"]
    if get_option("moe_gather_w"):
        wg = constrain(wg, "model", None, None)
        wu = constrain(wu, "model", None, None)
        wd = constrain(wd, "model", None, None)
    g = torch.bmm(buf, wg)
    u = torch.bmm(buf, wu)
    y = torch.bmm(silu(g) * u, wd)
    if ep:
        y = constrain(y, "model", "batch", None)
    return local_apply(
        lambda *a: _from_experts(*a, Tl=Tl, n=n, me=me),
        (y, slot, keep, flat_g, dst, pos), [e3, b2] + [r1] * 4, b2)


def aux_load_balance_loss(p, x, cfg):
    """Switch-style auxiliary loss (f_i * P_i * E), for the training loop."""
    logits = x.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    top1 = torch.argmax(logits, dim=-1)
    E = cfg.moe_experts
    f = torch.nn.functional.one_hot(top1, E).float().mean(dim=0)
    P = probs.mean(dim=0)
    return torch.sum(f * P) * E
