"""GQA attention: a blockwise-streaming (flash-style) train/prefill path
and a direct masked-softmax decode path over a static cache.

The counterpart of ``repro.models.attention``.  ``flash_attention`` is
the reference's algorithm in plain PyTorch: Python loops over
(q-block, kv-block) with a running float32 (max, denom, acc)
accumulator, so the S x S score matrix is never materialized.
Causality is enforced by block masking; fully-masked kv blocks still
execute, as in the reference.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Shard

from ..dist.api import along, current_mesh, local_apply, replicated
from .layers import apply_mrope, apply_rope, dense_init

NEG_INF = -1e30


def init_attn(gen, cfg, dtype, device, lead=()):
    """One attention block's params; ``lead`` prepends stacking axes
    (layers, groups) to every shape."""
    d, H, KH, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    lead = tuple(lead)
    p = {
        "wq": dense_init(gen, lead + (d, H * hd), dtype, device),
        "wk": dense_init(gen, lead + (d, KH * hd), dtype, device),
        "wv": dense_init(gen, lead + (d, KH * hd), dtype, device),
        "wo": dense_init(gen, lead + (H * hd, d), dtype, device),
    }
    ax = {
        "wq": ("embed", "heads_flat"),
        "wk": ("embed", "kv_flat"),
        "wv": ("embed", "kv_flat"),
        "wo": ("heads_flat", "embed"),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(lead + (H * hd,), dtype=dtype, device=device)
        p["bk"] = torch.zeros(lead + (KH * hd,), dtype=dtype, device=device)
        p["bv"] = torch.zeros(lead + (KH * hd,), dtype=dtype, device=device)
        ax["bq"] = ("heads_flat",)
        ax["bk"] = ("kv_flat",)
        ax["bv"] = ("kv_flat",)
    return p, ax


def _project(p, x, cfg):
    """The flat q, k, v projections (B, S, heads x hd)."""
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return q, k, v


def _heads(q, k, v, positions, cfg):
    """Flat projections -> (B, S, heads, hd), q and k rotated.  The head
    counts come from the shapes, so a rank holding some of the heads
    splits and rotates those."""
    B, S = q.shape[:2]
    hd = cfg.head_dim
    q = q.reshape(B, S, -1, hd)
    k = k.reshape(B, S, -1, hd)
    v = v.reshape(B, S, -1, hd)
    if cfg.rope == "mrope":
        q = apply_mrope(q, positions)
        k = apply_mrope(k, positions)
    else:
        pos = positions if positions.ndim == 2 else positions[0]
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    return q, k, v


def _head_axis(cfg, mesh) -> str | None:
    """``"model"`` when the heads split evenly over the mesh's model
    axis (each rank then attends with its own query and KV heads, the
    tensor-parallel layout), else None (every rank attends with all)."""
    m = dict(zip(mesh.mesh_dim_names, mesh.shape)).get("model", 1) \
        if mesh is not None else 1
    if m > 1 and cfg.n_heads % m == 0 and cfg.n_kv_heads % m == 0:
        return "model"
    return None


def _pos_axes(positions):
    return ("batch", None) if positions.ndim == 2 else (None, "batch", None)


def flash_attention(q, k, v, *, causal: bool = True,
                    q_block: int = 512, kv_block: int = 512):
    """q (B,S,H,D), k/v (B,S,KH,D), GQA via head grouping. Blockwise."""
    B, S, H, D = q.shape
    KH = k.shape[2]
    G = H // KH
    scale = 1.0 / (D ** 0.5)
    q_block = min(q_block, S)
    kv_block = min(kv_block, S)
    nq, nk = S // q_block, S // kv_block
    assert S % q_block == 0 and S % kv_block == 0
    qb = q.reshape(B, nq, q_block, KH, G, D)
    kb = k.reshape(B, nk, kv_block, KH, D)
    vb = v.reshape(B, nk, kv_block, KH, D)
    dev = q.device
    outs = []
    for qi in range(nq):
        qblk = qb[:, qi].float()                      # (B, q_block, KH, G, D)
        acc = torch.zeros((B, q_block, KH, G, D), dtype=torch.float32,
                          device=dev)
        m = torch.full((B, q_block, KH, G), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, q_block, KH, G), dtype=torch.float32, device=dev)
        for ki in range(nk):
            kblk = kb[:, ki].float()
            vblk = vb[:, ki].float()
            s = torch.einsum("bqkgd,bckd->bqkgc", qblk, kblk) * scale
            if causal:
                qpos = qi * q_block + torch.arange(q_block, device=dev)
                kpos = ki * kv_block + torch.arange(kv_block, device=dev)
                mask = qpos[:, None] >= kpos[None, :]
                s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            pr = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + pr.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bqkgc,bckd->bqkgd", pr, vblk)
            m = m_new
        outs.append(acc / torch.clamp_min(l[..., None], 1e-30))
    out = torch.stack(outs, dim=1).reshape(B, S, H, D)
    return out.to(q.dtype)


def attn_forward(p, x, cfg, positions, *, q_block=512, kv_block=512):
    """Training / prefill attention (no cache). Returns (out, (k, v)).

    Under a mesh the rotations and the attention core run on each rank's
    batch shard and, where ``_head_axis`` allows, its heads."""
    def core(q, k, v, positions):
        q, k, v = _heads(q, k, v, positions, cfg)
        o = flash_attention(q, k, v, causal=True,
                            q_block=q_block, kv_block=kv_block)
        B, S, H, D = o.shape
        return o.reshape(B, S, H * D), k, v

    h = _head_axis(cfg, current_mesh())
    flat = ("batch", None, h)
    o, k, v = local_apply(core, (*_project(p, x, cfg), positions),
                          [flat, flat, flat, _pos_axes(positions)],
                          [flat, ("batch", None, h, None),
                           ("batch", None, h, None)])
    return o @ p["wo"], (k, v)


def _decode_core(q, cache_k, cache_v, pos: int, dtype):
    """Softmax of one query over the static cache, with the unclamped
    ``arange(Smax) <= pos`` mask."""
    B = q.shape[0]
    H, hd = q.shape[2], q.shape[3]
    KH = cache_k.shape[2]
    G = H // KH
    Smax = cache_k.shape[1]
    scale = 1.0 / (hd ** 0.5)
    qg = q.reshape(B, 1, KH, G, hd)
    s = torch.einsum("bqkgd,bskd->bqkgs", qg.float(), cache_k.float()) * scale
    valid = torch.arange(Smax, device=q.device) <= pos
    s = torch.where(valid[None, None, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bqkgs,bskd->bqkgd", w, cache_v.float())
    return o.reshape(B, 1, H * hd).to(dtype)


def _write_at(cache, at: int, new):
    """``cache[:, at] = new[:, 0]``, in place.  A DTensor cache whose
    sequence dim is sharded (``kv_seq_model``) is written through a mask
    over that dim, each rank into its own slice: indexing a sharded dim
    would write into a gathered copy."""
    if isinstance(cache, DTensor) and any(
            isinstance(pl, Shard) and pl.dim == 1 for pl in cache.placements):
        hit = along(torch.arange(cache.shape[1], device=cache.device) == at,
                    cache, 1)
        cache.copy_(torch.where(hit[None, :, None, None], new, cache))
    else:
        cache[:, at] = new[:, 0]


def attn_decode(p, x, cache_k, cache_v, pos: int, cfg):
    """One-token decode. x (B,1,d); cache (B,Smax,KH,hd); pos int.

    The new K and V are written into the static cache IN PLACE at
    ``pos`` along the sequence axis (allocate once, reuse).  As
    ``jax.lax.dynamic_update_slice_in_dim`` does, the start is clamped
    so that the update fits: a ``pos >= Smax`` writes at ``Smax - 1``.
    Softmax runs over the full static cache with the unclamped
    ``arange(Smax) <= pos`` mask.  Under a mesh each rank attends over
    its batch shard of the cache with every head.
    """
    B = x.shape[0]
    shape = (B, 1) if cfg.rope != "mrope" else (3, B, 1)
    positions = replicated(torch.full(shape, pos, dtype=torch.int32,
                                      device=x.device), x)
    flat = ("batch", None, None)
    heads = ("batch", None, None, None)
    q, k_new, v_new = local_apply(
        lambda q, k, v, pos_: _heads(q, k, v, pos_, cfg),
        (*_project(p, x, cfg), positions),
        [flat, flat, flat, _pos_axes(positions)], [heads, heads, heads])
    Smax = cache_k.shape[1]
    at = min(max(int(pos), 0), Smax - 1)
    _write_at(cache_k, at, k_new)
    _write_at(cache_v, at, v_new)
    o = local_apply(lambda q, ck, cv: _decode_core(q, ck, cv, pos, x.dtype),
                    (q, cache_k, cache_v), [heads, heads, heads], flat)
    o = o @ p["wo"]
    return o, cache_k, cache_v
