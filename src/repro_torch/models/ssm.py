"""Mamba2 (SSD — state-space duality, arXiv:2405.21060) block.

The counterpart of ``repro.models.ssm``.  Training/prefill uses the
chunked SSD algorithm: quadratic attention-like computation inside
chunks of length Q, linear state passing between chunks.  The reference
passes states with an associative scan over (decay, state) pairs; here
it is a loop over the chunks, state = decay x state + chunk state: the
same recurrence in another association order, so the two agree within
float32 rounding, not bit for bit.  Decode is the O(1) state recurrence.
All SSD internals run in float32.  ``softplus`` is ``F.softplus``, which
returns x itself above 20 where ``jax.nn.softplus`` returns
log(1 + e^x): the two differ there by less than 2e-9.  Under a mesh
whose model axis divides the heads, each rank runs the core on its own
block of heads (``_head_block``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..dist.api import batch_mesh_axes, constrain, current_mesh, local_apply
from .layers import dense_init, silu


def init_ssm(gen, cfg, dtype, device, lead=()):
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    H = d_in // cfg.ssm_headdim
    G, N = cfg.ssm_groups, cfg.ssm_state
    conv_ch = d_in + 2 * G * N
    lead = tuple(lead)
    f32 = torch.float32
    p = {
        "in_proj": dense_init(gen, lead + (d, 2 * d_in + 2 * G * N + H),
                              dtype, device),
        "conv_w": dense_init(gen, lead + (cfg.ssm_conv, conv_ch), dtype,
                             device, scale=0.1),
        "conv_b": torch.zeros(lead + (conv_ch,), dtype=dtype, device=device),
        "A_log": torch.zeros(lead + (H,), dtype=f32, device=device),
        "D": torch.ones(lead + (H,), dtype=f32, device=device),
        "dt_bias": torch.zeros(lead + (H,), dtype=f32, device=device),
        "out_proj": dense_init(gen, lead + (d_in, d), dtype, device),
        "norm_w": torch.ones(lead + (d_in,), dtype=dtype, device=device),
    }
    ax = {
        "in_proj": ("embed", "ssm_inner"),
        "conv_w": (None, "ssm_inner"),
        "conv_b": ("ssm_inner",),
        "A_log": ("ssm_heads",),
        "D": ("ssm_heads",),
        "dt_bias": ("ssm_heads",),
        "out_proj": ("ssm_inner", "embed"),
        "norm_w": ("ssm_inner",),
    }
    return p, ax


def _split_proj(z_all, cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    GN = cfg.ssm_groups * cfg.ssm_state
    H = z_all.shape[-1] - 2 * d_in - 2 * GN
    z, xb, B, C, dt = torch.split(z_all, [d_in, d_in, GN, GN, H], dim=-1)
    return z, xb, B, C, dt


def _causal_conv(x, w, b):
    """x (B, S, ch); w (K, ch) depthwise causal conv."""
    K = w.shape[0]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(K))
    return out + b


def _gated_norm(y, z, norm_w):
    """Mamba2's gated RMSNorm before out_proj, in float32."""
    y = y * silu(z.float())
    var = torch.mean(y * y, dim=-1, keepdim=True)
    return y * torch.rsqrt(var + 1e-5) * norm_w.float()


#: the SSM block's parameters that its core takes, in this order
_CORE = ("conv_w", "conv_b", "dt_bias", "A_log", "D", "norm_w")


def _core_args(p):
    """The core's parameters, and their layout under a mesh: whole on
    every rank."""
    return tuple(p[n] for n in _CORE), [(None,) * p[n].ndim for n in _CORE]


def _ssd_core(z_all, conv_w, conv_b, dt_bias, A_log, D, norm_w, cfg,
              chunk, dtype):
    """From the input projection to the gated norm: (y, final_state,
    conv_tail), y in ``dtype``."""
    Bsz, S, _ = z_all.shape
    d_in = cfg.ssm_expand * cfg.d_model
    hd = cfg.ssm_headdim
    H = d_in // hd
    G, N = cfg.ssm_groups, cfg.ssm_state
    z, xb, Bv, Cv, dt = _split_proj(z_all, cfg)
    conv_in = torch.cat([xb, Bv, Cv], dim=-1)
    conv_out = silu(_causal_conv(conv_in, conv_w, conv_b))
    xb, Bv, Cv = torch.split(conv_out, [d_in, G * N, G * N], dim=-1)

    dt = F.softplus(dt.float() + dt_bias)                        # (B,S,H)
    A = -torch.exp(A_log)                                         # (H,)
    xh = xb.reshape(Bsz, S, H, hd).float()
    rep = H // G
    Bh = Bv.reshape(Bsz, S, G, N).float().repeat_interleave(rep, dim=2)
    Ch = Cv.reshape(Bsz, S, G, N).float().repeat_interleave(rep, dim=2)
    y, state = _ssd_chunked(xh, Bh, Ch, dt, A, D, chunk)
    y = _gated_norm(y.reshape(Bsz, S, d_in), z, norm_w)
    conv_tail = conv_in[:, -(cfg.ssm_conv - 1):, :]               # (B,K-1,ch)
    return y.to(dtype), state, conv_tail


def _ssd_chunked(xh, Bh, Ch, dt, A, D, chunk):
    """The chunked SSD of the heads of ``xh`` (B, S, H, P), float32:
    (y (B, S, H, P) with the D skip, final state (B, H, N, P))."""
    Bsz, S, H, hd = xh.shape
    N = Bh.shape[-1]
    Q = min(chunk, S)
    assert S % Q == 0
    nc = S // Q
    xc = xh.reshape(Bsz, nc, Q, H, hd)
    Bc = Bh.reshape(Bsz, nc, Q, H, N)
    Cc = Ch.reshape(Bsz, nc, Q, H, N)
    dtc = dt.reshape(Bsz, nc, Q, H)
    dA = dtc * A                                                  # (B,nc,Q,H)
    cum = torch.cumsum(dA, dim=2)                                 # (B,nc,Q,H)

    # intra-chunk (quadratic within chunk)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]          # (B,nc,Qi,Qj,H)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=xh.device))
    # exp after the mask: above the diagonal diff > 0 overflows exp, and
    # where's backward would multiply that inf by 0 (NaN gradients)
    L = torch.exp(torch.where(causal[None, None, :, :, None], diff,
                              -torch.inf))
    scores = torch.einsum("bcihn,bcjhn->bcijh", Cc, Bc) * L
    y_intra = torch.einsum("bcijh,bcjh,bcjhp->bcihp", scores, dtc, xc)

    # chunk states: state_c = sum_j exp(cum_last - cum_j) dt_j B_j x_j^T
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)             # (B,nc,Q,H)
    states = torch.einsum("bcjh,bcjh,bcjhn,bcjhp->bchnp",
                          decay_to_end, dtc, Bc, xc)              # (B,nc,H,N,P)
    chunk_decay = torch.exp(cum[:, :, -1, :])                     # (B,nc,H)

    # inter-chunk state passing, one chunk after another
    st = states[:, 0]
    st_scan = [st]
    for c in range(1, nc):
        st = states[:, c] + chunk_decay[:, c, :, None, None] * st
        st_scan.append(st)
    # state entering chunk c = the state after chunk c-1
    st_in = torch.stack([torch.zeros_like(st)] + st_scan[:-1], dim=1)
    y_inter = torch.einsum("bcihn,bchnp,bcih->bcihp",
                           Cc, st_in, torch.exp(cum))
    y = (y_intra + y_inter).reshape(Bsz, S, H, hd)
    return y + D[None, None, :, None] * xh, st_scan[-1]


def _head_block(cfg):
    """Under a mesh whose ``model`` axis (not taken by the batch) divides
    the SSD heads: the first of this rank's contiguous block of heads
    (``_ssd_core_heads`` runs the core on those).  Otherwise None: the
    core runs on every head, as it must where the specs replicate the
    inner width (mamba2-130m at full width packs 3,352 columns and 24
    heads, which a 16-wide model axis divides neither of)."""
    mesh = current_mesh()
    if mesh is None or "model" in batch_mesh_axes(mesh):
        return None
    m = dict(zip(mesh.mesh_dim_names, mesh.shape)).get("model", 1)
    H = cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim
    if m == 1 or H % m:
        return None
    return mesh.get_local_rank("model") * (H // m)


def _mine(t, cfg, h0: int, Hl: int):
    """The channels of heads [h0, h0 + Hl) of the conv's x channels of
    ``t`` (last dim: d_in x channels, then the shared B and C)."""
    d_in = cfg.ssm_expand * cfg.d_model
    hd = cfg.ssm_headdim
    return torch.cat([t[..., h0 * hd:(h0 + Hl) * hd], t[..., d_in:]], dim=-1)


def _ssd_core_heads(z_all, conv_w, conv_b, dt_bias, A_log, D, cfg, chunk,
                    h0: int):
    """``_ssd_core`` on heads [h0, h0 + Hl) (Hl those of ``dt_bias``)
    from the whole packed projection: (y * silu(z) in float32 on those
    heads' channels, their final state, the whole conv_tail).  The gated
    norm's mean runs over every channel, so ``_norm_heads`` ends it."""
    Bsz, S, _ = z_all.shape
    d_in = cfg.ssm_expand * cfg.d_model
    hd = cfg.ssm_headdim
    H, Hl = d_in // hd, dt_bias.shape[0]
    G, N = cfg.ssm_groups, cfg.ssm_state
    z, xb, Bv, Cv, dt = _split_proj(z_all, cfg)
    conv_in = _mine(torch.cat([xb, Bv, Cv], dim=-1), cfg, h0, Hl)
    conv_out = silu(_causal_conv(conv_in, _mine(conv_w, cfg, h0, Hl),
                                 _mine(conv_b, cfg, h0, Hl)))
    xb, Bv, Cv = torch.split(conv_out, [Hl * hd, G * N, G * N], dim=-1)
    heads = slice(h0, h0 + Hl)
    dt = F.softplus(dt[..., heads].float() + dt_bias)
    A = -torch.exp(A_log)
    xh = xb.reshape(Bsz, S, Hl, hd).float()
    Bh = Bv.reshape(Bsz, S, G, N).float().repeat_interleave(
        H // G, dim=2)[:, :, heads]
    Ch = Cv.reshape(Bsz, S, G, N).float().repeat_interleave(
        H // G, dim=2)[:, :, heads]
    y, state = _ssd_chunked(xh, Bh, Ch, dt, A, D, chunk)
    yz = y.reshape(Bsz, S, Hl * hd) * silu(
        z[..., h0 * hd:(h0 + Hl) * hd].float())
    conv_tail = z_all[:, -(cfg.ssm_conv - 1):, d_in:2 * d_in + 2 * G * N]
    return yz, state, conv_tail


def _norm_heads(yz, norm_w):
    """The rest of ``_gated_norm`` on ``yz`` (y * silu(z), float32) with
    its channels split over ``model``: each row's mean square is summed
    over the model ranks (one all-reduce), then applied."""
    var = torch.mean(yz * yz, dim=-1, keepdim=True)
    var = constrain(var, "batch", *(None,) * (yz.ndim - 1))
    return yz * torch.rsqrt(var + 1e-5) * norm_w.float()


def ssd_forward(p, x, cfg, chunk: int = 128):
    """x (B, S, d) -> (B, S, d); returns (out, final_state, conv_tail).
    Under a mesh the core runs on each rank's batch shard and, where
    ``_head_block`` allows, its block of heads, from the whole packed
    projection (z, x, B, C and dt in one dim, split over ``model`` in
    halves that do not line up with the heads, so it is gathered: an
    activation, not a weight); the state comes out split by heads."""
    z_all = x @ p["in_proj"]
    b3 = ("batch", None, None)
    h0 = _head_block(cfg)
    if h0 is not None:
        m1 = ("model",)
        yz, st, conv_tail = local_apply(
            lambda *a: _ssd_core_heads(*a, cfg, chunk, h0),
            (z_all, *(p[n] for n in ("conv_w", "conv_b", "dt_bias",
                                     "A_log", "D"))),
            [b3, (None, None), (None,), m1, m1, m1],
            [("batch", None, "model"), ("batch", "model", None, None), b3])
        y = _norm_heads(yz, p["norm_w"]).to(x.dtype)
        return y @ p["out_proj"], st, conv_tail
    args, axes = _core_args(p)
    y, st, conv_tail = local_apply(
        lambda z, *a: _ssd_core(z, *a, cfg, chunk, x.dtype), (z_all, *args),
        [b3, *axes], [b3, ("batch", None, None, None), b3])
    return y @ p["out_proj"], st, conv_tail


def _decode_core(z_all, state, conv_buf, conv_w, conv_b, dt_bias, A_log,
                 D, norm_w, cfg, dtype):
    """One token's state recurrence: (y in ``dtype``, new_state,
    new_conv_buf)."""
    Bsz = z_all.shape[0]
    d_in = cfg.ssm_expand * cfg.d_model
    hd = cfg.ssm_headdim
    H = d_in // hd
    G, N = cfg.ssm_groups, cfg.ssm_state
    z, xb, Bv, Cv, dt = _split_proj(z_all, cfg)
    conv_in = torch.cat([xb, Bv, Cv], dim=-1)                     # (B,1,ch)
    win = torch.cat([conv_buf, conv_in], dim=1)                   # (B,K,ch)
    conv_out = torch.einsum("bkc,kc->bc", win, conv_w) + conv_b
    conv_out = silu(conv_out)[:, None, :]
    xb, Bv, Cv = torch.split(conv_out, [d_in, G * N, G * N], dim=-1)
    dt = F.softplus(dt[:, 0].float() + dt_bias)                   # (B,H)
    A = -torch.exp(A_log)
    xh = xb.reshape(Bsz, H, hd).float()
    Bh = Bv.reshape(Bsz, G, N).repeat_interleave(H // G, dim=1).float()
    Ch = Cv.reshape(Bsz, G, N).repeat_interleave(H // G, dim=1).float()
    y, state = _ssd_step(state, xh, Bh, Ch, dt, A, D)
    y = _gated_norm(y.reshape(Bsz, d_in), z[:, 0], norm_w)
    return y.to(dtype), state, win[:, 1:, :]


def _ssd_step(state, xh, Bh, Ch, dt, A, D):
    """One token of the recurrence of the heads of ``xh`` (B, H, P),
    float32: (y (B, H, P) with the D skip, new state (B, H, N, P))."""
    decay = torch.exp(dt * A)                                     # (B,H)
    state = state * decay[..., None, None] + torch.einsum(
        "bh,bhn,bhp->bhnp", dt, Bh, xh)
    y = torch.einsum("bhn,bhnp->bhp", Ch, state)
    return y + D[None, :, None] * xh, state


def _decode_core_heads(z_all, state, conv_buf, conv_w, conv_b, dt_bias,
                       A_log, D, cfg, h0: int):
    """``_decode_core`` on heads [h0, h0 + Hl) (``state`` holds those):
    (y * silu(z) in float32 on their channels, their new state, the
    whole new conv window)."""
    Bsz = z_all.shape[0]
    d_in = cfg.ssm_expand * cfg.d_model
    hd = cfg.ssm_headdim
    H, Hl = d_in // hd, dt_bias.shape[0]
    G, N = cfg.ssm_groups, cfg.ssm_state
    z, xb, Bv, Cv, dt = _split_proj(z_all, cfg)
    conv_in = torch.cat([xb, Bv, Cv], dim=-1)                     # (B,1,ch)
    win = torch.cat([conv_buf, conv_in], dim=1)                   # (B,K,ch)
    conv_out = torch.einsum("bkc,kc->bc", _mine(win, cfg, h0, Hl),
                            _mine(conv_w, cfg, h0, Hl)) \
        + _mine(conv_b, cfg, h0, Hl)
    conv_out = silu(conv_out)[:, None, :]
    xb, Bv, Cv = torch.split(conv_out, [Hl * hd, G * N, G * N], dim=-1)
    heads = slice(h0, h0 + Hl)
    dt = F.softplus(dt[:, 0, heads].float() + dt_bias)           # (B,Hl)
    A = -torch.exp(A_log)
    xh = xb.reshape(Bsz, Hl, hd).float()
    Bh = Bv.reshape(Bsz, G, N).repeat_interleave(H // G, dim=1)[:, heads] \
        .float()
    Ch = Cv.reshape(Bsz, G, N).repeat_interleave(H // G, dim=1)[:, heads] \
        .float()
    y, state = _ssd_step(state, xh, Bh, Ch, dt, A, D)
    yz = y.reshape(Bsz, Hl * hd) * silu(
        z[:, 0, h0 * hd:(h0 + Hl) * hd].float())
    return yz, state, win[:, 1:, :]


def ssd_decode(p, x, state, conv_buf, cfg):
    """One-token decode. x (B,1,d); state (B,H,N,P); conv_buf (B,K-1,ch).
    Returns (out, new_state, new_conv_buf); the inputs are not written.
    Under a mesh as ``ssd_forward``: where ``_head_block`` allows, each
    rank steps its own heads of its batch shard of the state, and the new
    state is laid out as the cache holds it (split by batch only)."""
    z_all = x @ p["in_proj"]
    b3, b4 = ("batch", None, None), ("batch", None, None, None)
    h0 = _head_block(cfg)
    if h0 is not None:
        m1, h4 = ("model",), ("batch", "model", None, None)
        yz, state, win = local_apply(
            lambda *a: _decode_core_heads(*a, cfg, h0),
            (z_all, state, conv_buf, *(p[n] for n in (
                "conv_w", "conv_b", "dt_bias", "A_log", "D"))),
            [b3, h4, b3, (None, None), (None,), m1, m1, m1],
            [("batch", "model"), h4, b3])
        y = _norm_heads(yz, p["norm_w"]).to(x.dtype)
        state = constrain(state, *b4)
    else:
        args, axes = _core_args(p)
        y, state, win = local_apply(
            lambda z, st, cb, *a: _decode_core(z, st, cb, *a, cfg, x.dtype),
            (z_all, state, conv_buf, *args), [b3, b4, b3, *axes],
            [("batch", None), b4, b3])
    out = y @ p["out_proj"]
    return out[:, None, :], state, win
