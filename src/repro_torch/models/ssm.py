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
log(1 + e^x): the two differ there by less than 2e-9.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..dist.api import local_apply
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
                                   device=z_all.device))
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
    y = y + D[None, None, :, None] * xh
    y = _gated_norm(y.reshape(Bsz, S, d_in), z, norm_w)
    conv_tail = conv_in[:, -(cfg.ssm_conv - 1):, :]               # (B,K-1,ch)
    return y.to(dtype), st_scan[-1], conv_tail


def ssd_forward(p, x, cfg, chunk: int = 128):
    """x (B, S, d) -> (B, S, d); returns (out, final_state, conv_tail).
    Under a mesh the core runs on each rank's batch shard with the whole
    inner width (the projection packs z, x, B, C and dt in one dim)."""
    z_all = x @ p["in_proj"]
    args, axes = _core_args(p)
    b3 = ("batch", None, None)
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
    decay = torch.exp(dt * A)                                     # (B,H)
    state = state * decay[..., None, None] + torch.einsum(
        "bh,bhn,bhp->bhnp", dt, Bh, xh)
    y = torch.einsum("bhn,bhnp->bhp", Ch, state)
    y = y + D[None, :, None] * xh
    y = _gated_norm(y.reshape(Bsz, d_in), z[:, 0], norm_w)
    return y.to(dtype), state, win[:, 1:, :]


def ssd_decode(p, x, state, conv_buf, cfg):
    """One-token decode. x (B,1,d); state (B,H,N,P); conv_buf (B,K-1,ch).
    Returns (out, new_state, new_conv_buf); the inputs are not written."""
    z_all = x @ p["in_proj"]
    args, axes = _core_args(p)
    b3, b4 = ("batch", None, None), ("batch", None, None, None)
    y, state, win = local_apply(
        lambda z, st, cb, *a: _decode_core(z, st, cb, *a, cfg, x.dtype),
        (z_all, state, conv_buf, *args), [b3, b4, b3, *axes],
        [("batch", None), b4, b3])
    out = y @ p["out_proj"]
    return out[:, None, :], state, win
