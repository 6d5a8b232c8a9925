"""Shared layer primitives: norms, rotary embeddings, FFN activations.

The counterpart of ``repro.models.layers``.  Everything is functional
(params = nested dicts of tensors) and carries parallel "logical axis"
metadata pytrees for the sharding layer.  The dtype steps are the
reference's: float32 inside the norm and the rotations, and a cast back
to the input's dtype.
"""

from __future__ import annotations

import numpy as np
import torch


def silu(x):
    """``x * sigmoid(x)``, two rounded steps in ``x``'s dtype, as
    ``jax.nn.silu`` computes it."""
    return x * torch.sigmoid(x)


def rms_norm(x, w, eps=1e-5):
    dt = x.dtype
    x = x.float()
    v = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(v + eps)) * w.float()).to(dt)


def swiglu(x, w_gate, w_up, w_down):
    g = x @ w_gate
    u = x @ w_up
    return (silu(g) * u) @ w_down


def sq_relu_ffn(x, w_up, w_down):
    """Nemotron-4 squared-ReLU FFN (Primer): relu(xW1)^2 W2."""
    u = x @ w_up
    r = torch.relu(u)
    return (r * r) @ w_down


# ------------------------- rotary embeddings -------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0):
    """Inverse frequencies in numpy float64, as the reference computes
    them; callers cast to float32."""
    half = head_dim // 2
    return 1.0 / (theta ** (np.arange(0, half) * 2.0 / head_dim))


def _rotate(x, ang):
    half = x.shape[-1] // 2
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.cat([o1, o2], dim=-1).to(x.dtype)


def _freqs(D: int, theta: float, device) -> torch.Tensor:
    return torch.as_tensor(rope_freqs(D, theta).astype(np.float32),
                           device=device)


def apply_rope(x, positions, theta: float = 10000.0):
    """x (..., S, H, D); positions (..., S) int32 broadcastable."""
    freqs = _freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].float() * freqs              # (..., S, half)
    return _rotate(x, ang)


MROPE_SECTIONS = (16, 24, 24)   # qwen2-vl: temporal/height/width half-dims


def mrope_sections(half: int) -> tuple[int, int, int]:
    """Qwen2-VL uses (16,24,24) at head_dim=128; scale proportionally for
    reduced smoke configs."""
    t = max(half * 16 // 64, 1)
    h = max(half * 24 // 64, 1)
    return (t, h, half - t - h)


def apply_mrope(x, positions3, theta: float = 1000000.0, sections=None):
    """Qwen2-VL M-RoPE. x (B, S, H, D); positions3 (3, B, S).

    The rotary half-dim is split into (t, h, w) sections, each rotated by
    its own position stream (equal streams reduce to plain RoPE).
    """
    D = x.shape[-1]
    half = D // 2
    if sections is None:
        sections = mrope_sections(half)
    assert sum(sections) == half, (sections, half)
    freqs = _freqs(D, theta, x.device)                      # (half,)
    angs = []
    off = 0
    for s_i, sec in enumerate(sections):
        pos = positions3[s_i]                                # (B, S)
        angs.append(pos[..., None].float() * freqs[off:off + sec])
        off += sec
    return _rotate(x, torch.cat(angs, dim=-1))              # (B, S, half)


# ------------------------- init helpers -------------------------

def dense_init(gen, shape, dtype, device, scale=0.02):
    """float32 normals x ``scale`` drawn from the ``torch.Generator``
    ``gen`` on ``device``, then cast to ``dtype``.  On the meta device
    the draw has no values, and ``gen`` is not used."""
    dev = torch.device(device)
    x = torch.randn(tuple(shape), generator=None if dev.type == "meta"
                    else gen, dtype=torch.float32, device=dev)
    return (x * scale).to(dtype)
