"""AdamW with global-norm clipping and optional int8 gradient compression
(error feedback) for cross-pod reduction (``repro.optim.adamw``'
counterpart).

Plain functions over the nested dict of tensors that ``models.lm`` uses,
no ``torch.optim.Optimizer``: the state is ``{"step", "mu", "nu"}``, so a
checkpoint keeps the reference's MANIFEST keys.  The arithmetic is the
reference's, in float32 and in the same order: the moments are float32
whatever the parameter dtype, the bias corrections are taken on a float32
step, the global norm sums the leaves in the reference's order (a dict's
keys sorted), and the update is applied to ``p`` in float32 and cast back
to ``p.dtype``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    compress_grads: bool = False      # int8 + error feedback (cross-pod)


def tree_leaves(tree) -> list:
    """The leaves of a nested dict in ``jax.tree.leaves``' order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_map(f, tree, *rest):
    """``f`` over the leaves of nested dicts of one structure, visited in
    ``tree_leaves``' order (the dicts it returns have their keys sorted,
    as ``jax.tree.map``'s have)."""
    if isinstance(tree, dict):
        return {k: tree_map(f, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return f(tree, *rest)


def adamw_init(params):
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = tree_leaves(params)[0].device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "mu": tree_map(zeros, params),
            "nu": tree_map(zeros, params)}


def _schedule(cfg: AdamWConfig, step):
    warm = torch.clamp(step.to(torch.float32) / cfg.warmup_steps, max=1.0)
    return cfg.lr * warm


def compress_int8(g):
    """Symmetric per-tensor int8 quantization -> (q, scale).  Rounds half
    to even, as ``jnp.round`` does."""
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q, scale):
    return q.to(torch.float32) * scale


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state,
                 error_fb: Any = None):
    """Returns (new_params, new_state, new_error_fb).

    With compress_grads, each gradient tensor is int8-quantized (as it
    would be before the cross-pod all-reduce) and the quantization error
    is fed back into the next step's gradient (1-bit-Adam-style EF)."""
    if cfg.compress_grads:
        if error_fb is None:
            error_fb = tree_map(
                lambda g: torch.zeros_like(g, dtype=torch.float32), grads)
        gplus = tree_map(lambda g, e: g.to(torch.float32) + e, grads,
                         error_fb)
        grads_c = tree_map(lambda g: decompress_int8(*compress_int8(g)),
                           gplus)
        error_fb = tree_map(lambda g, gc: g - gc, gplus, grads_c)
        grads = grads_c

    # global-norm clip
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                           for g in tree_leaves(grads)))
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                       max=1.0)
    step = state["step"] + 1
    lr = _schedule(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** step.to(torch.float32)

    def upd(p, g, mu, nu):
        g = g.to(torch.float32) * clip
        mu = cfg.b1 * mu + (1 - cfg.b1) * g
        nu = cfg.b2 * nu + (1 - cfg.b2) * g * g
        mhat = mu / b1c
        nhat = nu / b2c
        p32 = p.to(torch.float32)
        delta = mhat / (torch.sqrt(nhat) + cfg.eps) + cfg.weight_decay * p32
        return (p32 - lr * delta).to(p.dtype), mu, nu

    new = tree_map(upd, params, grads, state["mu"], state["nu"])
    new_state = {"step": step, "mu": _pick(new, 1), "nu": _pick(new, 2)}
    return _pick(new, 0), new_state, error_fb


def _pick(tree, i):
    """The ``i``-th of the tuples at the leaves of ``tree``."""
    return tree_map(lambda t: t[i], tree)
