"""Step factories: train_step / prefill_step / decode_step closures over
an ArchConfig (``repro.launch.steps``' counterpart).

The train step takes its gradients through ``torch.autograd`` and keeps
no graph across steps: the new parameters come out of ``adamw_update``
detached.  With ``compress_grads`` the quantization error is carried to
the next step in the train state under ``"error_fb"`` (the reference's
``make_train_step`` drops it); without it the state holds the
reference's keys only.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from ..configs.base import ArchConfig
from ..models import lm
from ..optim import AdamWConfig, adamw_update
from ..optim.adamw import tree_leaves, tree_map


def _laid_out_as(g, p):
    """A gradient laid out as its parameter (a sharded step reduces a
    DTensor gradient to its parameter's placements here, where the
    optimizer meets the two)."""
    if isinstance(g, DTensor) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


def loss_and_grads(params, cfg: ArchConfig, batch, *, q_block=512,
                   kv_block=512):
    """(loss, grads): ``lm.loss_fn`` of ``batch`` and its gradient with
    respect to every leaf of ``params``, as a tree of the same structure
    (a leaf the loss does not reach gets zeros, as ``jax.grad`` gives)."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    leaves = tree_leaves(live)
    with torch.enable_grad():
        loss = lm.loss_fn(live, cfg, batch, q_block=q_block,
                          kv_block=kv_block)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else _laid_out_as(g, p)
              for p, g in zip(leaves, grads))
    return loss.detach(), tree_map(lambda _: next(it), live)


def make_train_step(cfg: ArchConfig, opt: AdamWConfig = AdamWConfig(),
                    *, q_block=512, kv_block=512):
    def train_step(state, batch):
        lval, grads = loss_and_grads(state["params"], cfg, batch,
                                     q_block=q_block, kv_block=kv_block)
        new_p, new_opt, efb = adamw_update(opt, state["params"], grads,
                                           state["opt"],
                                           state.get("error_fb"))
        new = {"params": new_p, "opt": new_opt}
        if opt.compress_grads:
            new["error_fb"] = efb
        return new, lval
    return train_step


def make_prefill_step(cfg: ArchConfig, *, q_block=512, kv_block=512):
    def prefill_step(params, batch):
        hidden = lm.forward(params, cfg, batch, q_block=q_block,
                            kv_block=kv_block, return_hidden=True)
        # head applied to the last position only (next-token logits)
        return lm.apply_head(params, cfg, hidden[:, -1])
    return prefill_step


def make_decode_step(cfg: ArchConfig):
    def decode_step(params, cache, batch, pos):
        logits, cache = lm.decode_step(params, cfg, cache, batch, pos)
        return logits[:, -1], cache
    return decode_step
