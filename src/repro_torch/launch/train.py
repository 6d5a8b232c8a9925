"""End-to-end training driver with fault tolerance
(``repro.launch.train``' counterpart).

The reference's loop on one device, through ``torch.autograd``:
  * CheckpointManager (atomic, keep-k, checksum-verified restart; a
    bfloat16 state saves and restores),
  * StragglerMonitor (rolling step-time watchdog -> rebalance/checkpoint),
  * optional int8 gradient compression, its error feedback carried in
    the train state.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --steps 8 --ckpt-dir /tmp/ck
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu

It runs on the card unless ``--device cpu`` is given; without a card it
exits 2.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch

from ..api import resolve_device
from ..configs import get_arch, smoke_config
from ..ft import CheckpointManager, StragglerMonitor
from ..models import lm
from ..optim import AdamWConfig, adamw_init
from ..optim.adamw import tree_map
from .steps import make_train_step


def synthetic_batch(cfg, batch: int, seq: int, step: int, *,
                    device="cuda"):
    """The reference's batch for ``step``: the same draws from
    ``np.random.default_rng(step)``, as int32 tensors (and bfloat16
    embeds) on ``device``."""
    dev = lm._device(device)
    rng = np.random.default_rng(step)

    def i32(a):
        return torch.from_numpy(a).to(device=dev, dtype=torch.int32)
    if cfg.input_kind == "codes":
        toks = rng.integers(0, cfg.vocab, size=(batch, seq, cfg.n_codebooks))
        return {"tokens": i32(toks), "labels": i32(toks)}
    if cfg.input_kind == "embeds":
        embeds = rng.normal(0, 0.02, size=(batch, seq, cfg.d_model))
        return {"embeds": torch.from_numpy(embeds).to(device=dev,
                                                      dtype=torch.bfloat16),
                "positions": torch.arange(seq, dtype=torch.int32,
                                          device=dev).expand(3, batch, seq),
                "labels": i32(rng.integers(0, cfg.vocab, size=(batch, seq)))}
    toks = rng.integers(0, cfg.vocab, size=(batch, seq + 1))
    return {"tokens": i32(toks[:, :-1]), "labels": i32(toks[:, 1:])}


def train(cfg, *, steps: int, batch: int, seq: int, ckpt_dir: str,
          ckpt_every: int = 20, opt: AdamWConfig = AdamWConfig(),
          q_block: int = 128, resume: bool = True, verbose: bool = True,
          device="cuda", generator: torch.Generator | None = None,
          params=None, on_step=None):
    """Train ``cfg`` for ``steps`` steps on ``device`` (the card by
    default; without one this raises) and save the final state; returns
    (state, the losses of the steps run here).  The initial params are
    ``params`` (e.g. the reference's, carried by
    ``models.convert.params_from_reference``) or drawn by
    ``lm.init_params`` from ``generator`` (seeded with 0 by default).
    ``on_step(step, loss, seconds)`` is called after every step, with the
    step's wall time to its loss on the host."""
    dev = lm._device(device)
    if params is None:
        gen = generator or torch.Generator(dev).manual_seed(0)
        params, _ = lm.init_params(cfg, gen, device=dev)
    state = {"params": params, "opt": adamw_init(params)}
    if opt.compress_grads:
        state["error_fb"] = tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    mgr = CheckpointManager(ckpt_dir, keep=3)
    start = 0
    if resume and mgr.steps():
        state, start = mgr.restore(state)
        if verbose:
            print(f"[train] resumed from step {start}")
    step_fn = make_train_step(cfg, opt, q_block=q_block, kv_block=q_block)
    mon = StragglerMonitor()
    losses = []
    for step in range(start, steps):
        mon.start_step()
        t0 = time.perf_counter()
        batch_data = synthetic_batch(cfg, batch, seq, step, device=dev)
        state, loss = step_fn(state, batch_data)
        loss = float(loss)
        losses.append(loss)
        if on_step is not None:
            on_step(step, loss, time.perf_counter() - t0)
        ev = mon.end_step(step)
        if ev is not None and verbose:
            print(f"[straggler] step {ev.step} {ev.step_time*1e3:.0f}ms "
                  f"(median {ev.median*1e3:.0f}ms) -> {ev.action}")
        if ev is not None and ev.action == "checkpoint":
            mgr.save(step + 1, state)
        if (step + 1) % ckpt_every == 0:
            mgr.save(step + 1, state)
        if verbose and (step % 10 == 0 or step == steps - 1):
            print(f"step {step:5d} loss {loss:.4f}")
    mgr.save(steps, state)
    return state, losses


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda[:n] (default) or cpu")
    args = ap.parse_args(argv)
    cfg = smoke_config(args.arch) if args.smoke else get_arch(args.arch)
    try:
        dev = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"train: {e}", file=sys.stderr)
        return 2
    opt = AdamWConfig(compress_grads=args.compress_grads)
    t0 = time.time()
    _, losses = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                      ckpt_dir=args.ckpt_dir, opt=opt, device=dev)
    if losses:
        print(f"done in {time.time()-t0:.1f}s; "
              f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
