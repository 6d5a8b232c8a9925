"""Batched serving loop: prefill + decode with the paper's batching
discipline applied to requests (``repro.launch.serve``' counterpart).

The BWA-MEM insights mapped onto serving:
  * stage-major batching (Fig 2): a whole batch is prefilled, then the
    whole batch decodes in lockstep — not request-major;
  * length-sorting (paper §5.3.1): requests are sorted by prompt length
    before blocking so padded prefill lanes are uniform; wasted-lane
    accounting is reported exactly like the paper's Table 8;
  * contiguous pre-allocation (§3.2): one static KV cache, written in
    place.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

It runs on the card unless ``--device cpu`` is given; without a card it
exits 2.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..api import resolve_device
from ..configs import get_arch, smoke_config
from ..models import lm


def serve_batch(cfg, params, prompts: list[np.ndarray], max_new: int,
                *, sort_by_length: bool = True, verbose: bool = False,
                on_step=None):
    """Greedy-decode a batch of token prompts on the params' device.
    Returns (outputs, stats).

    Prompts are prefilled by teacher-forced ``decode_step``s in lockstep
    with the decode.  Each step's next token is the first maximal logit
    (``torch.argmax``, as ``jnp.argmax``).  ``on_step(pos, logits)``,
    when given, sees each step's (B, V) logits, rows in length-sorted
    order.  ``verbose`` is the reference's keyword, and prints nothing.

    Where ``repro.launch.serve.serve_batch`` takes the argmax of the
    (B, 1, V) logits and so builds a (B, 1, 1) token tensor that fails
    the second step, this takes it over the last position's (B, V)
    logits, so the next tokens are (B, 1).
    """
    B = len(prompts)
    lens = np.array([len(p) for p in prompts])
    order = np.argsort(lens) if sort_by_length else np.arange(B)
    inv = np.argsort(order)
    lens_s = lens[order]
    Smax = int(lens.max()) + max_new
    dev = lm.params_device(params)
    # stage 1: batched prefill via teacher-forced decode of padded prompts
    toks = np.zeros((B, int(lens.max())), np.int32)
    for i, o in enumerate(order):
        toks[i, :lens_s[i]] = prompts[o]
    useful = int(lens.sum())
    total = B * int(lens.max())
    out_tokens = [[] for _ in range(B)]
    with torch.inference_mode():
        cache = lm.init_cache(cfg, B, Smax, device=dev)
        toks_d = torch.as_tensor(toks, device=dev)
        lens_d = torch.as_tensor(lens_s, device=dev)
        cur = toks_d[:, :1]
        # lockstep prefill+decode (simple reference serving loop)
        for pos in range(int(lens.max()) + max_new - 1):
            logits, cache = lm.decode_step(params, cfg, cache,
                                           {"tokens": cur}, pos)
            if on_step is not None:
                on_step(pos, logits[:, -1])
            nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
            if pos + 1 < toks.shape[1]:
                use_forced = (pos + 1 < lens_d)[:, None]
                cur = torch.where(use_forced, toks_d[:, pos + 1:pos + 2], nxt)
            else:
                cur = nxt
            emit = np.flatnonzero(pos + 1 >= lens_s)
            if emit.size:
                host = cur[:, 0].cpu().numpy()     # one copy for the batch
                for i in emit:
                    out_tokens[i].append(int(host[i]))
    outs = [np.array(out_tokens[inv[i]][:max_new], np.int32)
            for i in range(B)]
    stats = {"useful_prefill_tokens": useful, "padded_tokens": total,
             "lane_efficiency": useful / total}
    return outs, stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda[:n] (default) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the params' generator and the prompts")
    args = ap.parse_args(argv)
    cfg = smoke_config(args.arch) if args.smoke else get_arch(args.arch)
    try:
        dev = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"serve: {e}", file=sys.stderr)
        return 2
    params, _ = lm.init_params(
        cfg, torch.Generator(dev).manual_seed(args.seed), device=dev)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab, size=rng.integers(4, 40))
               .astype(np.int32) for _ in range(args.batch)]
    t0 = time.time()
    outs, stats = serve_batch(cfg, params, prompts, args.max_new)
    print(f"served {args.batch} requests in {time.time()-t0:.1f}s; "
          f"lane efficiency {stats['lane_efficiency']:.2f}")
    print("first output:", outs[0][:10])
    return 0


if __name__ == "__main__":
    sys.exit(main())
