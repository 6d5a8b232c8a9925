"""The "cuda" engine: the stage-major SE and PE pipelines on one device,
their hot kernels (fmocc extension rounds, BSW blocks, including the PE
mate-rescue blocks) through ``kernels``.

It is ``core.pipeline.run_se_batched`` / ``pe.run_pe_batched`` with the
occ configuration picked by the
attach-time sweep — the paper's eta experiment (§4.4 / Table 4) run on
the card: each (layout, threads-per-block) candidate is timed with CUDA
events on a synthetic batch of extension entries, and the fastest
becomes the index's SMEM round kernel for that device.  Every candidate
returns the same values, so the pick changes speed only, never the SAM.
On the CPU there is no kernel to tune: the plain version runs with the
default candidate.

Replaces ``repro.kernels.engine``'s Pallas sweep (``sweep_occ_configs`` /
``attach_occ_config``), ``run_se_pallas`` and ``run_pe_pallas``.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from .. import obs
from ..core.pipeline import PipelineOptions, run_se_batched
from ..pe import run_pe_batched
from .fmocc.ops import DEFAULT_CANDIDATE, DIRECTIONS, OccConfig, ext_round

#: (layout, threads per block) candidates the sweep times on the card
SWEEP_CANDIDATES = (("eta32", 256), ("eta32", 512), ("eta128", 256))
#: Synthetic extension entries per launch (8 occ lookups each).  Large
#: enough that one launch's device time is several times the wrapper's
#: host time, so launches queue up behind each other and the events time
#: the device alone.
SWEEP_ENTRIES = 1 << 21
SWEEP_LAUNCHES = 4       # launches between the two events of a rep
SWEEP_REPS = 3           # timed reps per candidate (best taken)
#: A candidate displaces the default only when it is at least this much
#: faster; nearer than that the timing cannot tell them apart, and the
#: pick (and the per-layout launch counts) would change from run to run.
SWEEP_MARGIN = 0.05


def sweep_entries(N: int, n: int, seed: int) -> np.ndarray:
    """(4, n) int32 (k, l, s, c) synthetic extension entries over an index
    of N rows: k and l uniform in [0, N), s uniform in [1, 64] clipped so
    that both [k, k+s) and [l, l+s) lie in [0, N] (a round extends either
    direction), c uniform in 0..4 (4: an ambiguous base).  Seeded, so
    repeated sweeps see identical inputs."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, N, n)
    l = rng.integers(0, N, n)
    s = np.minimum(rng.integers(1, 65, n), N - np.maximum(k, l))
    c = rng.integers(0, 5, n)
    return np.stack([k, l, s, c]).astype(np.int32)


def sweep_timings(idx, device) -> dict:
    """Device milliseconds per launch of every candidate on ``device``
    (CUDA), on ``SWEEP_ENTRIES`` synthetic entries, the launches
    alternating backward and forward rounds.

    One untimed launch precedes the first event, so the device is busy
    while the host enqueues the event and the timed launches behind it.
    Synthetic uniform entries are representative because the kernel is
    data-oblivious: two bucket gathers and a fixed count per entry,
    whatever the values.
    """
    dev = torch.device(device)
    fm = idx.device(dev)
    st = torch.from_numpy(sweep_entries(int(idx.N), SWEEP_ENTRIES, 0)).to(dev)
    timings = {}
    for layout, block in SWEEP_CANDIDATES:
        def fn(which):
            return ext_round(fm, which, *st, layout=layout, block=block)
        fn("bwd")                                      # warmup (and build)
        best = float("inf")
        for _ in range(SWEEP_REPS):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            fn("fwd")
            t0.record()
            for j in range(SWEEP_LAUNCHES):
                fn(DIRECTIONS[j % 2])
            t1.record()
            t1.synchronize()
            best = min(best, t0.elapsed_time(t1) / SWEEP_LAUNCHES)
        timings[(layout, block)] = best
    return timings


def sweep_occ_configs(idx, device) -> OccConfig:
    """The fastest candidate on ``device``; the default unless another is
    ``SWEEP_MARGIN`` faster.  On the CPU there is no kernel to time."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return OccConfig(*DEFAULT_CANDIDATE, str(dev))
    timings = sweep_timings(idx, dev)
    pick = min(timings, key=timings.get)
    if timings[pick] > (1 - SWEEP_MARGIN) * timings[DEFAULT_CANDIDATE]:
        pick = DEFAULT_CANDIDATE
    return OccConfig(*pick, str(dev))


#: Serializes the attach-time sweep: concurrent aligner calls sharing one
#: index must not race the cache probe/sweep/store below.
_ATTACH_LOCK = threading.Lock()


def attach_occ_config(idx, device) -> OccConfig:
    """Sweep once per (index, device) and cache it on the index
    (``idx._cuda_occ_cfg``, keyed by device)."""
    key = str(torch.device(device))
    cfgs = getattr(idx, "_cuda_occ_cfg", None)
    if cfgs is not None and key in cfgs:
        return cfgs[key]
    with _ATTACH_LOCK:
        cfgs = getattr(idx, "_cuda_occ_cfg", None)
        if cfgs is None:
            cfgs = idx._cuda_occ_cfg = {}
        if key not in cfgs:
            with obs.span("kernel.occ_sweep", cat="kernel"):
                cfgs[key] = sweep_occ_configs(idx, key)
    return cfgs[key]


def run_se_cuda(idx, reads, opt: PipelineOptions = PipelineOptions()):
    """SE driver of the "cuda" engine.  Returns (list per read of
    Alignment, stats); ``stats["occ_kernel"]`` names the occ
    configuration the SMEM rounds ran ("layout/block")."""
    cfg = attach_occ_config(idx, opt.device)
    results, stats = run_se_batched(idx, reads, opt, occ=cfg)
    stats["occ_kernel"] = f"{cfg.layout}/{cfg.block}"
    return results, stats


def run_pe_cuda(idx, reads1, reads2,
                opt: PipelineOptions = PipelineOptions(),
                pe_opt=None, names=None):
    """PE driver of the "cuda" engine.  Returns (sam_lines, stats);
    ``stats["occ_kernel"]`` as in ``run_se_cuda``."""
    cfg = attach_occ_config(idx, opt.device)
    lines, stats = run_pe_batched(idx, reads1, reads2, opt, pe_opt,
                                  names=names, occ=cfg)
    stats["occ_kernel"] = f"{cfg.layout}/{cfg.block}"
    return lines, stats
