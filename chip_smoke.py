#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Drives single-end ``mem`` on the card through the port's own entry points
and checks every hand-written kernel against its plain PyTorch version.
Phases (each prints one line, any failure raises and exits non-zero):

1. environment: Python, torch, CUDA and nvcc versions; the card's name and
   power limit as ``nvidia-smi`` reports them;
2. kernel build: ``nvcc`` of ``src/repro_torch/kernels/csrc/*.cu``, timed,
   with the ptxas register report;
3. index: a 4,641,652-bp reference (the length of E. coli K-12 MG1655,
   synthesized with ``make_reference(4_641_652, seed=42)``) written as
   FASTA and indexed by ``repro_torch.cli index``;
4. kernels against their plain versions on the card, exactly, under
   every (layout, threads per block) candidate of the occ sweep: both
   fmocc layouts on 2^20 - 24 queries (a count no block size divides;
   uniform i in [-1, N-1] plus every bucket edge +-1 around ``primary``
   and i = N-1) and on the (2, E, 4) queries of every SMEM round of the
   device stages run on 512 reads; BSW on every block of real extension
   tasks those reads dispatch and on synthetic blocks: band width 1,
   z-drop triggered, query lengths on strip edges (31-33, 63-65, 127-129
   at qmax 160) and long queries (qmax 256, tmax 320).  Times side by
   side: each kernel's device time (torch.profiler, mean of 20 calls; BSW
   on the first 4 real blocks, and on their tasks repacked into one
   launch), its wrapper call and its plain version (CUDA events, median
   of 20); the BSW kernel's registers (ptxas) and shared memory; the
   sweep's device time per launch of each candidate; and the card's busy
   share while the device stages (SMEM, SAL, chaining, BSW) run on the
   512 reads under the profiler;
5. main path: 2,048 simulated 101-bp reads through ``repro_torch.cli mem
   --device cuda -b 2048`` (one batch) with every kernel launch counter
   set to 0 just before and read just after; one primary SAM line per
   read, reads/s, the stage breakdown, SMEM rounds and the
   truth-recovery share;
6. card against CPU: the first 256 reads through ``Aligner(device="cpu")``
   give SAM body lines byte-identical to the card's.

The line before the last is one JSON object with every kernel's launches,
error, times and bound; the last line is ``{"ok": true, "device": ...}``.
Without a CUDA device it exits 1 and prints no result.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import cli, kernels, obs  # noqa: E402
from repro_torch.api import Aligner  # noqa: E402
from repro_torch.core.bsw import BSWParams, pack_tasks  # noqa: E402
from repro_torch.core.chain import chain_seeds, filter_chains  # noqa: E402
from repro_torch.core.contig import contig_edges  # noqa: E402
from repro_torch.core.pipeline import (BatchedBSWExecutor,  # noqa: E402
                                       PipelineOptions)
from repro_torch.core.sal import seeds_from_intervals  # noqa: E402
from repro_torch.core.smem import collect_smems_batch  # noqa: E402
from repro_torch.data import (make_reference, simulate_reads,  # noqa: E402
                              write_fasta, write_fastq)
from repro_torch.io.store import load_index  # noqa: E402
from repro_torch.io.stream import open_batches  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.bsw.ops import (bsw_call,  # noqa: E402
                                          bsw_extend_kernel, launch_geometry)
from repro_torch.kernels.bsw.ref import bsw_ref  # noqa: E402
from repro_torch.kernels.engine import (SWEEP_CANDIDATES,  # noqa: E402
                                        attach_occ_config, sweep_timings)
from repro_torch.kernels.fmocc.ops import occ  # noqa: E402
from repro_torch.kernels.fmocc.ref import occ_ref  # noqa: E402

REF_LEN = 4_641_652        # E. coli K-12 MG1655 (NC_000913.3)
N_READS = 2048             # one batch, ~1/50 of bwa's 10-Mbase -K chunk
READ_LEN = 101
N_SAMPLE_READS = 512
N_CPU_READS = 256
OCC_QUERIES = (1 << 20) - 24   # a partial last block at every block size
BSW_REAL_BLOCKS = 4
TIMING_REPS = 20
PROFILER_ATTEMPTS = 3

# Peak rates of one H100 SXM (NVIDIA's data sheet, at 700 W).  The
# int32 rate is not in the table of peaks: an SM issues 64 int32 lanes a
# clock (half its 128 float32 lanes), and the BSW cell has no multiply-
# add to count twice, so 64 lanes x 132 SMs x 1.98 GHz.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# int32 ALU operations per banded DP cell of ksw_extend2, the spec
# (core/bsw.py:bsw_extend's inner loop; loads, stores, loop control and
# address arithmetic not counted): score 4, M 3, h 2, row max 3, E 4, F 4.
# The work is the spec's whatever implements it: the warp kernel's scan
# and ballots are not added.
BSW_OPS_PER_CELL = 20
SECTOR = 32                # DRAM access granularity in bytes

KERNELS = {
    "fmocc_eta32": ("src/repro_torch/kernels/csrc/fmocc.cu",
                    "src/repro/kernels/fmocc/kernel.py:86"),
    "fmocc_eta128": ("src/repro_torch/kernels/csrc/fmocc.cu",
                     "src/repro/kernels/fmocc/kernel.py:96"),
    "bsw": ("src/repro_torch/kernels/csrc/bsw.cu",
            "src/repro/kernels/bsw/kernel.py:61"),
}


def phase(name: str, **fields) -> None:
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def cuda_ms(fn, reps: int = TIMING_REPS) -> float:
    """Median CUDA-event time of ``fn()`` in ms, after one warmup call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def profiled(fn):
    """Run ``fn()`` under torch.profiler; return (its result, {event name:
    device microseconds}, wall seconds to the end of the device work)."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = {e.key: e.self_device_time_total for e in prof.key_averages()
           if e.self_device_time_total > 0}
    return out, dev, wall


def kernel_ms(fn, kernel: str, launches: int) -> float:
    """Device time of one launch of ``kernel`` (the profiler's, without
    the wrapper's host time), over ``TIMING_REPS`` calls of ``fn`` that
    launch it ``launches`` times each."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILER_ATTEMPTS):
        _, dev, _ = profiled(lambda: [fn() for _ in range(TIMING_REPS)])
        us = sum(v for k, v in dev.items() if kernel in k)
        if us > 0:
            return us / (TIMING_REPS * launches) / 1e3
        # torch.profiler can return a session with no device activity at
        # all; that is a fault of the tracer, not a time: take it again
        print(f"  profiler: no device time for {kernel} in session "
              f"{attempt + 1}", flush=True)
    raise AssertionError(f"the profiler saw no device time for {kernel}")


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


# ---------------------------------------------------------------------
# phase 4: kernels against their plain versions
# ---------------------------------------------------------------------

def occ_queries(idx, dev):
    """``OCC_QUERIES`` (c, i): every bucket edge +-1 around ``primary`` in
    both layouts, i = -1, 0, N-2, N-1 for all four bases, the rest
    uniform."""
    N, prim = int(idx.N), int(idx.primary)
    edge = {-1, 0, N - 2, N - 1, prim - 1, prim, prim + 1}
    for eta in (32, 128):
        for b in range(prim // eta - 1, prim // eta + 3):
            edge.update((b * eta - 2, b * eta - 1, b * eta))
    fixed = sorted(i for i in edge if -1 <= i <= N - 1)
    rng = np.random.default_rng(1)
    c = rng.integers(0, 4, OCC_QUERIES, dtype=np.int32)
    i = rng.integers(-1, N - 1, OCC_QUERIES, dtype=np.int32, endpoint=True)
    k = 4 * len(fixed)
    c[:k] = np.tile(np.arange(4, dtype=np.int32), len(fixed))
    i[:k] = np.repeat(np.asarray(fixed, np.int32), 4)
    return (torch.from_numpy(c).to(dev), torch.from_numpy(i).to(dev))


def occ_bound_ms(c, i, layout: str) -> float:
    """Least time for these queries: c and i read and Occ written once
    (12 B a query) plus every distinct 32-B sector of the count table and
    every distinct bucket row the queries touch, over the HBM rate."""
    shift = 5 if layout == "eta32" else 7
    b = (i + 1) >> shift
    count_sectors = torch.unique(b >> 1).numel()   # 16 B of counts a bucket
    rows = torch.unique(b).numel()                 # one 32-B row a bucket
    nbytes = 12 * c.numel() + SECTOR * (count_sectors + rows)
    return 1e3 * nbytes / HBM_BYTES_PER_S


def check_occ(idx, dev, rounds: list) -> dict:
    """Both layouts against the plain version on the synthetic queries and
    on ``rounds`` (the (c, i) of real SMEM rounds), under every sweep
    candidate's block size; then timed and bounded on the synthetic ones."""
    fm = idx.device(dev)
    c, i = occ_queries(idx, dev)
    out = {}
    errs = {}
    for layout, block in SWEEP_CANDIDATES:
        for tag, (cq, iq) in [("synthetic", (c, i))] + [
                (f"round{r}", q) for r, q in enumerate(rounds)]:
            got = occ(fm, cq, iq, layout=layout, block=block)
            want = occ_ref(fm, cq, iq, layout=layout)
            if not torch.equal(got, want):
                raise AssertionError(
                    f"fmocc_{layout} (block {block}) differs from its plain "
                    f"version on {tag} at {int((got != want).sum())} of "
                    f"{cq.numel()} queries")
            if got.numel():
                errs[layout] = max(errs.get(layout, 0),
                                   int((got - want).abs().max()))
    sizes = sorted(q[0].numel() for q in rounds)
    phase("occ_exact", candidates=len(SWEEP_CANDIDATES),
          synthetic_queries=c.numel(), real_rounds=len(rounds),
          real_queries_min=sizes[0], real_queries_median=sizes[len(sizes) // 2],
          real_queries_max=sizes[-1], max_abs_err=json.dumps(errs))
    for layout in ("eta32", "eta128"):
        err = errs[layout]          # the synthetic queries are never empty
        call = cuda_ms(lambda: occ(fm, c, i, layout=layout))
        ms = kernel_ms(lambda: occ(fm, c, i, layout=layout),
                       f"occ_{layout}_kernel", 1)
        plain = cuda_ms(lambda: occ_ref(fm, c, i, layout=layout))
        bound = occ_bound_ms(c, i, layout)
        phase("occ", layout=layout, queries=c.numel(), max_abs_err=err,
              kernel_ms=f"{ms:.4f}", call_ms=f"{call:.4f}",
              plain_ms=f"{plain:.4f}", bound_ms=f"{bound:.4f}")
        out[f"fmocc_{layout}"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                      bound_ms=bound, bound_by="bytes")
    return out


def device_stages(idx, reads, dev):
    """The device stages of the mem path on ``reads``: SMEM, SAL and
    chaining as ``run_se_batched`` runs them, then the BSW executor.
    Returns (the (c, i) queries of every SMEM round, copied, and every
    packed block the executor dispatches)."""
    opt = PipelineOptions(device=str(dev))
    lens = np.full(len(reads), reads.shape[1], np.int64)
    occ_fn = attach_occ_config(idx, dev).occ_fn
    rounds = []

    def recording_occ(fm, c, i):
        rounds.append((c.clone(), i.clone()))
        return occ_fn(fm, c, i)
    recording_occ.device = occ_fn.device
    mems = collect_smems_batch(idx, reads, lens, opt.mem,
                               occ_fn=recording_occ)
    seeds, _ = seeds_from_intervals(idx, mems, opt.mem.max_occ, device=dev)
    edges = contig_edges(idx)
    jobs = []
    for r in range(len(reads)):
        chains = filter_chains(chain_seeds(
            [(rb, qb, ln) for (rb, qb, ln, _) in seeds[r]], idx.n_ref,
            opt.chain, edges), opt.chain)
        jobs.extend(((r, ci), ch, reads[r], idx)
                    for ci, ch in enumerate(chains))
    blocks = []

    def record(queries, targets, h0s, p, ws=None, qmax=None, tmax=None):
        blocks.append(pack_tasks(queries, targets, h0s, p, ws, qmax, tmax))
        return bsw_extend_kernel(queries, targets, h0s, p, ws, qmax, tmax,
                                 device=dev)

    BatchedBSWExecutor(opt.bsw, batch_fn=record,
                       block=opt.bsw_block).plan_and_run(jobs)
    if len(blocks) < BSW_REAL_BLOCKS:
        raise AssertionError(f"only {len(blocks)} BSW blocks in the sample")
    return rounds, blocks


def related(rng, qlens, tlens):
    """Queries and targets that copy them with ~5% substitutions, so
    scores stay high and the band stays wide."""
    qs, ts = [], []
    for ql, tl in zip(qlens, tlens):
        q = rng.integers(0, 4, ql).astype(np.uint8)
        t = rng.integers(0, 4, tl).astype(np.uint8)
        k = min(ql, tl)
        t[:k] = np.where(rng.random(k) < 0.05, rng.integers(0, 4, k), q[:k])
        qs.append(q)
        ts.append(t)
    return qs, ts


def synthetic_bsw_blocks() -> dict:
    """Four 256-task blocks: band width 1; z-drop triggered (a 40-bp exact
    match, a 20-bp unrelated gap and a 100-bp exact match, with Z-drop 20,
    so the extension stops in the gap); query lengths on either side of
    strip edges (31-33, 63-65, 127-129, padded to qmax 160, h0 up to 200 so
    the first row's fill crosses strips); long queries (qlen 200-256 with
    a band as wide as the query, padded to qmax 256 and tmax 320).
    name -> (packed block, BSWParams)."""
    rng = np.random.default_rng(5)
    W = 256
    p = BSWParams()
    q1 = [rng.integers(0, 4, int(rng.integers(1, 101))).astype(np.uint8)
          for _ in range(W)]
    t1 = [rng.integers(0, 4, int(rng.integers(1, 121))).astype(np.uint8)
          for _ in range(W)]
    h1 = rng.integers(1, 60, W).tolist()
    q2, t2 = [], []
    for _ in range(W):
        head, tail = rng.integers(0, 4, 40), rng.integers(0, 4, 100)
        q2.append(np.concatenate([head, rng.integers(0, 4, 20), tail]
                                 ).astype(np.uint8))
        t2.append(np.concatenate([head, rng.integers(0, 4, 20), tail]
                                 ).astype(np.uint8))
    pz = BSWParams(zdrop=20)
    ql3 = [(31, 32, 33, 63, 64, 65, 127, 128, 129)[k % 9] for k in range(W)]
    q3, t3 = related(rng, ql3, [q + int(rng.integers(-5, 30)) for q in ql3])
    h3 = rng.integers(1, 200, W).tolist()
    w3 = [(100, 5, 160)[k % 3] for k in range(W)]
    ql4 = rng.integers(200, 257, W).tolist()
    q4, t4 = related(rng, ql4, [int(rng.integers(q, 321)) for q in ql4])
    h4 = rng.integers(5, 100, W).tolist()
    return {"w1": (pack_tasks(q1, t1, h1, p, [1] * W), p),
            "zdrop": (pack_tasks(q2, t2, [30] * W, pz), pz),
            "strip_edge": (pack_tasks(q3, t3, h3, p, w3, qmax=160), p),
            "long_query": (pack_tasks(q4, t4, h4, p, [256] * W, qmax=256,
                                      tmax=320), p)}


def repack(blocks: list) -> tuple:
    """The tasks of several packed blocks as one block, padded with code 4
    to the largest qmax and tmax."""
    qmax = max(b[0].shape[1] for b in blocks)
    tmax = max(b[1].shape[1] for b in blocks)
    pad = lambda a, n: np.pad(a, ((0, 0), (0, n - a.shape[1])),
                              constant_values=4)
    return (np.concatenate([pad(b[0], qmax) for b in blocks]),
            np.concatenate([pad(b[1], tmax) for b in blocks]),
            *(np.concatenate([b[k] for b in blocks]) for k in range(2, 6)))


def ptxas_resources(kernel: str) -> str:
    """The ptxas report (registers, spills, static shared memory) of the
    entry function whose name holds ``kernel``, from this run's build
    (none if the library was loaded as built by an earlier run)."""
    out, cur = [], None
    for ln in build.build_log.splitlines():
        if "Compiling entry function" in ln:
            cur = ln
        elif cur and kernel in cur and ("Used" in ln or "spill" in ln):
            out.append(ln.split(":", 1)[-1].strip())
    return " | ".join(out) or "not_built_in_this_run"


def check_bsw(blocks: dict, dev) -> dict:
    """``blocks``: name -> (packed block, BSWParams), each held exactly
    against the plain version; the first ``BSW_REAL_BLOCKS`` "real*"
    blocks are timed and bounded, one launch at a time and repacked into
    one launch."""
    out = {}
    dev_blocks = {k: ([torch.from_numpy(a).to(dev) for a in v], bp)
                  for k, (v, bp) in blocks.items()}
    err = 0
    for name, (args, bp) in dev_blocks.items():
        got = bsw_call(*args, bp)
        want = bsw_ref(*args, bp)
        err = max(err, int((got - want).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"bsw differs from its plain version on "
                                 f"block {name}")
    real_names = [k for k in dev_blocks if k.startswith("real")]
    phase("bsw_exact", real_blocks=len(real_names),
          real_tasks=sum(dev_blocks[k][0][0].shape[0] for k in real_names),
          synthetic=",".join(k for k in dev_blocks if k not in real_names),
          max_abs_err=err)
    timed = real_names[:BSW_REAL_BLOCKS]
    real = [dev_blocks[k][0] for k in timed]
    p = BSWParams()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    geo = {k: launch_geometry(a[0].shape[0], a[0].shape[1], sms)
           for k, (a, _) in dev_blocks.items()}
    phase("bsw_resources", ptxas=ptxas_resources("bsw_kernel").replace(
        " ", "_"), geometry_ctas_warps_smem=json.dumps(
        geo, separators=(",", ":")).replace(" ", ""))
    call = cuda_ms(lambda: [bsw_call(*a, p) for a in real]) / len(real)
    ms = kernel_ms(lambda: [bsw_call(*a, p) for a in real], "bsw_kernel",
                   len(real))
    plain = cuda_ms(lambda: [bsw_ref(*a, p) for a in real],
                    reps=5) / len(real)
    # the same tasks in one launch: exact, then timed
    one = [torch.from_numpy(a).to(dev)
           for a in repack([blocks[k][0] for k in timed])]
    if not torch.equal(bsw_call(*one, p),
                       torch.cat([bsw_call(*a, p) for a in real], dim=1)):
        raise AssertionError("bsw differs on the repacked real blocks")
    one_ms = kernel_ms(lambda: bsw_call(*one, p), "bsw_kernel", 1)
    phase("bsw_one_launch", tasks=one[0].shape[0], qmax=one[0].shape[1],
          tmax=one[1].shape[1],
          geometry=json.dumps(launch_geometry(*one[0].shape, sms),
                              separators=(",", ":")),
          kernel_ms=f"{one_ms:.4f}",
          four_launches_ms=f"{ms * len(real):.4f}")
    # the banded cells these blocks need, counted by the plain version
    reg = obs.MetricsRegistry()
    with obs.activate(reg):
        for a in real:
            bsw_ref(*a, p)
    snap = reg.snapshot()
    cells = int(snap.get("bsw_cells_banded", 0))
    rows = int(snap.get("bsw_task_rows", 0))
    nbytes = sum(t.numel() * 4 for a in real for t in a) + \
        sum(6 * a[0].shape[0] * 4 for a in real)
    ops_ms = 1e3 * cells * BSW_OPS_PER_CELL / INT32_OPS_PER_S / len(real)
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S / len(real)
    phase("bsw", blocks=",".join(timed), tasks_real=sum(
        a[0].shape[0] for a in real), cells_real=cells, task_rows_real=rows,
        cells_per_row=f"{cells / max(rows, 1):.1f}",
        tmax_real=",".join(str(a[1].shape[1]) for a in real), max_abs_err=err,
        kernel_ms_per_block=f"{ms:.4f}", call_ms_per_block=f"{call:.4f}",
        plain_ms_per_block=f"{plain:.4f}",
        bound_ms_per_block=f"{max(ops_ms, bytes_ms):.6f}")
    out["bsw"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                      bound_ms=max(ops_ms, bytes_ms),
                      bound_by="operations" if ops_ms >= bytes_ms
                      else "bytes")
    return out


# ---------------------------------------------------------------------
# phases 5 and 6: main path, card against CPU
# ---------------------------------------------------------------------

def sam_body(path) -> list[str]:
    with open(path) as f:
        return [ln.rstrip("\n") for ln in f if not ln.startswith("@")]


def check_records(body: list[str], names: list[str], truth) -> float:
    """One primary line per read; returns the truth-recovery share."""
    primary = {}
    for ln in body:
        f = ln.split("\t")
        if int(f[1]) & 0x900:
            continue
        if f[0] in primary:
            raise AssertionError(f"read {f[0]} has two primary lines")
        primary[f[0]] = f
    if sorted(primary) != sorted(names):
        raise AssertionError(f"{len(primary)} primary lines for "
                             f"{len(names)} reads")
    hits = 0
    for r, name in enumerate(names):
        f = primary[name]
        if not int(f[1]) & 0x4 and abs(int(f[3]) - 1 - int(truth["pos"][r])) <= 12:
            hits += 1
    return hits / len(names)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    t_start = time.perf_counter()

    # 1. environment
    nvcc_v = subprocess.run([build.nvcc(), "--version"], capture_output=True,
                            text=True, check=True).stdout.strip()
    phase("env", python=sys.version.split()[0], torch=torch.__version__,
          cuda=torch.version.cuda, nvcc=nvcc_v.splitlines()[-1].replace(" ", "_"),
          device=kind.replace(" ", "_"), count=torch.cuda.device_count(),
          capability=".".join(map(str, torch.cuda.get_device_capability(0))))
    card = smi("name,power.limit")
    print(card, flush=True)

    # 2. kernel build
    t0 = time.perf_counter()
    build.library()
    phase("build", seconds=f"{time.perf_counter() - t0:.2f}",
          library=build.library_path().name)
    for ln in build.build_log.splitlines():
        if "entry function" in ln or "registers" in ln or "spill" in ln:
            print("  ptxas:", ln.strip(), flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        # 3. index
        ref = make_reference(REF_LEN, seed=42)
        fa = tmp / "ref.fa"
        write_fasta(fa, [("chr", ref)])
        t0 = time.perf_counter()
        if cli.main(["index", str(fa)]) != 0:
            raise AssertionError("repro_torch.cli index failed")
        t_index = time.perf_counter() - t0
        idx = load_index(fa)
        fm = idx.device(dev)
        phase("index", ref_bp=REF_LEN, N=int(idx.N),
              host_build_s=f"{t_index:.2f}", device_bytes=fm.nbytes())

        # 4. kernels against their plain versions
        reads, truth = simulate_reads(ref, N_READS, READ_LEN, seed=7)
        cfg = attach_occ_config(idx, dev)       # the sweep, timed apart
        timings = sweep_timings(idx, dev)
        phase("sweep", picked=f"{cfg.layout}/{cfg.block}",
              ms_per_launch=json.dumps(
                  {f"{la}/{bl}": round(t, 5)
                   for (la, bl), t in timings.items()}))
        (rounds, sample), dev_us, wall = profiled(
            lambda: device_stages(idx, reads[:N_SAMPLE_READS], dev))
        top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:4]
        phase("device_share", stages="smem+sal+chain+bsw",
              reads=N_SAMPLE_READS,
              wall_s=f"{wall:.2f}",
              device_busy=f"{sum(dev_us.values()) / 1e6 / wall:.4f}",
              top=json.dumps({k[:40]: round(v / 1e3, 2) for k, v in top},
                             separators=(",", ":")))
        results = check_occ(idx, dev, rounds)
        del rounds
        blocks = {f"real{j}": (b, BSWParams())
                  for j, b in enumerate(sample)}
        blocks.update(synthetic_bsw_blocks())
        results.update(check_bsw(blocks, dev))

        # 5. main path through the CLI
        fq = tmp / "reads.fq"
        names = [f"read{r}" for r in range(N_READS)]
        write_fastq(fq, reads, names)
        sam, prof = tmp / "out.sam", tmp / "prof.json"
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        rc = cli.main(["mem", str(fa), str(fq), "-o", str(sam), "--device",
                       "cuda", "-b", str(N_READS), "--no-pg", "--profile",
                       str(prof)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        if rc != 0:
            raise AssertionError(f"repro_torch.cli mem exited {rc}")
        payload = obs.read_profile(prof)
        snap = payload["snapshot"]
        picked = snap["occ_kernel"]    # one batch: one "layout/block"
        if not isinstance(picked, str):
            raise AssertionError(f"mem ran {len(picked)} batches, not one")
        picked = picked.split("/")[0]
        for k in (f"fmocc_{picked}", "bsw"):
            if launches[k] <= 0:
                raise AssertionError(f"kernel {k} was not launched on the "
                                     f"main path")
        body = sam_body(sam)
        share = check_records(body, names, truth)
        bd = payload["breakdown"]
        stages = {r["stage"]: r["time_s"] for r in bd["stages"]
                  if r["time_s"]}
        phase("mem", reads=N_READS, wall_s=f"{wall:.2f}",
              reads_per_s=f"{N_READS / wall:.1f}", occ_kernel=picked,
              launches=json.dumps(launches, separators=(",", ":")),
              smem_rounds=int(snap["smem_rounds"]),
              smem_h2d_bytes=int(snap["smem_h2d_bytes"]),
              smem_d2h_bytes=int(snap["smem_d2h_bytes"]),
              truth_share=f"{share:.4f}")
        phase("breakdown", stages=json.dumps(stages, separators=(",", ":")),
              kernels=json.dumps(bd.get("kernels", {}),
                                 separators=(",", ":")),
              unattributed_s=bd["unattributed_s"])

        # 6. the card's SAM against the CPU path's for the first reads
        first = next(iter(open_batches(str(fq), batch_size=N_CPU_READS)))
        t0 = time.perf_counter()
        cpu = Aligner.from_bundle(fa, device="cpu").align(first).sam()
        keep = set(first.names)
        card_lines = [ln for ln in body if ln.split("\t", 1)[0] in keep]
        if cpu != card_lines:
            bad = next(j for j, (a, b) in enumerate(zip(cpu, card_lines))
                       if a != b) if len(cpu) == len(card_lines) else -1
            raise AssertionError(f"card and CPU SAM differ (first line {bad})")
        phase("cpu_vs_card", reads=len(first), lines=len(cpu),
              identical=True, cpu_s=f"{time.perf_counter() - t0:.1f}")

    report = []
    for name, (source, replaces) in KERNELS.items():
        r = results[name]
        report.append({"name": name, "route": "cuda", "source": source,
                       "replaces": replaces, "launches": launches[name],
                       "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                       "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                       "bound_by": r["bound_by"], "library_ms": None})
    phase("done", total_s=f"{time.perf_counter() - t_start:.1f}")
    print(card, flush=True)
    print(json.dumps({"kernels": report}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
