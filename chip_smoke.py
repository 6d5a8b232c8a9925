#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Drives single-end and paired-end ``mem``, sharded ``mem``, ``memdist``,
the alignment server, the LM serving path and LM training on the card
through the port's own entry points and checks every hand-written kernel against its
plain PyTorch version.
Phases (each prints one line, any failure raises and exits non-zero):

1. environment: Python, torch, CUDA and nvcc versions; the card's name and
   power limit as ``nvidia-smi`` reports them;
2. kernel build: ``nvcc`` of ``src/repro_torch/kernels/csrc/*.cu``, timed,
   with the ptxas register report;
3. index: a 4,641,652-bp reference (the length of E. coli K-12 MG1655,
   synthesized with ``make_reference(4_641_652, seed=42)``) written as
   FASTA and indexed by ``repro_torch.cli index``;
4. kernels against their plain versions on the card, exactly, under
   every (layout, threads per block) candidate of the occ sweep: the
   fused SMEM round kernel in both layouts and both directions on 2^17
   synthetic entries plus edge entries (k-1 and k+s-1 at -1, 0, N-2, N-1,
   every bucket edge +-1 around ``primary``; s = 0; c in 0..4) and on the
   compacted entries of every SMEM round of the device stages run on 512
   reads; BSW on every block of real extension tasks those reads
   dispatch and on synthetic blocks: band width 1, z-drop triggered,
   query lengths on strip edges (31-33, 63-65, 127-129 at qmax 160) and
   long queries (qmax 256, tmax 320).  Times side by side: each kernel's
   device time (torch.profiler, mean of 20 calls; the round kernel warm,
   as the main path finds the index in L2, and cold, with L2 flushed
   between launches by writing a 256-MB buffer (on the synthetic entries
   also by reading it), on the synthetic entries and on the largest and
   the median real round; BSW on the first 4 real blocks, and on their tasks
   repacked into one launch), its wrapper call and its plain version
   (CUDA events, median of 20); each kernel's registers (ptxas) and the
   BSW kernel's shared memory; the sweep's device time per launch of each
   candidate; and the card's busy share while the device stages (SMEM,
   SAL, chaining, BSW) run on the 512 reads under the profiler.  Then
   ``bsw_rescue_exact``: every BSW block of PE mate rescue on 256 simulated
   pairs (insert N(300, 30), 15% of the mates rescue-only), held exactly
   against the plain version and timed beside its bound.  Then
   ``galign_exact``: finalize's banded global alignment kernel on every
   region that finalize emits for the 512 reads (one launch, as the main
   path makes it), for both ends of the 256 pairs and for their rescued
   mates, and on synthetic sets (the edge cases n == 0, m == 0,
   |n - m| > w and all N; w at 1; paths off the band; long reads at
   qmax 256; long tasks on a narrow band, n 400-1,000; tasks past a
   warp's shared-memory slot, n 3,300-3,800; bands of 1,024 columns or
   more; the three paths mixed in one call), held exactly (score and
   CIGAR) against the plain version and on 32 tasks of each set against
   the host ``global_align_cigar``, with the tasks each path of the
   kernel took (shared / global decisions / wide); then on the 512
   reads' launch and on the long reads' its device time (torch.profiler,
   mean of 20), the wrapper's call (one host read of the lengths), the
   pipeline's launch on a host plan, the plain version's time, the bound,
   the columns a lane (k), a CTA's shared memory, the resident CTAs a SM
   and the tasks on each path; and every galign kernel's registers and
   spill bytes (ptxas).  Then ``diagseed_exact``: mate rescue's
   anchor-search kernel on every candidate window the rescue sample's plan
   scans and on synthetic sets (a chunk's 616 windows of 785 bases, ties
   across and within diagonals, N in mates and reference, a window wider
   than a CTA's shared memory), held exactly against the plain version and
   on 64 candidates of each set against the host ``best_diag_seed``; on
   the chunk-sized set and the real one the kernel's device time, the
   pipeline's launch, its whole entry (gather, pack, copy, readback), the
   host's numpy scan, the plain version and the bytes bound;
5. main path: 2,048 simulated 101-bp reads through ``repro_torch.cli mem
   --device cuda -b 2048`` (one batch) with every kernel launch counter
   set to 0 just before and read just after, and the earlier phases'
   cyclic garbage collected before (``gc_s``, ``gc_full``: the
   collector's seconds and full collections inside the run, here and in
   phase 7); one primary SAM line per read, reads/s, the stage
   breakdown, finalize's split (the galign call, the decision replay,
   the CIGARs' application, the SAM lines' formatting), SMEM rounds and
   the truth-recovery share;
6. card against CPU: the first 256 reads through ``Aligner(device="cpu")``
   give SAM body lines byte-identical to the card's;
7. paired-end main path: 1,024 simulated pairs (2,048 reads) through
   ``repro_torch.cli mem --device cuda -b 1024 ref r1.fq r2.fq`` (one
   batch) with the launch counters set to 0 just before and read just
   after, the rescue's launches read apart; pairs/s, the proper-pair
   share, rescued mates, FR's insert-size estimate, truth recovery per
   end, the stage breakdown, finalize's split and rescue cells
   useful/total;
8. PE card against CPU: the first 128 pairs, as one batch, through
   ``Aligner.align_pairs`` on the card and on the CPU give identical SAM;
9. sharded mem: what the live exporter cost phase 5; then the first 256
   reads of phase 5 through ``repro_torch.cli mem --shard i/2`` for
   i = 0, 1, each with ``--profile``, ``--runlog``, ``--live`` and
   ``--trace``: the two bodies interleaved by read ordinal are phase 5's
   lines of those reads, ``report --merge`` counts every read once, each
   run log runs from ``run_start`` to ``run_end`` status ok, the live files
   parse and each trace holds ``kernel.fmocc`` and ``kernel.bsw`` spans;
10. memdist: 384 reads through ``repro_torch.cli memdist --device cuda
   -K 9696 -n 3`` (4 chunks, shards of 2/1/1) with shard 0 killed before
   its second chunk (``REPRO_FT_INJECT=0:1``): one retry that resumes from
   the checkpoint, and SAM byte-identical to ``mem -K 9696``;
11. memdist on pairs: the first 128 pairs of phase 7 through ``memdist
   -K 12928 -n 2 --pe-bootstrap`` (2 chunks), byte-identical to ``mem -K
   12928 --pe-bootstrap``;
12. serve: an in-process ``repro_torch.serve.AlignmentServer`` on the card
   over phase 3's index (``max_batch_reads=512``, insert-size stats frozen
   from phase 4's rescue sample).  Paused, it queues 8 concurrent TCP
   clients of 16 reads each (phase 5's first 128 reads, one request with
   the header); resumed, it must run them as ONE batch of width 8, and
   each response must be phase 5's lines of its reads.  Then 4 clients of
   8 pairs (phase 7's first 32 pairs) run as one batch of width 4, each
   response equal to an offline ``Aligner(pe_stats=...).align_pairs`` of
   the 32 pairs on the card.  Any error frame or ``crash`` event fails
   the phase; it prints each batch's wall and pad share and the requests'
   waits from the run log;
13. LM serve: Qwen1.5-0.5B at full width in bf16 (24 layers, d_model
   1024, vocab 151,936), its params drawn on the card from
   ``torch.Generator("cuda").manual_seed(0)``, serves the 8 prompts of
   ``repro_torch.launch.serve``'s main (seed 0, 4-39 tokens) with
   ``max_new`` 16 through ``serve_batch``, twice: every output 16 ids in
   [0, vocab), both runs the same tokens.  It prints the parameter count
   and GB, the init time, each run's wall, the decode steps, generated
   tokens/s, the lane efficiency and ``max_memory_allocated``, then, over
   8 more decode steps under torch.profiler, the card's busy share and
   the host-to-device copies and stream synchronisations a step; it
   asserts that TF32 matmuls are off;
14. LM exact, float32: (a) Qwen1.5-0.5B at full width, teacher-forced
   ``decode_step`` over B=2, S=64 against ``forward`` with 32-row blocks
   (one block fully masked), max |diff| <= 1e-3; the same params copied
   to the CPU and ``serve_batch`` of the first 2 prompts (``max_new`` 8)
   on both devices: the tokens agree at every step whose CPU top-2 margin
   is > 1e-3 (a step under it is printed, not failed) and every step's
   logits within 1e-3; (b) every arch at its smoke config: ``forward``,
   ``loss_fn`` and 16 decode steps on the card against the CPU within
   1e-4, and decode against forward on the card for the 5 archs of
   ``tests/test_models.py``'s test; (c) mamba2-130m at full width, B=1,
   S=256 (two SSD chunks): decode against forward within 1e-3.  It prints
   each check's max error by arch.
15. LM train: Qwen1.5-0.5B at full width in bf16 trained 8 steps by
   ``launch.train.train`` at ``launch/train.py``'s CLI shape (B=8,
   S=128, blocks of 128), one checkpoint (6.2 GB) written at the end:
   every loss finite; the first step's seconds, the warm ms a step,
   tokens/s, ``max_memory_allocated``, the save seconds (the last
   step's end to ``train``'s return) and the restore seconds of that
   checkpoint, restored onto the card equal to the trained state bit for
   bit; then 2 more steps under torch.profiler (device ms a step, busy
   share, the largest device items).  The smoke config then trains 8
   steps, resumes from that checkpoint to step 10, and its losses at
   steps 8-9 equal those of one uninterrupted 10-step run bit for bit;
16. LM train exact, float32, TF32 off: one ``make_train_step`` of
   Qwen1.5-0.5B at full width (B=1, S=64) on the card and on the CPU
   from the same params, and 3 steps of every smoke arch at S=128 (one
   full SSD chunk; ``AdamWConfig(lr=1e-3, warmup_steps=1)``): the losses
   within 1e-4 of (1 + |loss|), each gradient leaf (read from step 1's
   first moment) within 1e-3 of its max, every one finite, and the
   params at most 2 x lr x steps apart with at most 1e-4 of the elements
   more than 1e-5 apart.
17. dry run: ``repro_torch.launch.dryrun --smoke`` (5 smoke cells on a
   2x2 placeholder mesh) and the qwen1.5-0.5b, dbrx-132b and
   llama4-scout-17b-a16e ``train_4k`` cells on 16x16, four subprocesses,
   fake tensors on the card: eight cells' per-chip flops equal hand
   counts to the digit (dbrx attends with each rank's 3 of its 48
   heads, llama4-scout with rank 0's 3 of its 40), and the MoE smoke
   cell moves its tokens by all-to-all;
18. a sharded step: 3 bf16 train steps of phase 15's shape on a 1x1
   cuda mesh over NCCL, bit-identical to the unsharded steps;
19. baseline: the original BWA-MEM organisation (``AlignOptions(engine=
   "baseline")``: read by read, the scalar oracles on the host) on phase
   5's first 128 reads gives phase 5's lines, and on phase 7's first 32
   pairs (stats frozen from phase 4's rescue sample) the ``cuda``
   engine's SAM on the card, with no kernel launched; it prints each
   stage's seconds a read beside phase 5's and their ratio (the paper's
   per-stage speedups), and the compressed SA's LF walk
   (``sal_compressed``, both occ layouts) on the card against
   ``sal_direct`` on the SA rows of phase 5's SMEM (CUDA events, median
   of 20), values equal.
Phases 5, 7 and 9-12 each set the launch counters to 0 just before their
run and read them just after, and fail if a kernel of the path was not
launched (galign in every one, the rescued mates' in phase 7, and one
diagseed launch for phase 7's one batch); phase
19 fails if its engine launched any.  The LM path reaches none of the
five kernels: phases 13-16
set the counters to 0 before they start and fail if any kernel was
launched by the end of any of them.

The line before the last is one JSON object with every kernel's launches
(from phases 4-12; the LM phases launch none), error, times and bound;
the last line is ``{"ok": true, "device": ...}``.
Without a CUDA device it exits 1 and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import gc
import io
import json
import os
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import cli, kernels, obs  # noqa: E402
from repro_torch.configs import (ARCHS, SHAPES, get_arch,  # noqa: E402
                                 smoke_config)
from repro_torch.launch.serve import serve_batch  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.launch.train import synthetic_batch, train  # noqa: E402
from repro_torch.ft import CheckpointManager  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.dist.api import active_mesh  # noqa: E402
from repro_torch.dist.sharding import (P, Sharding,  # noqa: E402
                                       distribute, make_batch_specs,
                                       make_param_specs, moment_specs,
                                       rules_for)
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.api import Aligner  # noqa: E402
from repro_torch.core.bsw import BSWParams, pack_tasks  # noqa: E402
from repro_torch.core.chain import chain_seeds, filter_chains  # noqa: E402
from repro_torch.core.contig import contig_edges  # noqa: E402
from repro_torch import pe  # noqa: E402
from repro_torch.core.pipeline import (BatchedBSWExecutor,  # noqa: E402
                                       PipelineOptions, run_se_batched)
from repro_torch.core.sam import global_align_cigar  # noqa: E402
from repro_torch.core import sal as sal_mod  # noqa: E402
from repro_torch.core.sal import (sal_compressed, sal_direct,  # noqa: E402
                                  seeds_from_intervals)
from repro_torch.core import smem as smem_mod  # noqa: E402
from repro_torch.core.smem import collect_smems_batch  # noqa: E402
from repro_torch.data import (decode, make_reference,  # noqa: E402
                              simulate_pairs, simulate_reads, write_fasta,
                              write_fastq, write_fastq_pair)
from repro_torch.io.store import load_index  # noqa: E402
from repro_torch.io.stream import _pack_pe, open_batches  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import bsw as bsw_pkg  # noqa: E402
from repro_torch.kernels.bsw.ops import (bsw_call,  # noqa: E402
                                          launch_geometry)
from repro_torch.kernels.bsw.ref import bsw_ref  # noqa: E402
from repro_torch.kernels.engine import (SWEEP_CANDIDATES,  # noqa: E402
                                        SWEEP_LAUNCHES, SWEEP_REPS,
                                        attach_occ_config, sweep_entries,
                                        sweep_timings)
from repro_torch.kernels.fmocc.ops import (DIRECTIONS, LAYOUTS,  # noqa: E402
                                           ext_round)
from repro_torch.kernels.fmocc.ref import ext_round_ref  # noqa: E402
from repro_torch.kernels.diagseed import ops as diagseed_ops  # noqa: E402
from repro_torch.kernels.diagseed.ops import diagseed_call  # noqa: E402
from repro_torch.kernels.diagseed.ref import diagseed_ref  # noqa: E402
from repro_torch.kernels import galign as galign_pkg  # noqa: E402
from repro_torch.kernels.galign import ops as galign_ops  # noqa: E402
from repro_torch.kernels.galign.ops import galign_call  # noqa: E402
from repro_torch.kernels.galign.ref import galign_ref  # noqa: E402
from repro_torch.options import AlignOptions  # noqa: E402
from repro_torch.serve import AlignmentServer, ServeClient  # noqa: E402

REF_LEN = 4_641_652        # E. coli K-12 MG1655 (NC_000913.3)
N_READS = 2048             # one batch, ~1/50 of bwa's 10-Mbase -K chunk
READ_LEN = 101
N_SAMPLE_READS = 512
N_CPU_READS = 256
N_PAIRS = 1024             # the PE phase: 2,048 reads, the SE phase's width
N_RESCUE_PAIRS = 256
N_CPU_PAIRS = 128
N_SHARD_READS = 256        # phase 9: the first reads of phase 5, 2 shards
N_MEMDIST_READS = 384      # phase 10
MEMDIST_K = 96 * READ_LEN  # 9,696 bases: 4 chunks of 96 reads
N_MEMDIST_PAIRS = 128      # phase 11: the first pairs of phase 7
MEMDIST_PE_K = 64 * 2 * READ_LEN   # 12,928 bases: 2 chunks of 64 pairs
N_BASELINE_READS = 128     # phase 19: the first reads of phase 5
N_BASELINE_PAIRS = 32      # and the first pairs of phase 7
BASELINE_STAGES = ("smem", "sal", "chain", "bsw", "finalize")
N_SERVE_CLIENTS = 8        # phase 12: 8 clients x 16 reads = 128 reads
N_SERVE_READS = 16
N_SERVE_PE_CLIENTS = 4     # then 4 clients x 8 pairs = 32 pairs
N_SERVE_PAIRS = 8
SERVE_BATCH_READS = 512
PAIR_SIM = dict(insert_mean=300, insert_std=30, burst_frac=0.15)
LM_ARCH = "qwen1.5-0.5b"   # phases 13-14: launch/serve.py's default arch
LM_PROMPTS = 8             # launch/serve.py's main: 8 prompts of 4-39 tokens
LM_MAX_NEW = 16
LM_PROFILED_STEPS = 8      # decode steps under the profiler (phase 13)
LM_EXACT_B, LM_EXACT_S, LM_EXACT_BLOCK = 2, 64, 32   # 2x2 flash blocks
LM_CPU_PROMPTS, LM_CPU_MAX_NEW = 2, 8
LM_TOL = 1e-3              # float32 at full width: logits, max |diff|
LM_SMOKE_TOL = 1e-4        # float32 at the smoke configs
LM_MARGIN = 1e-3           # a CPU top-2 margin under this may flip a token
LM_SMOKE_B, LM_SMOKE_S, LM_SMOKE_BLOCK = 2, 16, 8
#: the archs of tests/test_models.py's decode-against-forward test (the
#: MoE archs drop other tokens at a decode step's capacity)
LM_DECODE_ARCHS = ("qwen1.5-0.5b", "internlm2-1.8b", "mamba2-130m",
                   "zamba2-7b", "musicgen-large")
LM_SSM_ARCH, LM_SSM_S = "mamba2-130m", 256           # two SSD chunks of 128
# phase 15: launch/train.py's CLI shape, 8 steps, one checkpoint at the end
LM_TRAIN_STEPS, LM_TRAIN_B, LM_TRAIN_S, LM_TRAIN_BLOCK = 8, 8, 128, 128
LM_RESUME_STEPS = 10       # the smoke config resumed at step 8 of 10
LM_TRAIN_PROFILED_STEPS = 2
# phase 16, float32 card against CPU: one step at full width (B=1, S=64)
# and 3 steps of every smoke arch at S=128, where the reference's SSD
# gradients are not finite
LM_GRAD_B, LM_GRAD_S = 1, 64
LM_GRAD_SMOKE_B, LM_GRAD_SMOKE_S, LM_GRAD_SMOKE_STEPS = 2, 128, 3
LM_GRAD_SMOKE_OPT = AdamWConfig(lr=1e-3, warmup_steps=1)
LM_LOSS_TOL = 1e-4         # |loss diff| / (1 + |loss|)
LM_GRAD_TOL = 1e-3         # max |grad diff| over the leaf's max |grad|
LM_PARAM_CLOSE = 1e-5      # updated params: all but a share within this
LM_PARAM_SHARE = 1e-4      # the share of elements allowed over it
# phase 17: the dry run's smoke sweep and two production cells, a dense
# one and a MoE one, each in a process of its own (the placeholder world
# stays out of this one); the production cells' attention in
# whole-sequence blocks (the counts are those of 512-row blocks: PERF.md)
DRYRUN_CELL = ("qwen1.5-0.5b", "train_4k")
DRYRUN_MOE_CELL = ("dbrx-132b", "train_4k")
#: llama4-scout's 40 query heads do not divide the 16-wide model axis
DRYRUN_UNEVEN_CELL = ("llama4-scout-17b-a16e", "train_4k")
DRYRUN_Q_BLOCK = 4096
DRYRUN_TIMEOUT_S = 240
#: the production cell's peak of live local bytes a chip (in the loss:
#: five float32 logit shards, the layers' saved inputs, the arguments)
DRYRUN_PEAK_BYTES = 16_589_204_492
# phase 18: phase 15's shape on a 1x1 mesh over an NCCL group of one
LM_MESH_STEPS = 3
EXT_ENTRIES = 1 << 17     # synthetic round entries, before the edge entries
#: written between two launches of a cold timing: more than twice the L2
L2_FLUSH_BYTES = 256 << 20
BSW_REAL_BLOCKS = 4
TIMING_REPS = 20
PROFILER_ATTEMPTS = 3

# Peak rates of one H100 SXM (NVIDIA's data sheet, at 700 W).  The
# int32 rate is not in the table of peaks: an SM issues 64 int32 lanes a
# clock (half its 128 float32 lanes), and the BSW cell has no multiply-
# add to count twice, so 64 lanes x 132 SMs x 1.98 GHz.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12  # dense bf16 on the tensor cores
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# int32 ALU operations per banded DP cell of ksw_extend2, the spec
# (core/bsw.py:bsw_extend's inner loop; loads, stores, loop control and
# address arithmetic not counted): score 4, M 3, h 2, row max 3, E 4, F 4.
# The work is the spec's whatever implements it: the warp kernel's scan
# and ballots are not added.
BSW_OPS_PER_CELL = 20
# int32 ALU operations per banded DP cell of global_align_cigar, the spec
# (core/sam.py's inner loop, counted as BSW_OPS_PER_CELL is): E 3, F 3,
# the diagonal with its score 3, H 2.  The traceback's decisions and
# walk are not added.
GALIGN_OPS_PER_CELL = 11
#: tasks of each galign set also held against the host global_align_cigar
GALIGN_HOST_SAMPLE = 32
#: candidates of each diagseed set also held against best_diag_seed
DIAGSEED_HOST_SAMPLE = 64
#: mate rescue's anchor seed length (pe.PEOptions.rescue_min_seed)
DIAGSEED_MIN = 10
SECTOR = 32                # DRAM access granularity in bytes

KERNELS = {
    "fmocc_ext_eta32": ("src/repro_torch/kernels/csrc/fmocc.cu",
                        "src/repro/kernels/fmocc/kernel.py:86"),
    "fmocc_ext_eta128": ("src/repro_torch/kernels/csrc/fmocc.cu",
                         "src/repro/kernels/fmocc/kernel.py:96"),
    "bsw": ("src/repro_torch/kernels/csrc/bsw.cu",
            "src/repro/kernels/bsw/kernel.py:61"),
    # host code in both packages; no Pallas counterpart
    "galign": ("src/repro_torch/kernels/csrc/galign.cu",
               "src/repro/core/sam.py:18"),
    # host code in both packages; no Pallas counterpart
    "diagseed": ("src/repro_torch/kernels/csrc/diagseed.cu",
                 "src/repro/pe/rescue.py:49"),
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


@contextlib.contextmanager
def collector_time():
    """Collect the cyclic garbage of earlier phases first (a ``mem`` run
    starts in a process without it), then add up the garbage collector's
    pauses inside the block: ``{"gc_s": seconds, "gc_full": full
    collections}``, filled in on exit."""
    gc.collect()
    out, start = {"gc_s": 0.0, "gc_full": 0}, [0.0]

    def hook(phase_, info):
        if phase_ == "start":
            start[0] = time.perf_counter()
        else:
            out["gc_s"] += time.perf_counter() - start[0]
            out["gc_full"] += info["generation"] == 2
    gc.callbacks.append(hook)
    try:
        yield out
    finally:
        gc.callbacks.remove(hook)


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


# ---------------------------------------------------------------------
# phase 4: kernels against their plain versions
# ---------------------------------------------------------------------

def edge_entries(N: int, primary: int) -> np.ndarray:
    """(4, m) int32 (k, l, s, c) entries whose positions k-1 or k+s-1 sit
    at i = -1, 0, N-2, N-1, primary +-1 and every bucket edge +-1 of both
    layouts around ``primary``: for each such i and each c in 0..4, k-1 =
    i with s = 0 and s = 3, and k+s-1 = i; l = k, so both directions read
    inside the index."""
    edge = {-1, 0, N - 2, N - 1, primary - 1, primary, primary + 1}
    for eta in (32, 128):
        for b in range(primary // eta - 1, primary // eta + 3):
            edge.update((b * eta - 2, b * eta - 1, b * eta))
    cols = []
    for i in sorted(i for i in edge if -1 <= i <= N - 1):
        for k, s in ((i + 1, 0), (i + 1, min(3, N - i - 1)),
                     (i + 1 - min(5, i + 1), min(5, i + 1))):
            cols.extend((k, k, s, c) for c in range(5))
    return np.asarray(cols, np.int32).T


def ext_bound_ms(st: torch.Tensor, which: str, layout: str) -> float:
    """Least time for one round on the (4, n) entries ``st``: k, l, s, c
    read and k', l', s' written once (28 B an entry) plus every distinct
    32-B sector of the count table and every distinct bucket row that the
    entries' two positions touch, over the HBM rate."""
    shift = 5 if layout == "eta32" else 7
    k = st[0] if which == "bwd" else st[1]
    b = torch.cat([k, k + st[2]]) >> shift
    count_sectors = torch.unique(b >> 1).numel()   # 16 B of counts a bucket
    rows = torch.unique(b).numel()                 # one 32-B row a bucket
    nbytes = 28 * st.shape[1] + SECTOR * (count_sectors + rows)
    return 1e3 * nbytes / HBM_BYTES_PER_S


def check_ext(idx, dev, rounds: list) -> dict:
    """The round kernel against its plain version, exactly, in both
    layouts and both directions under every sweep candidate, on the
    synthetic and edge entries and on ``rounds`` (the (4, n) entries of
    real SMEM rounds); then timed and bounded per layout on the synthetic
    entries and on the largest and the median real round."""
    fm = idx.device(dev)
    N, prim = int(idx.N), int(idx.primary)
    syn = torch.from_numpy(np.concatenate(
        [sweep_entries(N, EXT_ENTRIES, 1), edge_entries(N, prim)],
        axis=1)).to(dev)
    inputs = [("synthetic", syn)] + [(f"round{r}", st)
                                     for r, (_, st) in enumerate(rounds)]
    errs = {}
    for layout in LAYOUTS:
        blocks = [b for la, b in SWEEP_CANDIDATES if la == layout]
        for which in DIRECTIONS:
            for tag, st in inputs:
                want = ext_round_ref(fm, which, *st, layout=layout)
                for block in blocks:
                    got = ext_round(fm, which, *st, layout=layout,
                                    block=block)
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"fmocc_ext_{layout} {which} (block {block}) "
                            f"differs from its plain version on {tag} at "
                            f"{int((got != want).any(0).sum())} of "
                            f"{st.shape[1]} entries")
                    errs[layout] = max(errs.get(layout, 0),
                                       int((got - want).abs().max()))
    sizes = sorted(st.shape[1] for _, st in rounds)
    phase("ext_exact", candidates=len(SWEEP_CANDIDATES), directions=2,
          synthetic_entries=syn.shape[1], real_rounds=len(rounds),
          real_entries=sum(sizes), real_entries_min=sizes[0],
          real_entries_median=sizes[len(sizes) // 2],
          real_entries_max=sizes[-1], max_abs_err=json.dumps(errs))
    by_size = sorted(rounds, key=lambda r: r[1].shape[1])
    real = {"largest": by_size[-1], "median": by_size[len(by_size) // 2]}
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    out = {}
    for layout in LAYOUTS:
        name = f"fmocc_ext_{layout}"

        def run(st, which="bwd"):
            return ext_round(fm, which, *st, layout=layout)

        def cold(st, which="bwd"):
            flush.fill_(1)
            return run(st, which)

        def cold_read(st, which="bwd"):
            # L2 refilled with clean lines: no write-back of the flush's
            # dirty lines competes with the kernel's misses
            flush.sum()
            return run(st, which)
        ms = kernel_ms(lambda: run(syn), "ext_round_kernel", 1)
        cold_ms = kernel_ms(lambda: cold(syn), "ext_round_kernel", 1)
        cold_read_ms = kernel_ms(lambda: cold_read(syn), "ext_round_kernel",
                                 1)
        call = cuda_ms(lambda: run(syn))
        plain = cuda_ms(lambda: ext_round_ref(fm, "bwd", *syn, layout=layout))
        bound = ext_bound_ms(syn, "bwd", layout)
        phase("ext", layout=layout, entries=syn.shape[1], direction="bwd",
              max_abs_err=errs[layout], kernel_ms=f"{ms:.4f}",
              cold_kernel_ms=f"{cold_ms:.4f}",
              cold_read_kernel_ms=f"{cold_read_ms:.4f}", call_ms=f"{call:.4f}",
              plain_ms=f"{plain:.4f}", bound_ms=f"{bound:.6f}",
              cold_share_of_bound=f"{bound / cold_ms:.3f}",
              warm=("L2-resident_below_the_HBM_bound" if ms < bound
                    else f"{bound / ms:.3f}_of_bound"),
              ptxas=ptxas_resources("ext_round_kernel",
                                    layout.capitalize()).replace(" ", "_"))
        for tag, (which, st) in real.items():
            warm = kernel_ms(lambda: run(st, which), "ext_round_kernel", 1)
            flushed = kernel_ms(lambda: cold(st, which), "ext_round_kernel",
                                1)
            phase("ext_real", layout=layout, round=tag, direction=which,
                  entries=st.shape[1], kernel_ms=f"{warm:.4f}",
                  cold_kernel_ms=f"{flushed:.4f}",
                  call_ms=f"{cuda_ms(lambda: run(st, which)):.4f}",
                  bound_ms=f"{ext_bound_ms(st, which, layout):.6f}")
        out[name] = dict(max_abs_err=errs[layout], ms=ms, cold_ms=cold_ms,
                         plain_ms=plain, bound_ms=bound, bound_by="bytes")
    del flush
    return out


def device_stages(idx, reads, dev):
    """The device stages of the mem path on ``reads``: SMEM, SAL and
    chaining as ``run_se_batched`` runs them, then the BSW executor.
    Returns (the direction and the compacted (k, l, s, c) entries of
    every SMEM round, as ``ext_round`` got them, and every packed block
    the executor dispatches)."""
    opt = PipelineOptions(device=str(dev))
    lens = np.full(len(reads), reads.shape[1], np.int64)
    occ = attach_occ_config(idx, dev)
    rounds = []

    def recording(fm, which, k, l, s, c, **kw):
        # references, not copies: a round's entries are a tensor of their
        # own that nothing writes after the launch, and a copy here would
        # add device work to the profiled stages
        rounds.append((which, (k, l, s, c)))
        return ext_round(fm, which, k, l, s, c, **kw)
    smem_mod.ext_round = recording
    try:
        mems = collect_smems_batch(idx, reads, lens, opt.mem, occ=occ)
    finally:
        smem_mod.ext_round = ext_round
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
    with recording_bsw(blocks):
        BatchedBSWExecutor(opt.bsw, device=dev,
                           block=opt.bsw_block).plan_and_run(jobs)
    if len(blocks) < BSW_REAL_BLOCKS:
        raise AssertionError(f"only {len(blocks)} BSW blocks in the sample")
    return rounds, blocks


@contextlib.contextmanager
def recording_bsw(blocks: list):
    """Every call of the bsw entry that the BSW executor looks up: each
    block's packed arrays appended to ``blocks`` before it launches the
    kernel."""
    real = bsw_pkg.bsw_extend_kernel

    def record(queries, targets, h0s, p, ws=None, qmax=None, tmax=None, *,
               device):
        blocks.append(pack_tasks(queries, targets, h0s, p, ws, qmax, tmax))
        return real(queries, targets, h0s, p, ws, qmax, tmax, device=device)
    bsw_pkg.bsw_extend_kernel = record
    try:
        yield blocks
    finally:
        bsw_pkg.bsw_extend_kernel = real


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


def ptxas_resources(*names: str) -> str:
    """The ptxas report (registers, spills, static shared memory) of the
    entry function whose mangled name holds every one of ``names``, from
    this run's build (none if the library was loaded as built by an
    earlier run)."""
    out, cur = [], None
    for ln in build.build_log.splitlines():
        if "Compiling entry function" in ln:
            cur = ln
        elif cur and all(n in cur for n in names) and (
                "Used" in ln or "spill" in ln):
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
    cells, rows = bsw_cells(real, p)
    bound, by = bsw_bound_ms(real, cells)
    phase("bsw", blocks=",".join(timed), tasks_real=sum(
        a[0].shape[0] for a in real), cells_real=cells, task_rows_real=rows,
        cells_per_row=f"{cells / max(rows, 1):.1f}",
        tmax_real=",".join(str(a[1].shape[1]) for a in real), max_abs_err=err,
        kernel_ms_per_block=f"{ms:.4f}", call_ms_per_block=f"{call:.4f}",
        plain_ms_per_block=f"{plain:.4f}", bound_ms_per_block=f"{bound:.6f}")
    out["bsw"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                      bound_by=by)
    return out


def bsw_cells(blocks: list, p: BSWParams) -> tuple[int, int]:
    """(banded DP cells, task rows) of ``blocks`` (each the six packed
    arrays of one launch), counted by the plain version."""
    reg = obs.MetricsRegistry()
    with obs.activate(reg):
        for a in blocks:
            bsw_ref(*a, p)
    snap = reg.snapshot()
    return int(snap.get("bsw_cells_banded", 0)), int(snap.get("bsw_task_rows",
                                                              0))


def bsw_bound_ms(blocks: list, cells: int) -> tuple[float, str]:
    """Least time a block for ``blocks`` and what bounds it: their
    ``cells`` banded cells x ``BSW_OPS_PER_CELL`` over the int32 rate, or
    every input read and the (6, W) output written once over the HBM
    rate."""
    nbytes = sum(t.numel() * 4 for a in blocks for t in a) + \
        sum(6 * a[0].shape[0] * 4 for a in blocks)
    ops_ms = 1e3 * cells * BSW_OPS_PER_CELL / INT32_OPS_PER_S / len(blocks)
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S / len(blocks)
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes")


def rescue_blocks(idx, reads1, reads2, dev):
    """The PE path's mate rescue on (reads1, reads2): both ends through
    ``run_se_batched`` on ``dev``, the insert-size estimate, the rescue
    plan with the batched ``seed_fn`` (its candidates recorded before it
    launches the kernel), ``run_rescues_batched`` with every packed block
    recorded before it launches the kernel, and ``merge_rescues``.
    Returns (the blocks, the rescue's stats, the PairStat[4], the galign
    tasks of both ends' finalize and of the rescued mates', the seed_fn's
    candidates)."""
    opt = PipelineOptions(device=str(dev))
    n = len(reads1)
    calls, seed_calls = [], []
    with recording_galign(calls):
        res, _ = run_se_batched(idx, np.concatenate([reads1, reads2]), opt,
                                occ=attach_occ_config(idx, dev))
    peopt = pe.PEOptions()
    pes = pe.estimate_pestat(res[:n], res[n:], idx, max_ins=peopt.max_ins)
    seed_fn = functools.partial(diagseed_ops.diag_seed_batch,
                                device=opt.device)

    def record_seeds(queries, S, wlos, whis, min_len):
        seed_calls.append((list(queries), list(wlos), list(whis), min_len))
        return seed_fn(queries, S, wlos, whis, min_len)
    tasks = pe.plan_rescues((res[:n], res[n:]), (reads1, reads2), pes, idx,
                            peopt, seed_fn=record_seeds)
    if len(seed_calls) != 1:
        raise AssertionError(f"the rescue plan made {len(seed_calls)} "
                             f"seed_fn calls, not one")
    blocks = []
    with recording_bsw(blocks):
        outs, stats = pe.run_rescues_batched(tasks, idx, opt.bsw, device=dev,
                                             block=opt.bsw_block)
    with recording_galign(calls):
        pe.merge_rescues((res[:n], res[n:]), tasks, outs, idx, opt.bsw,
                         opt.mem.min_seed_len, peopt,
                         align=functools.partial(
                             galign_pkg.global_align_batch,
                             device=opt.device))
    return blocks, stats, pes, calls, seed_calls[0]


def check_rescue_bsw(blocks: list, dev) -> dict:
    """Every rescue block held exactly against the plain version, then
    timed beside its bound; the kernel line reports the block with the
    most banded cells."""
    if not blocks:
        raise AssertionError("the rescue sample dispatched no BSW block")
    p = BSWParams()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    args = [[torch.from_numpy(a).to(dev) for a in b] for b in blocks]
    err = 0
    for j, a in enumerate(args):
        got, want = bsw_call(*a, p), bsw_ref(*a, p)
        err = max(err, int((got - want).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"bsw differs from its plain version on "
                                 f"rescue block {j}")
    cells, rows = bsw_cells(args, p)
    geo = [launch_geometry(a[0].shape[0], a[0].shape[1], sms) for a in args]
    phase("bsw_rescue_exact", blocks=len(args),
          tasks=sum(a[0].shape[0] for a in args),
          qmax=",".join(str(a[0].shape[1]) for a in args),
          tmax=",".join(str(a[1].shape[1]) for a in args),
          cells=cells, task_rows=rows,
          cells_per_row=f"{cells / max(rows, 1):.1f}",
          max_smem_bytes_a_cta=max(g[2] for g in geo), max_abs_err=err)
    heaviest = None
    for j, one in enumerate(args):
        ms = kernel_ms(lambda: bsw_call(*one, p), "bsw_kernel", 1)
        plain = cuda_ms(lambda: bsw_ref(*one, p), reps=5)
        c1, r1 = bsw_cells([one], p)
        bound, by = bsw_bound_ms([one], c1)
        phase("bsw_rescue", block=j, tasks=one[0].shape[0],
              qmax=one[0].shape[1], tmax=one[1].shape[1], cells=c1,
              cells_per_row=f"{c1 / max(r1, 1):.1f}",
              geometry=json.dumps(geo[j], separators=(",", ":")),
              kernel_ms=f"{ms:.4f}", plain_ms=f"{plain:.4f}",
              bound_ms=f"{bound:.6f}", bound_by=by)
        if heaviest is None or c1 > heaviest[0]:
            heaviest = (c1, dict(rescue_max_abs_err=err, rescue_ms=ms,
                                 rescue_plain_ms=plain, rescue_bound_ms=bound,
                                 rescue_bound_by=by))
    return heaviest[1]


@contextlib.contextmanager
def recording_galign(calls: list):
    """Every call of the galign entry that the pipeline looks up on
    ``kernels.galign``: its tasks appended to ``calls`` before it
    launches the kernel."""
    real = galign_pkg.global_align_batch

    def record(tasks, p, *, device):
        calls.append(list(tasks))
        return real(tasks, p, device=device)
    galign_pkg.global_align_batch = record
    try:
        yield calls
    finally:
        galign_pkg.global_align_batch = real


def synthetic_galign_tasks() -> dict:
    """name -> (q, t, w) tasks: the edge cases (n == 0, m == 0, both,
    |n - m| > w, all N); w at 1 on related pairs of 60-129 bases; paths
    off the band (a target's shifted copy, offset 5-40 against a
    half-width of 1-4); long reads (n 200-256, so qmax 256, w up to
    120); long tasks on a narrow band (n 400-1,000, w 1-20); tasks whose
    decisions outgrow a warp's shared-memory slot (n 3,300-3,800, w 10-15:
    the global-decision path); bands of 1,024 columns or more (n 1,030-
    1,060, w 600: the wide path); and one set that mixes the three
    paths in one call."""
    rng = np.random.default_rng(23)
    r = lambda k: rng.integers(0, 5, k)          # noqa: E731
    edge = [(r(0), r(0), 5), (r(0), r(7), 1), (r(9), r(0), 3),
            (r(1), r(1), 1), (r(1), r(40), 2), (r(40), r(1), 2),
            (r(60), r(10), 5), (r(10), r(60), 5),
            (np.full(20, 4), np.full(25, 4), 1)]
    ql = rng.integers(60, 130, 256).tolist()
    qs, ts = related(rng, ql, [q + int(rng.integers(-8, 9)) for q in ql])
    w1 = [(q, t, 1) for q, t in zip(qs, ts)]
    off = []
    for _ in range(128):
        L, sh = int(rng.integers(30, 150)), int(rng.integers(5, 41))
        t = rng.integers(0, 4, L)
        off.append((np.concatenate([t[sh:], rng.integers(0, 4, sh)]), t,
                    int(rng.integers(1, 5))))
    ql = rng.integers(200, 257, 256).tolist()
    qs, ts = related(rng, ql, [q + int(rng.integers(-20, 40)) for q in ql])
    long = [(q, t, int(rng.integers(10, 121))) for q, t in zip(qs, ts)]
    sets = {"edge": edge, "w1": w1, "off_band": off, "long_query": long}
    for name, count, lo, hi, span, ws in (
            ("long_narrow", 64, 400, 1001, 8, (1, 21)),
            ("global_path", 4, 3300, 3801, 4, (10, 16)),
            ("wide", 2, 1030, 1061, 4, (600, 601))):
        ql = rng.integers(lo, hi, count).tolist()
        qs, ts = related(rng, ql, [q + int(rng.integers(-span, span + 1))
                                   for q in ql])
        sets[name] = [(q, t, int(rng.integers(*ws))) for q, t in zip(qs, ts)]
    sets["mixed"] = (edge[:4] + sets["long_narrow"][:4]
                     + sets["global_path"][:1] + sets["wide"][:1])
    return sets


def galign_cells(tasks) -> int:
    """Banded DP cells of ``tasks``: each row's [max(1, i - w), min(m,
    i + w)] with the reference's w = max(w, |n - m| + 3)."""
    total = 0
    for q, t, w in tasks:
        n, m = len(q), len(t)
        if n and m:
            w = max(w, abs(n - m) + 3)
            i = np.arange(1, n + 1)
            total += int(np.maximum(0, np.minimum(m, i + w)
                                    - np.maximum(1, i - w) + 1).sum())
    return total


def galign_bound_ms(tasks, cells: int, runs: int) -> tuple[float, str]:
    """Least time of one launch over ``tasks`` and what bounds it: their
    ``cells`` banded cells x ``GALIGN_OPS_PER_CELL`` over the int32 rate,
    or every input (the codes, n, m, w) read and every output (score,
    run count, ``runs`` runs) written once over the HBM rate."""
    nbytes = (sum(len(q) + len(t) for q, t, _ in tasks) + 12 * len(tasks)
              + 8 * len(tasks) + 4 * runs)
    ops_ms = 1e3 * cells * GALIGN_OPS_PER_CELL / INT32_OPS_PER_S
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes")


def kernel_regs(*names: str) -> str:
    """``{registers}r/{spill stores}+{spill loads}s`` of the kernel whose
    mangled name holds ``names``, from this run's ptxas report."""
    rep = ptxas_resources(*names)
    regs = re.search(r"Used (\d+) registers", rep)
    sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", rep)
    if not regs or not sp:
        return "not_built_in_this_run"
    return f"{regs.group(1)}r/{sp.group(1)}+{sp.group(2)}s"


def galign_ptxas() -> str:
    """Registers and spill bytes of every galign kernel, by instantiation:
    ``k4`` is galign_kernel<4, false> (decisions in shared memory), ``k4g``
    its global-decision twin, ``wide`` galign_wide_kernel."""
    names = [(f"k{k}{tag}", (f"galign_kernelILi{k}ELb{flag}E",))
             for k in galign_ops.KS for tag, flag in (("", 0), ("g", 1))]
    names.append(("wide", ("galign_wide_kernel",)))
    return ",".join(f"{tag}:{kernel_regs(*n)}" for tag, n in names)


def time_galign(tasks, dev, p: BSWParams) -> dict:
    """One launch over ``tasks`` as finalize makes it: the kernel's device
    time, the wrapper ``galign_call`` (one host read of the lengths), the
    pipeline's ``galign_launch`` on a plan made from host arrays (no host
    read), the plain version, and the bound."""
    arrays = galign_ops.pack(tasks)
    pl = galign_ops.plan(*arrays[2:])
    args = [torch.from_numpy(a).to(dev) for a in arrays]
    cells = galign_cells(tasks)
    runs = int(galign_call(*args, p)[1].sum())
    bound, by = galign_bound_ms(tasks, cells, runs)
    return dict(
        tasks=len(tasks), nmax=args[0].shape[1], mmax=args[1].shape[1],
        cells=cells, runs=runs, k=pl.k, smem_cta=pl.smem_cta,
        resident_ctas=galign_ops.resident_ctas(pl),
        paths=f"{pl.n_smem}/{pl.n_global}/{pl.n_wide}",
        ptxas=f"k{pl.k}:" + kernel_regs(f"galign_kernelILi{pl.k}ELb0E"),
        ms=kernel_ms(lambda: galign_call(*args, p), "galign_kernel", 1),
        call_ms=cuda_ms(lambda: galign_call(*args, p)),
        launch_ms=cuda_ms(lambda: galign_ops.galign_launch(*args, p, pl)),
        plain_ms=cuda_ms(lambda: galign_ref(*args, p), reps=3),
        bound_ms=bound, bound_by=by)


def check_galign(sets: dict, dev) -> dict:
    """Every task set held exactly (score and CIGAR) against the plain
    version on the same card tensors, and ``GALIGN_HOST_SAMPLE`` of each
    against the host ``global_align_cigar``, with the tasks each path of
    the kernel took; then the real SE set and the long reads, each in one
    launch as finalize makes it, timed beside their bounds."""
    p = BSWParams()
    err, n_tasks, n_host = 0, 0, 0
    paths = np.zeros(3, np.int64)
    for name, tasks in sets.items():
        arrays = galign_ops.pack(tasks)
        pl = galign_ops.plan(*arrays[2:])
        paths += (pl.n_smem, pl.n_global, pl.n_wide)
        args = [torch.from_numpy(a).to(dev) for a in arrays]
        out, want = galign_call(*args, p), galign_ref(*args, p)
        err = max(err, int((out[0] - want[0]).abs().max()))
        got = galign_ops.unpack(*out)
        if got != galign_ops.unpack(*want):
            bad = next(k for k, (a, b) in enumerate(
                zip(got, galign_ops.unpack(*want))) if a != b)
            raise AssertionError(f"galign differs from its plain version on "
                                 f"set {name}, task {bad}")
        step = max(1, len(tasks) // GALIGN_HOST_SAMPLE)
        for k in range(0, len(tasks), step):
            if global_align_cigar(*tasks[k], p) != got[k]:
                raise AssertionError(f"galign differs from global_align_cigar "
                                     f"on set {name}, task {k}")
            n_host += 1
        n_tasks += len(tasks)
    if not paths.all():
        raise AssertionError(f"a galign path ran on no task: shared/global/"
                             f"wide {paths.tolist()}")
    phase("galign_exact", sets=",".join(f"{k}:{len(v)}" for k, v in
                                        sets.items()),
          tasks=n_tasks, host_checked=n_host, max_abs_err=err,
          paths="/".join(map(str, paths)))
    timed = {name: time_galign(sets[name], dev, p)
             for name in ("real_se", "long_query")}
    for name, t in timed.items():
        phase("galign", set=name, tasks=t["tasks"], nmax=t["nmax"],
              mmax=t["mmax"], cells=t["cells"], runs=t["runs"], k=t["k"],
              smem_cta=t["smem_cta"], resident_ctas=t["resident_ctas"],
              paths=t["paths"], ptxas=t["ptxas"],
              kernel_ms=f"{t['ms']:.4f}",
              call_ms=f"{t['call_ms']:.4f}",
              launch_ms=f"{t['launch_ms']:.4f}",
              plain_ms=f"{t['plain_ms']:.4f}",
              bound_ms=f"{t['bound_ms']:.6f}", bound_by=t["bound_by"])
    phase("galign_build", ptxas=galign_ptxas(),
          launches_phase4=kernels.launch_counts()["galign"])
    se = timed["real_se"]
    return {"galign": dict(max_abs_err=err, ms=se["ms"],
                           plain_ms=se["plain_ms"], bound_ms=se["bound_ms"],
                           bound_by=se["bound_by"])}


def finalize_split(snap: dict, what: str) -> None:
    """Finalize's parts from a ``--profile`` run's snapshot: the galign
    call (packing, the launch, unpacking), the decision replay and
    marking before it, the CIGARs' application after it (strand, NM,
    MAPQ), and the SAM lines' formatting and writing."""
    get = lambda k: float(snap.get(k, 0.0))     # noqa: E731
    phase(what, finalize_s=f"{get('time_finalize_s'):.3f}",
          galign_kernel_s=f"{get('time_kernel.galign_s'):.3f}",
          decision_replay_s=f"{get('time_finalize.replay_s'):.3f}",
          cigar_apply_s=f"{get('time_finalize.cigar_s'):.3f}",
          sam_format_s=f"{get('time_sam_format_s'):.3f}",
          galign_tasks=int(snap.get("galign_tasks", 0)))


def synthetic_diagseed_sets() -> dict:
    """name -> (S, queries, wlos, whis): each its own reference of codes
    0..3.

    * ``chunk``: 616 windows of 785 bases with 151-base mates, as many as
      a 3,312-pair chunk of the benchmark's PE cells scans; a mate is a
      copy of 151 bases inside its window with ~2% substitutions (one in
      five unrelated);
    * ``ties``: equal longest runs on two diagonals, the larger one's
      ending first, and twice on one diagonal;
    * ``ns``: N (code 4) in the mates and in the reference, the mates'
      own Ns copied into the windows, and an all-N mate on an all-N window;
    * ``wide``: a window wider than a CTA's shared memory (240,000 bases,
      read from device memory) with its best run near its far end, a
      20,000-base window, and ordinary ones."""
    rng = np.random.default_rng(29)
    r = lambda k: rng.integers(0, 4, k).astype(np.uint8)   # noqa: E731
    sets = {}
    S = r(1_000_000)
    qs, lo = [], rng.integers(0, len(S) - 785, 616)
    for k, a in enumerate(lo):
        at = int(a) + int(rng.integers(0, 785 - 151))
        q = S[at:at + 151].copy()
        q = np.where(rng.random(151) < 0.02, r(151), q).astype(np.uint8)
        qs.append(q if k % 5 else r(151))
    sets["chunk"] = (S, qs, lo.tolist(), (lo + 785).tolist())
    S, q = r(5_000), r(120)

    def plant(lo, d, jb, je):
        S[lo + d + jb:lo + d + je] = q[jb:je]
        S[lo + d + jb - 1] = (q[jb - 1] + 1) % 4
        S[lo + d + je] = (q[je] + 1) % 4
    plant(1_000, 40, 70, 100)
    plant(1_000, 300, 20, 50)
    plant(3_000, 17, 5, 30)
    plant(3_000, 17, 60, 85)
    sets["ties"] = (S, [q, q], [1_000, 3_000], [1_600, 3_500])
    S = r(20_000)
    S[rng.random(len(S)) < 0.02] = 4
    qs, wl = [], []
    for k in range(32):
        q = r(151)
        q[rng.random(151) < 0.03] = 4
        at = 500 * k + int(rng.integers(0, 300))
        S[at:at + 151] = q
        qs.append(q)
        wl.append(500 * k)
    S[19_000:19_100] = 4
    sets["ns"] = (S, qs + [np.full(40, 4, np.uint8)], wl + [19_000],
                  [w + 450 for w in wl] + [19_100])
    S, q = r(400_000), r(151)
    S[100_000 + 239_000 + 30:100_000 + 239_000 + 140] = q[30:140]
    S[10_000 + 19_000 + 10:10_000 + 19_000 + 60] = q[10:60]
    sets["wide"] = (S, [q, q, q, r(151)],
                    [100_000, 10_000, 50_000, 60_000],
                    [340_000, 30_000, 50_785, 60_900])
    return sets


def diagseed_cells(queries, wlos, whis) -> int:
    """Byte compares of the reference's scan: sum over each window's
    diagonals d of min(L, n - d)."""
    total = 0
    for q, lo, hi in zip(queries, wlos, whis):
        n, L = hi - lo, len(q)
        d = np.arange(n)
        total += int(np.minimum(L, n - d).sum())
    return total


def host_ms(fn, reps: int = 5) -> float:
    """Median host-clock time of ``fn()`` in ms, after one warmup call
    (``fn`` ends in a host read, so the device work is inside)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def check_diagseed(sets: dict, dev) -> dict:
    """Every candidate set held exactly against the plain version on the
    same card tensors, and each set's first ``DIAGSEED_HOST_SAMPLE``
    candidates against the host ``best_diag_seed`` through the pipeline's
    entry; then the chunk-sized set and the real candidates timed: the
    kernel's device time (profiler, mean of 20 launches), the pipeline's
    launch on host-sized shared memory, the entry (gather, pack, copy,
    launch, readback), the host's numpy scan window by window, the plain
    version, and the bytes bound (windows and mates read once over the
    HBM rate)."""
    err, n_cands, n_host, n_global = 0, 0, 0, 0
    for name, (S, queries, wlos, whis) in sets.items():
        arrays = diagseed_ops.pack(queries, S, wlos, whis)
        args = [torch.from_numpy(a).to(dev) for a in arrays]
        got = diagseed_call(*args, DIAGSEED_MIN)
        want = diagseed_ref(*args, DIAGSEED_MIN)
        err = max(err, int((got - want).abs().max()))
        if not torch.equal(got, want):
            bad = int(torch.nonzero((got != want).any(1))[0, 0])
            raise AssertionError(
                f"diagseed differs from its plain version on set {name}, "
                f"candidate {bad}: {got[bad].tolist()} != "
                f"{want[bad].tolist()}")
        k = DIAGSEED_HOST_SAMPLE
        host = pe.host_diag_seeds(queries[:k], S, wlos[:k], whis[:k],
                                  DIAGSEED_MIN)
        entry = diagseed_ops.diag_seed_batch(
            queries[:k], S, wlos[:k], whis[:k], DIAGSEED_MIN,
            device=str(dev))
        if not np.array_equal(host, entry):
            raise AssertionError(f"diagseed differs from best_diag_seed on "
                                 f"set {name}")
        n_host += len(host)
        n_cands += len(queries)
        n_global += int((diagseed_ops.stage_bytes(arrays[2], arrays[5])
                         > diagseed_ops.SMEM_CTA_MAX).sum())
    if not n_global:
        raise AssertionError("no diagseed candidate took the device-memory "
                             "path")
    phase("diagseed_exact", sets=",".join(f"{k}:{len(v[1])}" for k, v in
                                          sets.items()),
          candidates=n_cands, host_checked=n_host, device_memory_path=n_global,
          max_abs_err=err)
    timed = {}
    for name in ("chunk", "real"):
        S, queries, wlos, whis = sets[name]
        arrays = diagseed_ops.pack(queries, S, wlos, whis)
        args = [torch.from_numpy(a).to(dev) for a in arrays]
        smem = diagseed_ops.smem_bytes(arrays[2], arrays[5])
        nbytes = int(arrays[0].size + arrays[3].size)
        fn = functools.partial(diagseed_ops.diag_seed_batch,
                               device=str(dev))
        t = dict(candidates=len(queries), window_bytes=int(arrays[0].size),
                 mate_bytes=int(arrays[3].size),
                 compares=diagseed_cells(queries, wlos, whis), smem=smem,
                 ms=kernel_ms(lambda: diagseed_call(*args, DIAGSEED_MIN),
                              "diagseed_kernel", 1),
                 launch_ms=cuda_ms(lambda: diagseed_ops.diagseed_launch(
                     *args, DIAGSEED_MIN, smem)),
                 entry_ms=host_ms(lambda: fn(queries, S, wlos, whis,
                                             DIAGSEED_MIN)),
                 host_ms=host_ms(lambda: pe.host_diag_seeds(
                     queries, S, wlos, whis, DIAGSEED_MIN), reps=3),
                 plain_ms=cuda_ms(lambda: diagseed_ref(*args, DIAGSEED_MIN),
                                  reps=3),
                 bound_ms=1e3 * nbytes / HBM_BYTES_PER_S)
        timed[name] = t
        phase("diagseed", set=name, candidates=t["candidates"],
              window_bytes=t["window_bytes"], mate_bytes=t["mate_bytes"],
              compares=t["compares"], smem_cta=smem,
              kernel_ms=f"{t['ms']:.4f}", launch_ms=f"{t['launch_ms']:.4f}",
              entry_ms=f"{t['entry_ms']:.3f}",
              host_numpy_ms=f"{t['host_ms']:.2f}",
              plain_ms=f"{t['plain_ms']:.3f}",
              bound_ms=f"{t['bound_ms']:.6f}", bound_by="bytes")
    phase("diagseed_build", ptxas=kernel_regs("diagseed_kernel"),
          launches_phase4=kernels.launch_counts()["diagseed"])
    c = timed["chunk"]
    return {"diagseed": dict(max_abs_err=err, ms=c["ms"],
                             plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
                             bound_by="bytes")}


# ---------------------------------------------------------------------
# phases 5 to 8: main paths, card against CPU
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


def check_pair_records(body: list[str], names: list[str], truth) -> tuple:
    """Two primary lines per pair, one flagged first (0x40) and one last
    (0x80) in the pair; returns (the proper-pair share, the truth-recovery
    share of end 1, of end 2)."""
    primary = {}
    for ln in body:
        f = ln.split("\t")
        flag = int(f[1])
        if flag & 0x900:
            continue
        key = (f[0], 0 if flag & 0x40 else 1)
        if not flag & 0xC0 or key in primary:
            raise AssertionError(f"pair {f[0]}: flag {flag} is not one "
                                 f"primary line an end")
        primary[key] = f
    if sorted(primary) != sorted((n, e) for n in names for e in (0, 1)):
        raise AssertionError(f"{len(primary)} primary lines for "
                             f"{len(names)} pairs")
    proper = sum(bool(int(primary[(n, 0)][1]) & 0x2) for n in names)
    hits = [0, 0]
    for i, n in enumerate(names):
        for e, key in enumerate(("pos1", "pos2")):
            f = primary[(n, e)]
            if not int(f[1]) & 0x4 and \
                    abs(int(f[3]) - 1 - int(truth[key][i])) <= 12:
                hits[e] += 1
    return tuple(x / len(names) for x in (proper, *hits))


def mem_pe(fa, tmp: pathlib.Path, ref) -> dict:
    """Phase 7: ``N_PAIRS`` simulated pairs through ``repro_torch.cli mem
    --device cuda`` as one batch, the launch counters set to 0 just
    before and read just after; the launches inside the mate-rescue stage
    are read apart around ``pe.rescue.run_rescues_batched``."""
    r1, r2, truth = simulate_pairs(ref, N_PAIRS, READ_LEN, seed=13,
                                   **PAIR_SIM)
    fq1, fq2 = tmp / "r1.fq", tmp / "r2.fq"
    write_fastq_pair(fq1, fq2, r1, r2)
    names = [f"pair{i}" for i in range(N_PAIRS)]
    sam, prof = tmp / "pe.sam", tmp / "pe.json"
    rescue_launches = dict.fromkeys(kernels.launch_counts(), 0)
    run_rescues = pe.rescue.run_rescues_batched
    merge = pe.rescue.merge_rescues

    def counted(fn):
        def run(*args, **kw):
            before = kernels.launch_counts()
            out = fn(*args, **kw)
            for k, v in kernels.launch_counts().items():
                rescue_launches[k] += v - before[k]
            return out
        return run
    pe.rescue.run_rescues_batched = counted(run_rescues)
    pe.rescue.merge_rescues = counted(merge)
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with collector_time() as gct:
            t0 = time.perf_counter()
            rc = cli.main(["mem", str(fa), str(fq1), str(fq2), "-o",
                           str(sam), "--device", "cuda", "-b", str(N_PAIRS),
                           "--no-pg", "--profile", str(prof)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
    finally:
        pe.rescue.run_rescues_batched = run_rescues
        pe.rescue.merge_rescues = merge
    if rc != 0:
        raise AssertionError(f"repro_torch.cli mem (paired) exited {rc}")
    payload = obs.read_profile(prof)
    snap = payload["snapshot"]
    picked = snap["occ_kernel"]
    if not isinstance(picked, str):
        raise AssertionError(f"mem ran {len(picked)} batches, not one")
    proper, truth1, truth2 = check_pair_records(sam_body(sam), names, truth)
    fr_failed, fr_avg, fr_std = (snap[k][1] for k in
                                 ("pes_failed", "pes_avg", "pes_std"))
    if fr_failed:
        raise AssertionError("FR insert-size stats failed on the PE batch")
    phase("mem_pe", pairs=N_PAIRS, reads=2 * N_PAIRS, wall_s=f"{wall:.2f}",
          pairs_per_s=f"{N_PAIRS / wall:.1f}", gc_s=f"{gct['gc_s']:.3f}",
          gc_full=gct["gc_full"],
          reads_per_s=f"{2 * N_PAIRS / wall:.1f}", occ_kernel=picked,
          proper_share=f"{proper:.4f}", n_rescued=int(snap["n_rescued"]),
          fr_avg=f"{fr_avg:.2f}", fr_std=f"{fr_std:.2f}",
          truth_share_end1=f"{truth1:.4f}", truth_share_end2=f"{truth2:.4f}",
          launches=json.dumps(launches, separators=(",", ":")),
          launches_rescue=json.dumps(rescue_launches, separators=(",", ":")),
          bsw_tasks_se=int(snap["bsw_tasks"]),
          rescue_tasks=int(snap["rescue_tasks"]),
          rescue_bsw=int(snap["rescue_bsw"]),
          rescue_cells_useful=int(snap["rescue_cells_useful"]),
          rescue_cells_total=int(snap["rescue_cells_total"]),
          smem_rounds=int(snap["smem_rounds"]))
    bd = payload["breakdown"]
    stages = {r["stage"]: r["time_s"] for r in bd["stages"] if r["time_s"]}
    phase("breakdown_pe", stages=json.dumps(stages, separators=(",", ":")),
          kernels=json.dumps(bd.get("kernels", {}), separators=(",", ":")),
          unattributed_s=bd["unattributed_s"])
    finalize_split(snap, "finalize_split_pe")
    return dict(launches=launches, rescue_launches=rescue_launches,
                occ_kernel=picked.split("/")[0], fq1=fq1, fq2=fq2, r1=r1,
                r2=r2)


def cpu_vs_card_pe(fa, fq1, fq2) -> None:
    """Phase 8: the first ``N_CPU_PAIRS`` pairs as one batch through
    ``Aligner.align_pairs`` on the card and on the CPU: identical SAM.
    (Against the phase-7 run's lines they could differ: the insert-size
    stats are estimated per batch.)"""
    first = next(iter(open_batches(str(fq1), str(fq2),
                                   batch_size=N_CPU_PAIRS)))
    t0 = time.perf_counter()
    card = Aligner.from_bundle(fa, device="cuda").align_pairs(first)
    t_card = time.perf_counter() - t0
    cpu = Aligner.from_bundle(fa, device="cpu").align_pairs(first)
    if card.sam() != cpu.sam():
        bad = next((j for j, (a, b) in enumerate(zip(card.sam(), cpu.sam()))
                    if a != b), -1)
        raise AssertionError(f"card and CPU PE SAM differ (first line {bad})")
    phase("cpu_vs_card_pe", pairs=len(first), lines=len(cpu.sam()),
          identical=True, n_rescued=card.stats["n_rescued"],
          n_proper=card.stats["n_proper"], card_s=f"{t_card:.1f}",
          cpu_s=f"{time.perf_counter() - t0 - t_card:.1f}")


# ---------------------------------------------------------------------
# phases 9 to 11: sharded mem, memdist, memdist on pairs
# ---------------------------------------------------------------------

def sweep_launches() -> dict:
    """Launches of one attach-time occ sweep, by kernel: per candidate a
    warmup and ``SWEEP_REPS`` timed reps of 1 + ``SWEEP_LAUNCHES``."""
    out = dict.fromkeys(kernels.launch_counts(), 0)
    for layout, _ in SWEEP_CANDIDATES:
        out[f"fmocc_ext_{layout}"] += 1 + SWEEP_REPS * (1 + SWEEP_LAUNCHES)
    return out


def require_path_launches(launches: dict, n_sweeps: int, what: str) -> None:
    """The run launched BSW and galign, and SMEM rounds beyond its
    ``n_sweeps`` sweeps' launches of the round kernel."""
    sweep = sweep_launches()
    for k in ("bsw", "galign"):
        if launches[k] <= 0:
            raise AssertionError(f"{what}: the {k} kernel was not launched")
    if not any(launches[k] > n_sweeps * sweep[k] for k in sweep
               if k.startswith("fmocc")):
        raise AssertionError(f"{what}: no SMEM round kernel launched beyond "
                             f"the sweep ({launches})")


def run_cli(argv: list[str], what: str) -> tuple[float, dict]:
    """``repro_torch.cli`` on ``argv`` with the launch counters set to 0
    just before and read just after; (wall seconds, launches)."""
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    if rc != 0:
        raise AssertionError(f"{what} exited {rc}")
    return wall, launches


def by_read(body: list[str]) -> list[tuple[str, list[str]]]:
    """SAM body lines grouped into (QNAME, its consecutive lines)."""
    groups = []
    for ln in body:
        name = ln.split("\t", 1)[0]
        if groups and groups[-1][0] == name:
            groups[-1][1].append(ln)
        else:
            groups.append((name, [ln]))
    return groups


def live_export_cost(prof: pathlib.Path, wall_s: float) -> None:
    """What the live exporter cost phase 5's ``--profile`` run: its
    flushes (the ``seq`` of the last one) times the time of one flush of
    that run's snapshot, against the run's wall."""
    stem = prof.with_suffix("")
    flushes = json.loads(pathlib.Path(f"{stem}.live.json").read_text())["seq"]
    snap = obs.read_profile(prof)["snapshot"]
    exp = obs.LiveExporter(prof.parent / "cost.live", interval=3600.0)
    exp.start(lambda: snap)
    t0 = time.perf_counter()
    for _ in range(TIMING_REPS):
        exp.flush()
    flush_ms = 1e3 * (time.perf_counter() - t0) / TIMING_REPS
    exp.stop()
    phase("live_export", mem_flushes=flushes, flush_ms=f"{flush_ms:.3f}",
          share_of_mem_wall=f"{flushes * flush_ms / 1e3 / wall_s:.5f}")


def mem_shard(fa, tmp: pathlib.Path, reads, body: list[str]) -> dict:
    """Phase 9: the first ``N_SHARD_READS`` reads of phase 5 through
    ``repro_torch.cli mem --shard i/2`` for i = 0, 1, each with a profile,
    a run log, live files and a trace.  The two bodies, interleaved by
    read ordinal (the shard filter keeps ordinal mod 2), are phase 5's
    lines of those reads; the profiles merge to every read once."""
    fq = tmp / "shard_reads.fq"
    names = [f"read{r}" for r in range(N_SHARD_READS)]
    write_fastq(fq, reads[:N_SHARD_READS], names)
    launches = dict.fromkeys(kernels.launch_counts(), 0)
    shards = []
    for i in range(2):
        p = {k: tmp / f"shard{i}.{k}" for k in
             ("sam", "json", "runlog.jsonl", "trace.json")}
        wall, got = run_cli(
            ["mem", str(fa), str(fq), "-o", str(p["sam"]), "--device",
             "cuda", "--shard", f"{i}/2", "--no-pg", "--profile",
             str(p["json"]), "--runlog", str(p["runlog.jsonl"]), "--live",
             str(tmp / f"shard{i}.live"), "--trace", str(p["trace.json"])],
            f"repro_torch.cli mem --shard {i}/2")
        require_path_launches(got, 1, f"mem --shard {i}/2")
        for k, v in got.items():
            launches[k] += v
        events = obs.read_runlog(p["runlog.jsonl"])
        if (events[0]["event"], events[-1]["event"],
                events[-1]["status"]) != ("run_start", "run_end", "ok"):
            raise AssertionError(f"shard {i}: run log does not run from "
                                 f"run_start to run_end status=ok")
        live = json.loads((tmp / f"shard{i}.live.json").read_text())
        prom = (tmp / f"shard{i}.live.prom").read_text()
        if "repro_io_reads" not in prom or "snapshot" not in live:
            raise AssertionError(f"shard {i}: live files lack the run's "
                                 f"metrics")
        trace = json.loads(p["trace.json"].read_text())["traceEvents"]
        spans = collections.Counter(e["name"] for e in trace
                                    if e.get("ph") == "X")
        for k in ("kernel.fmocc", "kernel.bsw"):
            if spans[k] == 0:
                raise AssertionError(f"shard {i}: no {k} span in the trace")
        shards.append(dict(
            wall=wall, body=sam_body(p["sam"]), profile=str(p["json"]),
            events=dict(collections.Counter(e["event"] for e in events)),
            spans={k: spans[k] for k in ("kernel.fmocc", "kernel.bsw",
                                         "smem", "bsw", "finalize")},
            live_flushes=live["seq"]))
    streams = [iter(by_read(s["body"])) for s in shards]
    merged = []
    for r, name in enumerate(names):
        got_name, lines = next(streams[r % 2])
        if got_name != name:
            raise AssertionError(f"shard {r % 2} holds {got_name} where "
                                 f"{name} belongs")
        merged.extend(lines)
    keep = set(names)
    if merged != [ln for ln in body if ln.split("\t", 1)[0] in keep]:
        raise AssertionError("the interleaved shard bodies differ from the "
                             "unsharded run's lines")
    merged_json = tmp / "shards_merged.json"
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["report", "--merge", "-o", str(merged_json),
                       *(s["profile"] for s in shards)])
    io_reads = obs.read_profile(merged_json)["snapshot"]["io_reads"]
    if rc != 0 or io_reads != N_SHARD_READS:
        raise AssertionError(f"report --merge: exit {rc}, io_reads "
                             f"{io_reads}")
    phase("mem_shard", reads=N_SHARD_READS, shards=2,
          wall_s=",".join(f"{s['wall']:.2f}" for s in shards),
          identical_to_mem=True, merged_io_reads=io_reads,
          events=json.dumps([s["events"] for s in shards],
                            separators=(",", ":")),
          spans=json.dumps([s["spans"] for s in shards],
                           separators=(",", ":")),
          live_flushes=",".join(str(s["live_flushes"]) for s in shards),
          launches=json.dumps(launches, separators=(",", ":")))
    return launches


def memdist_se(fa, tmp: pathlib.Path, reads) -> dict:
    """Phase 10: ``N_MEMDIST_READS`` reads through ``repro_torch.cli
    memdist -K 9696 -n 3`` (4 chunks of 96 reads, shards of 2/1/1) with
    shard 0 killed before its second chunk (``REPRO_FT_INJECT=0:1``), so
    the retry resumes from its first checkpoint; byte-identical to ``mem
    -K 9696`` on the same reads."""
    fq = tmp / "memdist.fq"
    write_fastq(fq, reads[:N_MEMDIST_READS],
                [f"read{r}" for r in range(N_MEMDIST_READS)])
    out, rl = tmp / "memdist.sam", tmp / "memdist.runlog.jsonl"
    os.environ["REPRO_FT_INJECT"] = "0:1"
    try:
        wall, launches = run_cli(
            ["memdist", str(fa), str(fq), "-o", str(out), "--device", "cuda",
             "-K", str(MEMDIST_K), "-n", "3", "--no-pg", "--runlog",
             str(rl)], "repro_torch.cli memdist")
    finally:
        del os.environ["REPRO_FT_INJECT"]
    require_path_launches(launches, 1, "memdist")
    events = obs.read_runlog(rl)
    plan = next(e for e in events if e["event"] == "job_plan")
    if plan["shards"] != [[0, 0, 2], [1, 2, 3], [2, 3, 4]]:
        raise AssertionError(f"memdist planned {plan['shards']}")
    retries = [e for e in events if e["event"] == "shard_retry"]
    if len(retries) != 1 or retries[0]["shard"] != 0:
        raise AssertionError(f"memdist logged {len(retries)} shard "
                             f"retries, not one of shard 0")
    resumed = [e for e in events
               if e["event"] == "shard_start" and e["resumed"]]
    if [(e["shard"], e["chunks_done"]) for e in resumed] != [(0, 1)]:
        raise AssertionError("the retried shard did not resume after its "
                             "first chunk")
    shard_walls = {e["shard"]: e["wall_s"] for e in events
                   if e["event"] == "shard_end"}
    merge = next(e for e in events if e["event"] == "merge")
    mem_out = tmp / "memdist_mem.sam"
    mem_wall, mem_launches = run_cli(
        ["mem", str(fa), str(fq), "-o", str(mem_out), "--device", "cuda",
         "-K", str(MEMDIST_K), "--no-pg"], "repro_torch.cli mem -K")
    require_path_launches(mem_launches, 1, "mem -K")
    if out.read_bytes() != mem_out.read_bytes():
        raise AssertionError("memdist and mem -K SAM differ")
    phase("memdist", reads=N_MEMDIST_READS, chunks=plan["n_chunks"],
          shards="2/1/1", wall_s=f"{wall:.2f}",
          mem_k_wall_s=f"{mem_wall:.2f}", retries=len(retries),
          shard_wall_s=json.dumps(shard_walls, separators=(",", ":")),
          merge_ms=f"{merge['merge_s'] * 1e3:.2f}", identical_to_mem_k=True,
          sam_bytes=len(out.read_bytes()),
          launches=json.dumps(launches, separators=(",", ":")),
          launches_mem_k=json.dumps(mem_launches, separators=(",", ":")))
    return launches


def memdist_pe(fa, tmp: pathlib.Path, r1, r2) -> dict:
    """Phase 11: the first ``N_MEMDIST_PAIRS`` pairs of phase 7 through
    ``repro_torch.cli memdist -K 12928 -n 2 --pe-bootstrap`` (2 chunks of
    64 pairs, insert-size stats frozen from the first); byte-identical to
    ``mem -K 12928 --pe-bootstrap``."""
    fq1, fq2 = tmp / "memdist_r1.fq", tmp / "memdist_r2.fq"
    write_fastq_pair(fq1, fq2, r1[:N_MEMDIST_PAIRS], r2[:N_MEMDIST_PAIRS])
    out, rl = tmp / "memdist_pe.sam", tmp / "memdist_pe.runlog.jsonl"
    common = ["-K", str(MEMDIST_PE_K), "--pe-bootstrap", "--device", "cuda",
              "--no-pg"]
    wall, launches = run_cli(
        ["memdist", str(fa), str(fq1), str(fq2), "-o", str(out), "-n", "2",
         "--runlog", str(rl), *common], "repro_torch.cli memdist (paired)")
    require_path_launches(launches, 1, "memdist (paired)")
    events = obs.read_runlog(rl)
    plan = next(e for e in events if e["event"] == "job_plan")
    if plan["n_chunks"] != 2 or not plan["pe_frozen"]:
        raise AssertionError(f"memdist (paired) planned {plan}")
    mem_out = tmp / "memdist_pe_mem.sam"
    mem_wall, mem_launches = run_cli(
        ["mem", str(fa), str(fq1), str(fq2), "-o", str(mem_out), *common],
        "repro_torch.cli mem -K --pe-bootstrap")
    require_path_launches(mem_launches, 1, "mem -K --pe-bootstrap")
    if out.read_bytes() != mem_out.read_bytes():
        raise AssertionError("memdist and mem -K --pe-bootstrap SAM differ")
    body = sam_body(out)
    phase("memdist_pe", pairs=N_MEMDIST_PAIRS, chunks=plan["n_chunks"],
          wall_s=f"{wall:.2f}", mem_k_wall_s=f"{mem_wall:.2f}",
          identical_to_mem_k=True, lines=len(body),
          proper=sum(bool(int(ln.split("\t")[1]) & 0x2) for ln in body),
          shard_wall_s=json.dumps({e["shard"]: e["wall_s"] for e in events
                                   if e["event"] == "shard_end"},
                                  separators=(",", ":")),
          launches=json.dumps(launches, separators=(",", ":")),
          launches_mem_k=json.dumps(mem_launches, separators=(",", ":")))
    return launches


# ---------------------------------------------------------------------
# phase 12: the alignment server
# ---------------------------------------------------------------------

def serve_round(srv, requests: list, call) -> list:
    """Hold the scheduler, send each request from its own client thread,
    wait until every one is queued (the scheduler holds at most the first
    outside the queue), resume, and return the results in order; any
    error frame or failed thread raises."""
    srv.pause()
    before = srv.metrics.snapshot().get("serve_requests", 0)
    results, errors = [None] * len(requests), []

    def client(i):
        try:
            with ServeClient.connect(*srv.address) as c:
                results[i] = call(c, i, requests[i])
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append((i, repr(e)))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(requests))]
    for t in threads:
        t.start()
    deadline = time.time() + 60
    while (srv.metrics.snapshot().get("serve_requests", 0) - before
           < len(requests) or len(srv.queue) < len(requests) - 1):
        if time.time() > deadline or errors:
            srv.resume()
            raise AssertionError(f"serve: requests not queued ({errors})")
        time.sleep(0.01)
    srv.resume()
    for t in threads:
        t.join(timeout=300)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"serve: client errors {errors}")
    return results


def lines_of(lines: list[str], names) -> list[str]:
    keep = set(names)
    return [ln for ln in lines if ln.split("\t", 1)[0] in keep]


def serve_phase(idx, dev, tmp: pathlib.Path, reads, sam: pathlib.Path,
                r1, r2, pes) -> dict:
    """Phase 12: the alignment server on the card, SE then PE, with the
    launch counters set to 0 just before and read just after its
    requests; the PE responses are then held against an offline run."""
    body = sam_body(sam)
    header = [ln for ln in sam.read_text().splitlines()
              if ln.startswith("@")]
    rl = tmp / "serve.runlog.jsonl"
    runlog = obs.RunLog(rl)
    runlog.manifest("chip_smoke serve", engine="cuda")
    se_reqs = [[(f"read{r}", decode(reads[r]))
                for r in range(i * N_SERVE_READS, (i + 1) * N_SERVE_READS)]
               for i in range(N_SERVE_CLIENTS)]
    pe_reqs = [[(f"pair{p}", decode(r1[p]), decode(r2[p]))
                for p in range(i * N_SERVE_PAIRS, (i + 1) * N_SERVE_PAIRS)]
               for i in range(N_SERVE_PE_CLIENTS)]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    srv = AlignmentServer(idx, AlignOptions(device=str(dev)),
                          max_batch_reads=SERVE_BATCH_READS, pe_stats=pes,
                          runlog=runlog)
    srv.start()
    try:
        se_res = serve_round(srv, se_reqs, lambda c, i, items: c.align(
            items, header=i == 0, request_id=f"se{i}"))
        se_batches = srv.metrics.snapshot().get("serve_batches", 0)
        pe_res = serve_round(srv, pe_reqs, lambda c, i, items: c.align_pairs(
            items, request_id=f"pe{i}"))
        pe_batches = srv.metrics.snapshot().get("serve_batches", 0)
    finally:
        srv.shutdown()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    require_path_launches(launches, 0, "serve")
    if (se_batches, pe_batches) != (1, 2):
        raise AssertionError(f"serve ran {se_batches} SE and "
                             f"{pe_batches - se_batches} PE batches, not 1 "
                             f"and 1")
    if se_res[0].header != header:
        raise AssertionError("the served header differs from mem's")
    for items, res in zip(se_reqs, se_res):
        if res.sam != lines_of(body, (n for n, _ in items)):
            raise AssertionError(f"served SAM of {items[0][0]}.. differs "
                                 f"from mem's lines of those reads")
    pairs = [it for items in pe_reqs for it in items]
    t1 = time.perf_counter()
    offline = Aligner(idx, device=dev, pe_stats=pes).align_pairs(
        _pack_pe([n for n, _, _ in pairs], [a for _, a, _ in pairs],
                 [b for _, _, b in pairs])).sam()
    offline_s = time.perf_counter() - t1
    for items, res in zip(pe_reqs, pe_res):
        if res.sam != lines_of(offline, (n for n, _, _ in items)):
            raise AssertionError(f"served SAM of {items[0][0]}.. differs "
                                 f"from the offline frozen-stats run")
    events = obs.read_runlog(rl)
    kinds = collections.Counter(e["event"] for e in events)
    if kinds["crash"] or kinds["request_error"]:
        raise AssertionError(f"serve logged {dict(kinds)}")
    batches = [e for e in events if e["event"] == "batch_coalesced"]
    if [(b["op"], b["requests"]) for b in batches] != [
            ("align", N_SERVE_CLIENTS), ("align_pairs", N_SERVE_PE_CLIENTS)]:
        raise AssertionError(f"serve batches {batches}")
    waits = {op: sorted(e["wait_s"] for e in events
                        if e["event"] == "request_done" and e["id"] in ids)
             for op, ids in (("se", {r.id for r in se_res}),
                             ("pe", {r.id for r in pe_res}))}
    if [len(w) for w in waits.values()] != [N_SERVE_CLIENTS,
                                           N_SERVE_PE_CLIENTS]:
        raise AssertionError(f"serve: request_done events {dict(kinds)}")
    phase("serve", reads=N_SERVE_CLIENTS * N_SERVE_READS,
          pairs=len(pairs), wall_s=f"{wall:.2f}",
          first_batch_s=batches[0]["batch_s"],
          other_batches_s=",".join(str(b["batch_s"]) for b in batches[1:]),
          widths=",".join(str(b["requests"]) for b in batches),
          pad_frac=",".join(str(b["pad_frac"]) for b in batches),
          se_wait_p50_s=statistics.median(waits["se"]),
          se_wait_max_s=waits["se"][-1],
          pe_wait_p50_s=statistics.median(waits["pe"]),
          pe_wait_max_s=waits["pe"][-1],
          offline_pe_s=f"{offline_s:.2f}",
          identical_to_mem=True, identical_to_offline_pe=True,
          events=json.dumps(dict(kinds), separators=(",", ":")),
          launches=json.dumps(launches, separators=(",", ":")),
          card=smi("name,power.limit").replace(" ", "_"))
    return launches


# ---------------------------------------------------------------------
# phases 13-14: the LM serving path
# ---------------------------------------------------------------------

def lm_prompts(vocab: int, n: int) -> list:
    """The prompts of ``repro_torch.launch.serve``'s main (seed 0)."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=rng.integers(4, 40))
            .astype(np.int32) for _ in range(n)]


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def max_diff(a, b) -> float:
    return float((a.float().cpu() - b.float().cpu()).abs().max())


def require_no_launches(what: str) -> None:
    """The LM path reaches none of the BWA-MEM kernels."""
    launched = {k: v for k, v in kernels.launch_counts().items() if v}
    if launched:
        raise AssertionError(f"{what} launched BWA-MEM kernels: {launched}")


def require_tf32_off() -> bool:
    tf32 = torch.backends.cuda.matmul.allow_tf32
    if tf32 or torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("float32 matmuls are not exact float32 (TF32)")
    return tf32


def profiled_decode_steps(cfg, params, B: int, smax: int, dev) -> dict:
    """LM_PROFILED_STEPS greedy decode steps of a served batch's geometry
    under the profiler (after one unprofiled step): the card's busy
    share, host-to-device copies and stream synchronisations a step, and
    the largest device items.  A served run holds ~100k PyTorch calls,
    whose trace takes the profiler about a minute to process; a few steps
    show the same per-step work."""
    with torch.inference_mode():
        cache = lm.init_cache(cfg, B, smax, device=dev)
        cur = torch.zeros((B, 1), dtype=torch.int32, device=dev)

        def step(pos, cur):
            logits, _ = lm.decode_step(params, cfg, cache, {"tokens": cur},
                                       pos)
            return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        cur = step(0, cur)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for pos in range(1, 1 + LM_PROFILED_STEPS):
                cur = step(pos, cur)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev_us = {e.key: e.self_device_time_total for e in events
              if e.self_device_time_total > 0}
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:4]
    n = LM_PROFILED_STEPS
    return {"profiled_steps": n,
            "profiled_ms_per_step": f"{wall / n * 1e3:.3f}",
            "device_ms_per_step": f"{sum(dev_us.values()) / 1e3 / n:.3f}",
            "device_busy": f"{sum(dev_us.values()) / 1e6 / wall:.4f}",
            "h2d_per_step": sum(e.count for e in events
                                if "HtoD" in e.key) / n,
            "syncs_per_step": sum(e.count for e in events
                                  if e.key == "cudaStreamSynchronize") / n,
            "top_ms": json.dumps({k[:40]: round(v / 1e3, 3) for k, v in top},
                                 separators=(",", ":"))}


def lm_serve_phase(dev) -> None:
    """Phase 13: Qwen1.5-0.5B at full width in bf16, initialised on the
    card, serves launch/serve.py's 8 prompts twice (16 new tokens)."""
    t_phase = time.perf_counter()
    tf32 = require_tf32_off()
    cfg = get_arch(LM_ARCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, _ = lm.init_params(cfg, torch.Generator(dev).manual_seed(0),
                               device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = tree_leaves(params)
    n_params = sum(x.numel() for x in leaves)
    nbytes = sum(x.numel() * x.element_size() for x in leaves)
    prompts = lm_prompts(cfg.vocab, LM_PROMPTS)
    kernels.reset_launch_counts()
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        outs, stats = serve_batch(cfg, params, prompts, LM_MAX_NEW)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0, outs))
    steps = max(len(p) for p in prompts) + LM_MAX_NEW - 1
    prof = profiled_decode_steps(cfg, params, len(prompts), steps + 1, dev)
    require_no_launches("[lm_serve]")
    for o in runs[0][1]:
        if o.shape != (LM_MAX_NEW,) or not ((0 <= o) & (o < cfg.vocab)).all():
            raise AssertionError(f"lm_serve: bad output {o}")
    if any(not np.array_equal(a, b) for a, b in zip(runs[0][1], runs[1][1])):
        raise AssertionError("lm_serve: the two runs gave other tokens")
    (cold, _), (warm, _) = runs
    gen = LM_PROMPTS * LM_MAX_NEW
    phase("lm_serve", arch=LM_ARCH, dtype=cfg.dtype, params=n_params,
          param_count=cfg.param_count(), gb=f"{nbytes / 1e9:.3f}",
          init_s=f"{init_s:.3f}", prompts=LM_PROMPTS, max_new=LM_MAX_NEW,
          prompt_lens=",".join(str(len(p)) for p in prompts),
          decode_steps=steps, first_s=f"{cold:.3f}", warm_s=f"{warm:.3f}",
          warm_ms_per_step=f"{warm / steps * 1e3:.3f}",
          tokens_per_s_warm=f"{gen / warm:.1f}",
          tokens_per_s_first=f"{gen / cold:.1f}",
          lane_efficiency=f"{stats['lane_efficiency']:.4f}",
          max_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}",
          identical_runs=True, allow_tf32=tf32, **prof,
          first_output=",".join(map(str, runs[0][1][0][:8])),
          wall_s=f"{time.perf_counter() - t_phase:.2f}",
          card=smi("name,power.limit").replace(" ", "_"))


def lm_batch(cfg, B: int, S: int, rng) -> dict:
    if cfg.input_kind == "embeds":
        ar = np.tile(np.arange(S, dtype=np.int32), (B, 1))
        return {"embeds": rng.normal(0, 0.1, size=(B, S, cfg.d_model))
                .astype(np.float32),
                "positions": np.stack([ar, ar, ar]),
                "labels": rng.integers(0, cfg.vocab, size=(B, S))}
    shape = (B, S, cfg.n_codebooks) if cfg.n_codebooks else (B, S)
    toks = rng.integers(0, cfg.vocab, size=shape)
    return {"tokens": toks, "labels": toks}


def lm_run(params, cfg, batch: dict, dev, block: int) -> tuple:
    """(forward logits, loss, the stacked logits of S teacher-forced
    decode steps from a fresh cache) on ``dev``."""
    b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    key = "embeds" if "embeds" in b else "tokens"
    B, S = b[key].shape[:2]
    with torch.inference_mode():
        full = lm.forward(params, cfg, b, q_block=block, kv_block=block)
        loss = lm.loss_fn(params, cfg, b, q_block=block, kv_block=block)
        cache = lm.init_cache(cfg, B, S, device=dev)
        dec = torch.stack([lm.decode_step(
            params, cfg, cache, {key: b[key][:, p:p + 1]}, p)[0][:, 0]
            for p in range(S)], dim=1)
    return full, loss, dec


def check_err(what: str, err: float, tol: float) -> str:
    if not err <= tol:
        raise AssertionError(f"lm_exact: {what} max |diff| {err:.3e} > {tol}")
    return f"{err:.3e}"


def lm_card_vs_cpu_serve(cfg, params, dev) -> dict:
    """serve_batch of the first prompts on the card and on the CPU: the
    tokens agree at every step whose CPU top-2 margin is > LM_MARGIN
    (a step under it is printed, and its row compared no further), and
    the logits of every compared step are within LM_TOL."""
    prompts = lm_prompts(cfg.vocab, LM_PROMPTS)[:LM_CPU_PROMPTS]
    lens_s = np.sort([len(p) for p in prompts])
    seen = {"card": [], "cpu": []}
    t0 = time.perf_counter()
    card_out, _ = serve_batch(cfg, params, prompts, LM_CPU_MAX_NEW,
                              on_step=lambda p, lg: seen["card"].append(
                                  lg.float().cpu()))
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_out, _ = serve_batch(cfg, tree_to(params, "cpu"), prompts,
                             LM_CPU_MAX_NEW, on_step=lambda p, lg:
                             seen["cpu"].append(lg.float()))
    cpu_s = time.perf_counter() - t0
    err, near, live = 0.0, [], set(range(len(prompts)))
    for pos, (a, b) in enumerate(zip(seen["card"], seen["cpu"])):
        for i in sorted(live):
            err = max(err, float((a[i] - b[i]).abs().max()))
            if pos + 1 < lens_s[i]:
                continue                         # a prompt token comes next
            top2 = torch.topk(b[i], 2).values
            margin = float(top2[0] - top2[1])
            if int(a[i].argmax()) != int(b[i].argmax()):
                if margin > LM_MARGIN:
                    raise AssertionError(f"lm_exact: step {pos} row {i}: "
                                         f"card and CPU tokens differ at "
                                         f"margin {margin:.3e}")
                near.append((pos, i, margin))
                live.discard(i)
    order = np.argsort([len(p) for p in prompts])
    for i, o in enumerate(order):
        if i in live and not np.array_equal(card_out[o], cpu_out[o]):
            raise AssertionError(f"lm_exact: served tokens of prompt {o} "
                                 f"differ between the card and the CPU")
    return {"serve_logits": check_err("serve logits card vs CPU", err,
                                      LM_TOL),
            "serve_steps": len(seen["cpu"]), "serve_card_s": f"{card_s:.3f}",
            "serve_cpu_s": f"{cpu_s:.3f}", "near_ties": near or "none",
            "served_identical": not near}


def lm_exact_phase(dev) -> None:
    """Phase 14: float32 on the card against itself (decode against
    forward) and against the CPU, at full width and at every smoke
    config."""
    t_phase = time.perf_counter()
    require_tf32_off()
    kernels.reset_launch_counts()
    # (a) Qwen1.5-0.5B at full width, float32
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_arch(LM_ARCH), dtype="float32")
    params, _ = lm.init_params(cfg, torch.Generator(dev).manual_seed(0),
                               device=dev)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, size=(LM_EXACT_B, LM_EXACT_S))
    full, _, dec = lm_run(params, cfg, {"tokens": toks, "labels": toks}, dev,
                          LM_EXACT_BLOCK)
    res = {"decode_vs_forward": check_err(
        "Qwen decode vs forward", max_diff(dec, full), LM_TOL)}
    res.update(lm_card_vs_cpu_serve(cfg, params, dev))
    del params, full, dec
    torch.cuda.empty_cache()
    phase("lm_exact_full", arch=LM_ARCH, dtype="float32", B=LM_EXACT_B,
          S=LM_EXACT_S, block=LM_EXACT_BLOCK, tol=LM_TOL,
          wall_s=f"{time.perf_counter() - t0:.2f}", **res)
    # (b) every arch at its smoke config, float32, card against CPU
    t0 = time.perf_counter()
    worst = {}
    for name in sorted(ARCHS):
        cfg = dataclasses.replace(smoke_config(name), dtype="float32")
        params, _ = lm.init_params(cfg, torch.Generator(dev).manual_seed(0),
                                   device=dev)
        batch = lm_batch(cfg, LM_SMOKE_B, LM_SMOKE_S,
                         np.random.default_rng(2))
        card = lm_run(params, cfg, batch, dev, LM_SMOKE_BLOCK)
        cpu = lm_run(tree_to(params, "cpu"), cfg, batch, "cpu",
                     LM_SMOKE_BLOCK)
        errs = {k: check_err(f"{name} {k} card vs CPU", max_diff(a, b),
                             LM_SMOKE_TOL)
                for k, a, b in zip(("forward", "loss", "decode"), card, cpu)}
        if name in LM_DECODE_ARCHS:
            errs["decode_vs_forward"] = check_err(
                f"{name} decode vs forward", max_diff(card[2], card[0]),
                LM_SMOKE_TOL)
        worst[name] = errs
    phase("lm_exact_smoke", archs=len(worst), dtype="float32",
          B=LM_SMOKE_B, S=LM_SMOKE_S, block=LM_SMOKE_BLOCK, tol=LM_SMOKE_TOL,
          wall_s=f"{time.perf_counter() - t0:.2f}",
          max_abs=json.dumps(worst, separators=(",", ":")))
    # (c) mamba2-130m at full width, float32: decode against forward
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_arch(LM_SSM_ARCH), dtype="float32")
    params, _ = lm.init_params(cfg, torch.Generator(dev).manual_seed(0),
                               device=dev)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, size=(1, LM_SSM_S))
    full, _, dec = lm_run(params, cfg, {"tokens": toks, "labels": toks}, dev,
                          LM_EXACT_BLOCK)
    err = check_err("mamba2 decode vs forward", max_diff(dec, full), LM_TOL)
    del params, full, dec
    torch.cuda.empty_cache()
    require_no_launches("[lm_exact]")
    phase("lm_exact_ssm", arch=LM_SSM_ARCH, dtype="float32", B=1,
          S=LM_SSM_S, chunks=LM_SSM_S // min(128, LM_SSM_S),
          decode_vs_forward=err, tol=LM_TOL,
          wall_s=f"{time.perf_counter() - t0:.2f}")
    phase("lm_exact", wall_s=f"{time.perf_counter() - t_phase:.2f}",
          launches=json.dumps(kernels.launch_counts(),
                              separators=(",", ":")),
          card=smi("name,power.limit").replace(" ", "_"))


# ---------------------------------------------------------------------
# phases 15-16: LM training
# ---------------------------------------------------------------------

def finite_losses(what: str, losses: list) -> None:
    if not all(np.isfinite(x) for x in losses):
        raise AssertionError(f"{what}: a loss is not finite: {losses}")


def profiled_train_steps(cfg, state, dev) -> dict:
    """LM_TRAIN_PROFILED_STEPS train steps of phase 15's geometry under
    the profiler, after one unprofiled step: device time a step, the
    card's busy share and the largest device items."""
    step_fn = make_train_step(cfg, q_block=LM_TRAIN_BLOCK,
                              kv_block=LM_TRAIN_BLOCK)
    batch = synthetic_batch(cfg, LM_TRAIN_B, LM_TRAIN_S, LM_TRAIN_STEPS,
                            device=dev)
    state, loss = step_fn(state, batch)
    float(loss)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(LM_TRAIN_PROFILED_STEPS):
            state, loss = step_fn(state, batch)
            float(loss)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev_us = {e.key: e.self_device_time_total for e in events
              if e.self_device_time_total > 0}
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:6]
    n = LM_TRAIN_PROFILED_STEPS
    return {"profiled_steps": n,
            "profiled_ms_per_step": f"{wall / n * 1e3:.3f}",
            "device_ms_per_step": f"{sum(dev_us.values()) / 1e3 / n:.3f}",
            "device_busy": f"{sum(dev_us.values()) / 1e6 / wall:.4f}",
            "aten_calls_per_step": sum(e.count for e in events
                                       if e.key.startswith("aten::")) // n,
            "kernel_launches_per_step": sum(
                e.count for e in events
                if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                             "cuLaunchKernel", "cuLaunchKernelEx")) // n,
            "top_ms": json.dumps({k[:40]: round(v / 1e3 / n, 3)
                                  for k, v in top}, separators=(",", ":"))}


def train_step_bound(cfg, params) -> dict:
    """The least time one train step of phase 15 could take: the larger
    of its products' operations over the bf16 peak and the bytes it must
    move over the memory rate.  Operations: the weight products of the
    forward, the backward (twice the forward) and full remat's second
    forward of the blocks, and causal attention's two products a layer
    (the causal half).  Bytes: the params and both float32 moments, each
    read once and written once."""
    tokens = LM_TRAIN_B * LM_TRAIN_S
    n_blocks = sum(x.numel() for x in tree_leaves(params["blocks"]))
    attn = (4 * LM_TRAIN_B * cfg.n_heads * cfg.head_dim * cfg.n_layers
            * LM_TRAIN_S * (LM_TRAIN_S + 1) // 2)
    fwd_blocks = 2 * tokens * n_blocks + attn
    flops = 3 * (fwd_blocks + 2 * tokens * params["head"].numel()) \
        + fwd_blocks
    nbytes = sum(2 * x.numel() * (x.element_size() + 8)
                 for x in tree_leaves(params))
    t_ops, t_bytes = flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    return {"step_tflop": f"{flops / 1e12:.3f}",
            "step_gb_moved": f"{nbytes / 1e9:.3f}",
            "bound_ms": f"{max(t_ops, t_bytes) * 1e3:.3f}",
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def lm_train_phase(dev, tmp: pathlib.Path) -> None:
    """Phase 15: Qwen1.5-0.5B at full width in bf16 trained 8 steps by
    ``launch.train.train`` (B=8, S=128; one checkpoint, at the end),
    its checkpoint restored bit for bit, 2 more steps profiled; then
    the smoke config resumed at step 8 of 10, against 10 steps in one
    run."""
    t_phase = time.perf_counter()
    kernels.reset_launch_counts()
    cfg = get_arch(LM_ARCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ends = []
    t0 = time.perf_counter()
    state, losses = train(
        cfg, steps=LM_TRAIN_STEPS, batch=LM_TRAIN_B, seq=LM_TRAIN_S,
        q_block=LM_TRAIN_BLOCK, ckpt_dir=str(tmp / "full"),
        ckpt_every=LM_TRAIN_STEPS + 1, device=dev, verbose=False,
        on_step=lambda step, loss, s: ends.append((s, time.perf_counter())))
    save_s = time.perf_counter() - ends[-1][1]     # the final save
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    finite_losses("lm_train", losses)
    if len(losses) != LM_TRAIN_STEPS:
        raise AssertionError(f"lm_train ran {len(losses)} steps")
    ckpt_bytes = sum(f.stat().st_size for f in (tmp / "full").rglob("*.npy"))
    t0 = time.perf_counter()
    restored, at = CheckpointManager(tmp / "full").restore(state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if at != LM_TRAIN_STEPS or not all(
            a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
            for a, b in zip(tree_leaves(restored), tree_leaves(state))):
        raise AssertionError("lm_train: the restored state is not the "
                             "trained one")
    del restored
    bound = train_step_bound(cfg, state["params"])
    prof = profiled_train_steps(cfg, state, dev)
    del state
    torch.cuda.empty_cache()
    warm = statistics.mean(s for s, _ in ends[1:])
    tokens = LM_TRAIN_B * LM_TRAIN_S
    phase("lm_train", arch=LM_ARCH, dtype=cfg.dtype, B=LM_TRAIN_B,
          S=LM_TRAIN_S, steps=LM_TRAIN_STEPS, train_s=f"{train_s:.3f}",
          first_step_s=f"{ends[0][0]:.3f}",
          warm_ms_per_step=f"{warm * 1e3:.3f}",
          tokens_per_s_warm=f"{tokens / warm:.1f}",
          max_mem_gb=f"{peak / 1e9:.3f}",
          losses=",".join(f"{x:.6f}" for x in losses),
          ckpt_gb=f"{ckpt_bytes / 1e9:.3f}", save_s=f"{save_s:.3f}",
          restore_s=f"{restore_s:.3f}", restored_identical=True, **bound,
          **prof, card=smi("name,power.limit").replace(" ", "_"))
    # resume at the smoke config: steps 8-9 after a restart equal steps
    # 8-9 of one uninterrupted run, bit for bit
    t0 = time.perf_counter()
    scfg = smoke_config(LM_ARCH)
    kw = dict(batch=LM_TRAIN_B, seq=LM_TRAIN_S, q_block=LM_TRAIN_BLOCK,
              device=dev, verbose=False)
    first = train(scfg, steps=LM_TRAIN_STEPS, ckpt_dir=str(tmp / "resume"),
                  **kw)[1]
    resumed = train(scfg, steps=LM_RESUME_STEPS, ckpt_dir=str(tmp / "resume"),
                    **kw)[1]
    whole = train(scfg, steps=LM_RESUME_STEPS, ckpt_dir=str(tmp / "whole"),
                  **kw)[1]
    finite_losses("lm_train_resume", whole)
    if first + resumed != whole or len(resumed) != 2:
        raise AssertionError(f"lm_train_resume: {first} + {resumed} != "
                             f"{whole}")
    require_no_launches("[lm_train]")
    phase("lm_train_resume", arch=LM_ARCH, config="smoke", dtype=scfg.dtype,
          resumed_at=LM_TRAIN_STEPS, steps=LM_RESUME_STEPS,
          losses_8_9=",".join(repr(x) for x in resumed), identical=True,
          wall_s=f"{time.perf_counter() - t0:.2f}",
          phase_s=f"{time.perf_counter() - t_phase:.2f}")


def grad_errs(a: dict, b: dict) -> float:
    """The largest, over the leaves, max |a - b| over the leaf's max |b|."""
    worst = 0.0
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        y = y.float().cpu()
        if not (torch.isfinite(x).all() and torch.isfinite(y).all()):
            raise AssertionError("lm_train_exact: a gradient is not finite")
        scale = float(y.abs().max())
        worst = max(worst, float((x.float().cpu() - y).abs().max())
                    / (scale if scale > 0 else 1.0))
    return worst


def param_errs(a: dict, b: dict) -> tuple[float, float]:
    """(max |a - b|, the share of elements over LM_PARAM_CLOSE)."""
    worst, over, n = 0.0, 0, 0
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        d = (x.float().cpu() - y.float().cpu()).abs()
        if not torch.isfinite(d).all():
            raise AssertionError("lm_train_exact: a parameter is not finite")
        worst = max(worst, float(d.max()))
        over += int((d > LM_PARAM_CLOSE).sum())
        n += d.numel()
    return worst, over / n


def loss_err(a, b) -> float:
    return abs(float(a) - float(b)) / (1 + abs(float(b)))


def train_run(cfg, params, batches, opt, block) -> tuple:
    """(every step's loss, step 1's gradients, the final params) of
    ``make_train_step`` over ``batches`` from ``params``.  The gradients
    are read from step 1's first moment, ``mu = (1 - b1) * clip * g``:
    each leaf's gradient times one scalar, without a second backward."""
    step_fn = make_train_step(cfg, opt, q_block=block, kv_block=block)
    state = {"params": params, "opt": adamw_init(params)}
    losses, grads = [], None
    for b in batches:
        state, lv = step_fn(state, b)
        losses.append(float(lv))
        if grads is None:
            grads = state["opt"]["mu"]
    return losses, grads, state["params"]


def lm_train_exact_phase(dev) -> None:
    """Phase 16: float32 training on the card against the CPU: one step
    at full width, 3 steps of every smoke arch at S=128."""
    t_phase = time.perf_counter()
    require_tf32_off()
    kernels.reset_launch_counts()
    # (a) Qwen1.5-0.5B at full width, float32, one step
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_arch(LM_ARCH), dtype="float32")
    params, _ = lm.init_params(cfg, torch.Generator(dev).manual_seed(0),
                               device=dev)
    batch = synthetic_batch(cfg, LM_GRAD_B, LM_GRAD_S, 0, device=dev)
    opt = AdamWConfig()
    card = train_run(cfg, params, [batch], opt, LM_EXACT_BLOCK)
    card = (card[0], tree_to(card[1], "cpu"), tree_to(card[2], "cpu"))
    card_s = time.perf_counter() - t0
    params = tree_to(params, "cpu")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cpu = train_run(cfg, params, [tree_to(batch, "cpu")], opt,
                    LM_EXACT_BLOCK)
    cpu_s = time.perf_counter() - t0
    lr1 = opt.lr / opt.warmup_steps
    errs = (loss_err(card[0][0], cpu[0][0]), grad_errs(card[1], cpu[1]),
            *param_errs(card[2], cpu[2]))
    if not (errs[0] <= LM_LOSS_TOL and errs[1] <= LM_GRAD_TOL
            and errs[2] <= 2 * lr1 and errs[3] <= LM_PARAM_SHARE):
        raise AssertionError(
            f"lm_train_exact_full: loss {errs[0]:.3e}, grads {errs[1]:.3e}, "
            f"params {errs[2]:.3e} ({errs[3]:.2e} over {LM_PARAM_CLOSE})")
    phase("lm_train_exact_full", arch=LM_ARCH, dtype="float32", B=LM_GRAD_B,
          S=LM_GRAD_S, loss=f"{cpu[0][0]:.6f}", loss_err=f"{errs[0]:.3e}",
          grad_err=f"{errs[1]:.3e}", param_max=f"{errs[2]:.3e}",
          param_share_over=f"{errs[3]:.2e}",
          tol=f"loss {LM_LOSS_TOL} grads {LM_GRAD_TOL} params {2 * lr1:.1e}",
          card_s=f"{card_s:.2f}", cpu_s=f"{cpu_s:.2f}")
    del params, card, cpu
    # (b) every smoke arch, float32, 3 steps at S=128: finite gradients
    t0 = time.perf_counter()
    worst = {}
    for name in sorted(ARCHS):
        cfg = dataclasses.replace(smoke_config(name), dtype="float32")
        params, _ = lm.init_params(cfg, torch.Generator(dev).manual_seed(0),
                                   device=dev)
        batches = []
        for i in range(LM_GRAD_SMOKE_STEPS):
            b = synthetic_batch(cfg, LM_GRAD_SMOKE_B, LM_GRAD_SMOKE_S, i,
                                device=dev)
            if "embeds" in b:
                b["embeds"] = b["embeds"].float()
            batches.append(b)
        card = train_run(cfg, params, batches, LM_GRAD_SMOKE_OPT,
                         LM_GRAD_SMOKE_S)
        cpu = train_run(cfg, tree_to(params, "cpu"),
                        [tree_to(b, "cpu") for b in batches],
                        LM_GRAD_SMOKE_OPT, LM_GRAD_SMOKE_S)
        finite_losses(f"lm_train_exact_smoke {name}", card[0] + cpu[0])
        g = grad_errs(card[1], cpu[1])
        lerr = max(loss_err(a, b) for a, b in zip(card[0], cpu[0]))
        p_max, p_share = param_errs(card[2], cpu[2])
        bound = 2 * LM_GRAD_SMOKE_OPT.lr * LM_GRAD_SMOKE_STEPS
        if not (lerr <= LM_LOSS_TOL and g <= LM_GRAD_TOL and p_max <= bound
                and p_share <= LM_PARAM_SHARE):
            raise AssertionError(
                f"lm_train_exact_smoke {name}: loss {lerr:.3e}, grads "
                f"{g:.3e}, params {p_max:.3e} ({p_share:.2e} over "
                f"{LM_PARAM_CLOSE})")
        worst[name] = {"loss": f"{lerr:.2e}", "grad": f"{g:.2e}",
                       "param": f"{p_max:.2e}"}
    require_no_launches("[lm_train_exact]")
    phase("lm_train_exact_smoke", archs=len(worst), dtype="float32",
          B=LM_GRAD_SMOKE_B, S=LM_GRAD_SMOKE_S, steps=LM_GRAD_SMOKE_STEPS,
          finite=True, max_err=json.dumps(worst, separators=(",", ":")),
          wall_s=f"{time.perf_counter() - t0:.2f}")
    phase("lm_train_exact", wall_s=f"{time.perf_counter() - t_phase:.2f}",
          launches=json.dumps(kernels.launch_counts(),
                              separators=(",", ":")),
          card=smi("name,power.limit").replace(" ", "_"))


# ---------------------------------------------------------------------
# phases 17-18: the dry run, and a sharded train step
# ---------------------------------------------------------------------

#: runs ``repro_torch.launch.dryrun.main`` on argv[1:] with the BWA-MEM
#: launch counters at 0, and prints the counts the run left on a line
#: of its own before exiting with main's code
DRYRUN_CHILD = (
    "import json, sys\n"
    "from repro_torch import kernels\n"
    "from repro_torch.launch import dryrun\n"
    "kernels.reset_launch_counts()\n"
    "rc = dryrun.main(sys.argv[1:])\n"
    "print('LAUNCHES ' + json.dumps(kernels.launch_counts()), flush=True)\n"
    "sys.exit(rc)\n")


def dense_train_flops_per_chip(cfg, B: int, S: int, data: int,
                               model: int) -> int:
    """Hand count of the products one chip runs in a dense train step
    (swiglu, heads and d_ff split over ``model``, the batch over
    ``data``, every layer checkpointed, attention blocks unmasked):
    the head's product forward and its two backward ones; each layer's
    products forward, recomputed and their two backward ones, less the
    recomputed down projection (a non-reentrant checkpoint stops once
    what the backward needs is recomputed)."""
    T = B // data * S
    hl, fl, vl = cfg.n_heads * cfg.head_dim // model, cfg.d_ff // model, \
        cfg.vocab // model
    kvl = cfg.n_kv_heads * cfg.head_dim // model
    d = cfg.d_model

    def mm(m, k, n):
        return 2 * m * k * n
    layer_fwd = (mm(T, d, hl + 2 * kvl) + mm(T, hl, d) + mm(T, d, 2 * fl)
                 + mm(T, fl, d) + 2 * 2 * T * S * hl)
    return 3 * mm(T, d, vl) + cfg.n_layers * (4 * layer_fwd - mm(T, fl, d))


def moe_train_flops_per_chip(cfg, B: int, S: int, data: int,
                             model: int) -> int:
    """Hand count of the products one chip runs in a MoE train step
    (every layer checkpointed; the capacity of the global batch): the
    head's product forward and its two backward ones; each layer's
    forward, recomputed and its two backward ones.  A layer: q and o on
    the rank's flat share of the heads' columns, attention with rank 0's
    block of query heads (dbrx's 8 KV heads do not divide a 16-wide model
    axis: K and V are gathered and each rank attends with its own 3 query
    heads; llama4-scout's 40 query heads do not divide it either: Q is
    gathered too and rank 0 attends with 3 of them, ranks 8-15 with 2),
    k and v on its share of the KV columns, the router on the rank's
    tokens, and the expert products on its E/data experts at all C slots
    and d_ff/model (the down projection is recomputed: the combine's
    backward needs its output)."""
    Bl = B // data
    T = Bl * S
    H, hd, d = cfg.n_heads, cfg.head_dim, cfg.d_model
    hl, kvl = H * hd // model, cfg.n_kv_heads * hd // model
    ha = -(-H // model) * hd                   # rank 0's heads' columns
    E, k = cfg.moe_experts, cfg.moe_top_k
    C = int(B * S * k * 1.25 / E)
    El, fl, vl = E // data, cfg.d_ff // model, cfg.vocab // model

    def mm(m, k, n):
        return 2 * m * k * n
    layer_fwd = (mm(T, d, hl + 2 * kvl) + 2 * 2 * T * S * ha
                 + mm(T, hl, d) + mm(T, d, E)
                 + El * (2 * mm(C, d, fl) + mm(C, fl, d)))
    return 3 * mm(T, d, vl) + cfg.n_layers * 4 * layer_fwd


def smoke_flops_per_chip() -> dict:
    """Hand counts of the products one chip of the 2x2 smoke mesh runs in
    four of the dry run's smoke cells (2 layers of d 64; 4 heads and 2 KV
    heads of 16; d_ff 128; vocab 256: 128 a rank), as
    ``tests/test_torch_dryrun.py`` writes each out term by term:

    * qwen1.5-0.5b prefill_smoke (B 4, S 128): 2 sequences, half of the
      heads, of d_ff and of the vocab, every (q, kv) block pair, the
      head on the last position only;
    * qwen1.5-0.5b decode_smoke (B 8, a cache of 128): 4 rows, attending
      with the rank's 2 query heads and their KV head;
    * dbrx-132b train_smoke (B 8, S 128, top-2 of 4 experts, no remat):
      512 tokens, the router on them, the expert products on the rank's
      2 experts at all C = 640 slots and half of d_ff, every product
      forward and its two backward ones;
    * mamba2-130m decode_smoke (B 8; 8 heads of 16, state 16, a packed
      in_proj of 296 columns): 4 rows through the rank's 4 heads, the
      depthwise conv of their 64 x channels and the 32 B and C ones."""
    def mm(m, k, n):
        return 2 * m * k * n
    prefill = (mm(256, 64, 32 + 2 * 16) + 2 * 2 * 256 * 128 * 32
               + mm(256, 32, 64) + 3 * mm(256, 64, 64))
    decode = (mm(4, 64, 32 + 2 * 16) + 2 * 2 * 4 * 2 * 128 * 16
              + mm(4, 32, 64) + 3 * mm(4, 64, 64))
    moe = (mm(512, 64, 32 + 2 * 16) + 2 * 2 * 4 * 128 * 128 * 32
           + mm(512, 32, 64) + mm(512, 64, 4)
           + 2 * (2 * mm(640, 64, 64) + mm(640, 64, 64)))
    ssm = (mm(4, 64, 148) + (64 + 32) * mm(4, 4, 1) + 4 * 4 * mm(1, 16, 16)
           + mm(4, 64, 64))
    return {("qwen1.5-0.5b", "prefill_smoke"): 2 * prefill + mm(2, 64, 128),
            ("qwen1.5-0.5b", "decode_smoke"): 2 * decode + mm(4, 64, 128),
            ("dbrx-132b", "train_smoke"): 3 * (2 * moe + mm(512, 64, 128)),
            ("mamba2-130m", "decode_smoke"): 2 * ssm + mm(4, 64, 128)}


def dryrun_phase(tmp: pathlib.Path) -> None:
    """Phase 17: ``repro_torch.launch.dryrun --smoke`` (5 smoke cells on a
    2x2 mesh of a 4-rank placeholder world) and the full-width
    production cells DRYRUN_CELL, DRYRUN_MOE_CELL and DRYRUN_UNEVEN_CELL
    on the 16x16 mesh of a 256-rank world, four processes at once, fake
    tensors on the card; each must exit 0, write its records and launch
    no BWA-MEM kernel (each reports the counts of its own run), and each
    record is printed.  The dense production cell's per-chip flops must
    equal ``dense_train_flops_per_chip`` and its peak DRYRUN_PEAK_BYTES
    (the counts of torch 2.13 on the CPU), the two MoE ones'
    ``moe_train_flops_per_chip``, four smoke cells' flops
    ``smoke_flops_per_chip``."""
    t_phase = time.perf_counter()
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                               if p])}
    base = [sys.executable, "-c", DRYRUN_CHILD]
    runs = {"smoke": base + ["--smoke", "--out-dir", str(tmp / "smoke")]}
    for key, (arch, shape) in (("cell", DRYRUN_CELL),
                               ("moe", DRYRUN_MOE_CELL),
                               ("uneven", DRYRUN_UNEVEN_CELL)):
        runs[key] = base + ["--arch", arch, "--shape", shape, "--q-block",
                            str(DRYRUN_Q_BLOCK), "--out-dir", str(tmp / key)]
    procs = {k: subprocess.Popen(argv, cwd=ROOT, env=env, text=True,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT)
             for k, argv in runs.items()}
    walls, launches = {}, {}
    for k, proc in procs.items():
        try:
            out, _ = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        walls[k] = time.perf_counter() - t_phase
        if proc.returncode != 0:
            raise AssertionError(f"dryrun {k} exited {proc.returncode}:\n"
                                 + out[-3000:])
        got = [ln for ln in out.splitlines() if ln.startswith("LAUNCHES ")]
        if len(got) != 1:
            raise AssertionError(f"dryrun {k} reported no launch counts:\n"
                                 + out[-3000:])
        launches[k] = json.loads(got[0][len("LAUNCHES "):])
        if not launches[k] or any(launches[k].values()):
            raise AssertionError(f"dryrun {k} launched BWA-MEM kernels: "
                                 f"{launches[k]}")
    recs = [json.loads(f.read_text()) for d in runs
            for f in sorted((tmp / d).glob("*.json"))]
    if len(recs) != 8:
        raise AssertionError(f"dryrun wrote {len(recs)} records, not 8")
    for r in recs:
        rf, c = r["roofline"], r["collectives"]
        if not (r["cost"]["flops"] > 0 and c["counts"]
                and r["device_type"] == "cuda"):
            raise AssertionError(f"dryrun record {r['arch']} {r['shape']}: "
                                 f"{r['cost']} {c['counts']}")
        phase("dryrun_cell", arch=r["arch"], shape=r["shape"],
              mesh=r["mesh"], run_s=f"{r['run_s']:.2f}",
              flops_per_chip=f"{r['cost']['flops']:.6g}",
              model_flops_per_chip=f"{rf['model_flops_per_chip']:.6g}",
              coll_counts=json.dumps(c["counts"], separators=(",", ":")),
              coll_bytes=json.dumps({k: int(v) for k, v in
                                     c["bytes_by_kind"].items()},
                                    separators=(",", ":")),
              compute_s=f"{rf['compute_s']:.6g}",
              memory_s=f"{rf['memory_s']:.6g}",
              collective_s=f"{rf['collective_s']:.6g}",
              dominant=rf["dominant"],
              roofline_fraction=f"{rf['roofline_fraction']:.6g}",
              argument_bytes=r["memory"]["argument_bytes"],
              peak_bytes=r["memory"]["peak_bytes"])
    by_cell = {(r["arch"], r["shape"]): r for r in recs}
    want = {key: count(get_arch(key[0]), SHAPES[key[1]].global_batch,
                       SHAPES[key[1]].seq_len, 16, 16)
            for key, count in ((DRYRUN_CELL, dense_train_flops_per_chip),
                               (DRYRUN_MOE_CELL, moe_train_flops_per_chip),
                               (DRYRUN_UNEVEN_CELL,
                                moe_train_flops_per_chip))}
    want.update(smoke_flops_per_chip())
    for (arch, sname), count in want.items():
        got = by_cell[arch, sname]["cost"]["flops"]
        if got != count:
            raise AssertionError(f"dryrun {arch} {sname}: {got} flops a "
                                 f"chip, the hand count is {count}")
    cell = by_cell[DRYRUN_CELL]
    if cell["memory"]["peak_bytes"] != DRYRUN_PEAK_BYTES:
        raise AssertionError(f"dryrun {DRYRUN_CELL}: peak "
                             f"{cell['memory']['peak_bytes']} bytes a chip, "
                             f"not {DRYRUN_PEAK_BYTES}")
    a2a = by_cell["dbrx-132b", "train_smoke"]["collectives"]["counts"].get(
        "all-to-all", 0)
    if a2a < 2:
        raise AssertionError(f"dryrun dbrx-132b train_smoke: {a2a} "
                             "all-to-alls, the tokens' exchange needs 2+")
    phase("dryrun", cells=len(recs), smoke_wall_s=f"{walls['smoke']:.2f}",
          cell_wall_s=f"{walls['cell']:.2f}",
          moe_cell_wall_s=f"{walls['moe']:.2f}",
          moe_cell_run_s=f"{by_cell[DRYRUN_MOE_CELL]['run_s']:.2f}",
          uneven_cell_wall_s=f"{walls['uneven']:.2f}",
          uneven_cell_run_s=f"{by_cell[DRYRUN_UNEVEN_CELL]['run_s']:.2f}",
          hand_counts=json.dumps({f"{a} {s}": v for (a, s), v in
                                  want.items()}, separators=(",", ":")),
          launches=json.dumps(launches, separators=(",", ":")),
          q_block=DRYRUN_Q_BLOCK, hardware=json.dumps(recs[-1]["hardware"],
                                                      separators=(",", ":")),
          wall_s=f"{time.perf_counter() - t_phase:.2f}")


def lm_train_mesh_phase(dev) -> None:
    """Phase 18: phase 15's train step (Qwen1.5-0.5B at full width in
    bf16, B=8, S=128) LM_MESH_STEPS times from the same params, without a
    mesh and then on a 1x1 cuda ``DeviceMesh`` over an NCCL group of one,
    the state and the batches laid out by the sharding specs: the losses
    and the params bit-identical, ``constrain`` reached in every layer,
    the warm ms a step of both."""
    t_phase = time.perf_counter()
    kernels.reset_launch_counts()
    cfg = get_arch(LM_ARCH)
    params, axes = lm.init_params(cfg, torch.Generator(dev).manual_seed(0),
                                  device=dev)
    batches = [synthetic_batch(cfg, LM_TRAIN_B, LM_TRAIN_S, i, device=dev)
               for i in range(LM_MESH_STEPS)]
    step_fn = make_train_step(cfg, q_block=LM_TRAIN_BLOCK,
                              kv_block=LM_TRAIN_BLOCK)

    def run(state, batches):
        losses, secs = [], []
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step_fn(state, b)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(loss)
        return state, losses, secs

    plain, plain_losses, plain_s = run(
        {"params": params, "opt": adamw_init(params)}, batches)
    plain_params = plain["params"]
    del plain
    calls = [0]
    constrain = lm.constrain

    def counted(*a, **k):
        calls[0] += 1
        return constrain(*a, **k)
    torch.distributed.init_process_group(
        "nccl", store=torch.distributed.HashStore(), rank=0, world_size=1,
        device_id=torch.device("cuda", torch.cuda.current_device()))
    lm.constrain = counted
    try:
        mesh = make_host_mesh("cuda")
        rules = rules_for(cfg, mesh)
        ms = moment_specs(axes, params, mesh, rules)
        state = distribute(
            {"params": params, "opt": adamw_init(params)},
            {"params": make_param_specs(axes, params, mesh, rules),
             "opt": {"step": Sharding(mesh, P()), "mu": ms, "nu": ms}})
        with active_mesh(mesh):
            sharded = [distribute(b, make_batch_specs(b, mesh))
                       for b in batches]
            state, losses, secs = run(state, sharded)
        same_losses = all(torch.equal(a.full_tensor(), b)
                          for a, b in zip(losses, plain_losses))
        same_params = all(torch.equal(a.full_tensor(), b) for a, b in zip(
            tree_leaves(state["params"]), tree_leaves(plain_params)))
        placements = sorted({str(tuple(p.placements))
                             for p in tree_leaves(state["params"])})
    finally:
        lm.constrain = constrain
        torch.distributed.destroy_process_group()
    if not (same_losses and same_params):
        raise AssertionError(f"lm_train_mesh: losses identical "
                             f"{same_losses}, params identical {same_params}")
    if calls[0] < cfg.n_layers * LM_MESH_STEPS:
        raise AssertionError(f"lm_train_mesh: constrain reached "
                             f"{calls[0]} times in {LM_MESH_STEPS} steps of "
                             f"{cfg.n_layers} layers")
    require_no_launches("[lm_train_mesh]")
    phase("lm_train_mesh", arch=LM_ARCH, dtype=cfg.dtype, B=LM_TRAIN_B,
          S=LM_TRAIN_S, mesh="1x1", backend="nccl", steps=LM_MESH_STEPS,
          losses=",".join(repr(float(x)) for x in plain_losses),
          identical=True, constrain_calls=calls[0],
          placements=json.dumps(placements, separators=(",", ":")),
          warm_ms_mesh=f"{statistics.mean(secs[1:]) * 1e3:.3f}",
          warm_ms_plain=f"{statistics.mean(plain_s[1:]) * 1e3:.3f}",
          first_step_s_mesh=f"{secs[0]:.3f}",
          first_step_s_plain=f"{plain_s[0]:.3f}",
          wall_s=f"{time.perf_counter() - t_phase:.2f}",
          card=smi("name,power.limit").replace(" ", "_"))


# ---------------------------------------------------------------------
# phase 19: the original organisation (the baseline engine)
# ---------------------------------------------------------------------

def baseline_phase(idx, dev, reads, names, body: list[str], stages: dict,
                   r1, r2, pes) -> None:
    """Phase 19: the ``baseline`` engine, the original BWA-MEM (read by
    read, the scalar SMEM oracle, one compressed-SA LF walk a lookup,
    the scalar ``ksw_extend``) on the host, with the launch counters at
    0 just before and read just after: no kernel may launch.  Its SAM of
    phase 5's first reads must be phase 5's lines, its SAM of phase 7's
    first pairs (stats frozen from phase 4's rescue sample) the ``cuda``
    engine's on the card.  Then each stage's seconds a read beside phase
    5's, and ``sal_compressed`` (both occ layouts) on the card against
    ``sal_direct`` on the SA rows of phase 5's SMEM."""
    t_phase = time.perf_counter()
    n, npairs = N_BASELINE_READS, N_BASELINE_PAIRS
    base = AlignOptions(engine="baseline", device=str(dev))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    se = Aligner(idx, base, telemetry=True).align(reads[:n], names=names[:n])
    se_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pe_base = Aligner(idx, base, pe_stats=pes).align_pairs(r1[:npairs],
                                                           r2[:npairs])
    pe_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    if any(launches.values()):
        raise AssertionError(f"the baseline engine launched kernels: "
                             f"{launches}")
    if se.sam() != lines_of(body, names[:n]):
        raise AssertionError("baseline SAM differs from phase 5's lines")
    card_pe = Aligner(idx, device=dev, pe_stats=pes).align_pairs(
        r1[:npairs], r2[:npairs]).sam()
    if pe_base.sam() != card_pe:
        raise AssertionError("baseline PE SAM differs from the cuda "
                             "engine's")
    card = smi("name,power.limit").replace(" ", "_")
    phase("baseline", reads=n, pairs=npairs, se_s=f"{se_s:.3f}",
          pe_s=f"{pe_s:.3f}", se_s_per_read=f"{se_s / n:.6f}",
          identical_to_mem=True, identical_to_cuda_pe=True,
          launches=json.dumps(launches, separators=(",", ":")), card=card)
    per_read = {}
    for st in BASELINE_STAGES:
        b = float(se.stats.get(f"time_{st}_s", 0.0)) / n
        c = float(stages.get(st, 0.0)) / N_READS
        per_read[st] = {"baseline_s": round(b, 9), "card_s": round(c, 9),
                        "ratio": round(b / c, 3) if c else None}
    phase("baseline_stages", per_read=json.dumps(per_read,
                                                separators=(",", ":")),
          card=card)

    # SAL on the card: the LF walk against the uncompressed SA's gather
    opt = PipelineOptions(device=str(dev))
    lens = np.full(len(reads), reads.shape[1], np.int64)
    mems = collect_smems_batch(idx, reads, lens, opt.mem,
                               occ=attach_occ_config(idx, dev))
    fm = idx.device(dev)
    looked_up = []

    def recording(fm, rows, out=None):
        looked_up.append(rows)
        return sal_direct(fm, rows, out)
    sal_mod.sal_direct = recording
    try:
        seeds_from_intervals(idx, mems, opt.mem.max_occ, device=dev)
    finally:
        sal_mod.sal_direct = sal_direct
    (rows,) = looked_up
    direct = sal_direct(fm, rows)
    walk = {}
    for layout, eta32 in (("eta32", True), ("eta128", False)):
        vals, steps = sal_compressed(fm, rows, occ_eta32=eta32)
        if not torch.equal(vals, direct):
            raise AssertionError(f"sal_compressed ({layout}) differs from "
                                 f"sal_direct")
        walk[layout] = (cuda_ms(lambda e=eta32: sal_compressed(
            fm, rows, occ_eta32=e)), steps)
    direct_ms = cuda_ms(lambda: sal_direct(fm, rows))
    steps = walk["eta32"][1].double()
    phase("baseline_sal", reads=len(reads), rows=rows.numel(),
          mean_steps=f"{float(steps.mean()):.3f}",
          max_steps=int(steps.max()),
          compressed_eta32_ms=f"{walk['eta32'][0]:.4f}",
          compressed_eta128_ms=f"{walk['eta128'][0]:.4f}",
          direct_ms=f"{direct_ms:.4f}",
          eta32_over_direct=f"{walk['eta32'][0] / direct_ms:.1f}",
          wall_s=f"{time.perf_counter() - t_phase:.2f}", card=card)


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
        results = check_ext(idx, dev, [(which, torch.stack(st))
                                       for which, st in rounds])
        del rounds
        blocks = {f"real{j}": (b, BSWParams())
                  for j, b in enumerate(sample)}
        blocks.update(synthetic_bsw_blocks())
        results.update(check_bsw(blocks, dev))
        p1, p2, _ = simulate_pairs(ref, N_RESCUE_PAIRS, READ_LEN, seed=11,
                                   **PAIR_SIM)
        rblocks, rstats, pes_r, gcalls, seeds_r = rescue_blocks(idx, p1, p2,
                                                                dev)
        phase("rescue_sample", pairs=N_RESCUE_PAIRS,
              rescue_tasks=rstats["rescue_tasks"],
              rescue_bsw=rstats["rescue_bsw"], fr_failed=pes_r[1].failed,
              fr_avg=f"{pes_r[1].avg:.2f}")
        results["bsw"].update(check_rescue_bsw(rblocks, dev))
        del rblocks
        # finalize's regions: the 512 reads' in one launch as the main
        # path makes it, both ends' and the rescued mates' of the rescue
        # sample, and the synthetic sets
        se_calls = []
        with recording_galign(se_calls):
            run_se_batched(idx, reads[:N_SAMPLE_READS],
                           PipelineOptions(device=str(dev)), occ=cfg)
        if len(se_calls) != 1 or len(gcalls) != 2:
            raise AssertionError(f"galign calls: SE {len(se_calls)}, PE "
                                 f"{[len(c) for c in gcalls]}")
        results.update(check_galign(
            {"real_se": se_calls[0], "pe_ends": gcalls[0],
             "rescued": gcalls[1], **synthetic_galign_tasks()}, dev))
        del se_calls, gcalls
        # mate rescue's anchor search: the rescue sample's real candidates
        # and the synthetic sets
        results.update(check_diagseed(
            {"real": (idx.seq, *seeds_r[:3]), **synthetic_diagseed_sets()},
            dev))
        del seeds_r

        # 5. main path through the CLI
        fq = tmp / "reads.fq"
        names = [f"read{r}" for r in range(N_READS)]
        write_fastq(fq, reads, names)
        sam, prof = tmp / "out.sam", tmp / "prof.json"
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with collector_time() as gct:
            t0 = time.perf_counter()
            rc = cli.main(["mem", str(fa), str(fq), "-o", str(sam),
                           "--device", "cuda", "-b", str(N_READS), "--no-pg",
                           "--profile", str(prof)])
            torch.cuda.synchronize()
            wall_mem = time.perf_counter() - t0
        launches = kernels.launch_counts()
        if rc != 0:
            raise AssertionError(f"repro_torch.cli mem exited {rc}")
        payload = obs.read_profile(prof)
        snap = payload["snapshot"]
        picked = snap["occ_kernel"]    # one batch: one "layout/block"
        if not isinstance(picked, str):
            raise AssertionError(f"mem ran {len(picked)} batches, not one")
        picked = picked.split("/")[0]
        for k in (f"fmocc_ext_{picked}", "bsw", "galign"):
            if launches[k] <= 0:
                raise AssertionError(f"kernel {k} was not launched on the "
                                     f"main path")
        body = sam_body(sam)
        share = check_records(body, names, truth)
        bd = payload["breakdown"]
        stages = {r["stage"]: r["time_s"] for r in bd["stages"]
                  if r["time_s"]}
        phase("mem", reads=N_READS, wall_s=f"{wall_mem:.2f}",
              reads_per_s=f"{N_READS / wall_mem:.1f}", occ_kernel=picked,
              gc_s=f"{gct['gc_s']:.3f}", gc_full=gct["gc_full"],
              launches=json.dumps(launches, separators=(",", ":")),
              smem_rounds=int(snap["smem_rounds"]),
              smem_h2d_bytes=int(snap["smem_h2d_bytes"]),
              smem_d2h_bytes=int(snap["smem_d2h_bytes"]),
              truth_share=f"{share:.4f}")
        phase("breakdown", stages=json.dumps(stages, separators=(",", ":")),
              kernels=json.dumps(bd.get("kernels", {}),
                                 separators=(",", ":")),
              unattributed_s=bd["unattributed_s"])
        finalize_split(snap, "finalize_split")

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

        # 7. paired-end main path through the CLI
        pe_run = mem_pe(fa, tmp, ref)
        launches_pe = pe_run["launches"]
        for k in (f"fmocc_ext_{pe_run['occ_kernel']}", "bsw", "galign"):
            if launches_pe[k] <= 0:
                raise AssertionError(f"kernel {k} was not launched on the "
                                     f"PE path")
        for k in ("bsw", "galign"):
            if pe_run["rescue_launches"][k] <= 0:
                raise AssertionError(f"mate rescue launched no {k} kernel")
        if launches_pe["diagseed"] != 1:
            raise AssertionError(f"the PE batch's rescue plan launched "
                                 f"diagseed {launches_pe['diagseed']} times, "
                                 f"not once")

        # 8. the card's PE SAM against the CPU path's on the first pairs
        cpu_vs_card_pe(fa, pe_run["fq1"], pe_run["fq2"])

        # 9. sharded mem with run logs, live files, traces and a merge
        live_export_cost(prof, wall_mem)
        launches_shard = mem_shard(fa, tmp, reads, body)

        # 10. memdist with an injected kill, against mem -K
        launches_memdist = memdist_se(fa, tmp, reads)

        # 11. memdist on pairs, against mem -K --pe-bootstrap
        launches_memdist_pe = memdist_pe(fa, tmp, pe_run["r1"],
                                         pe_run["r2"])

        # 12. the alignment server: concurrent clients, one batch each
        launches_serve = serve_phase(idx, dev, tmp, reads, sam, pe_run["r1"],
                                     pe_run["r2"], pes_r)

    # 13. the LM serving path: Qwen1.5-0.5B at full width in bf16
    lm_serve_phase(dev)

    # 14. the LM path in float32: decode vs forward, the card vs the CPU
    lm_exact_phase(dev)

    # 15. LM training: Qwen1.5-0.5B at full width in bf16, a checkpoint,
    # a resume
    with tempfile.TemporaryDirectory() as tmp:
        lm_train_phase(dev, pathlib.Path(tmp))

    # 16. LM training in float32: the card against the CPU
    lm_train_exact_phase(dev)

    # 17. the dry run: smoke cells and two production cells, counted
    with tempfile.TemporaryDirectory() as tmp:
        dryrun_phase(pathlib.Path(tmp))

    # 18. a train step on a 1x1 mesh, bit-identical to the unsharded one
    lm_train_mesh_phase(dev)

    # 19. the original organisation (the baseline engine) against phases
    # 5 and 7, and the compressed SA's walk on the card
    baseline_phase(idx, dev, reads, names, body, stages, pe_run["r1"],
                   pe_run["r2"], pes_r)

    report = []
    for name, (source, replaces) in KERNELS.items():
        r = results[name]
        report.append({"name": name, "route": "cuda", "source": source,
                       "replaces": replaces, "launches": launches[name],
                       "launches_pe": launches_pe[name],
                       "launches_mem_shard": launches_shard[name],
                       "launches_memdist": launches_memdist[name],
                       "launches_memdist_pe": launches_memdist_pe[name],
                       "launches_serve": launches_serve[name],
                       "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                       "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                       "bound_by": r["bound_by"], "library_ms": None,
                       "cold_ms": r.get("cold_ms"),
                       **{k: v for k, v in r.items()
                          if k.startswith("rescue_")}})
    phase("done", total_s=f"{time.perf_counter() - t_start:.1f}")
    print(card, flush=True)
    print(json.dumps({"kernels": report}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
