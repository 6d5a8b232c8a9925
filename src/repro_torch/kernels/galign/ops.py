"""Finalize's banded global alignment through the galign CUDA kernel
(``csrc/galign.cu``).

``galign_call`` is the wrapper over packed task arrays.  For tensors on
the CPU it runs the plain PyTorch version (``ref.galign_ref``); for
tensors on a CUDA device it launches the kernel, one warp a task, with
its scratch (a byte a DP cell, two rows of H and F a task) allocated
here; any other device raises.  A value range beyond int32 (ValueError)
or a traceback the reference could not take (RuntimeError) raises too.

``global_align_batch`` is the pipeline's entry: it packs ``(q, t, w)``
tasks, runs them on ``device`` in one call and returns
``core.sam.global_align_cigar``'s ``(score, cigar)`` for each, equal to
it bit for bit.  It replaces that host function on the ``cuda`` engine's
finalize (no Pallas counterpart).
"""

from __future__ import annotations

import numpy as np
import torch

from ... import obs
from ...core.bsw import BSWParams
from ...core.sam import _OPS
from .. import build
from .ref import NEG, galign_ref

#: warps (tasks) a CTA
WARPS = 4

#: kernel launches by kernel name (reset by kernels.reset_launch_counts)
LAUNCHES = {"galign": 0}


def check_range(ns: torch.Tensor, ms: torch.Tensor, p: BSWParams) -> None:
    """Raise ValueError unless int32 holds every value of every task:
    the reference's values stay within |NEG| + (n + m + 2) times the
    largest step, and the kernel's prefix terms add at most (m + 1)
    times one more."""
    step = max(abs(p.a), abs(p.b), 1, abs(p.o_del) + abs(p.e_del),
               abs(p.o_ins) + abs(p.e_ins))
    most = int((ns.long() + ms.long()).max()) if ns.numel() else 0
    if -NEG + (2 * most + 4) * step >= 1 << 30:
        raise ValueError(f"galign: tasks of n + m = {most} with a largest "
                         f"penalty of {step} leave int32's range")


def galign_call(qs: torch.Tensor, ts: torch.Tensor, ns: torch.Tensor,
                ms: torch.Tensor, ws: torch.Tensor, p: BSWParams):
    """qs (T, nmax) / ts (T, mmax) uint8 codes 0..4; ns, ms, ws (T,)
    int32 -> (score (T,), nruns (T,), runs (T, max(n + m, 1))) int32, a
    run ``count << 2 | op`` (op 0 M, 1 I, 2 D) in CIGAR order."""
    dev = qs.device
    if dev.type not in ("cpu", "cuda"):
        raise RuntimeError(f"galign has no kernel for device {dev}")
    check_range(ns, ms, p)
    if dev.type == "cpu":
        return galign_ref(qs, ts, ns, ms, ws, p)
    T = qs.shape[0]
    for name, x, dt in (("qs", qs, torch.uint8), ("ts", ts, torch.uint8),
                        ("ns", ns, torch.int32), ("ms", ms, torch.int32),
                        ("ws", ws, torch.int32)):
        if x.device != dev or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"galign: {name} must be contiguous {dt} on "
                             f"{dev}")
    if ts.shape[0] != T or any(x.shape != (T,) for x in (ns, ms, ws)):
        raise ValueError("galign: task arrays disagree on T")
    n64, m64 = ns.long(), ms.long()
    stride = max(int((n64 + m64).max()) if T else 0, 1)
    cells = (n64 + 1) * (m64 + 1)
    boff = torch.cumsum(cells, 0) - cells
    roff = torch.cumsum(4 * (m64 + 1), 0) - 4 * (m64 + 1)
    nbits = int(cells.sum()) if T else 0
    nrows = int(4 * (m64 + 1).sum()) if T else 0
    bits = torch.empty(max(nbits, 1), dtype=torch.uint8, device=dev)
    rows = torch.empty(max(nrows, 1), dtype=torch.int32, device=dev)
    score = torch.empty(T, dtype=torch.int32, device=dev)
    nruns = torch.empty(T, dtype=torch.int32, device=dev)
    runs = torch.empty((T, stride), dtype=torch.int32, device=dev)
    if T == 0:
        return score, nruns, runs
    lib = build.library()
    err = lib.galign(qs.data_ptr(), ts.data_ptr(), qs.shape[1], ts.shape[1],
                     ns.data_ptr(), ms.data_ptr(), ws.data_ptr(),
                     boff.data_ptr(), roff.data_ptr(), bits.data_ptr(),
                     rows.data_ptr(), T, p.a, p.b, p.o_del, p.e_del, p.o_ins,
                     p.e_ins, stride, score.data_ptr(), nruns.data_ptr(),
                     runs.data_ptr(), WARPS,
                     torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "galign")
    build.count_launch(LAUNCHES, "galign")
    return score, nruns, runs


def pack(tasks) -> list[np.ndarray]:
    """``(q, t, w)`` tasks -> qs (T, nmax), ts (T, mmax) uint8 codes
    (clipped to 0..4, padded with 4) and ns, ms, ws (T,) int32."""
    T = len(tasks)
    ns = np.array([len(q) for q, _, _ in tasks], np.int32)
    ms = np.array([len(t) for _, t, _ in tasks], np.int32)
    ws = np.array([w for _, _, w in tasks], np.int32)
    qs = np.full((T, max(int(ns.max()) if T else 0, 1)), 4, np.uint8)
    ts = np.full((T, max(int(ms.max()) if T else 0, 1)), 4, np.uint8)
    for k, (q, t, _) in enumerate(tasks):
        qs[k, :len(q)] = np.clip(q, 0, 4)
        ts[k, :len(t)] = np.clip(t, 0, 4)
    return [qs, ts, ns, ms, ws]


def unpack(score, nruns, runs) -> list[tuple[int, list[tuple[int, str]]]]:
    """The wrapper's arrays -> ``[(score, [(count, op), ...]), ...]``;
    raises RuntimeError for a task marked bad (nruns -1)."""
    score, nruns, runs = (np.asarray(x.cpu()) for x in (score, nruns, runs))
    if (nruns < 0).any():
        raise RuntimeError(f"galign: the traceback of task "
                           f"{int(np.flatnonzero(nruns < 0)[0])} leaves the "
                           f"band")
    return [(int(s), [(int(r) >> 2, _OPS[int(r) & 3]) for r in rr[:k]])
            for s, k, rr in zip(score, nruns, runs)]


def global_align_batch(tasks, p: BSWParams, *, device):
    """``core.sam.global_align_cigar(q, t, w, p)`` for every ``(q, t,
    w)`` task, in one call on ``device``: ``[(score, cigar), ...]``."""
    if not tasks:
        return []
    with obs.span("kernel.galign", cat="kernel", tasks=len(tasks)):
        obs.count("kernel_galign_dispatches")
        obs.count("galign_tasks", len(tasks))
        args = [torch.from_numpy(a).to(device) for a in pack(tasks)]
        return unpack(*galign_call(*args, p))
