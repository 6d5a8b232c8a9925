"""Finalize's banded global alignment through the galign CUDA kernel
(``csrc/galign.cu``).

``galign_call`` is the wrapper over packed task arrays.  For tensors on
the CPU it runs the plain PyTorch version (``ref.galign_ref``); for
tensors on a CUDA device it reads the lengths once to the host, makes the
launch's ``plan`` there and launches (``galign_launch``); any other device
raises.  A value range beyond int32 (ValueError) or a traceback the
reference could not take (RuntimeError) raises too.

``plan`` is the host half of a launch, a pure function of the lengths:
the runs' stride, the columns a lane holds (``k``), which path each task
takes (its decisions in shared memory, in global scratch, or the wide
path for a band of 1,024 columns or more), each path's tasks longest
first, the shared-memory slot of a warp and the global scratch offsets.

``global_align_batch`` is the pipeline's entry: it packs ``(q, t, w)``
tasks, plans them from the host-side lengths, runs them on ``device`` in
one call with no device-to-host read before the launch, and returns
``core.sam.global_align_cigar``'s ``(score, cigar)`` for each, equal to
it bit for bit.  It replaces that host function on the ``cuda`` engine's
finalize (no Pallas counterpart).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from ... import obs
from ...core.bsw import BSWParams
from ...core.sam import _OPS
from .. import build
from .ref import NEG, galign_ref

#: warps (tasks) a CTA, as csrc/galign.cu's WARPS
WARPS = 4
#: the register path's columns a lane, one kernel each (csrc/galign.cu)
KS = (2, 4, 8, 16, 32)
#: bands this wide or wider take the wide path (32 lanes x KS[-1] columns)
WIDE = 32 * KS[-1]
#: dynamic shared memory a CTA may take on the H100 (227 KB)
SMEM_CTA_MAX = 232448
#: a warp's shared-memory slot at most; a task needing more takes the
#: global-decision path
SLOT_MAX = SMEM_CTA_MAX // WARPS

#: kernel launches by kernel name (reset by kernels.reset_launch_counts)
LAUNCHES = {"galign": 0}


def _up16(x):
    return (x + 15) // 16 * 16


@dataclass(frozen=True)
class Plan:
    """One launch's host-side numbers (``plan``)."""
    stride: int            # runs' row length, max(n + m, 1)
    most: int              # max n + m (check_range)
    k: int                 # register path: columns a lane
    slot: int              # bytes of shared memory a warp (shared path)
    order: np.ndarray      # (T,) int64 task ids: shared, global, wide
    n_smem: int
    n_global: int
    n_wide: int
    boff: np.ndarray       # (T,) int64 offsets into the global scratch
    roff: np.ndarray       # (T,) int64 offsets into the wide rows
    nbits: int             # bytes of global scratch
    nrows: int             # int32 of wide rows

    @property
    def smem_cta(self) -> int:
        """Dynamic shared memory of a CTA on the shared path."""
        return WARPS * self.slot


def plan(ns, ms, ws, slot_max: int = SLOT_MAX) -> Plan:
    """The launch plan of tasks of lengths ``ns``, ``ms`` and half-widths
    ``ws`` (host arrays).  A task's widest band row is W = min(m, 2w + 1)
    with the reference's w = max(w, |n - m| + 3); k is the least of
    ``KS`` with 32 k > W for every task below ``WIDE``; a row's decisions
    take RB = ceil(W / k) k / 2 bytes, and a task's slot is n RB bytes
    then 4 (n + m) for its runs, each rounded up to 16.  A slot over
    ``slot_max`` sends its task to global scratch, a band of ``WIDE`` or
    more to the wide path ((n + 1)(m + 1) decision bytes and 4 (m + 1)
    int32 of rows); tasks with n or m 0 take the shared path with a
    slot of 0."""
    n = np.asarray(ns, np.int64).reshape(-1)
    m = np.asarray(ms, np.int64).reshape(-1)
    w = np.asarray(ws, np.int64).reshape(-1)
    T = len(n)
    most = int((n + m).max()) if T else 0
    live = (n > 0) & (m > 0)
    band = np.where(live, np.minimum(m, 2 * np.maximum(
        w, np.abs(n - m) + 3) + 1), 0)
    wide = band >= WIDE
    k = next(k for k in KS if 32 * k > int(np.where(wide, 0, band).max(
        initial=0)))
    rb = -(-band // k) * (k // 2)
    slots = np.where(live, _up16(_up16(n * rb) + 4 * (n + m)), 0)
    path = np.where(wide, 2, (slots > slot_max).astype(np.int64))
    counts = np.bincount(path, minlength=3)
    # global scratch: a global task's slot, a wide task's decision bytes
    size = np.where(wide, _up16((n + 1) * (m + 1)), slots)
    gbytes = np.where(path > 0, size, 0)
    rows = np.where(wide, 4 * (m + 1), 0)
    return Plan(stride=max(most, 1), most=most, k=k,
                slot=int(np.where(path == 0, slots, 0).max(initial=0)),
                order=np.lexsort((-size, path)).astype(np.int64),
                n_smem=int(counts[0]), n_global=int(counts[1]),
                n_wide=int(counts[2]), boff=np.cumsum(gbytes) - gbytes,
                roff=np.cumsum(rows) - rows, nbits=int(gbytes.sum()),
                nrows=int(rows.sum()))


def check_range(ns, ms, p: BSWParams, most: int | None = None) -> None:
    """Raise ValueError unless int32 holds every value of every task
    (host lengths ``ns``, ``ms``, or their largest sum ``most``): the
    reference's values stay within |NEG| + (n + m + 2) times the largest
    step, and the kernel's prefix terms add at most (m + 1) times one
    more.  The kernel also keeps a row's scores (a, -b, -1 for N) as
    signed bytes, as BWA-MEM's own int8 score matrix does."""
    if not (-128 <= p.a <= 127 and -128 <= -p.b <= 127):
        raise ValueError(f"galign: scores a = {p.a}, -b = {-p.b} do not fit "
                         f"a signed byte")
    step = max(abs(p.a), abs(p.b), 1, abs(p.o_del) + abs(p.e_del),
               abs(p.o_ins) + abs(p.e_ins))
    if most is None:
        n, m = np.asarray(ns, np.int64), np.asarray(ms, np.int64)
        most = int((n + m).max()) if n.size else 0
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
    if dev.type == "cpu":
        check_range(ns, ms, p)
        return galign_ref(qs, ts, ns, ms, ws, p)
    lens = torch.stack([ns, ms, ws]).cpu().numpy()     # the one host read
    return galign_launch(qs, ts, ns, ms, ws, p, plan(*lens))


def galign_launch(qs: torch.Tensor, ts: torch.Tensor, ns: torch.Tensor,
                  ms: torch.Tensor, ws: torch.Tensor, p: BSWParams,
                  pl: Plan):
    """``galign_call`` on CUDA tensors whose ``plan`` the caller made from
    the same lengths on the host: no device-to-host read.  Launches one
    kernel a path that has tasks."""
    dev = qs.device
    if dev.type != "cuda":
        raise RuntimeError(f"galign_launch takes CUDA tensors, not {dev}")
    check_range(None, None, p, most=pl.most)
    T = qs.shape[0]
    for name, x, dt in (("qs", qs, torch.uint8), ("ts", ts, torch.uint8),
                        ("ns", ns, torch.int32), ("ms", ms, torch.int32),
                        ("ws", ws, torch.int32)):
        if x.device != dev or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"galign: {name} must be contiguous {dt} on "
                             f"{dev}")
    if ts.shape[0] != T or any(x.shape != (T,) for x in (ns, ms, ws)) \
            or len(pl.order) != T:
        raise ValueError("galign: task arrays disagree on T")
    score = torch.empty(T, dtype=torch.int32, device=dev)
    nruns = torch.empty(T, dtype=torch.int32, device=dev)
    runs = torch.empty((T, pl.stride), dtype=torch.int32, device=dev)
    if T == 0:
        return score, nruns, runs
    meta = to_device(np.concatenate([pl.order, pl.boff, pl.roff]), dev)
    bits = torch.empty(max(pl.nbits, 1), dtype=torch.uint8, device=dev)
    rows = torch.empty(max(pl.nrows, 1), dtype=torch.int32, device=dev)
    entry = build.library().galign
    ptr = meta.data_ptr()
    args = (qs.data_ptr(), ts.data_ptr(), qs.shape[1], ts.shape[1],
            ns.data_ptr(), ms.data_ptr(), ws.data_ptr(), ptr, pl.n_smem,
            pl.n_global, pl.n_wide, ptr + 8 * T, ptr + 16 * T,
            bits.data_ptr(), rows.data_ptr(), pl.k, pl.slot, p.a, p.b,
            p.o_del, p.e_del, p.o_ins, p.e_ins, pl.stride, score.data_ptr(),
            nruns.data_ptr(), runs.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    with obs.device_span("galign", dev, build.GATE):
        err = entry(*args)
    build.check(err, "galign")
    for count in (pl.n_smem, pl.n_global, pl.n_wide):
        if count:
            build.count_launch(LAUNCHES, "galign")
    return score, nruns, runs


def resident_ctas(pl: Plan) -> int:
    """CTAs of the shared path's kernel for ``pl`` that one SM holds at
    once (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    blocks = ctypes.c_int(0)
    err = build.library().galign_occupancy(pl.k, pl.smem_cta,
                                           ctypes.byref(blocks))
    build.check(err, "galign_occupancy")
    return blocks.value


def to_device(a: np.ndarray, dev) -> torch.Tensor:
    """A host array on ``dev``; on a card through pinned memory without
    waiting for the copy (the stream orders it)."""
    x = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(dev).type != "cuda":
        return x.to(dev)
    return x.pin_memory().to(dev, non_blocking=True)


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
        arrays = pack(tasks)
        args = [to_device(a, device) for a in arrays]
        if args[0].device.type != "cuda":
            return unpack(*galign_call(*args, p))
        return unpack(*galign_launch(*args, p, plan(*arrays[2:])))
