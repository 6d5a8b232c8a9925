"""What a traced run (``--trace 1``) reads besides the port's own spans
and counters: the inputs of each kernel launch in the window, the work
they make (``frozen.work``), and the device's activity from
``torch.profiler``.

``KernelInputs`` wraps the port's three kernel entries while the window
runs and keeps their inputs: ``core.smem``'s ``ext_round`` (the round's
k, l, s rows, views of the tensor the round sent, so nothing is
copied), ``kernels.bsw.bsw_extend_kernel`` (each block's task lists and
padded widths) and ``kernels.galign.global_align_batch`` (each call's
tasks and the runs it returned).  ``work_s`` turns them into the least
time of each kernel's launches, once the window has closed.

``DeviceTrace`` reads the profiler's events: the device time of each
kernel by name, the union of device activity over the window, the
device operations that took the most time, and the idle gaps summed by
the port's innermost host span at each gap (the port's own trace of
spans, ``obs.Telemetry(trace=True)``), the two clocks aligned on a
marker kernel launched first.
"""

from __future__ import annotations

import collections
import contextlib
import time

import numpy as np
import torch

from .frozen import work

#: profiler kernel names (substrings) of each port kernel
KERNEL_NAMES = {"fmocc": "ext_round_kernel", "bsw": "bsw_kernel",
                "galign": "galign"}
TOP = 10


class KernelInputs:
    def __init__(self):
        self.rounds: list = []       # (which, layout, k, l, s)
        self.bsw: list = []          # (queries, targets, h0s, ws, qmax, tmax)
        self.galign: list = []       # (tasks, runs)
        self.bsw_params = None

    @contextlib.contextmanager
    def recording(self):
        import repro_torch.core.smem as smem
        import repro_torch.kernels.bsw as bsw_pkg
        import repro_torch.kernels.galign as galign_pkg
        ext_round = smem.ext_round
        bsw_extend_kernel = bsw_pkg.bsw_extend_kernel
        global_align_batch = galign_pkg.global_align_batch

        def rec_round(fm, which, k, l, s, c, **kw):
            self.rounds.append((which, kw.get("layout", "eta32"), k, l, s))
            return ext_round(fm, which, k, l, s, c, **kw)

        def rec_bsw(queries, targets, h0s, p, ws=None, qmax=None,
                    tmax=None, **kw):
            self.bsw_params = p
            self.bsw.append((list(queries), list(targets), list(h0s),
                             None if ws is None else list(ws), qmax, tmax))
            return bsw_extend_kernel(queries, targets, h0s, p, ws, qmax,
                                     tmax, **kw)

        def rec_galign(tasks, p, **kw):
            out = global_align_batch(tasks, p, **kw)
            self.galign.append((list(tasks),
                                sum(len(cig) for _, cig in out)))
            return out

        smem.ext_round = rec_round
        bsw_pkg.bsw_extend_kernel = rec_bsw
        galign_pkg.global_align_batch = rec_galign
        try:
            yield self
        finally:
            smem.ext_round = ext_round
            bsw_pkg.bsw_extend_kernel = bsw_extend_kernel
            galign_pkg.global_align_batch = global_align_batch

    def work_s(self, device) -> dict:
        """Least seconds of all recorded launches, by kernel (a kernel
        with no launch is left out)."""
        out = {}
        if self.rounds:
            out["fmocc"] = sum(
                work.ext_bound_s(torch.stack((k, l, s)), which, layout)
                for which, layout, k, l, s in self.rounds)
        if self.bsw:
            out["bsw"] = self._bsw_s(device)
        if self.galign:
            out["galign"] = sum(
                work.galign_bound_s(tasks, work.galign_cells(tasks), runs)
                for tasks, runs in self.galign)
        return out

    def _bsw_s(self, device) -> float:
        """Each block's bound from its own cells and padded widths; the
        cells are counted task by task (a task's banded cells do not
        depend on its block), in large blocks of similar lengths."""
        owner = np.concatenate([np.full(len(qs), i) for i, (qs, *_)
                                in enumerate(self.bsw)])
        qs = [q for blk in self.bsw for q in blk[0]]
        ts = [t for blk in self.bsw for t in blk[1]]
        hs = [h for blk in self.bsw for h in blk[2]]
        ws = [w for blk in self.bsw
              for w in (blk[3] or [self.bsw_params.w] * len(blk[0]))]
        cells = work.bsw_cells_each(qs, ts, hs, ws, self.bsw_params, device)
        per_block = np.bincount(owner, weights=cells,
                                minlength=len(self.bsw))
        return sum(work.bsw_bound_s(int(c), len(blk[0]), blk[4], blk[5])
                   for c, blk in zip(per_block, self.bsw))


def _events(prof):
    """(name, start_ns, duration_ns) of every device event."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        try:
            start, dur = e.start_ns(), e.duration_ns()
        except AttributeError:
            start, dur = e.start_us() * 1000, e.duration_us() * 1000
        out.append((e.name(), int(start), int(dur)))
    return out


def _union(iv: np.ndarray) -> tuple[float, np.ndarray]:
    """Total length of the union of intervals (n, 2), and the gaps
    between them (m, 2), in the intervals' units."""
    if not len(iv):
        return 0.0, np.zeros((0, 2))
    iv = iv[np.argsort(iv[:, 0])]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.concatenate([[True], iv[1:, 0] > ends[:-1]])
    starts = iv[new, 0]
    stops = np.concatenate([ends[np.flatnonzero(new)[1:] - 1], [ends[-1]]])
    gaps = np.stack([stops[:-1], starts[1:]], axis=1)
    return float((stops - starts).sum()), gaps


def _label_gaps(gaps: np.ndarray, spans: list) -> dict:
    """Seconds of idle gaps by the innermost span (name, t0, t1) open
    on the host at each gap's middle; "outside spans" where none is."""
    marks = [(t0, 0, i) for i, (_, t0, _) in enumerate(spans)]
    marks += [(t1, 2, i) for i, (_, _, t1) in enumerate(spans)]
    marks += [((a + b) / 2, 1, j) for j, (a, b) in enumerate(gaps)]
    marks.sort()
    open_: list = []
    out: dict = collections.defaultdict(float)
    for _, kind, i in marks:
        if kind == 0:
            open_.append(i)
        elif kind == 2:
            if i in open_:
                open_.remove(i)
        else:
            name = spans[open_[-1]][0] if open_ else "outside spans"
            out[name] += float(gaps[i][1] - gaps[i][0])
    return out


class DeviceTrace:
    """The profiler over the window, with a marker kernel launched first
    at a known host time."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.t_mark = 0.0

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize(self.device)
        self.t_mark = time.perf_counter()
        torch.ones(1, device=self.device).add_(1)
        torch.cuda.synchronize(self.device)
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize(self.device)
        self.prof.__exit__(*exc)
        return False

    def read(self, t0: float, t1: float, spans: list) -> dict:
        """Device numbers of the host window [t0, t1] (perf_counter):
        ``busy_s``, ``window_s``, ``kernel_s`` by port kernel,
        ``device_ops`` and ``idle_gaps`` (top ``TOP``)."""
        ev = _events(self.prof)
        if not ev:
            return {}
        ev.sort(key=lambda e: e[1])
        mark = ev[0][1]
        to_host = lambda ns: self.t_mark + (ns - mark) / 1e9  # noqa: E731
        iv = np.array([(to_host(s), to_host(s + d)) for _, s, d in ev[1:]])
        iv = np.clip(iv, t0, t1) if len(iv) else iv.reshape(0, 2)
        busy, gaps = _union(iv)
        if len(iv):
            first, last = iv[:, 0].min(), iv[:, 1].max()
            gaps = np.concatenate([[[t0, first]], gaps, [[last, t1]]])
            gaps = gaps[gaps[:, 1] > gaps[:, 0]]
        by_name: dict = collections.defaultdict(float)
        for name, _, d in ev[1:]:
            by_name[name] += d / 1e9
        kernel_s = {k: sum(v for n, v in by_name.items() if sub in n)
                    for k, sub in KERNEL_NAMES.items()}
        idle = _label_gaps(gaps, spans)
        top = lambda d: [[k, v] for k, v in sorted(  # noqa: E731
            d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"busy_s": busy, "window_s": t1 - t0, "kernel_s": kernel_s,
                "device_ops": top(by_name), "idle_gaps": top(idle)}


def host_spans(tracer) -> list:
    """(name, t0, t1) in perf_counter seconds of the port's trace
    events."""
    epoch = tracer._epoch
    return [(e["name"], epoch + e["ts"] / 1e6,
             epoch + (e["ts"] + e["dur"]) / 1e6)
            for e in tracer.to_dict()["traceEvents"] if e.get("ph") == "X"]
