"""Trace spans + the ambient telemetry context.

Two cooperating pieces:

* ``TraceCollector`` — a thread-safe in-process buffer of Chrome
  trace-event objects (``ph: "X"`` complete events with microsecond
  ``ts``/``dur``), serialized as the ``{"traceEvents": [...]}`` JSON
  that chrome://tracing and Perfetto load directly.  Nesting is implied
  by containment per thread, exactly how those UIs render it.  Beside
  the host's spans it keeps a device track (``device_span``: each kernel
  launch timed by a pair of CUDA events) and clock pairs
  (``perf_counter``, ``time.time_ns()``) taken back to back, so a reader
  can place the spans on another tool's Unix-clock timeline (the
  profiler's).  ``to_dict`` holds the host's spans only; ``save``
  writes the device track too.

* the **ambient telemetry context** — a thread-local
  ``(MetricsRegistry, TraceCollector)`` pair that instrumented code
  resolves through ``span``/``count``/``observe``.  When nothing is
  active (the default), ``span`` returns one shared no-op object and
  ``count``/``observe`` return immediately: the hot path pays a single
  thread-local read, nothing else — no allocation, no branching on
  options threaded through every stage.

``activate`` nests: the facade activates a run-level scope around a
whole ``stream_sam`` loop (catching I/O-side instrumentation) and a
fresh per-call registry inside each ``align`` call (so per-batch stats
merge associatively), restoring the outer scope on exit.  A scope
carries the index of the ``-K`` chunk it runs in (``chunk``), which a
nested scope inherits and every span and device event recorded in it
carries as ``args.chunk``.  A scope's device events are resolved when
it closes: one anchor event, one synchronize, one host stamp.

``GcClock`` sums the garbage collector's seconds and runs while it is
``running``; a traced ``stream_sam`` holds one for the stream's length.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import threading
import time

import torch

from .metrics import MetricsRegistry

#: trace thread id of device ``i``'s track (apart from the host threads')
DEVICE_TID = 1 << 20

_TLS = threading.local()


class _NullSpan:
    """Shared do-nothing context manager (telemetry disabled)."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class TraceCollector:
    """Bounded, thread-safe buffer of Chrome trace events."""

    def __init__(self, max_events: int = 1_000_000):
        self._lock = threading.Lock()
        self.max_events = max_events
        self.events: list[dict] = []
        self.dropped = 0
        self._epoch = time.perf_counter()
        self._pid = os.getpid()
        self._tids: dict[int, int] = {}
        self.device_events: list[dict] = []
        #: (perf_counter s, time.time_ns()) taken back to back: at
        #: creation and at each resolve, whose device events convert best
        #: through its own pair (the first one after them)
        self.clock_pairs: list[tuple[float, int]] = []
        self._pool: dict[int, list] = {}
        self.clock_pair()

    def clock_pair(self) -> float:
        """Stamp both clocks back to back, keep the pair, and return the
        ``perf_counter`` reading."""
        t, ns = time.perf_counter(), time.time_ns()
        with self._lock:
            self.clock_pairs.append((t, ns))
        return t

    def take_event(self, index: int):
        """A timing CUDA event for device ``index``, from the pool."""
        with self._lock:
            free = self._pool.get(index)
            if free:
                return free.pop()
        return torch.cuda.Event(enable_timing=True)

    def give_events(self, index: int, events) -> None:
        with self._lock:
            self._pool.setdefault(index, []).extend(events)

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            tid = self._tids[ident] = len(self._tids)
        return tid

    def complete(self, name: str, t0: float, dur: float,
                 cat: str = "stage", args: dict | None = None) -> None:
        """Record one complete ('X') event; t0 is a perf_counter stamp."""
        ev = {"name": name, "cat": cat, "ph": "X",
              "ts": (t0 - self._epoch) * 1e6, "dur": dur * 1e6,
              "pid": self._pid, "tid": self._tid()}
        if args:
            ev["args"] = dict(args)
        with self._lock:
            if len(self.events) + len(self.device_events) < self.max_events:
                self.events.append(ev)
            else:
                self.dropped += 1

    def device_complete(self, name: str, t0: float, dur: float,
                        index: int, args: dict | None = None) -> None:
        """Record one kernel's device time on device ``index``'s track;
        t0 is on the host's ``perf_counter`` clock."""
        ev = {"name": name, "cat": "device", "ph": "X",
              "ts": (t0 - self._epoch) * 1e6, "dur": dur * 1e6,
              "pid": self._pid, "tid": DEVICE_TID + index}
        if args:
            ev["args"] = dict(args)
        with self._lock:
            if len(self.events) + len(self.device_events) < self.max_events:
                self.device_events.append(ev)
            else:
                self.dropped += 1

    def instant(self, name: str, cat: str = "mark",
                args: dict | None = None) -> None:
        ev = {"name": name, "cat": cat, "ph": "i", "s": "t",
              "ts": (time.perf_counter() - self._epoch) * 1e6,
              "pid": self._pid, "tid": self._tid()}
        if args:
            ev["args"] = dict(args)
        with self._lock:
            if len(self.events) + len(self.device_events) < self.max_events:
                self.events.append(ev)
            else:
                self.dropped += 1

    def to_dict(self, device: bool = False) -> dict:
        """The trace as Chrome trace-event JSON: the host's events, and
        with ``device`` each device's track after them (named by a
        ``thread_name`` metadata event).  ``otherData`` holds the epoch
        of ``ts`` (``perf_counter`` seconds) and the clock pairs."""
        with self._lock:
            events = list(self.events)
            dev = list(self.device_events) if device else []
            pairs = list(self.clock_pairs)
            dropped = self.dropped
        for tid in sorted({e["tid"] for e in dev}):
            events.append({"name": "thread_name", "ph": "M",
                           "pid": self._pid, "tid": tid,
                           "args": {"name": f"cuda:{tid - DEVICE_TID}"}})
        return {"traceEvents": events + dev, "displayTimeUnit": "ms",
                "otherData": {"tool": "repro.obs", "dropped": dropped,
                              "epoch_perf_s": self._epoch,
                              "clock_pairs": [list(p) for p in pairs]}}

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(device=True), f)

    def __len__(self) -> int:
        with self._lock:
            return len(self.events) + len(self.device_events)


class Telemetry:
    """Per-``Aligner`` telemetry configuration + the run-long trace
    buffer.  Metrics registries are per-call (opened by the facade so
    per-batch Snapshots merge associatively); the trace collector — when
    tracing is requested — lives here and accumulates for the whole run.
    """

    def __init__(self, *, trace: bool = False, max_events: int = 1_000_000):
        self.tracer = TraceCollector(max_events) if trace else None

    def activate(self, registry: MetricsRegistry | None = None):
        """Context manager: make (registry, self.tracer) ambient for the
        calling thread; yields the registry (a fresh one by default)."""
        return activate(registry or MetricsRegistry(), self.tracer)


class GcClock:
    """The garbage collector's seconds, collections and full (generation
    2) collections while ``running``, summed by one ``gc.callbacks``
    hook.  The hook takes no lock: a collection may start inside any
    allocation, one made under a registry's or a tracer's lock included.
    So the sums go to the registry once, when the hook is removed, as
    ``time_gc_s``, ``gc_collections`` and ``gc_full``."""

    def __init__(self):
        self.seconds = 0.0
        self.collections = 0
        self.full = 0
        self._t0 = 0.0

    def _hook(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
            return
        self.seconds += time.perf_counter() - self._t0
        self.collections += 1
        self.full += info["generation"] == 2

    @contextlib.contextmanager
    def running(self, registry: MetricsRegistry):
        gc.callbacks.append(self._hook)
        try:
            yield self
        finally:
            gc.callbacks.remove(self._hook)
            registry.add_time("gc", self.seconds)
            registry.inc("gc_collections", self.collections)
            registry.inc("gc_full", self.full)


class _Active:
    __slots__ = ("registry", "tracer", "chunk", "pending")

    def __init__(self, registry, tracer, chunk=None):
        self.registry = registry
        self.tracer = tracer
        self.chunk = chunk
        #: (kernel, device index, stream, start, end, chunk) not resolved
        self.pending: list = []


def current() -> _Active | None:
    """The calling thread's active telemetry scope (None when off)."""
    return getattr(_TLS, "active", None)


def enabled() -> bool:
    return getattr(_TLS, "active", None) is not None


@contextlib.contextmanager
def activate(registry: MetricsRegistry | None,
             tracer: TraceCollector | None = None):
    """Push an ambient telemetry scope (nests; restores the previous
    scope on exit; inherits its chunk index).  Yields the registry.  On a
    normal exit the scope's device events are resolved (``_resolve``),
    inside an ``obs.resolve`` span: what the device track costs the
    host."""
    prev = current()
    act = _TLS.active = _Active(registry, tracer,
                                prev.chunk if prev is not None else None)
    try:
        yield registry
        if act.pending:
            with _Span(act, "obs.resolve", "trace", None):
                _resolve(act)
    finally:
        _TLS.active = prev


def _resolve(act: _Active) -> None:
    """Time the scope's pending kernel launches.  Per stream: record an
    anchor event after them, wait for it, and stamp both host clocks;
    each launch's end is then the anchor's host time less the events'
    distance.  Each launch adds ``time_device_<kernel>_s`` to the
    registry and one event to its device's track."""
    pending, act.pending = act.pending, []
    tracer = act.tracer
    anchors = {}
    for _, index, stream, *_ in pending:
        if stream not in anchors:
            anchor = tracer.take_event(index)
            anchor.record(stream)
            anchor.synchronize()
            anchors[stream] = (index, anchor, tracer.clock_pair())
    total: dict[str, float] = {}
    for kernel, index, stream, start, end, chunk in pending:
        _, anchor, t_anchor = anchors[stream]
        dur = start.elapsed_time(end) / 1e3
        t_end = t_anchor - end.elapsed_time(anchor) / 1e3
        total[kernel] = total.get(kernel, 0.0) + dur
        tracer.device_complete(kernel, t_end - dur, dur, index,
                               None if chunk is None else {"chunk": chunk})
        tracer.give_events(index, (start, end))
    for index, anchor, _ in anchors.values():
        tracer.give_events(index, (anchor,))
    if act.registry is not None:
        for kernel, dur in total.items():
            act.registry.add_time(f"device_{kernel}", dur)


class _Span:
    """Timed scope: duration lands on the ambient registry as a
    ``time_<name>_s`` counter AND on the tracer as a trace event."""
    __slots__ = ("_act", "_name", "_cat", "_args", "_t0")

    def __init__(self, act, name, cat, args):
        self._act = act
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self._t0
        act = self._act
        if act.registry is not None:
            act.registry.add_time(self._name, dur)
        if act.tracer is not None:
            args = self._args
            if act.chunk is not None:
                args = dict(args or (), chunk=act.chunk)
            act.tracer.complete(self._name, self._t0, dur, self._cat, args)
        return False


class _ChunkSpan(_Span):
    """The ``chunk`` span: its index is the scope's chunk while open."""
    __slots__ = ("_prev",)

    def __enter__(self):
        self._prev = self._act.chunk
        self._act.chunk = self._args["chunk"]
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        self._act.chunk = self._prev
        return False


class _DeviceSpan:
    """One kernel launch between two CUDA events on the launch stream,
    resolved when the scope closes; the stream held at ``gate`` from
    before the start event until the end event is enqueued."""
    __slots__ = ("_act", "_kernel", "_index", "_stream", "_gate", "_held",
                 "_start")

    def __init__(self, act, kernel, device, gate):
        self._act = act
        self._kernel = kernel
        self._stream = torch.cuda.current_stream(device)
        self._index = self._stream.device.index
        self._gate = gate

    def __enter__(self):
        if self._gate is not None:
            self._held = self._gate.hold(self._stream)
        try:
            self._start = self._act.tracer.take_event(self._index)
            self._start.record(self._stream)
        except BaseException:
            self._release()
            raise
        return self

    def _release(self):
        if self._gate is not None:
            self._gate.release(self._held)

    def __exit__(self, exc_type, *exc):
        act = self._act
        try:
            if exc_type is not None:
                act.tracer.give_events(self._index, (self._start,))
                return False
            end = act.tracer.take_event(self._index)
            end.record(self._stream)
            act.pending.append((self._kernel, self._index, self._stream,
                                self._start, end, act.chunk))
        finally:
            self._release()
        return False


def span(name: str, cat: str = "stage", **args):
    """Nestable timed scope: ``with span("smem"): ...``.

    Returns the shared no-op object when no telemetry scope is active —
    the disabled hot path allocates nothing.
    """
    act = getattr(_TLS, "active", None)
    if act is None:
        return NULL_SPAN
    return _Span(act, name, cat, args or None)


def chunk(index: int):
    """The ``chunk`` span of the ``-K`` chunk ``index``: every span and
    device event recorded inside it carries ``args.chunk`` = ``index``.
    The shared no-op object when telemetry is off."""
    act = getattr(_TLS, "active", None)
    if act is None:
        return NULL_SPAN
    return _ChunkSpan(act, "chunk", "stage", {"chunk": index})


def device_span(kernel: str, device, gate=None):
    """Time the kernel launched inside it on ``device``'s current stream
    with two pooled CUDA events, when a tracer is active; the pair is
    resolved when the scope closes, into ``time_device_<kernel>_s`` and
    the device track.  ``gate`` (``hold(stream)`` -> token,
    ``release(token)``; ``kernels.build.GATE``) holds the stream while the
    host enqueues the start event, the launch and the end event, so the
    pair does not time the host's launch path.  The shared no-op object
    when no tracer is active: no event, no gate, no sync."""
    act = getattr(_TLS, "active", None)
    if act is None or act.tracer is None:
        return NULL_SPAN
    return _DeviceSpan(act, kernel, device, gate)


def count(name: str, n=1) -> None:
    """Bump a counter on the ambient registry (no-op when off)."""
    act = getattr(_TLS, "active", None)
    if act is not None and act.registry is not None:
        act.registry.inc(name, n)


def observe(name: str, value, edges=None) -> None:
    """Record a histogram observation on the ambient registry."""
    act = getattr(_TLS, "active", None)
    if act is not None and act.registry is not None:
        act.registry.observe(name, value, edges=edges)


def set_gauge(name: str, value) -> None:
    act = getattr(_TLS, "active", None)
    if act is not None and act.registry is not None:
        act.registry.set_gauge(name, value)
