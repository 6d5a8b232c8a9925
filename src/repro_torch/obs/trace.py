"""Trace spans + the ambient telemetry context.

Two cooperating pieces:

* ``TraceCollector`` — a thread-safe in-process buffer of Chrome
  trace-event objects (``ph: "X"`` complete events with microsecond
  ``ts``/``dur``), serialized as the ``{"traceEvents": [...]}`` JSON
  that chrome://tracing and Perfetto load directly.  Nesting is implied
  by containment per thread, exactly how those UIs render it.

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
merge associatively), restoring the outer scope on exit.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time

from .metrics import MetricsRegistry

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
            if len(self.events) < self.max_events:
                self.events.append(ev)
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
            if len(self.events) < self.max_events:
                self.events.append(ev)
            else:
                self.dropped += 1

    def to_dict(self) -> dict:
        with self._lock:
            events = list(self.events)
            dropped = self.dropped
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"tool": "repro.obs", "dropped": dropped}}

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)

    def __len__(self) -> int:
        with self._lock:
            return len(self.events)


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


class _Active:
    __slots__ = ("registry", "tracer")

    def __init__(self, registry, tracer):
        self.registry = registry
        self.tracer = tracer


def current() -> _Active | None:
    """The calling thread's active telemetry scope (None when off)."""
    return getattr(_TLS, "active", None)


def enabled() -> bool:
    return getattr(_TLS, "active", None) is not None


@contextlib.contextmanager
def activate(registry: MetricsRegistry | None,
             tracer: TraceCollector | None = None):
    """Push an ambient telemetry scope (nests; restores the previous
    scope on exit).  Yields the registry."""
    prev = current()
    _TLS.active = _Active(registry, tracer)
    try:
        yield registry
    finally:
        _TLS.active = prev


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
            act.tracer.complete(self._name, self._t0, dur,
                                self._cat, self._args)
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
