"""Mergeable pipeline metrics: counters, gauges, histograms, Snapshots.

The paper's whole method starts from measurement — Table 1 attributes
>85% of BWA-MEM runtime to three kernels (SMEM, SAL, BSW) and every
optimization is justified by a counter (cells useful vs computed, # SA
offsets, occ accesses).  This module is the accounting layer that lets
the repro reproduce those numbers:

* ``MetricsRegistry`` — a thread-safe sink that instrumented code writes
  into (``inc``/``set_gauge``/``observe``/``add_time``).  The facade
  opens a FRESH registry per ``Aligner`` call, so the captured numbers
  are per-batch and compose across batches/shards by merging.

* ``Snapshot`` — a ``dict`` subclass (dict-compatible for every existing
  ``stats`` consumer) whose ``merge`` is ASSOCIATIVE: numeric values
  sum, ``Hist`` bucket-merges, ``Gauge`` takes the max, and non-numeric
  payloads (e.g. per-batch insert-size estimates) collect into a
  ``MultiValue`` list, one entry per merged part.  Associativity is what
  makes per-shard/per-batch stats sum deterministically no matter how a
  distributed run groups its merges (MUSIC-style massive-read-set
  distribution needs exactly this property).

Zero dependencies beyond numpy; serialization (``to_jsonable`` /
``from_jsonable``) round-trips through plain JSON for the ``--profile``
artifact and ``repro.cli report``.
"""

from __future__ import annotations

import bisect
import dataclasses
import threading

import numpy as np

NUMERIC = (int, float, np.integer, np.floating)

#: default histogram bucket edges — geometric, wide enough for counts,
#: lane widths and second-scale durations alike
DEFAULT_EDGES = tuple(float(10.0 ** e) for e in range(-6, 7))

#: edges for ratio-valued histograms (batch fill / pad waste, [0, 1])
RATIO_EDGES = (0.01, 0.02, 0.05, 0.1, 0.2, 0.35, 0.5, 0.75, 0.9)


class Gauge(float):
    """A point-in-time value; merging two Gauges keeps the MAX (the
    conservative summary for things like per-batch length-group counts).
    Being a ``float`` subclass keeps it ==-comparable and JSON-friendly
    for callers that treat stats as a plain dict."""

    def merge(self, other: "Gauge") -> "Gauge":
        return Gauge(max(float(self), float(other)))


class MultiValue(list):
    """Non-summable per-part payloads collected during Snapshot merges
    (one entry per merged part).  The subclass marks 'already collected',
    which is what keeps ``Snapshot.merge`` associative: raw values wrap
    on first contact, MultiValues concatenate."""


@dataclasses.dataclass
class Hist:
    """Fixed-edge histogram; mergeable iff edges match (associative)."""
    edges: tuple
    counts: list            # len(edges) + 1 buckets; bucket i holds
                            # values v with edges[i-1] < v <= edges[i]
    count: int = 0
    total: float = 0.0
    vmin: float = float("inf")
    vmax: float = float("-inf")

    @classmethod
    def new(cls, edges=DEFAULT_EDGES) -> "Hist":
        edges = tuple(float(e) for e in edges)
        if list(edges) != sorted(set(edges)):
            raise ValueError(f"histogram edges must be strictly "
                             f"increasing: {edges}")
        return cls(edges=edges, counts=[0] * (len(edges) + 1))

    def observe(self, v) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.edges, v)] += 1
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def merge(self, other: "Hist") -> "Hist":
        if self.edges != other.edges:
            raise ValueError("cannot merge histograms with different edges")
        return Hist(edges=self.edges,
                    counts=[a + b for a, b in zip(self.counts, other.counts)],
                    count=self.count + other.count,
                    total=self.total + other.total,
                    vmin=min(self.vmin, other.vmin),
                    vmax=max(self.vmax, other.vmax))

    def copy(self) -> "Hist":
        return Hist(edges=self.edges, counts=list(self.counts),
                    count=self.count, total=self.total,
                    vmin=self.vmin, vmax=self.vmax)

    def to_jsonable(self) -> dict:
        return {"__hist__": 1, "edges": list(self.edges),
                "counts": list(self.counts), "count": self.count,
                "total": self.total,
                "min": None if self.count == 0 else self.vmin,
                "max": None if self.count == 0 else self.vmax}

    @classmethod
    def from_jsonable(cls, d: dict) -> "Hist":
        h = cls(edges=tuple(d["edges"]), counts=list(d["counts"]),
                count=int(d["count"]), total=float(d["total"]))
        h.vmin = float("inf") if d.get("min") is None else float(d["min"])
        h.vmax = float("-inf") if d.get("max") is None else float(d["max"])
        return h


def _merge_values(a, b):
    """One key's merge (see module docstring for the rules)."""
    if isinstance(a, Gauge) and isinstance(b, Gauge):
        return a.merge(b)
    if isinstance(a, NUMERIC) and isinstance(b, NUMERIC):
        return a + b
    if isinstance(a, Hist) and isinstance(b, Hist):
        return a.merge(b)
    av = a if isinstance(a, MultiValue) else MultiValue([a])
    bv = b if isinstance(b, MultiValue) else MultiValue([b])
    return MultiValue(av + bv)


def _copy_value(v):
    if isinstance(v, Hist):
        return v.copy()
    if isinstance(v, MultiValue):
        return MultiValue(v)
    return v


class Snapshot(dict):
    """Mergeable stats mapping — a ``dict``, so every existing consumer
    of a driver's ``stats`` (``stats["bsw_tasks"]``, ``dict(stats)``,
    ``.update``) keeps working unchanged."""

    def merge_in(self, other: dict) -> "Snapshot":
        """Fold ``other`` into self (in place).  Associative across any
        grouping of parts; see module docstring for per-type rules."""
        for k, v in other.items():
            if k in self:
                self[k] = _merge_values(self[k], v)
            else:
                self[k] = _copy_value(v)
        return self

    def merge(self, other: dict) -> "Snapshot":
        """Merged copy (``self`` untouched)."""
        out = Snapshot()
        out.merge_in(self)
        out.merge_in(other)
        return out

    @classmethod
    def merge_all(cls, parts) -> "Snapshot":
        out = cls()
        for p in parts:
            out.merge_in(p)
        return out

    # -- JSON round-trip (the --profile artifact format) --

    def to_jsonable(self) -> dict:
        out = {}
        for k, v in self.items():
            if isinstance(v, Gauge):
                out[k] = {"__gauge__": float(v)}
            elif isinstance(v, Hist):
                out[k] = v.to_jsonable()
            elif isinstance(v, MultiValue):
                out[k] = {"__multi__": list(v)}
            elif isinstance(v, np.integer):
                out[k] = int(v)
            elif isinstance(v, np.floating):
                out[k] = float(v)
            else:
                out[k] = v
        return out

    @classmethod
    def from_jsonable(cls, d: dict) -> "Snapshot":
        out = cls()
        for k, v in d.items():
            if isinstance(v, dict) and "__gauge__" in v:
                out[k] = Gauge(v["__gauge__"])
            elif isinstance(v, dict) and "__hist__" in v:
                out[k] = Hist.from_jsonable(v)
            elif isinstance(v, dict) and "__multi__" in v:
                out[k] = MultiValue(v["__multi__"])
            else:
                out[k] = v
        return out


class MetricsRegistry:
    """Thread-safe sink for counters/gauges/histograms.

    Instrumented code writes through the module-level helpers in
    ``repro.obs.trace`` (``count``/``observe``/``span``), which resolve
    the ambient registry — so the hot path carries no registry plumbing
    and pays only a thread-local read when telemetry is off.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict = {}
        self._gauges: dict = {}
        self._hists: dict[str, Hist] = {}

    def inc(self, name: str, n=1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def add_time(self, name: str, seconds: float) -> None:
        """Accumulate a stage timer under the ``time_<name>_s`` key (the
        spelling ``repro.obs.report`` renders as the kernel breakdown)."""
        self.inc(f"time_{name}_s", float(seconds))

    def set_gauge(self, name: str, value) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def observe(self, name: str, value, edges=None) -> None:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Hist.new(edges or DEFAULT_EDGES)
            h.observe(value)

    def snapshot(self) -> Snapshot:
        """Point-in-time Snapshot (hists copied; safe to merge/keep)."""
        with self._lock:
            out = Snapshot(self._counters)
            for k, v in self._gauges.items():
                out[k] = Gauge(v)
            for k, h in self._hists.items():
                out[k] = h.copy()
        return out
