"""Straggler detection/mitigation for the synchronous training loop.

At 1000+ nodes the slowest worker sets the step time.  The monitor keeps
a rolling step-time distribution; a step exceeding
``median x threshold`` is a straggle event.  Mitigations (host-level —
the data-parallel step itself is a single SPMD program):

* ``"rebalance"``  — shrink the per-host microbatch of the slow host
  (returned as a suggestion; the data pipeline re-slices on the next step;
  the paper's 'distribute the reads equally' assumption made dynamic);
* ``"checkpoint"`` — persistent straggling of the same host is treated as
  an impending failure: the loop is told to checkpoint now and request an
  elastic re-mesh (ft/elastic.py) that drops the node.
"""

from __future__ import annotations

import collections
import dataclasses
import statistics
import time


@dataclasses.dataclass
class StragglerEvent:
    step: int
    host: int
    step_time: float
    median: float
    action: str            # "none" | "rebalance" | "checkpoint"


class StragglerMonitor:
    def __init__(self, window: int = 32, threshold: float = 1.8,
                 persist: int = 3, min_samples: int | None = None):
        self.window = window
        self.threshold = threshold
        self.persist = persist
        # samples needed before judging: the training-loop default
        # (max(8, window/4)) suppresses warm-up noise; small-N callers
        # (e.g. the report's per-shard wall table over a handful of
        # shard profiles) lower it explicitly
        self.min_samples = (max(8, window // 4) if min_samples is None
                            else max(2, int(min_samples)))
        self.times: collections.deque = collections.deque(maxlen=window)
        self.strikes: collections.Counter = collections.Counter()
        self._t0 = None

    def start_step(self):
        self._t0 = time.perf_counter()

    def end_step(self, step: int, host: int = 0) -> StragglerEvent | None:
        return self.observe(step, host, time.perf_counter() - self._t0)

    def observe(self, step: int, host: int = 0,
                step_time: float = 0.0) -> StragglerEvent | None:
        """Feed one externally-measured step time (e.g. a shard's wall
        time from ``dist.api.align_shard``) into the rolling distribution
        — same detection logic as the start_step/end_step pair, usable
        when the caller already has real telemetry."""
        dt = float(step_time)
        self.times.append(dt)
        if len(self.times) < self.min_samples:
            return None
        med = statistics.median(self.times)
        if dt <= med * self.threshold:
            self.strikes[host] = 0
            return None
        self.strikes[host] += 1
        action = "checkpoint" if self.strikes[host] >= self.persist \
            else "rebalance"
        return StragglerEvent(step=step, host=host, step_time=dt,
                              median=med, action=action)

    def rebalance_fraction(self, host: int) -> float:
        """Suggested microbatch multiplier for a straggling host."""
        med = statistics.median(self.times) if self.times else 1.0
        last = self.times[-1] if self.times else med
        return max(0.5, min(1.0, med / max(last, 1e-9)))
