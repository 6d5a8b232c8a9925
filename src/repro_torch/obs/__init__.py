"""repro_torch.obs — pipeline telemetry (copy of ``repro.obs``).

* ``metrics`` — ``MetricsRegistry`` sink + associatively-mergeable
  ``Snapshot``;
* ``trace`` — ambient ``span``/``count``/``observe`` helpers, the
  ``Telemetry`` handle, and a Chrome-trace-event ``TraceCollector``;
* ``report`` — the kernel-breakdown renderer, the ``--profile`` JSON
  artifact and the cross-shard merge;
* ``runlog`` — the structured, run-scoped JSONL event log;
* ``export`` — live metrics files (snapshot JSON + Prometheus textfile).

Instrumented code imports the cheap ambient helpers::

    from repro_torch import obs
    with obs.span("smem"):
        obs.count("smem_rounds")

which are no-ops (one thread-local read) unless a scope is active.
``obs.chunk(i)`` opens a ``-K`` chunk's span and tags what runs inside
it; ``obs.device_span(kernel, device)`` times one kernel launch with
CUDA events when a tracer is active.
"""

from .export import (EXPORT_VERSION, LiveExporter, prometheus_text,
                     write_atomic)
from .metrics import (DEFAULT_EDGES, RATIO_EDGES, Gauge, Hist,
                      MetricsRegistry, MultiValue, Snapshot)
from .report import (SHARD_INVARIANT_COUNTERS, STAGES, breakdown,
                     merge_profiles, read_profile, render, shard_wall_table,
                     stage_times, write_merged_profile, write_profile)
from .runlog import (RUNLOG_VERSION, RunLog, index_fingerprint, new_run_id,
                     read_runlog)
from .trace import (NULL_SPAN, GcClock, Telemetry, TraceCollector, activate,
                    chunk, count, current, device_span, enabled, observe,
                    set_gauge, span)

__all__ = [
    "DEFAULT_EDGES", "RATIO_EDGES", "Gauge", "Hist", "MetricsRegistry",
    "MultiValue", "Snapshot",
    "SHARD_INVARIANT_COUNTERS", "STAGES", "breakdown", "merge_profiles",
    "read_profile", "render", "shard_wall_table", "stage_times",
    "write_merged_profile", "write_profile",
    "EXPORT_VERSION", "LiveExporter", "prometheus_text", "write_atomic",
    "RUNLOG_VERSION", "RunLog", "index_fingerprint", "new_run_id",
    "read_runlog",
    "NULL_SPAN", "GcClock", "Telemetry", "TraceCollector", "activate",
    "chunk", "count", "current", "device_span", "enabled", "observe",
    "set_gauge", "span",
]
