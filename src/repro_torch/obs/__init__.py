"""repro_torch.obs — pipeline telemetry (copy of ``repro.obs``'s metrics,
trace and report layers).

Instrumented code imports the cheap ambient helpers::

    from repro_torch import obs
    with obs.span("smem"):
        obs.count("smem_rounds")

which are no-ops (one thread-local read) unless a scope is active.
"""

from .metrics import (DEFAULT_EDGES, RATIO_EDGES, Gauge, Hist,
                      MetricsRegistry, MultiValue, Snapshot)
from .report import (STAGES, breakdown, read_profile, render, stage_times,
                     write_profile)
from .trace import (NULL_SPAN, Telemetry, TraceCollector, activate, count,
                    current, enabled, observe, set_gauge, span)

__all__ = [
    "DEFAULT_EDGES", "RATIO_EDGES", "Gauge", "Hist", "MetricsRegistry",
    "MultiValue", "Snapshot",
    "STAGES", "breakdown", "read_profile", "render", "stage_times",
    "write_profile",
    "NULL_SPAN", "Telemetry", "TraceCollector", "activate", "count",
    "current", "enabled", "observe", "set_gauge", "span",
]
