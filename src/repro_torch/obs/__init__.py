"""``repro_torch.obs`` — observability for the port.

* **Virtual-time tracing** (:mod:`repro_torch.obs.trace`): per-op causal
  spans in *simulated* time, in the same ``repro.obs.trace/v1`` format.
* **Metrics registry** (:mod:`repro_torch.obs.metrics`): typed
  Counter/Gauge/Histogram instruments behind stable dotted names.
* :func:`walltime`: the one sanctioned wall clock.
"""
from .clock import timed, walltime
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      NULL_INSTRUMENT, format_snapshot)
from .trace import BOUNDARY_FIELDS, STAGES, TraceSet

__all__ = [
    "BOUNDARY_FIELDS", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "NULL_INSTRUMENT", "STAGES", "TraceSet", "format_snapshot", "timed",
    "walltime",
]
