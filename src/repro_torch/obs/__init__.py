"""``repro_torch.obs`` — observability for the port.

* **Virtual-time tracing** (:mod:`repro_torch.obs.trace`): per-op causal
  spans in *simulated* time, in the same ``repro.obs.trace/v1`` format.
* **Metrics registry** (:mod:`repro_torch.obs.metrics`): typed
  Counter/Gauge/Histogram instruments behind stable dotted names.
* **Profiling** (:mod:`repro_torch.obs.profile`, :func:`walltime`): the
  one sanctioned wall clock, plus first-call / call-count / device-time
  / device-memory wrappers for the port's kernels.

CLI: ``python -m repro_torch.obs {summarize,diff,flamegraph} trace.json``.
"""
from .clock import timed, walltime
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      NULL_INSTRUMENT, format_snapshot)
from .profile import TraceCounter, profile_compile, profile_maxplus
from .trace import BOUNDARY_FIELDS, STAGES, TraceSet

__all__ = [
    "BOUNDARY_FIELDS", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "NULL_INSTRUMENT", "STAGES", "TraceCounter", "TraceSet",
    "format_snapshot", "profile_compile", "profile_maxplus", "timed",
    "walltime",
]
