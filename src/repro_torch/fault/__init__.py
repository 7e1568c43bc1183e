"""Fault tolerance for the port, module for module the reference's:

* :mod:`repro_torch.fault.detector` — the phi-accrual heartbeat failure
  detector, whose closed-form detection delay the simulator's crash
  schedules use;
* :mod:`repro_torch.fault.recovery` — the crash-recovery coordinator
  (:class:`FailureCoordinator`) for the core cluster: detector-driven
  suspicion, Chord stabilization rounds and §7.3 backup promotion, with
  a virtual-time :class:`RecoveryEvent` timeline.

Both are host-side Python and numpy; neither touches a device.
"""
from .detector import (PhiAccrualDetector, detection_delay,
                       false_positive_rate, phi_timeline, phi_trace,
                       suspicion_times)
from .recovery import FailureCoordinator, RecoveryEvent

__all__ = [
    "PhiAccrualDetector", "detection_delay", "false_positive_rate",
    "phi_timeline", "phi_trace", "suspicion_times",
    "FailureCoordinator", "RecoveryEvent",
]
