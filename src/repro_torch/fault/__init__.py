"""Failure detection for the port: the phi-accrual heartbeat detector
(:mod:`repro_torch.fault.detector`), whose closed-form detection delay
the simulator's crash schedules use."""
from .detector import (PhiAccrualDetector, detection_delay,
                       false_positive_rate, phi_timeline, phi_trace,
                       suspicion_times)

__all__ = [
    "PhiAccrualDetector", "detection_delay", "false_positive_rate",
    "phi_timeline", "phi_trace", "suspicion_times",
]
