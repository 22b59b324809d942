"""Resilience: the error taxonomy, the event log and fault injection
(the subset the serving and training paths use)."""

from .errors import (
    PreemptionError,
    ResilienceError,
    StepDivergedError,
    TransientCommError,
)
from .fault_injection import FaultInjector, FaultSpec, inject_faults
from .log import ResilienceEvent, ResilienceLog, attach, detach, emit

__all__ = [
    "FaultInjector", "FaultSpec", "PreemptionError", "ResilienceError",
    "ResilienceEvent", "ResilienceLog", "StepDivergedError",
    "TransientCommError", "attach",
    "detach", "emit", "inject_faults",
]
