"""Resilience: the error taxonomy, the event log, fault injection, the
bounded retry and the checkpoints' world manifests (the subset the
serving, training and checkpoint paths use)."""

from .errors import (
    PayloadCorruptionError,
    PreemptionError,
    ResilienceError,
    StepDivergedError,
    TransientCommError,
    WorldResizeRequiredError,
)
from .fault_injection import FaultInjector, FaultSpec, inject_faults
from .log import ResilienceEvent, ResilienceLog, attach, detach, emit
from .retry import RetryPolicy, call_with_retry, is_transient, lockstep_allgather

__all__ = [
    "FaultInjector", "FaultSpec", "PayloadCorruptionError",
    "PreemptionError", "ResilienceError", "ResilienceEvent",
    "ResilienceLog", "RetryPolicy", "StepDivergedError",
    "TransientCommError", "WorldResizeRequiredError", "attach",
    "call_with_retry", "detach", "emit", "inject_faults", "is_transient",
    "lockstep_allgather",
]
