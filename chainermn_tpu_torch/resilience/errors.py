"""Resilience error taxonomy (the subset the port raises or catches).

A copy of the classes of ``chainermn_tpu/resilience/errors.py`` that the
ported serving, training and checkpoint paths raise or catch.  Every failure the resilience
layer can contain is a :class:`ResilienceError` carrying structured
diagnostics; its ``recoverable`` flag is the contract with the retry
paths (the batcher re-queues a request on a recoverable error and
propagates everything else).
"""

from __future__ import annotations

from typing import Optional


class ResilienceError(RuntimeError):
    """Base class: a contained distributed failure with diagnostics.

    ``site`` names the instrumented operation (e.g. ``serving.prefill``),
    ``peer`` the rank/process involved (when addressed), ``attempts`` how
    many tries the retry layer spent, ``elapsed`` the wall-clock seconds
    across those tries.
    """

    recoverable = False

    def __init__(self, message: str, *, site: Optional[str] = None,
                 peer=None, attempts: Optional[int] = None,
                 elapsed: Optional[float] = None):
        super().__init__(message)
        self.site = site
        self.peer = peer
        self.attempts = attempts
        self.elapsed = elapsed

    def describe(self) -> str:
        """One structured line for logs."""
        parts = [f"kind={type(self).__name__}",
                 f"recoverable={self.recoverable}"]
        if self.site is not None:
            parts.append(f"site={self.site}")
        if self.peer is not None:
            parts.append(f"peer={self.peer}")
        if self.attempts is not None:
            parts.append(f"attempts={self.attempts}")
        if self.elapsed is not None:
            parts.append(f"elapsed={self.elapsed:.2f}s")
        return " ".join(parts)


class TransientCommError(ResilienceError):
    """A host-side exchange timed out or failed transiently (raised
    directly by the fault injector's ``timeout`` kind).  Recoverable."""

    recoverable = True


class PayloadCorruptionError(ResilienceError):
    """A control-plane payload failed to unpickle (a truncated or torn
    write).  Recoverable: an exchange again reproduces it, so the
    lockstep allgather retries it."""

    recoverable = True


class PreemptionError(ResilienceError):
    """A worker received a preemption/reclaim notice (or the injector's
    ``preempt`` kind simulating one).  Recoverable in the same world;
    the batcher treats it as a drain signal and lets it propagate."""

    recoverable = True


class WorldResizeRequiredError(ResilienceError):
    """The world that resumes is not the world that saved (the
    checkpoint's manifest names another world size), and no template
    was given to reshard onto.  Not recoverable in place: the job must
    re-form the world and reshard the checkpoint (ROADMAP Queue 1,
    'Resilience')."""

    recoverable = False


class StepDivergedError(ResilienceError):
    """Non-finite gradients under the ``abort`` policy of
    ``build_train_step``.  Not recoverable: restarting from the same
    state would diverge again."""

    recoverable = False
