"""Bounded retry with deterministic exponential backoff (port of
``chainermn_tpu/resilience/retry.py``: ``is_transient``,
``RetryPolicy``, ``call_with_retry`` and ``lockstep_allgather``).

A failed exchange is retried on a bounded, jitter-free schedule, so a
run replays exactly, and exhaustion raises :class:`TransientCommError`
naming the site, the peer, the attempts and the time spent.  What is
retried: ``TimeoutError``, anything already a
:class:`TransientCommError`, and errors whose text marks a deadline
(``DEADLINE_EXCEEDED``, "timed out"); an unclassified exception
propagates on its first attempt, since retrying an unknown failure can
apply a side effect twice.

The JAX package runs ``lockstep_allgather`` under its host-protocol
recorder (``protocol.exchange_site``); the port has no recorder yet
(ROADMAP Queue 1, 'Analysis'), so the exchange runs bare.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

from .errors import PayloadCorruptionError, ResilienceError, TransientCommError
from .log import emit

# text of an exception that marks a transient failure
_TRANSIENT_MARKERS = ("DEADLINE_EXCEEDED", "deadline exceeded", "timed out")


def is_transient(exc: BaseException) -> bool:
    if isinstance(exc, (TransientCommError, TimeoutError)):
        return True
    if isinstance(exc, ResilienceError):
        return False  # already classified as something else
    text = str(exc)
    return any(m in text for m in _TRANSIENT_MARKERS)


class RetryPolicy:
    """Bounded attempts with exponential backoff: ``delay(i)`` for
    attempt ``i`` (1-based) is ``min(base_delay * multiplier**(i-1),
    max_delay)``, with no jitter."""

    def __init__(self, max_attempts: int = 4, base_delay: float = 0.05,
                 multiplier: float = 2.0, max_delay: float = 2.0):
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
        self.max_attempts = int(max_attempts)
        self.base_delay = float(base_delay)
        self.multiplier = float(multiplier)
        self.max_delay = float(max_delay)

    def delay(self, attempt: int) -> float:
        return min(self.base_delay * self.multiplier ** (attempt - 1),
                   self.max_delay)

    def schedule(self) -> Sequence[float]:
        """The backoff between attempts 1..max_attempts."""
        return [self.delay(i) for i in range(1, self.max_attempts)]


DEFAULT_POLICY = RetryPolicy()


def call_with_retry(fn: Callable, *, site: str, peer=None,
                    policy: Optional[RetryPolicy] = None,
                    retryable: Callable[[BaseException], bool] = is_transient,
                    sleep: Callable[[float], None] = time.sleep):
    """``fn()`` under ``policy``, absorbing the failures ``retryable``
    accepts; on exhaustion :class:`TransientCommError` with the last
    failure chained."""
    policy = policy or DEFAULT_POLICY
    t0 = time.monotonic()
    last: Optional[BaseException] = None
    for attempt in range(1, policy.max_attempts + 1):
        try:
            return fn()
        except Exception as e:  # classified below; the rest re-raised
            if not retryable(e):
                raise
            last = e
            emit("retry", site, attempt=attempt, peer=peer,
                 error=f"{type(e).__name__}: {e}")
            if attempt < policy.max_attempts:
                sleep(policy.delay(attempt))
    elapsed = time.monotonic() - t0
    raise TransientCommError(
        f"{site}: {policy.max_attempts} attempts failed over "
        f"{elapsed:.2f}s"
        + (f" (peer={peer})" if peer is not None else "")
        + f"; last: {type(last).__name__}: {last}",
        site=site, peer=peer, attempts=policy.max_attempts, elapsed=elapsed,
    ) from last


def lockstep_allgather(comm, payload, *, site: str, max_attempts: int = 4):
    """Every rank's ``payload`` (``comm.allgather_obj``), retrying
    transient faults and :class:`PayloadCorruptionError`.  Every rank
    unpickles every rank's payload, so a torn payload fails on all ranks
    together and they exchange again together: that lockstep is what
    makes the retry safe here, where retrying a one-sided collective
    would desynchronize the ranks."""
    return call_with_retry(
        lambda: comm.allgather_obj(payload),
        site=site,
        policy=RetryPolicy(max_attempts=max_attempts),
        retryable=lambda e: is_transient(e)
        or isinstance(e, PayloadCorruptionError),
    )
