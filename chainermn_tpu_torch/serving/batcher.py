"""Continuous batching over the paged decode engine (port of
``chainermn_tpu/serving/batcher.py``).

A request queue feeds a fixed set of decode slots (the padded slot
model: every decode step runs the full capacity; empty slots decode the
null page and their logits are ignored), with requests joining and
leaving between decode iterations.

Resilience: a recoverable
:class:`~chainermn_tpu_torch.resilience.errors.ResilienceError` escaping
a prefill/decode step evicts the in-flight slots and re-queues their
requests (greedy decode replays identically from the prompt), bounded
per request by ``max_retries``; exhaustion fails the request, recorded
and never raised.  A :class:`PreemptionError` propagates (it is a drain
signal), as do non-recoverable errors.

Instrumentation: a ``serving.step`` span per iteration (the engine
emits ``serving.prefill`` / ``serving.decode``), and the batcher's own
:class:`~chainermn_tpu_torch.observability.metrics.MetricsRegistry`
holds ``serving.token_latency`` (one sample per active request per
decode iteration), ``serving.ttft`` (submit -> first token, split into
``.queue`` and ``.prefill``) and ``serving.prefill_latency``.

Not ported yet: handoff ingest (disaggregated serving) and the
multi-process admission sync of tensor-parallel serving.
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..observability import timeline as _obs
from ..observability.metrics import MetricsRegistry
from ..resilience.errors import PreemptionError, ResilienceError
from ..resilience.log import emit

_ids = itertools.count()

QUEUED, RUNNING, DONE, FAILED = "queued", "running", "done", "failed"


class Request:
    """One generation request and its runtime state."""

    def __init__(self, prompt: Sequence[int], max_new_tokens: int, *,
                 id: Optional[str] = None, eos_id: Optional[int] = None):
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self.prompt = [int(t) for t in prompt]
        if not self.prompt:
            raise ValueError("empty prompt")
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        self.id = id if id is not None else f"req{next(_ids)}"
        self.state = QUEUED
        self.tokens: List[int] = []
        self.slot: Optional[int] = None
        # cache positions inherited from a prefix-shared admission
        self.shared_len = 0
        self.retries = 0
        self.error: Optional[str] = None
        self.submitted_at: Optional[float] = None
        self.prefill_started_at: Optional[float] = None
        self.first_token_at: Optional[float] = None
        self.done_at: Optional[float] = None

    @property
    def total_tokens(self) -> int:
        return len(self.prompt) + self.max_new_tokens

    @property
    def output(self) -> List[int]:
        return self.prompt + self.tokens

    def _finished(self) -> bool:
        if len(self.tokens) >= self.max_new_tokens:
            return True
        return (self.eos_id is not None and bool(self.tokens)
                and self.tokens[-1] == self.eos_id)

    def __repr__(self):
        return (f"<Request {self.id} {self.state} prompt={len(self.prompt)}"
                f" generated={len(self.tokens)}/{self.max_new_tokens}>")


class ContinuousBatcher:
    """The iteration loop: admit joins, one decode step for the whole
    slot set, retire leaves, repeat."""

    def __init__(self, engine, *, max_retries: int = 1):
        self.engine = engine
        self.max_retries = int(max_retries)
        # the dense-oracle layout has no block table to alias, so it
        # stays the unshared reference
        self.share_prefixes = engine.layout == "paged"
        self.queue: deque = deque()
        self.active: Dict[int, Request] = {}
        self.finished: Dict[str, Request] = {}
        self.registry = MetricsRegistry()
        self.steps = 0
        self.tokens_generated = 0
        self.prefix_hits = 0
        self.prefix_tokens_shared = 0

    # -- submission -----------------------------------------------------
    def submit(self, request: Request) -> Request:
        if request.total_tokens > self.engine.max_total:
            raise ValueError(
                f"{request.id}: needs {request.total_tokens} cache "
                f"positions > engine max_total={self.engine.max_total}"
            )
        request.state = QUEUED
        request.submitted_at = time.monotonic()
        self.queue.append(request)
        return request

    def _sync_submissions(self) -> None:
        """Every rank of a multi-process tensor-parallel world must run
        the same admission schedule.  The port serves on one process
        (no comm), so there is nothing to agree on."""

    # -- one iteration --------------------------------------------------
    def _admit_joins(self, limit: Optional[int] = None) -> List[Request]:
        joins = []
        while self.queue and (limit is None or len(joins) < limit):
            r = self.queue[0]
            prefix = (
                self.engine.cache.lookup_prefix(r.prompt)
                if self.share_prefixes else None
            )
            if not self.engine.cache.can_admit(r.total_tokens,
                                               prefix=prefix):
                break
            self.queue.popleft()
            r.slot = self.engine.admit(r.total_tokens, prefix=prefix)
            r.shared_len = prefix.shared_len if prefix else 0
            if prefix is not None:
                self.prefix_hits += 1
                self.prefix_tokens_shared += prefix.shared_len
            r.state = RUNNING
            self.active[r.slot] = r
            joins.append(r)
        return joins

    def _prefill_one(self, r: Request) -> np.ndarray:
        logits = self.engine.prefill(r.slot, r.prompt)
        if self.share_prefixes:
            self.engine.cache.register_prefix(r.slot, r.prompt)
        return logits

    def _retire(self, r: Request) -> None:
        slot = r.slot
        self.engine.release(slot)
        del self.active[slot]
        r.slot = None
        r.state = DONE
        r.done_at = time.monotonic()
        self.finished[r.id] = r

    def _evict(self, r: Request) -> None:
        if r.slot is not None and r.slot in self.active:
            self.engine.cache.evict(r.slot)
            del self.active[r.slot]
            r.slot = None

    def _fail(self, r: Request, why: str) -> None:
        self._evict(r)
        r.state = FAILED
        r.error = why
        r.done_at = time.monotonic()
        self.finished[r.id] = r
        emit("request_failed", "serving.batcher", request=r.id, why=why)

    def _requeue(self, r: Request, why: str) -> None:
        """Retry path: evict, reset generated tokens and re-queue at the
        front, bounded by ``max_retries``."""
        self._evict(r)
        r.retries += 1
        if r.retries > self.max_retries:
            self._fail(r, f"retries exhausted after: {why}")
            return
        r.tokens = []
        r.state = QUEUED
        self.queue.appendleft(r)
        emit("request_retry", "serving.batcher", request=r.id,
             attempt=r.retries, why=why)

    def _decode_once(self) -> None:
        """One decode step for the whole slot set, appending one token
        per active request."""
        toks = np.zeros((self.engine.capacity,), np.int64)
        for slot, r in self.active.items():
            toks[slot] = r.tokens[-1] if r.tokens else 0
        t0 = time.monotonic()
        logits = self.engine.decode_step(toks)
        t1 = time.monotonic()
        # every active request received one token this iteration: the
        # iteration wall is the per-token latency sample
        for slot, r in list(self.active.items()):
            self.registry.histogram(
                "serving.token_latency").observe(t1 - t0)
            self._append_token(r, int(np.argmax(logits[slot])), t1)
            if r._finished():
                self._retire(r)

    def _append_token(self, r: Request, tok: int, t_now: float) -> None:
        r.tokens.append(int(tok))
        self.tokens_generated += 1
        if r.first_token_at is None:
            r.first_token_at = t_now
            if r.submitted_at is not None:
                self.registry.histogram("serving.ttft").observe(
                    t_now - r.submitted_at
                )
                if r.prefill_started_at is not None:
                    self.registry.histogram(
                        "serving.ttft.queue").observe(max(
                            r.prefill_started_at - r.submitted_at, 0.0))
                    self.registry.histogram(
                        "serving.ttft.prefill").observe(max(
                            t_now - r.prefill_started_at, 0.0))

    def step(self) -> bool:
        """One serving iteration; returns True while work remains."""
        if not self.queue and not self.active:
            return False
        with _obs.span("serving.step", queued=len(self.queue),
                       active=len(self.active)):
            try:
                # admit-and-prefill ONE request at a time: the prefill
                # registers the prompt's prefix chains, so later
                # requests of the same join wave already alias them
                while True:
                    joins = self._admit_joins(limit=1)
                    if not joins:
                        break
                    r = joins[0]
                    t0 = time.monotonic()
                    r.prefill_started_at = t0
                    logits = self._prefill_one(r)
                    t1 = time.monotonic()
                    self.registry.histogram(
                        "serving.prefill_latency").observe(t1 - t0)
                    self._append_token(r, int(np.argmax(logits)), t1)
                    if r._finished():
                        self._retire(r)
                if self.active:
                    self._decode_once()
                    self.steps += 1
            except PreemptionError:
                # a preemption notice is the replica's drain signal, not
                # a retryable fault: slots stay allocated
                raise
            except ResilienceError as err:
                if not err.recoverable:
                    raise
                for r in list(self.active.values()):
                    self._requeue(r, f"{type(err).__name__}: {err}")
        return bool(self.queue or self.active)

    # -- driving --------------------------------------------------------
    def run(self, max_steps: Optional[int] = None) -> Dict[str, Request]:
        """Drive :meth:`step` until the queue drains (or ``max_steps``
        iterations); returns finished requests by id."""
        n = 0
        self._sync_submissions()
        while self.step():
            n += 1
            if max_steps is not None and n >= max_steps:
                break
        return dict(self.finished)

    def serve(self, requests: Sequence[Request]) -> List[Request]:
        """Submit-and-run convenience; results in submission order."""
        reqs = list(requests)
        for r in reqs:
            self.submit(r)
        self.run()
        return [self.finished.get(r.id, r) for r in reqs]

    # -- reporting ------------------------------------------------------
    def latency_report(self) -> dict:
        """p50/p99 per serving phase from the batcher's own registry,
        plus the token/request counters."""
        out = {
            "steps": self.steps,
            "tokens_generated": self.tokens_generated,
            "done": sum(1 for r in self.finished.values()
                        if r.state == DONE),
            "failed": sum(1 for r in self.finished.values()
                          if r.state == FAILED),
            "prefix_hits": self.prefix_hits,
            "prefix_tokens_shared": self.prefix_tokens_shared,
        }
        for name in ("serving.token_latency", "serving.ttft",
                     "serving.ttft.queue", "serving.ttft.prefill",
                     "serving.prefill_latency"):
            if not self.registry.has_histogram(name):
                continue
            h = self.registry.histogram(name)
            if len(h) == 0:
                continue
            out[name] = {
                "p50_ms": round(h.percentile(50) * 1e3, 4),
                "p99_ms": round(h.percentile(99) * 1e3, 4),
                "n": len(h),
            }
        return out
