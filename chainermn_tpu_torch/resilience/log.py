"""Resilience event log.

Every injected fault, retry and failed request is recorded as a
:class:`ResilienceEvent` so tests can assert against exactly what
happened.  ``emit()`` fans one event object out to every attached
:class:`ResilienceLog`; with none attached it is a no-op.

Each event carries both clocks (``monotonic`` for ordering against the
span timeline, ``time`` for humans) and the recording process index.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

_ENV_PROCESS = "CHAINERMN_TPU_FAULT_PROCESS_INDEX"


def process_index() -> int:
    """This process's index, stamped on every event.  The env var wins and is re-read every call (a launcher
    sets it; tests monkeypatch it); then the rank of an initialized
    ``torch.distributed`` process group; outside a distributed world
    everything is process 0."""
    raw = os.environ.get(_ENV_PROCESS)
    if raw is not None:
        return int(raw)
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class ResilienceEvent:
    """One observed/injected fault or recovery action."""

    __slots__ = ("kind", "site", "time", "monotonic", "process", "info")

    def __init__(self, kind: str, site: Optional[str] = None, **info):
        self.kind = kind
        self.site = site
        self.time = time.time()
        self.monotonic = time.monotonic()
        self.process = process_index()
        self.info = info

    def __repr__(self):
        extra = "".join(f" {k}={v!r}" for k, v in self.info.items())
        return f"<ResilienceEvent {self.kind} site={self.site}{extra}>"


class ResilienceLog:
    """Append-only event list with a query helper."""

    def __init__(self):
        self._events: List[ResilienceEvent] = []

    def append(self, ev: ResilienceEvent) -> ResilienceEvent:
        self._events.append(ev)
        return ev

    def record(self, kind: str, site: Optional[str] = None,
               **info) -> ResilienceEvent:
        return self.append(ResilienceEvent(kind, site, **info))

    def events(self, kind: Optional[str] = None,
               site: Optional[str] = None) -> List[ResilienceEvent]:
        return [
            e for e in self._events
            if (kind is None or e.kind == kind)
            and (site is None or e.site == site)
        ]


# -- sink registry ------------------------------------------------------
_sinks: List[ResilienceLog] = []


def attach(log: ResilienceLog) -> None:
    """Route subsequent :func:`emit` events into ``log`` (idempotent)."""
    if log not in _sinks:
        _sinks.append(log)


def detach(log: ResilienceLog) -> None:
    if log in _sinks:
        _sinks.remove(log)


def emit(kind: str, site: Optional[str] = None, **info) -> None:
    """Record an event on every attached sink (no-op with none
    attached).  One event object is shared by all sinks."""
    if not _sinks:
        return
    ev = ResilienceEvent(kind, site, **info)
    for sink in _sinks:
        sink.append(ev)
