"""Span timeline: nestable host wall-time spans.

Activation follows the fault injector's pattern: a module-global
``_ACTIVE`` :class:`Telemetry` that is ``None`` unless :class:`observe`
or :func:`install` enabled it.  Instrumented sites call :func:`span`,
whose disabled fast path is one ``is None`` check returning the
stateless :data:`NULL_SPAN`.

Spans time the host loop on the monotonic clock.  A span around work
that ends in a device-to-host copy (the serving steps return host
logits) is a latency, not a dispatch time.

Serving spans: ``serving.step`` (one batcher iteration),
``serving.prefill`` and ``serving.decode`` (the engine's two steps).
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import List, Optional

from .metrics import MetricsRegistry


class Telemetry:
    """One activation's worth of state: a metrics registry and a
    timeline that observes every closed span's duration into
    ``registry.histogram(span_name)``."""

    def __init__(self, label: str = "telemetry"):
        self.label = label
        self.registry = MetricsRegistry()
        self.timeline = Timeline(label=label, registry=self.registry)


class _NullSpan:
    """The disabled path's context manager: stateless singleton."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _SpanCM:
    """Context manager recording one span on enter/exit."""

    __slots__ = ("_tl", "name", "args", "_t0", "_id", "_parent")

    def __init__(self, tl: "Timeline", name: str, args: dict):
        self._tl = tl
        self.name = name
        self.args = args

    def __enter__(self):
        stack = self._tl._stack()
        self._parent = stack[-1] if stack else 0
        self._id = next(self._tl._ids)
        stack.append(self._id)
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        t1 = time.monotonic()
        tl = self._tl
        stack = tl._stack()
        if stack and stack[-1] == self._id:
            stack.pop()
        tl._append({
            "type": "span", "name": self.name, "t": self._t0,
            "dur": t1 - self._t0, "sid": self._id,
            "parent": self._parent, "tid": threading.get_ident(),
            "args": self.args,
        })
        if tl._registry is not None:
            tl._registry.histogram(self.name).observe(t1 - self._t0)
        return False


class Timeline:
    """Append-only span stream, thread-safe.  Times are
    ``time.monotonic()`` seconds."""

    def __init__(self, label: str = "timeline", registry=None):
        self.label = label
        self.t0 = time.monotonic()
        self._events: List[dict] = []
        self._lock = threading.Lock()
        self._local = threading.local()
        self._registry = registry
        self._ids = itertools.count(1)

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _append(self, ev: dict) -> None:
        with self._lock:
            self._events.append(ev)

    def span(self, name: str, **args) -> _SpanCM:
        return _SpanCM(self, name, args)

    def spans(self, name: Optional[str] = None) -> List[dict]:
        """Closed spans in start order, optionally of one name."""
        with self._lock:
            evs = sorted(self._events, key=lambda e: e["t"])
        return [e for e in evs if name is None or e["name"] == name]


# ----------------------------------------------------------------------
# activation (the fault injector's pattern)
# ----------------------------------------------------------------------
_ACTIVE: Optional[Telemetry] = None


def active() -> Optional[Telemetry]:
    return _ACTIVE


def install(telemetry: Optional[Telemetry]) -> None:
    """Set (or clear, with ``None``) the process-global telemetry."""
    global _ACTIVE
    _ACTIVE = telemetry


def span(name: str, **args):
    """Hot-path hook at every instrumented site; the disabled fast path
    is this one ``is None`` check returning :data:`NULL_SPAN`."""
    t = _ACTIVE
    if t is None:
        return NULL_SPAN
    return t.timeline.span(name, **args)


class observe:
    """Context manager: activate a :class:`Telemetry` for a ``with``
    block (nesting restores the previous one on exit)."""

    def __init__(self, telemetry: Optional[Telemetry] = None):
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self._prev: Optional[Telemetry] = None

    def __enter__(self) -> Telemetry:
        self._prev = _ACTIVE
        install(self.telemetry)
        return self.telemetry

    def __exit__(self, *exc):
        install(self._prev)
        return False
