"""Deterministic fault injection for the host-side control plane.

A call-count-addressed injector that instrumented sites
(``serving.prefill``, ``serving.decode_step``) consult via :func:`fire`.
A fault is addressed by ``(site, call_count)``: the Nth ``fire()`` at a
site either fires a spec or does not, identically on every run.

Off by default and free when off: the module-level ``_ACTIVE`` is
``None`` unless :class:`inject_faults`, :func:`install` or the
``CHAINERMN_TPU_FAULTS`` env var (a JSON list of :class:`FaultSpec`
kwargs, for processes a test cannot reach by object reference)
activated an injector, and ``fire()``'s fast path is one ``is None``
check.

Fault kinds: ``timeout`` (raise :class:`TransientCommError`),
``preempt`` (raise :class:`PreemptionError`), ``error`` (a plain
``RuntimeError``, for testing that only recognized faults are retried).
"""

from __future__ import annotations

import json
import os
from collections import Counter
from typing import Optional, Sequence

from .errors import PreemptionError, TransientCommError
from .log import ResilienceLog, emit

_KINDS = ("timeout", "error", "preempt")

ENV_SPEC = "CHAINERMN_TPU_FAULTS"


class FaultSpec:
    """One fault rule: where, what, and at which 1-based call counts
    (``at``) of ``site``."""

    def __init__(self, site: str, kind: str, *, at: Sequence[int] = ()):
        if kind not in _KINDS:
            raise ValueError(f"unknown fault kind {kind!r}; one of {_KINDS}")
        self.site = site
        self.kind = kind
        self.at = frozenset(int(c) for c in at)

    def __repr__(self):
        return f"<FaultSpec {self.kind}@{self.site} at={sorted(self.at)}>"


class FaultInjector:
    """Holds the specs and the per-site call counters."""

    def __init__(self, specs: Sequence[FaultSpec],
                 log: Optional[ResilienceLog] = None):
        self.specs = list(specs)
        self._counts: Counter = Counter()
        self.log = log if log is not None else ResilienceLog()

    def call_count(self, site: str) -> int:
        return self._counts[site]

    def fire(self, site: str) -> None:
        """Count a call at ``site`` and raise the first matching fault."""
        self._counts[site] += 1
        count = self._counts[site]
        for spec in self.specs:
            if spec.site != site or count not in spec.at:
                continue
            self.log.record("fault_injected", site, fault=spec.kind,
                            call=count)
            emit("fault_injected", site, fault=spec.kind, call=count)
            if spec.kind == "timeout":
                raise TransientCommError(
                    f"injected timeout at {site} (call {count})", site=site,
                )
            if spec.kind == "preempt":
                raise PreemptionError(
                    f"injected preemption notice at {site} (call {count})",
                    site=site,
                )
            raise RuntimeError(f"injected error at {site} (call {count})")


# -- activation ---------------------------------------------------------
_ACTIVE: Optional[FaultInjector] = None


def active() -> Optional[FaultInjector]:
    return _ACTIVE


def install(injector: Optional[FaultInjector]) -> None:
    """Set (or clear, with ``None``) the process-global injector."""
    global _ACTIVE
    _ACTIVE = injector


def fire(site: str) -> None:
    """Hot-path hook at every instrumented site; the un-instrumented
    fast path is this one ``is None`` check."""
    inj = _ACTIVE
    if inj is None:
        return
    inj.fire(site)


class inject_faults:
    """Context manager: activate an injector for a ``with`` block
    (``specs``: :class:`FaultSpec` objects or dicts of its kwargs).
    Nesting restores the previous injector on exit."""

    def __init__(self, specs, log: Optional[ResilienceLog] = None):
        specs = [s if isinstance(s, FaultSpec) else FaultSpec(**s)
                 for s in specs]
        self.injector = FaultInjector(specs, log=log)
        self._prev: Optional[FaultInjector] = None

    def __enter__(self) -> FaultInjector:
        self._prev = _ACTIVE
        install(self.injector)
        return self.injector

    def __exit__(self, *exc):
        install(self._prev)
        return False


def _from_env() -> None:
    """Activate from ``CHAINERMN_TPU_FAULTS`` (a JSON list of FaultSpec
    kwargs)."""
    raw = os.environ.get(ENV_SPEC)
    if not raw:
        return
    install(FaultInjector([FaultSpec(**d) for d in json.loads(raw)]))


_from_env()
