"""Metrics registry: named histograms of raw samples.

The batcher keeps its own :class:`MetricsRegistry` so the serving
percentiles (``serving.token_latency``, ``serving.ttft``,
``serving.prefill_latency``) exist whether or not telemetry is on, and
an active :class:`~chainermn_tpu_torch.observability.timeline.Telemetry`
observes every closed span's duration into one.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


class Histogram:
    """Append-only sample list with percentile queries."""

    __slots__ = ("name", "_values")

    def __init__(self, name: str = ""):
        self.name = name
        self._values: List[float] = []

    def observe(self, v: float) -> None:
        self._values.append(float(v))

    def percentile(self, p: float) -> float:
        if not self._values:
            return 0.0
        return float(np.percentile(np.asarray(self._values), p))

    def __len__(self):
        return len(self._values)

    def __repr__(self):
        return f"<Histogram {self.name} n={len(self._values)}>"


class MetricsRegistry:
    """Get-or-create registry of named histograms: a site and its reader
    cannot disagree about a metric's identity."""

    def __init__(self):
        self._histograms: Dict[str, Histogram] = {}

    def histogram(self, name: str) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(name)
        return h

    def has_histogram(self, name: str) -> bool:
        return name in self._histograms
