"""Observability: the metrics registry and the span timeline."""

from .metrics import Histogram, MetricsRegistry
from .timeline import Telemetry, Timeline, observe, span

__all__ = ["Histogram", "MetricsRegistry", "Telemetry", "Timeline",
           "observe", "span"]
