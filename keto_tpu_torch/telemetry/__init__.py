"""Observability (counterpart of ``keto_tpu/telemetry/``): structured
logging, tracing spans with OTLP export, metrics in Prometheus and
OpenMetrics text, the request flight recorder, SLO burn rates, wall-clock
attribution, the sampling profiler and the device statistics collector.
Standard library only, as in the reference: spans export to the structured
log, over OTLP/HTTP JSON and to an in-process ring; metrics are served at
``GET /metrics`` on both planes.

``federation.py`` is the fleet's federation scraper: the leader's
instance-labelled ``keto_cluster_*`` series and the ``/cluster/status``
rollup. ``DEVSTATS`` and
``DeviceStatsCollector`` load on first use, because ``devstats`` imports
``torch`` and a client that only stamps trace headers does not need it.
"""

from .federation import FederationScraper, rollup_health
from .flight import NOOP_CHECK_TELEMETRY, CheckTelemetry, FlightRecorder
from .logging import configure_logging, get_logger
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .openmetrics import ParseResult, parse_text
from .slo import SLOTracker
from .tracing import Span, Tracer

__all__ = [
    "ParseResult",
    "parse_text",
    "configure_logging",
    "get_logger",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Span",
    "Tracer",
    "DEVSTATS",
    "DeviceStatsCollector",
    "FlightRecorder",
    "CheckTelemetry",
    "NOOP_CHECK_TELEMETRY",
    "SLOTracker",
    "FederationScraper",
    "rollup_health",
]


def __getattr__(name):
    if name in ("DEVSTATS", "DeviceStatsCollector"):
        from . import devstats

        return getattr(devstats, name)
    raise AttributeError(name)
