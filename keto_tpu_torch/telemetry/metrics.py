"""Metrics: counters, gauges, histograms with Prometheus text exposition
(counterpart of ``keto_tpu/telemetry/metrics.py``; the metric names, types,
label names and bucket bounds are the reference's, letter for letter, so a
dashboard built on ``keto_tpu`` reads this package).

A dependency-free registry served at GET /metrics on both planes.

Thread-safety: one lock per metric; label sets materialize child series on
first use (the prometheus_client model, reimplemented in ~100 lines because
the runtime image does not ship the client library).
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_left
from typing import Optional, Sequence

# latency buckets in seconds, spaced for a sub-10ms p95 target
DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
    2.5, 5.0, 10.0,
)


def _escape_label_value(v) -> str:
    # Prometheus text format: label values escape backslash, double-quote,
    # AND line feed — an unescaped newline splits the sample line in two
    # and corrupts the whole exposition
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label_value(v)}"'
        for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


class _Metric:
    kind = ""

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: dict[tuple, "_Metric"] = {}

    def labels(self, **labels):
        key = tuple(labels.get(n, "") for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._make_child()
                self._children[key] = child
            return child

    def _series(self):
        """[(label-dict, child)] — the unlabeled metric is its own series."""
        if not self.labelnames:
            return [({}, self)]
        with self._lock:
            return [
                (dict(zip(self.labelnames, key)), child)
                for key, child in self._children.items()
            ]


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name, help, labelnames=()):
        super().__init__(name, help, labelnames)
        self._value = 0.0

    def _make_child(self):
        return Counter(self.name, self.help)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def _expose(self, labels, openmetrics=False):
        return [f"{self.name}{_fmt_labels(labels)} {self._value}"]


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name, help, labelnames=(), fn=None):
        super().__init__(name, help, labelnames)
        self._value = 0.0
        self._fn = fn  # callable gauges sample at scrape time

    def _make_child(self):
        return Gauge(self.name, self.help)

    def set_fn(self, fn) -> None:
        """Make this gauge (or a labeled child) sample ``fn`` at scrape
        time — labeled children can't take ``fn`` in the constructor
        because _make_child has no way to carry it."""
        self._fn = fn

    def set(self, value: float) -> None:
        with self._lock:
            self._value = value

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        if self._fn is not None:
            return float(self._fn())
        return self._value

    def _expose(self, labels, openmetrics=False):
        return [f"{self.name}{_fmt_labels(labels)} {self.value}"]


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help, labelnames=(), buckets=DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)  # +Inf tail
        self._sum = 0.0
        # bucket index -> (labels, value, unix-ts): the last exemplar
        # observed in that bucket, emitted in OpenMetrics expositions
        self._exemplars: dict[int, tuple[dict, float, float]] = {}

    def _make_child(self):
        return Histogram(self.name, self.help, buckets=self.buckets)

    def observe(self, value: float, exemplar: Optional[dict] = None) -> None:
        # le-inclusive bucket semantics: a value equal to a boundary
        # belongs to that bucket
        i = bisect_left(self.buckets, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            if exemplar:
                self._exemplars[i] = (dict(exemplar), value, time.time())

    def exemplars(self) -> dict[int, tuple[dict, float, float]]:
        with self._lock:
            return dict(self._exemplars)

    def percentile(self, q: float) -> float:
        """Approximate quantile from bucket counts (upper bound of the
        bucket containing the q-th observation) — for in-process
        introspection and tests, not exposition."""
        with self._lock:
            total = sum(self._counts)
            if total == 0:
                return 0.0
            rank = q * total
            acc = 0
            for i, c in enumerate(self._counts):
                acc += c
                if acc >= rank:
                    return (
                        self.buckets[i]
                        if i < len(self.buckets)
                        else float("inf")
                    )
        return float("inf")

    @property
    def count(self) -> int:
        return sum(self._counts)

    def _exemplar_suffix(self, i: int) -> str:
        """OpenMetrics exemplar clause for bucket index ``i`` (empty when
        none recorded): ``# {trace_id="…"} value timestamp``."""
        ex = self._exemplars.get(i)
        if ex is None:
            return ""
        ex_labels, ex_value, ex_ts = ex
        return f" # {_fmt_labels(ex_labels)} {ex_value} {round(ex_ts, 3)}"

    def _expose(self, labels, openmetrics=False):
        lines = []
        acc = 0
        for i, (b, c) in enumerate(zip(self.buckets, self._counts)):
            acc += c
            lb = dict(labels, le=repr(b) if b != int(b) else str(b))
            line = f"{self.name}_bucket{_fmt_labels(lb)} {acc}"
            if openmetrics:
                line += self._exemplar_suffix(i)
            lines.append(line)
        acc += self._counts[-1]
        line = (
            f'{self.name}_bucket{_fmt_labels(dict(labels, le="+Inf"))} {acc}'
        )
        if openmetrics:
            line += self._exemplar_suffix(len(self.buckets))
        lines.append(line)
        lines.append(f"{self.name}_sum{_fmt_labels(labels)} {self._sum}")
        lines.append(f"{self.name}_count{_fmt_labels(labels)} {acc}")
        return lines


class MetricsRegistry:
    """Named metrics + text exposition (GET /metrics)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    def _register(self, cls, name, help, labelnames=(), **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, labelnames, **kw)
                self._metrics[name] = m
            return m

    def counter(self, name, help="", labelnames=()) -> Counter:
        return self._register(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=(), fn=None) -> Gauge:
        return self._register(Gauge, name, help, labelnames, fn=fn)

    def histogram(
        self, name, help="", labelnames=(), buckets=DEFAULT_BUCKETS
    ) -> Histogram:
        return self._register(
            Histogram, name, help, labelnames, buckets=buckets
        )

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def expose(self, openmetrics: bool = False) -> str:
        """Prometheus text format v0.0.4, or OpenMetrics 1.0 when
        ``openmetrics`` is set (adds histogram exemplars + ``# EOF``)."""
        out = []
        with self._lock:
            metrics = list(self._metrics.values())
        for m in sorted(metrics, key=lambda m: m.name):
            out.append(f"# HELP {m.name} {m.help}")
            out.append(f"# TYPE {m.name} {m.kind}")
            for labels, child in m._series():
                out.extend(child._expose(labels, openmetrics=openmetrics))
        if openmetrics:
            out.append("# EOF")
        return "\n".join(out) + "\n"


# -- check-pipeline stage telemetry -----------------------------------------

# the stages of the pipelined check dispatch (engine/batcher.py), in flow
# order: enqueue = wait in the admission queue, encode = vocab-encode +
# encoded-cache probe, launch = launch-queue wait + kernel enqueue (async
# dispatch), device = block-until-materialized, decode = future resolution
# + cache population
PIPELINE_STAGES = ("enqueue", "encode", "launch", "device", "decode")

# stage latencies sit well under the end-to-end DEFAULT_BUCKETS: a healthy
# pipeline spends tens of microseconds to single-digit milliseconds per
# stage, so the buckets start 10x lower
PIPELINE_STAGE_BUCKETS = (
    0.00005, 0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 1.0,
)


def pipeline_stage_histogram(registry: MetricsRegistry) -> Histogram:
    """The per-stage latency histogram every pipelined batcher reports
    into — one series per PIPELINE_STAGES label value."""
    return registry.histogram(
        "keto_pipeline_stage_seconds",
        "per-batch latency of each check-pipeline stage",
        labelnames=("stage",),
        buckets=PIPELINE_STAGE_BUCKETS,
    )


# -- wall-clock attribution telemetry ----------------------------------------


def time_attribution_counter(registry: MetricsRegistry) -> Counter:
    """Cumulative wall-clock seconds charged to each stage of the check
    serving path by the accounting ledger (telemetry/attribution.py).
    Includes an explicit ``unattributed`` series for the residual, so
    the sum over stages equals total measured wall time."""
    return registry.counter(
        "keto_time_attribution_seconds_total",
        "wall-clock seconds of check serving attributed to each ledger "
        "stage (unattributed = residual the marks did not cover)",
        labelnames=("stage",),
    )


# -- deadline / hedging telemetry --------------------------------------------

# the stage label values deadline_expired_counter carries: "admission" is
# the transport/batcher entry reject (the request never entered the queue);
# the pipeline stages record mid-flight culls at that stage's boundary
DEADLINE_STAGES = ("admission", "dispatch", "encode", "launch", "decode")


def deadline_expired_counter(registry: MetricsRegistry) -> Counter:
    """Requests dropped because their caller deadline passed, by the stage
    that culled them — one series per DEADLINE_STAGES label value."""
    return registry.counter(
        "keto_deadline_expired_total",
        "check requests dropped because the caller deadline expired, "
        "labeled by the pipeline stage that culled them",
        labelnames=("stage",),
    )


# -- durability / recovery telemetry ------------------------------------------


def recovery_metrics(
    registry: MetricsRegistry, checkpoint_age_fn=None
) -> tuple[Counter, Gauge, Gauge, Gauge]:
    """(replayed, seconds, checkpoint_age, gap) for the durable write
    plane (store/durable.py): replayed = WAL deltas applied at the last
    boot, seconds = how long that recovery took, checkpoint_age = seconds
    since the newest checkpoint (sampled at scrape via
    ``checkpoint_age_fn``), gap = 1 when recovery found a WAL
    discontinuity and the store is serving possibly-stale state."""
    return (
        registry.counter(
            "keto_recovery_replayed_deltas_total",
            "WAL delta records replayed during boot-time store recovery",
        ),
        registry.gauge(
            "keto_recovery_seconds",
            "wall time of the last boot-time store recovery "
            "(checkpoint load + WAL replay)",
        ),
        registry.gauge(
            "keto_checkpoint_age_seconds",
            "seconds since the newest store checkpoint was cut",
            fn=checkpoint_age_fn,
        ),
        registry.gauge(
            "keto_recovery_gap",
            "1 when boot-time recovery found a WAL gap (acked writes may "
            "be missing; serving stale)",
        ),
    )


# -- device fault / failover telemetry ----------------------------------------

# a recovery is probe + residency rebuild + re-warmup: sub-second on a warm
# CPU mesh, tens of seconds when the re-init pays an XLA compile
RECOVERY_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)


def device_failover_metrics(
    registry: MetricsRegistry,
) -> tuple[Counter, Histogram]:
    """(failovers, recovery_seconds) for the device supervisor
    (driver/registry.py): failovers counts every device-lost/backend-swap
    event the supervisor handled; recovery_seconds measures device-lost to
    back-in-device-mode, the bounded window the --device-chaos drill
    asserts on."""
    return (
        registry.counter(
            "keto_backend_failovers_total",
            "device-lost / backend-swap events handled by the device "
            "supervisor",
        ),
        registry.histogram(
            "keto_device_recovery_seconds",
            "wall time from device-lost to serving in device mode again "
            "(probe + residency rebuild + re-warmup)",
            buckets=RECOVERY_BUCKETS,
        ),
    )


def hedge_counters(
    registry: MetricsRegistry,
) -> tuple[Counter, Counter, Counter, Counter]:
    """(fired, won, wasted, suppressed) counters for hedged single-check
    reads: fired = a hedge was issued, won = the hedge answered first,
    wasted = the primary answered first so the hedge's work was thrown
    away, suppressed = the primary was shed (429/RESOURCE_EXHAUSTED) so
    the hedge was NOT issued — duplicating a shed request doubles load
    exactly when the server asked for less."""
    return (
        registry.counter(
            "keto_hedge_fired_total",
            "hedged check reads issued (at most one per request)",
        ),
        registry.counter(
            "keto_hedge_won_total",
            "hedged check reads where the hedge answered first",
        ),
        registry.counter(
            "keto_hedge_wasted_total",
            "hedged check reads where the primary answered first",
        ),
        registry.counter(
            "keto_hedge_suppressed_overload_total",
            "hedges not issued because the primary failed with an "
            "overload shed (429/RESOURCE_EXHAUSTED)",
        ),
    )
