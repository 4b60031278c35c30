"""Per-tenant QoS: token-bucket admission per namespace (counterpart of
``keto_tpu/engine/qos.py``, without its stats). The fleet scale
(``set_scale``, ``keto_qos_fleet_scale``) is what the leader's aggregate
SLO burn alert sets (``telemetry/federation.py``), here and, through the
heartbeat reply's directives, on every follower.

The batcher's own load shedding is *global* — a bounded queue that rejects
everyone equally once full. That protects the process but not the tenants:
one namespace issuing checks at line rate fills the queue and starves every
other tenant long before the global bound trips. This module adds the
per-tenant layer in front of it: each namespace draws from its own token
bucket (``qos.rate`` tokens/s, ``qos.burst`` cap, per-namespace
``qos.overrides``), and a drained bucket rejects with the same retryable
429 contract the global shed uses, plus a ``Retry-After`` sized to the
bucket's actual refill time.

Admission happens at the batcher's entry points before any queueing or
engine work, one debit per check row (a batch debits its per-namespace row
counts). The id-native wire tier carries no per-row namespace strings:
encoded requests ship a namespace-id column, the wire front maps the unique
ids back to names through the vocab-synced ``NamespaceTable``
(O(tenants), not O(rows)), and the per-namespace counts are debited from
these same buckets.
"""

from __future__ import annotations

import threading
import time

from ..utils.errors import ErrResourceExhausted


class QosThrottled(ErrResourceExhausted):
    """A namespace exhausted its admission budget. Retryable: carries the
    seconds until the bucket holds the rejected demand again."""

    def __init__(self, namespace: str, retry_after_s: float):
        self.namespace = namespace
        self.retry_after_s = max(1, round(retry_after_s))
        super().__init__(
            f"namespace {namespace!r} is over its admission rate; "
            f"retry in ~{self.retry_after_s}s"
        )


class _Bucket:
    __slots__ = ("rate", "burst", "tokens", "stamp")

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self.stamp = now


class NamespaceQos:
    """Token buckets keyed by namespace.

    ``rate`` <= 0 admits everything for that namespace (per-namespace
    overrides may still throttle, and vice versa). Buckets materialize
    lazily on first use; the map is bounded by the live namespace set.
    """

    def __init__(
        self,
        rate: float = 0.0,
        burst: float = 100.0,
        overrides: dict | None = None,
        *,
        metrics=None,
        clock=time.monotonic,
    ):
        self.rate = float(rate)
        self.burst = max(1.0, float(burst))
        self.overrides = {
            str(ns): (
                float(o.get("rate", rate)),
                max(1.0, float(o.get("burst", burst))),
            )
            for ns, o in (overrides or {}).items()
        }
        self._clock = clock
        self._lock = threading.Lock()
        self._buckets: dict[str, _Bucket] = {}
        # the fleet-degradation scale (the cluster's burn alert): every
        # bucket's effective rate and burst are multiplied by it, so the
        # leader can tighten admission fleet-wide and relax it on recovery
        self._scale = 1.0
        self._scale_reason = ""
        self._throttled = None
        if metrics is not None:
            self._throttled = metrics.counter(
                "keto_qos_throttled_total",
                "check admissions rejected by per-namespace QoS",
                labelnames=("namespace",),
            )
            metrics.gauge(
                "keto_qos_fleet_scale",
                "fleet QoS scale applied to every bucket (1.0 normal, "
                "<1 while the aggregate burn alert is degrading)",
                fn=lambda: self._scale,
            )

    def set_scale(self, scale: float, reason: str = "") -> bool:
        """Apply a fleet-wide degradation scale in (0, 1]. Existing buckets
        rebuild on their next admit (the rate/burst mismatch check below).
        Returns True when the scale changed."""
        scale = min(1.0, max(0.01, float(scale)))
        with self._lock:
            if scale == self._scale:
                return False
            self._scale = scale
            self._scale_reason = str(reason)
        return True

    def _limits(self, namespace: str) -> tuple[float, float]:
        rate, burst = self.overrides.get(namespace, (self.rate, self.burst))
        scale = self._scale
        if scale != 1.0 and rate > 0:
            rate = rate * scale
            burst = max(1.0, burst * scale)
        return rate, burst

    def admit(self, namespace: str, n: int = 1) -> None:
        """Debit ``n`` check rows from ``namespace``'s bucket; raises
        :class:`QosThrottled` when the bucket cannot cover them."""
        rate, burst = self._limits(namespace)
        if rate <= 0:
            return
        now = self._clock()
        with self._lock:
            b = self._buckets.get(namespace)
            if b is None or b.rate != rate or b.burst != burst:
                b = _Bucket(rate, burst, now)
                self._buckets[namespace] = b
            b.tokens = min(b.burst, b.tokens + (now - b.stamp) * b.rate)
            b.stamp = now
            if b.tokens >= n:
                b.tokens -= n
                return
            deficit = n - b.tokens
        if self._throttled is not None:
            self._throttled.labels(namespace=namespace).inc()
        raise QosThrottled(namespace, retry_after_s=deficit / rate)

    def admit_counts(self, counts: dict[str, int]) -> None:
        """Admit a batch's per-namespace row counts — all-or-nothing per
        namespace; the first drained namespace rejects the batch (the client
        retries the whole request after backoff, matching the global shed's
        batch semantics)."""
        for namespace, n in counts.items():
            self.admit(namespace, n)
