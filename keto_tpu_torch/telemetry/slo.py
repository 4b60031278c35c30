"""Multi-window, multi-burn-rate SLO tracking for the check path
(counterpart of ``keto_tpu/telemetry/slo.py``).

The model is the Google SRE workbook's alerting recipe: pick an
objective (e.g. 99.9% of checks fast-and-correct), define the error
budget as ``1 - objective``, and watch the *burn rate* — the fraction of
requests that were bad over a window, divided by the budget — over a
fast window (minutes, catches sudden cliffs) and a slow window (an
hour, catches slow leaks). Burn rate 1.0 means burning exactly the
budget; an alert fires only when BOTH windows exceed the threshold,
which suppresses blips while still paging on real regressions.

"Bad" here is unified latency + errors: a request counts against the
budget when it errored OR took longer than the latency target. Events
land in per-second buckets in a deque bounded by the slow window, so
memory is O(slow_window_s) regardless of traffic.

The clock is injectable so window math is testable without sleeping.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

from .metrics import MetricsRegistry


class SLOTracker:
    def __init__(
        self,
        metrics: Optional[MetricsRegistry] = None,
        logger=None,
        objective: float = 0.999,
        latency_target_s: float = 0.25,
        fast_window_s: float = 300.0,
        slow_window_s: float = 3600.0,
        alert_burn_rate: float = 2.0,
        alert_cooldown_s: float = 300.0,
        clock=time.monotonic,
    ):
        if not 0.0 < objective < 1.0:
            raise ValueError(f"objective must be in (0, 1), got {objective}")
        self.objective = objective
        self.error_budget = 1.0 - objective
        self.latency_target_s = float(latency_target_s)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = max(float(slow_window_s), self.fast_window_s)
        self.alert_burn_rate = float(alert_burn_rate)
        self.alert_cooldown_s = float(alert_cooldown_s)
        self._clock = clock
        self._logger = logger
        self._lock = threading.Lock()
        # (second, good, bad) — append-only at the tail, evicted at the
        # head once older than the slow window
        self._buckets: deque[list] = deque()
        self._last_alert: float = float("-inf")
        self.alerts_fired = 0
        self._m_events = None
        self._m_bad = None
        if metrics is not None:
            burn = metrics.gauge(
                "keto_slo_burn_rate",
                "check SLO error-budget burn rate over the window "
                "(1.0 = burning exactly the budget)",
                labelnames=("window",),
            )
            burn.labels(window="fast").set_fn(
                lambda: self.burn_rate(self.fast_window_s)
            )
            burn.labels(window="slow").set_fn(
                lambda: self.burn_rate(self.slow_window_s)
            )
            metrics.gauge(
                "keto_slo_error_budget_remaining",
                "fraction of the slow-window error budget still unspent "
                "(1.0 = clean, 0.0 = budget exhausted)",
                fn=self.budget_remaining,
            )
            self._m_events = metrics.counter(
                "keto_slo_events_total",
                "check requests scored against the SLO",
            )
            self._m_bad = metrics.counter(
                "keto_slo_bad_events_total",
                "check requests that counted against the error budget "
                "(errored or slower than the latency target)",
            )

    # -- recording ------------------------------------------------------------

    def record(self, latency_s: float, error: bool = False) -> bool:
        """Score one request; returns whether it was bad."""
        bad = bool(error) or latency_s > self.latency_target_s
        now = self._clock()
        sec = int(now)
        with self._lock:
            if self._buckets and self._buckets[-1][0] == sec:
                b = self._buckets[-1]
            else:
                b = [sec, 0, 0]
                self._buckets.append(b)
            b[1 if not bad else 2] += 1
            self._evict(now)
        if self._m_events is not None:
            self._m_events.inc()
        if bad and self._m_bad is not None:
            self._m_bad.inc()
        if bad:
            self._maybe_alert(now)
        return bad

    def _evict(self, now: float) -> None:
        horizon = now - self.slow_window_s
        while self._buckets and self._buckets[0][0] < horizon:
            self._buckets.popleft()

    # -- window math ----------------------------------------------------------

    def _window_counts(self, window_s: float) -> tuple[int, int]:
        horizon = self._clock() - window_s
        good = bad = 0
        with self._lock:
            for sec, g, b in self._buckets:
                if sec >= horizon:
                    good += g
                    bad += b
        return good, bad

    def burn_rate(self, window_s: float) -> float:
        good, bad = self._window_counts(window_s)
        total = good + bad
        if total == 0:
            return 0.0
        return (bad / total) / self.error_budget

    def budget_remaining(self) -> float:
        good, bad = self._window_counts(self.slow_window_s)
        total = good + bad
        if total == 0:
            return 1.0
        spent = (bad / total) / self.error_budget
        return max(0.0, 1.0 - spent)

    # -- alerting -------------------------------------------------------------

    def _maybe_alert(self, now: float) -> None:
        if now - self._last_alert < self.alert_cooldown_s:
            return
        fast = self.burn_rate(self.fast_window_s)
        if fast < self.alert_burn_rate:
            return
        slow = self.burn_rate(self.slow_window_s)
        if slow < self.alert_burn_rate:
            return
        self._last_alert = now
        self.alerts_fired += 1
        if self._logger is not None:
            try:
                self._logger.warning(
                    "slo_burn_alert",
                    fast_burn_rate=round(fast, 2),
                    slow_burn_rate=round(slow, 2),
                    objective=self.objective,
                    latency_target_ms=round(self.latency_target_s * 1000, 1),
                    budget_remaining=round(self.budget_remaining(), 4),
                )
            except Exception:
                pass

    def snapshot(self) -> dict:
        fast_good, fast_bad = self._window_counts(self.fast_window_s)
        slow_good, slow_bad = self._window_counts(self.slow_window_s)
        return {
            "objective": self.objective,
            "latency_target_ms": round(self.latency_target_s * 1000, 1),
            "fast_window_s": self.fast_window_s,
            "slow_window_s": self.slow_window_s,
            "fast": {
                "good": fast_good,
                "bad": fast_bad,
                "burn_rate": round(self.burn_rate(self.fast_window_s), 4),
            },
            "slow": {
                "good": slow_good,
                "bad": slow_bad,
                "burn_rate": round(self.burn_rate(self.slow_window_s), 4),
            },
            "budget_remaining": round(self.budget_remaining(), 4),
            "alerts_fired": self.alerts_fired,
        }
