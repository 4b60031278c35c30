"""Leader-side telemetry federation: one fleet view from the per-node
planes (counterpart of ``keto_tpu/telemetry/federation.py``).

It runs on the leader (or a standalone node, which federates itself) and,
each cycle:

- upserts the node's own payload into the membership table, so the leader
  is a member of its own cluster;
- scrapes each alive member's ``/metrics`` (parsed by
  ``telemetry/openmetrics.py``) and ``/replication/status``;
- re-exports instance-labelled ``keto_cluster_*`` series: each member's
  replication lag (versions, seconds, staleness), qps (counter deltas over
  the scrape interval), SLO burn rates, breaker state, liveness;
- computes a cluster-wide SLO burn from the members'
  ``keto_slo_{bad_,}events_total`` deltas: the fleet can burn its aggregate
  budget while each node alone looks fine, so the aggregate gauge is what
  the error-budget alert pages on, and its alert tightens the fleet's QoS
  (``directives``, which ride back on every heartbeat reply);
- rolls each member up to green, yellow or red (``rollup_health``) for
  ``/cluster/status``.

The loop is a daemon thread off the serving path: a slow or dead member
costs the loop a timeout, never a request. ``fetch_fn`` and ``clock`` are
injectable, so tests drive cycles synchronously over canned expositions.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from typing import Callable, Optional

from .openmetrics import parse_text

# thresholds consulted by rollup_health; driver/config.py cluster.health.*
DEFAULT_THRESHOLDS = {
    "lag_versions_yellow": 100,
    "lag_versions_red": 10000,
    "lag_seconds_yellow": 5.0,
    "lag_seconds_red": 30.0,
    "staleness_yellow_s": 10.0,
    "staleness_red_s": 60.0,
    "burn_yellow": 1.0,
    "burn_red": 2.0,
}

_LEVELS = ("green", "yellow", "red")


def _worst(levels) -> str:
    worst = "green"
    for lv in levels:
        if _LEVELS.index(lv) > _LEVELS.index(worst):
            worst = lv
    return worst


def rollup_health(view: dict, thresholds: Optional[dict] = None):
    """Roll one member view up to ``(level, reasons)``.

    red: member down, device breaker open, or any red threshold crossed
    (lag versions/seconds, heartbeat staleness, SLO burn).
    yellow: breaker probing / device supervisor recovering, or a yellow
    threshold crossed. green otherwise. Unknown fields (None) never
    trip a threshold — a leader with no replication lag is green, not
    red-by-missing-data.
    """
    t = dict(DEFAULT_THRESHOLDS)
    if thresholds:
        t.update({k: v for k, v in thresholds.items() if v is not None})
    reasons: list[str] = []
    level = "green"

    def trip(new_level: str, reason: str) -> None:
        nonlocal level
        reasons.append(reason)
        level = _worst((level, new_level))

    if not view.get("alive", True):
        trip(
            "red",
            f"down: no heartbeat for {view.get('age_s', '?')}s",
        )
    breaker = view.get("breaker")
    if breaker == 1.0:
        trip("red", "device breaker open")
    elif breaker == 0.5:
        trip("yellow", "device breaker probing")
    if view.get("recovering"):
        trip("yellow", "device supervisor recovering")
    for field, yellow_key, red_key, label in (
        ("lag_versions", "lag_versions_yellow", "lag_versions_red",
         "replication lag"),
        ("lag_seconds", "lag_seconds_yellow", "lag_seconds_red",
         "replication lag"),
        ("staleness_seconds", "staleness_yellow_s", "staleness_red_s",
         "staleness"),
        ("burn_rate", "burn_yellow", "burn_red", "SLO burn"),
    ):
        v = view.get(field)
        if v is None:
            continue
        if v >= t[red_key]:
            trip("red", f"{label}: {field}={v} >= {t[red_key]}")
        elif v >= t[yellow_key]:
            trip("yellow", f"{label}: {field}={v} >= {t[yellow_key]}")
    return level, reasons


def _default_fetch(url: str, timeout_s: float) -> str:
    with urllib.request.urlopen(
        urllib.request.Request(url), timeout=timeout_s
    ) as resp:
        return resp.read().decode("utf-8")


class FederationScraper:
    def __init__(
        self,
        membership,
        metrics,
        *,
        scrape_interval_s: float = 2.0,
        timeout_s: float = 5.0,
        thresholds: Optional[dict] = None,
        objective: float = 0.999,
        alert_burn_rate: Optional[float] = None,
        self_payload_fn: Optional[Callable[[], dict]] = None,
        election_status_fn: Optional[Callable[[], dict]] = None,
        qos=None,  # NamespaceQos to tighten fleet-wide while degraded
        degrade_scale: float = 0.25,
        recovery_fraction: float = 0.5,
        logger=None,
        fetch_fn=None,  # fetch_fn(url, timeout_s) -> text; tests inject
        clock: Callable[[], float] = time.monotonic,
    ):
        self.membership = membership
        self.metrics = metrics
        self.scrape_interval_s = max(0.01, float(scrape_interval_s))
        self.timeout_s = float(timeout_s)
        self.thresholds = dict(DEFAULT_THRESHOLDS)
        if thresholds:
            self.thresholds.update(
                {k: v for k, v in thresholds.items() if v is not None}
            )
        self.objective = float(objective)
        self.alert_burn_rate = float(
            alert_burn_rate
            if alert_burn_rate is not None
            else self.thresholds["burn_red"]
        )
        self._self_payload_fn = self_payload_fn
        self._election_status_fn = election_status_fn
        self._qos = qos
        # fleet degradation state machine: tighten QoS when the
        # aggregate burn crosses the alert line, relax only once it
        # falls below recovery_fraction * alert (hysteresis, so a burn
        # hovering at the line does not flap the fleet's admission)
        self.degrade_scale = min(1.0, max(0.01, float(degrade_scale)))
        self.recovery_fraction = min(1.0, max(0.0, float(recovery_fraction)))
        self.degraded = False
        self.degraded_since: Optional[float] = None
        self.degradations = 0
        self._logger = logger
        self._fetch = fetch_fn or _default_fetch
        self._clock = clock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        # instance_id -> {t, http_total, events_total, bad_total}
        self._prev: dict[str, dict] = {}
        self._last_status: dict = {}
        self.cycles = 0
        self.scrape_errors = 0
        self.alerts_fired = 0
        self._last_alert_t = float("-inf")
        self.last_cycle_ms: Optional[float] = None

        g = metrics.gauge
        self._g_members = g(
            "keto_cluster_members",
            "cluster members known to the leader (alive or not)",
        )
        self._g_up = g(
            "keto_cluster_member_up",
            "1 when the member's heartbeat is fresh, 0 when it aged out",
            labelnames=("instance",),
        )
        self._g_lag_v = g(
            "keto_cluster_replication_lag_versions",
            "store versions this member is behind the leader",
            labelnames=("instance",),
        )
        self._g_lag_s = g(
            "keto_cluster_replication_lag_seconds",
            "seconds this member has continuously been behind",
            labelnames=("instance",),
        )
        self._g_stale = g(
            "keto_cluster_staleness_seconds",
            "seconds since this member last heard from the leader",
            labelnames=("instance",),
        )
        self._g_qps = g(
            "keto_cluster_qps",
            "member HTTP requests/s over the last scrape interval "
            "(keto_http_requests_total counter delta)",
            labelnames=("instance",),
        )
        self._g_burn = g(
            "keto_cluster_slo_burn_rate",
            "member check-SLO error-budget burn rate, by window",
            labelnames=("instance", "window"),
        )
        self._g_breaker = g(
            "keto_cluster_breaker_open",
            "member device-breaker state: 0 closed, 0.5 probing, 1 open",
            labelnames=("instance",),
        )
        self._g_agg_burn = g(
            "keto_cluster_slo_burn_rate_aggregate",
            "fleet-wide SLO burn rate from summed per-member event "
            "deltas over the scrape interval (alerts can fire here even "
            "when every node is individually under budget)",
        )
        self._c_scrape_errors = metrics.counter(
            "keto_cluster_scrape_errors_total",
            "member scrapes that failed (timeout, refused, parse error)",
            labelnames=("instance",),
        )
        self._g_cycle_ms = g(
            "keto_cluster_scrape_cycle_ms",
            "wall time of the last federation scrape cycle (runs on its "
            "own thread, off the serving path)",
        )
        self._g_degraded = g(
            "keto_cluster_degraded",
            "1 while the aggregate burn alert has the fleet's QoS "
            "tightened, else 0",
            fn=lambda: 1.0 if self.degraded else 0.0,
        )

    # -- one scrape cycle -----------------------------------------------------

    def _scrape_member(self, row: dict) -> dict:
        """Build one member view: heartbeat fields + scraped series."""
        instance = row["instance_id"]
        role = row.get("role") or ""
        view = {
            "instance_id": instance,
            "role": role or "leader",
            "alive": bool(row.get("alive")),
            "age_s": row.get("age_s"),
            "heartbeats": row.get("heartbeats"),
            "version": row.get("version"),
            "backend": row.get("backend"),
            "recovering": bool(
                (row.get("supervisor") or {}).get("recovering")
            ),
            "read_url": row.get("read_url"),
            "write_url": row.get("write_url"),
            "election": row.get("election"),
            "lag_versions": None,
            "lag_seconds": None,
            "staleness_seconds": None,
            "qps": None,
            "burn_fast": None,
            "burn_slow": None,
            "burn_rate": None,
            "breaker": None,
            "scrape_ok": False,
            "replication": None,
            "_deltas": (0.0, 0.0),  # (bad, events) for the aggregate
        }
        hb_breaker = row.get("breaker") or {}
        if hb_breaker:
            view["breaker"] = (
                1.0
                if hb_breaker.get("open")
                else (0.5 if hb_breaker.get("probing") else 0.0)
            )
        hb_slo = row.get("slo") or {}
        if hb_slo:
            view["burn_fast"] = (hb_slo.get("fast") or {}).get("burn_rate")
            view["burn_slow"] = (hb_slo.get("slow") or {}).get("burn_rate")
        if not view["alive"]:
            return view
        read_url = (row.get("read_url") or "").rstrip("/")
        if read_url:
            try:
                parsed = parse_text(
                    self._fetch(f"{read_url}/metrics", self.timeout_s)
                )
                view["scrape_ok"] = True
            except Exception as e:
                self.scrape_errors += 1
                self._c_scrape_errors.labels(instance=instance).inc()
                view["scrape_error"] = f"{type(e).__name__}: {e}"
                parsed = None
            if parsed is not None:
                view["lag_versions"] = parsed.value(
                    "keto_replication_lag_versions"
                )
                view["lag_seconds"] = parsed.value(
                    "keto_replication_lag_seconds"
                )
                view["staleness_seconds"] = parsed.value(
                    "keto_replication_staleness_seconds"
                )
                fast = parsed.value(
                    "keto_slo_burn_rate", {"window": "fast"}
                )
                slow = parsed.value(
                    "keto_slo_burn_rate", {"window": "slow"}
                )
                if fast is not None:
                    view["burn_fast"] = fast
                if slow is not None:
                    view["burn_slow"] = slow
                now = self._clock()
                http_total = parsed.sum_counter("keto_http_requests_total")
                events = parsed.sum_counter("keto_slo_events_total")
                bad = parsed.sum_counter("keto_slo_bad_events_total")
                prev = self._prev.get(instance)
                if prev is not None:
                    dt = max(1e-6, now - prev["t"])
                    if http_total is not None and prev["http"] is not None:
                        view["qps"] = round(
                            max(0.0, http_total - prev["http"]) / dt, 3
                        )
                    if events is not None and prev["events"] is not None:
                        d_events = max(0.0, events - prev["events"])
                        d_bad = (
                            max(0.0, bad - prev["bad"])
                            if bad is not None and prev["bad"] is not None
                            else 0.0
                        )
                        view["_deltas"] = (d_bad, d_events)
                self._prev[instance] = {
                    "t": now,
                    "http": http_total,
                    "events": events,
                    "bad": bad,
                }
        # the leader (and a standalone node) is never behind itself
        if view["lag_versions"] is None and view["role"] == "leader":
            view["lag_versions"] = 0.0
            if view["lag_seconds"] is None:
                view["lag_seconds"] = 0.0
            if view["staleness_seconds"] is None:
                view["staleness_seconds"] = 0.0
        write_url = (row.get("write_url") or "").rstrip("/")
        if write_url:
            try:
                view["replication"] = json.loads(
                    self._fetch(
                        f"{write_url}/replication/status", self.timeout_s
                    )
                )
            except Exception:
                pass  # best-effort; followers' heartbeat already has version
        return view

    def run_once(self) -> dict:
        """One federation cycle; returns the status dict. The loop calls
        this; tests call it directly."""
        t0 = time.monotonic()
        if self._self_payload_fn is not None:
            try:
                self.membership.upsert(self._self_payload_fn())
            except Exception:
                pass
        rows = self.membership.members()
        self._g_members.set(float(len(rows)))
        views = []
        agg_bad = 0.0
        agg_events = 0.0
        for row in rows:
            view = self._scrape_member(row)
            instance = view["instance_id"]
            self._g_up.labels(instance=instance).set(
                1.0 if view["alive"] else 0.0
            )
            for gauge, field in (
                (self._g_lag_v, "lag_versions"),
                (self._g_lag_s, "lag_seconds"),
                (self._g_stale, "staleness_seconds"),
                (self._g_qps, "qps"),
                (self._g_breaker, "breaker"),
            ):
                v = view.get(field)
                if v is not None:
                    gauge.labels(instance=instance).set(float(v))
            for window, field in (("fast", "burn_fast"), ("slow", "burn_slow")):
                v = view.get(field)
                if v is not None:
                    self._g_burn.labels(
                        instance=instance, window=window
                    ).set(float(v))
            d_bad, d_events = view.pop("_deltas")
            agg_bad += d_bad
            agg_events += d_events
            burns = [
                b for b in (view["burn_fast"], view["burn_slow"])
                if b is not None
            ]
            view["burn_rate"] = max(burns) if burns else None
            level, reasons = rollup_health(view, self.thresholds)
            view["health"] = level
            view["reasons"] = reasons
            views.append(view)
        budget = max(1e-9, 1.0 - self.objective)
        aggregate_burn = (
            (agg_bad / agg_events) / budget if agg_events > 0 else 0.0
        )
        self._g_agg_burn.set(round(aggregate_burn, 4))
        if aggregate_burn >= self.alert_burn_rate:
            now = time.monotonic()
            if now - self._last_alert_t >= 60.0:
                self._last_alert_t = now
                self.alerts_fired += 1
                if self._logger is not None:
                    try:
                        self._logger.warning(
                            "cluster_slo_burn_alert",
                            aggregate_burn_rate=round(aggregate_burn, 2),
                            alert_burn_rate=self.alert_burn_rate,
                            members=len(views),
                        )
                    except Exception:
                        pass
        self._update_degradation(aggregate_burn)
        self.cycles += 1
        self.last_cycle_ms = round((time.monotonic() - t0) * 1000, 3)
        self._g_cycle_ms.set(self.last_cycle_ms)
        alive = [v for v in views if v["alive"]]
        status = {
            "cluster": {
                "members": len(views),
                "alive": len(alive),
                "health": _worst(v["health"] for v in views)
                if views
                else "green",
                "aggregate_burn_rate": round(aggregate_burn, 4),
                "objective": self.objective,
                "alert_burn_rate": self.alert_burn_rate,
                "alerts_fired": self.alerts_fired,
                "degraded": self.degraded,
                "degradations": self.degradations,
                "directives": self.directives(),
                "scrape": {
                    "cycles": self.cycles,
                    "errors": self.scrape_errors,
                    "interval_s": self.scrape_interval_s,
                    "last_cycle_ms": self.last_cycle_ms,
                },
                "thresholds": self.thresholds,
            },
            "members": views,
        }
        if self._election_status_fn is not None:
            try:
                status["cluster"]["election"] = self._election_status_fn()
            except Exception:
                pass
        with self._lock:
            self._last_status = status
        return status

    def _update_degradation(self, aggregate_burn: float) -> None:
        """Flip the fleet degradation state with hysteresis and apply it
        locally; followers pick the same directive up from their next
        heartbeat reply."""
        if not self.degraded and aggregate_burn >= self.alert_burn_rate:
            self.degraded = True
            self.degraded_since = self._clock()
            self.degradations += 1
            if self._logger is not None:
                try:
                    self._logger.warning(
                        "cluster_qos_degraded",
                        aggregate_burn_rate=round(aggregate_burn, 2),
                        qos_scale=self.degrade_scale,
                    )
                except Exception:
                    pass
        elif self.degraded and aggregate_burn <= (
            self.alert_burn_rate * self.recovery_fraction
        ):
            self.degraded = False
            self.degraded_since = None
            if self._logger is not None:
                try:
                    self._logger.info(
                        "cluster_qos_recovered",
                        aggregate_burn_rate=round(aggregate_burn, 2),
                    )
                except Exception:
                    pass
        if self._qos is not None:
            self._qos.set_scale(
                self.degrade_scale if self.degraded else 1.0,
                reason=(
                    "cluster aggregate burn alert"
                    if self.degraded
                    else ""
                ),
            )

    def directives(self) -> dict:
        """The fleet order embedded in every heartbeat reply."""
        return {
            "qos_scale": self.degrade_scale if self.degraded else 1.0,
            "degraded": self.degraded,
            "reason": (
                "cluster aggregate burn alert" if self.degraded else ""
            ),
        }

    # -- surfaces -------------------------------------------------------------

    def status(self) -> dict:
        """Last cycle's fleet view (``/cluster/status`` body). Never
        scrapes inline — the serving path only reads the cached dict."""
        with self._lock:
            if self._last_status:
                return self._last_status
        # before the first cycle lands, answer from membership alone
        rows = self.membership.members()
        return {
            "cluster": {
                "members": len(rows),
                "alive": sum(1 for r in rows if r["alive"]),
                "health": "unknown",
                "scrape": {"cycles": 0},
            },
            "members": rows,
        }

    def member_read_urls(self) -> list:
        """[(instance_id, read_url)] for alive members — the /debug
        trace-stitch fan-out targets."""
        out = []
        for row in self.membership.alive():
            url = (row.get("read_url") or "").rstrip("/")
            if url:
                out.append((row["instance_id"], url))
        return out

    # -- lifecycle ------------------------------------------------------------

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.run_once()
            except Exception as e:
                if self._logger is not None:
                    try:
                        self._logger.warning(
                            "cluster_scrape_cycle_error",
                            error=f"{type(e).__name__}: {e}",
                        )
                    except Exception:
                        pass
            self._stop.wait(self.scrape_interval_s)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="keto-cluster-federation", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=self.timeout_s + self.scrape_interval_s)
            self._thread = None
