"""Overload-control plane (counterpart of ``keto_tpu/engine/overload.py``):
adaptive admission, the criticality brownout ladder and server-side
adaptive throttling in front of the check batcher.

Before this plane the batcher's only defence at saturation is its fixed
``max_queue`` bound, which sheds blindly once the queue is already
``max_queue/max_batch`` dispatches deep. Three pieces close the loop:

- :class:`AdaptiveLimiter`: an AIMD limit on the standing queue, driven by
  each batch's queue delay and service time against an EWMA baseline,
  plus the CoDel half (Nichols & Jacobson): a queue delay above
  ``target_delay_s`` for a whole ``interval_s`` flips the batcher from
  FIFO to adaptive LIFO and culls entries queued longer than the target.
- :class:`BrownoutController`: the ladder normal → hedge_suppress →
  bounded_stale → shed_sheddable → shed_default, one rung at a time, by
  pressure (queue length over the limit, latency over the target). A rung
  steps down only after a quiet ``hysteresis_s`` window. ``critical`` is
  never shed by the ladder: only ``max_queue`` can refuse it.
- :class:`AdaptiveThrottle`: the SRE accepts/requests throttle, rejecting
  with probability ``max(0, (requests - K*accepts) / (requests + 1))``
  once the ladder sheds.

:class:`OverloadController` is the facade the batcher calls: ``admit``
under its queue lock, ``observe`` once per dispatched batch. The clock and
the random source are injectable, so a test drives the plane
deterministically. Standard library only.

``OverloadController.snapshot`` and ``history`` are what ``/debug/overload``
serves (``api/debug.py``). With a metrics registry the controller exports
the reference's ``keto_overload_*`` families; the registry hands the ladder
its flight recorder and logger, which record every rung transition.
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque
from typing import Callable, Optional

CRITICAL = "critical"
DEFAULT = "default"
SHEDDABLE = "sheddable"
CRITICALITIES = (CRITICAL, DEFAULT, SHEDDABLE)

# shed order: higher rank sheds first; critical (rank 0) never sheds
_RANK = {CRITICAL: 0, DEFAULT: 1, SHEDDABLE: 2}

# the brownout ladder, in escalation order
STATE_NORMAL = 0
STATE_HEDGE_SUPPRESS = 1
STATE_BOUNDED_STALE = 2
STATE_SHED_SHEDDABLE = 3
STATE_SHED_DEFAULT = 4
STATE_NAMES = (
    "normal",
    "hedge_suppress",
    "bounded_stale",
    "shed_sheddable",
    "shed_default",
)


def parse_criticality(raw, default: str = DEFAULT) -> str:
    """Normalize a wire-supplied criticality class. Unknown/empty values
    fall back to ``default`` rather than erroring: a typo'd header must
    not change the caller's answer, only (possibly) its shed priority."""
    if raw is None:
        return default
    v = str(raw).strip().lower()
    return v if v in _RANK else default


class AdaptiveLimiter:
    """AIMD limit on the batcher's standing queue + CoDel delay target.

    Not thread-safe on its own — the owning :class:`OverloadController`
    serializes calls under its lock.
    """

    def __init__(
        self,
        initial: float,
        min_limit: float = 8,
        max_limit: float = 1 << 20,
        additive: float = 1.0,
        decrease: float = 0.9,
        target_delay_s: float = 0.1,
        interval_s: float = 0.1,
        tolerance: float = 2.0,
        baseline_alpha: float = 0.05,
        recent_alpha: float = 0.3,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.min_limit = float(min_limit)
        self.max_limit = float(max_limit)
        self.limit = min(self.max_limit, max(self.min_limit, float(initial)))
        self.additive = float(additive)
        self.decrease = float(decrease)
        self.target_delay_s = float(target_delay_s)
        self.interval_s = float(interval_s)
        self.tolerance = float(tolerance)
        self.baseline_alpha = float(baseline_alpha)
        self.recent_alpha = float(recent_alpha)
        self._clock = clock
        self._baseline: Optional[float] = None  # EWMA in healthy windows
        self._recent: Optional[float] = None  # fast EWMA, always updated
        self._above_since: Optional[float] = None  # CoDel: delay > target
        self.overloaded = False  # sustained standing queue
        self._last_adjust: Optional[float] = None
        self.decreases = 0
        self.increases = 0

    def observe(self, queue_delay_s: float, service_s: float = 0.0) -> None:
        """Feed one dispatched batch's queue delay (enqueue → dequeue)
        and service time. Runs the CoDel sustain detector and at most one
        AIMD adjustment per ``interval_s``."""
        now = self._clock()
        lat = float(queue_delay_s) + float(service_s)
        ra = self.recent_alpha
        self._recent = (
            lat if self._recent is None else (1 - ra) * self._recent + ra * lat
        )
        if self._baseline is None:
            self._baseline = lat
        elif not self.overloaded:
            # the baseline only learns from healthy windows; during an
            # overload episode it must keep remembering what "good"
            # looked like, or the inflation test would chase the storm
            ba = self.baseline_alpha
            self._baseline = (1 - ba) * self._baseline + ba * lat
        # CoDel sustain: above target continuously for one full interval
        if queue_delay_s > self.target_delay_s:
            if self._above_since is None:
                self._above_since = now
            elif now - self._above_since >= self.interval_s:
                self.overloaded = True
        else:
            self._above_since = None
            self.overloaded = False
        if self._last_adjust is not None and (
            now - self._last_adjust < self.interval_s
        ):
            return
        self._last_adjust = now
        inflated = (
            self._baseline is not None
            and self._recent is not None
            and self._recent > self.tolerance * max(self._baseline, 1e-9)
        )
        if self.overloaded or inflated or queue_delay_s > self.target_delay_s:
            new = max(self.min_limit, self.limit * self.decrease)
            if new < self.limit:
                self.decreases += 1
            self.limit = new
        else:
            new = min(self.max_limit, self.limit + self.additive)
            if new > self.limit:
                self.increases += 1
            self.limit = new

    def delay_ratio(self) -> float:
        """Recent observed latency over the CoDel target — the latency
        half of the brownout pressure signal."""
        if self._recent is None:
            return 0.0
        return self._recent / max(self.target_delay_s, 1e-9)

    def lifo(self) -> bool:
        """FIFO→adaptive-LIFO flip: serve newest-first while the standing
        queue is sustained (the oldest entries are the least likely to
        still meet their deadlines)."""
        return self.overloaded

    def cull_age_s(self) -> Optional[float]:
        """Queued-age cull threshold while overloaded, else None (no
        culling below sustained pressure — CoDel tolerates bursts)."""
        return self.target_delay_s if self.overloaded else None

    def note_idle(self, idle_s: float) -> None:
        """The queue stayed empty for ``idle_s``. No standing queue
        survives a whole interval of emptiness (CoDel leaves its dropping
        state when the queue empties), so the sustained-delay verdict is
        cleared; a shorter gap between two drains of a storm keeps it.
        Without this, the verdict of a storm's last batch would outlive
        any quiet spell and cull the next lone request on its first
        scheduling delay past the target."""
        if idle_s >= self.interval_s:
            self._above_since = None
            self.overloaded = False

    def snapshot(self) -> dict:
        return {
            "limit": round(self.limit, 2),
            "min_limit": self.min_limit,
            "target_delay_ms": round(self.target_delay_s * 1e3, 3),
            "baseline_ms": (
                round(self._baseline * 1e3, 3)
                if self._baseline is not None
                else None
            ),
            "recent_ms": (
                round(self._recent * 1e3, 3)
                if self._recent is not None
                else None
            ),
            "overloaded": self.overloaded,
            "lifo": self.lifo(),
            "increases": self.increases,
            "decreases": self.decreases,
        }


class BrownoutController:
    """The criticality ladder with hysteresis. Pressure is unitless
    (1.0 = at the adaptive limit / at the latency target); the rung
    thresholds say how far past it each degradation engages. Not
    thread-safe on its own — serialized by :class:`OverloadController`.
    """

    def __init__(
        self,
        up_thresholds: tuple = (1.0, 1.5, 2.0, 3.0),
        down_ratio: float = 0.7,
        hysteresis_s: float = 1.0,
        min_dwell_s: float = 0.05,
        flight=None,
        logger=None,
        clock: Callable[[], float] = time.monotonic,
        history: int = 256,
    ):
        if len(up_thresholds) != len(STATE_NAMES) - 1:
            raise ValueError(
                f"need {len(STATE_NAMES) - 1} rung thresholds, got "
                f"{len(up_thresholds)}"
            )
        if any(b <= a for a, b in zip(up_thresholds, up_thresholds[1:])):
            raise ValueError("rung thresholds must strictly increase")
        self.up_thresholds = tuple(float(t) for t in up_thresholds)
        self.down_ratio = float(down_ratio)
        self.hysteresis_s = float(hysteresis_s)
        self.min_dwell_s = float(min_dwell_s)
        self._flight = flight
        self._logger = logger
        self._clock = clock
        self.state = STATE_NORMAL
        self._last_change: Optional[float] = None
        self._below_since: Optional[float] = None
        self._last_update: Optional[float] = None
        self.transitions_up = 0
        self.transitions_down = 0
        self._history: deque[dict] = deque(maxlen=max(1, int(history)))
        # called with "up"/"down" on every rung change (the controller's
        # transitions counter)
        self._on_transition = None

    def update(self, pressure: float, now: Optional[float] = None) -> int:
        """Fold one pressure sample into the ladder. Steps up at most one
        rung per ``min_dwell_s`` (so escalation is ordered and every rung
        is observable); steps down one rung only after pressure has held
        below ``down_ratio`` of the current rung's threshold for a full
        ``hysteresis_s`` window."""
        if now is None:
            now = self._clock()
        self._last_update = now
        if (
            self.state < len(self.up_thresholds)
            and pressure >= self.up_thresholds[self.state]
        ):
            self._below_since = None
            if (
                self._last_change is None
                or now - self._last_change >= self.min_dwell_s
            ):
                self._step(self.state + 1, pressure, now, "up")
        elif self.state > 0 and pressure < (
            self.down_ratio * self.up_thresholds[self.state - 1]
        ):
            if self._below_since is None:
                self._below_since = now
            elif now - self._below_since >= self.hysteresis_s:
                self._step(self.state - 1, pressure, now, "down")
                # the next rung down needs its own full quiet window
                self._below_since = now
        else:
            self._below_since = None
        return self.state

    def current(self, now: Optional[float] = None) -> int:
        """The ladder state with idle decay applied: no traffic is zero
        pressure, so a fully idle node steps down one rung per elapsed
        hysteresis window instead of freezing browned-out forever."""
        if now is None:
            now = self._clock()
        while self.state > 0:
            ref = max(
                self._last_update or 0.0, self._last_change or 0.0
            )
            if now - ref < self.hysteresis_s:
                break
            stepped_at = ref + self.hysteresis_s
            self._step(self.state - 1, 0.0, stepped_at, "down")
            self._last_update = stepped_at
        return self.state

    def _step(
        self, new_state: int, pressure: float, now: float, direction: str
    ) -> None:
        old = self.state
        self.state = new_state
        self._last_change = now
        if direction == "up":
            self.transitions_up += 1
        else:
            self.transitions_down += 1
        event = {
            "ts": now,
            "direction": direction,
            "from": STATE_NAMES[old],
            "to": STATE_NAMES[new_state],
            "state": new_state,
            "pressure": round(float(pressure), 3),
        }
        self._history.append(event)
        if self._on_transition is not None:
            try:
                self._on_transition(direction)
            except Exception:
                pass
        if self._flight is not None:
            try:
                self._flight.record(kind="overload", **event)
            except Exception:
                pass
        if self._logger is not None:
            try:
                self._logger.info("overload brownout", **event)
            except Exception:
                pass

    def should_shed(self, criticality: str) -> bool:
        """Whether the ladder sheds this class at the current rung.
        ``critical`` is NEVER shed here — only the hard queue bound."""
        rank = _RANK.get(criticality, _RANK[DEFAULT])
        if rank == _RANK[CRITICAL]:
            return False
        if self.state >= STATE_SHED_DEFAULT:
            return True
        return self.state >= STATE_SHED_SHEDDABLE and rank >= _RANK[SHEDDABLE]

    def hedge_suppressed(self) -> bool:
        return self.state >= STATE_HEDGE_SUPPRESS

    def stale_ok(self) -> bool:
        return self.state >= STATE_BOUNDED_STALE

    def history(self, n: Optional[int] = None) -> list[dict]:
        out = list(self._history)
        out.reverse()
        return out if n is None else out[: max(0, int(n))]

    def snapshot(self) -> dict:
        return {
            "state": self.state,
            "state_name": STATE_NAMES[self.state],
            "ladder": list(STATE_NAMES),
            "up_thresholds": list(self.up_thresholds),
            "down_ratio": self.down_ratio,
            "hysteresis_s": self.hysteresis_s,
            "transitions_up": self.transitions_up,
            "transitions_down": self.transitions_down,
            "hedge_suppressed": self.hedge_suppressed(),
            "stale_ok": self.stale_ok(),
        }


class AdaptiveThrottle:
    """Sliding-window accepts/requests tracking with the SRE reject
    probability ``max(0, (requests - K*accepts) / (requests + 1))``.
    Bucketed per second so the window slides without per-request
    timestamps. Not thread-safe on its own — serialized by
    :class:`OverloadController` (or a caller's lock in tests)."""

    def __init__(
        self,
        window_s: float = 30.0,
        k: float = 2.0,
        bucket_s: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.window_s = float(window_s)
        self.k = float(k)
        self.bucket_s = max(1e-3, float(bucket_s))
        self._clock = clock
        # deque of [bucket_index, requests, accepts]
        self._buckets: deque[list] = deque()

    def _bucket(self, now: float) -> list:
        idx = int(now / self.bucket_s)
        horizon = idx - int(self.window_s / self.bucket_s)
        while self._buckets and self._buckets[0][0] <= horizon:
            self._buckets.popleft()
        if not self._buckets or self._buckets[-1][0] != idx:
            self._buckets.append([idx, 0, 0])
        return self._buckets[-1]

    def on_request(self, now: Optional[float] = None) -> None:
        b = self._bucket(self._clock() if now is None else now)
        b[1] += 1

    def on_accept(self, now: Optional[float] = None) -> None:
        b = self._bucket(self._clock() if now is None else now)
        b[2] += 1

    def totals(self, now: Optional[float] = None) -> tuple[int, int]:
        self._bucket(self._clock() if now is None else now)  # roll window
        reqs = sum(b[1] for b in self._buckets)
        accs = sum(b[2] for b in self._buckets)
        return reqs, accs

    def reject_probability(self, now: Optional[float] = None) -> float:
        reqs, accs = self.totals(now)
        return max(0.0, (reqs - self.k * accs) / (reqs + 1.0))

    def snapshot(self) -> dict:
        reqs, accs = self.totals()
        return {
            "window_s": self.window_s,
            "k": self.k,
            "requests": reqs,
            "accepts": accs,
            "reject_probability": round(self.reject_probability(), 4),
        }


class OverloadController:
    """The facade the CheckBatcher (and the registry) talk to.

    ``admit`` runs under the batcher's admission lock — it must stay
    cheap (a few float compares). ``observe`` runs on the dispatch/encode
    stage threads. An internal lock serializes the two against each
    other."""

    def __init__(
        self,
        max_queue: int,
        limiter: Optional[AdaptiveLimiter] = None,
        brownout: Optional[BrownoutController] = None,
        throttle: Optional[AdaptiveThrottle] = None,
        flight=None,
        logger=None,
        enabled_fn: Optional[Callable[[], bool]] = None,
        clock: Callable[[], float] = time.monotonic,
        rand: Callable[[], float] = random.random,
        metrics=None,
    ):
        self.max_queue = int(max_queue)
        self.limiter = limiter or AdaptiveLimiter(
            initial=max_queue, max_limit=max_queue, clock=clock
        )
        self.brownout = brownout or BrownoutController(
            flight=flight, logger=logger, clock=clock
        )
        self.throttle = throttle or AdaptiveThrottle(clock=clock)
        self._enabled_fn = enabled_fn
        self._clock = clock
        self._rand = rand
        self._lock = threading.Lock()
        self.sheds = {c: 0 for c in CRITICALITIES}
        self.throttle_rejects = 0
        self.culled = 0
        self.stale_served = 0
        self.admitted = 0
        self._m_sheds = None
        self._m_throttle = None
        self._m_culled = None
        self._m_stale = None
        if metrics is not None:
            metrics.gauge(
                "keto_overload_state",
                "brownout ladder rung: 0 normal, 1 hedge-suppress, "
                "2 bounded-stale, 3 shed-sheddable, 4 shed-default",
                fn=lambda: float(self.state()),
            )
            metrics.gauge(
                "keto_overload_limit",
                "adaptive admission limit on the check queue (AIMD; "
                "max_queue remains the hard bound)",
                fn=lambda: float(self.limiter.limit),
            )
            self._m_sheds = metrics.counter(
                "keto_overload_sheds_total",
                "check requests shed by the overload ladder, by "
                "criticality class",
                labelnames=("criticality",),
            )
            transitions = metrics.counter(
                "keto_overload_transitions_total",
                "brownout ladder transitions, by direction",
                labelnames=("direction",),
            )
            self._m_throttle = metrics.counter(
                "keto_overload_throttle_rejected_total",
                "check requests probabilistically rejected by the "
                "server's adaptive (accepts/requests) throttle",
            )
            self._m_culled = metrics.counter(
                "keto_overload_culled_total",
                "queued check entries culled because their queued age "
                "exceeded the CoDel target under sustained pressure",
            )
            self._m_stale = metrics.counter(
                "keto_overload_stale_served_total",
                "checks whose snaptoken freshness wait was relaxed to "
                "bounded-stale by the brownout ladder",
            )
            self.brownout._on_transition = (
                lambda d: transitions.labels(direction=d).inc()
            )

    # -- state ----------------------------------------------------------------

    def enabled(self) -> bool:
        if self._enabled_fn is None:
            return True
        try:
            return bool(self._enabled_fn())
        except Exception:
            return True

    def state(self) -> int:
        """Current ladder rung with idle decay applied — what the
        degradation checks below read."""
        if not self.enabled():
            return STATE_NORMAL
        with self._lock:
            return self.brownout.current()

    def pressure(self, queue_len: Optional[int] = None) -> float:
        p = self.limiter.delay_ratio()
        if queue_len is not None:
            p = max(p, queue_len / max(self.limiter.limit, 1.0))
        return p

    # -- the two hot-path hooks -------------------------------------------------

    def admit(self, queue_len: int, criticality: str = DEFAULT):
        """One admission decision under the batcher's lock. Returns None
        to admit, or a short shed-reason string (``brownout`` /
        ``throttle``) — the batcher raises the typed 429 and bumps its
        own shed counter; the by-class accounting happens here."""
        if not self.enabled():
            return None
        now = self._clock()
        with self._lock:
            self.throttle.on_request(now)
            state = self.brownout.update(self.pressure(queue_len), now)
            reason = None
            if state >= STATE_SHED_SHEDDABLE and self.brownout.should_shed(
                criticality
            ):
                reason = "brownout"
            elif (
                # probabilistic brake on the surviving non-critical
                # classes once the ladder sheds (state >= 3): reject at
                # the SRE accepts/requests rate instead of jumping
                # straight to the next deterministic rung. The ordering
                # invariant holds anyway: reject_probability only leaves
                # zero after requests outrun accepts across the window,
                # long after rung 3's deterministic sheddable sheds began
                state >= STATE_SHED_SHEDDABLE
                and _RANK.get(criticality, 1) > _RANK[CRITICAL]
                and self._rand() < self.throttle.reject_probability(now)
            ):
                reason = "throttle"
                self.throttle_rejects += 1
                if self._m_throttle is not None:
                    self._m_throttle.inc()
            if reason is not None:
                c = criticality if criticality in self.sheds else DEFAULT
                self.sheds[c] += 1
                if self._m_sheds is not None:
                    self._m_sheds.labels(criticality=c).inc()
                return reason
            self.throttle.on_accept(now)
            self.admitted += 1
            return None

    def observe(self, queue_delay_s: float, service_s: float = 0.0) -> None:
        """Per dispatched batch: feed the limiter and re-evaluate the
        ladder against the latency half of the pressure signal."""
        if not self.enabled():
            return
        with self._lock:
            self.limiter.observe(queue_delay_s, service_s)
            self.brownout.update(self.pressure())

    # -- degradation queries (each cheap, called from the hot paths) -----------

    def lifo(self) -> bool:
        return self.enabled() and self.limiter.lifo()

    def cull_age_s(self) -> Optional[float]:
        return self.limiter.cull_age_s() if self.enabled() else None

    def note_idle(self, idle_s: float) -> None:
        """The batcher's queue stayed empty for ``idle_s`` (see
        :meth:`AdaptiveLimiter.note_idle`)."""
        with self._lock:
            self.limiter.note_idle(idle_s)

    def note_culled(self, n: int) -> None:
        with self._lock:
            self.culled += n
        if self._m_culled is not None:
            self._m_culled.inc(n)

    def stale_ok(self) -> bool:
        """Brownout rung 2+: relax a snaptoken freshness wait to
        bounded-stale (answer at the engine's current snapshot)."""
        if not self.enabled():
            return False
        with self._lock:
            return self.brownout.current() >= STATE_BOUNDED_STALE

    def note_stale_served(self) -> None:
        with self._lock:
            self.stale_served += 1
        if self._m_stale is not None:
            self._m_stale.inc()

    def hedge_suppressed(self) -> bool:
        """Brownout rung 1+: stop advertising a hedge delay to clients
        (``/debug/autotune`` blanks its ``hedge_delay_ms`` knob then)."""
        if not self.enabled():
            return False
        with self._lock:
            return self.brownout.current() >= STATE_HEDGE_SUPPRESS

    # -- introspection ----------------------------------------------------------

    def history(self, n: Optional[int] = None) -> list[dict]:
        with self._lock:
            return self.brownout.history(n)

    def snapshot(self) -> dict:
        """The plane's state as one object (``/debug/overload``)."""
        with self._lock:
            state = self.brownout.current()
            return {
                "enabled": self.enabled(),
                "state": state,
                "state_name": STATE_NAMES[state],
                "pressure": round(self.pressure(), 3),
                "max_queue": self.max_queue,
                "limiter": self.limiter.snapshot(),
                "brownout": self.brownout.snapshot(),
                "throttle": self.throttle.snapshot(),
                "admitted": self.admitted,
                "sheds_by_class": dict(self.sheds),
                "throttle_rejects": self.throttle_rejects,
                "culled": self.culled,
                "stale_served": self.stale_served,
            }
