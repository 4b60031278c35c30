"""Online autotuner: ledger-driven feedback control of the serving knobs
(counterpart of ``keto_tpu/engine/autotune.py``).

The serving stack carries hand-set performance knobs (pipeline depth,
encode workers, the encoded-cache capacity, the HBM budget fraction, the
sharded tier's escalation budget, the Expand page size, the advertised
hedge delay) and a conserved wall-clock ledger (``telemetry/
attribution.py``) that says, each control interval, which stage the
marginal second went to. This module closes the loop:

- :class:`Knob`: name, owning attribution stage, bounds, step, the
  direction that helps, and the ``read``/``apply`` callables the registry
  threads to the live component seams (``CheckBatcher.reconfigure``,
  ``EncodedCache.resize``, ``HbmAdmission.set_budget_frac``, attribute sets
  on the expand, list and sharded engines, the hedge-delay advertisement).
- :class:`AutoTuner`, a bounded hill climber: each tick diffs the
  attribution snapshot, computes the objective (finished checks per
  attributed wall second), finds the bottleneck stage and moves that
  stage's knob ONE step in its helpful direction. The next tick judges the
  move against the pre-move baseline: a regression past
  ``revert_threshold`` puts the old value back and sits the (knob,
  direction) out for ``backoff_ticks`` ticks, so the climb converges
  instead of oscillating.
- Guard rails: every move freezes while the SLO's fast-window burn rate is
  at or above the alert threshold, or while an injected guard (the breaker
  open, HBM pressure; the registry wires both) names a reason. A pending
  move is reverted when a freeze hits: the newest change is the likeliest
  cause.
- Visibility: every move, commit, revert and freeze transition is a flight
  record (``kind=autotune``) with the before and after breakdowns, lands in
  the ``/debug/autotune`` history ring, and counts in
  ``keto_autotune_moves_total{knob,direction}`` /
  ``keto_autotune_reverts_total``; ``keto_autotune_frozen`` says whether
  moves are frozen and ``keto_autotune_knob_value{knob}`` samples each
  knob's live value at scrape time.

Everything is injectable (clock, ledger, SLO, guards, knob callables), so
the tests drive convergence deterministically against a scripted ledger.
The kill switch is the hot-reloadable ``autotune.enabled``: the daemon
reads it through ``enabled_fn`` every tick, so turning it off in the config
file stops every move at the next tick without a restart. The tuner is
host code only: it launches nothing on the card.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional, Sequence

from ..telemetry.attribution import UNATTRIBUTED


class Knob:
    """One tunable serving knob: identity, bounds, and the live seam.

    ``read``/``apply`` are the component callables: ``read()`` returns the
    current value, ``apply(v)`` installs a new one on the LIVE component
    (and, for config-backed knobs, writes it through the validated
    ``Config.set_hot`` path so /debug/config agrees with reality).
    ``stage`` names the attribution stage this knob owns; when that stage
    is the bottleneck the controller moves this knob. ``higher_helps``
    gives the hill-climb direction: True = raise the knob when its stage
    dominates, False = lower it."""

    __slots__ = (
        "name", "key", "stage", "lo", "hi", "step", "read", "apply",
        "higher_helps", "integer", "enabled",
    )

    def __init__(
        self,
        name: str,
        stage: str,
        lo: float,
        hi: float,
        step: float,
        read: Callable[[], float],
        apply: Callable[[float], None],
        higher_helps: bool = True,
        integer: bool = True,
        key: str = "",
        enabled: bool = True,
    ):
        if hi < lo:
            raise ValueError(f"knob {name}: hi {hi} < lo {lo}")
        if step <= 0:
            raise ValueError(f"knob {name}: step must be positive")
        self.name = name
        self.key = key  # config key, "" for virtual knobs (hedge delay)
        self.stage = stage
        self.lo = lo
        self.hi = hi
        self.step = step
        self.read = read
        self.apply = apply
        self.higher_helps = bool(higher_helps)
        self.integer = bool(integer)
        self.enabled = bool(enabled)

    def clamp(self, value: float) -> float:
        v = min(self.hi, max(self.lo, value))
        return int(round(v)) if self.integer else v

    def describe(self) -> dict:
        return {
            "key": self.key or None,
            "stage": self.stage,
            "lo": self.lo,
            "hi": self.hi,
            "step": self.step,
            "higher_helps": self.higher_helps,
            "enabled": self.enabled,
            "value": self.read(),
        }


class AutoTuner:
    """The feedback controller. Synchronous :meth:`step` does one control
    tick (the tests call it directly); :meth:`start` runs it on a daemon
    thread every ``interval_s``. The registry (``driver/registry.py``)
    starts that thread in ``start_all`` AFTER any replica fork — never at
    construction — so it can't violate fork hygiene."""

    def __init__(
        self,
        knobs: Sequence[Knob],
        attribution,  # AttributionLedger (or anything with .snapshot())
        slo=None,  # SLOTracker; None disables the burn-rate freeze
        metrics=None,
        flight=None,
        logger=None,
        interval_s: float = 5.0,
        min_requests: int = 32,
        revert_threshold: float = 0.05,
        freeze_burn_rate: float = 0.0,  # 0 = inherit slo.alert_burn_rate
        backoff_ticks: int = 3,
        history: int = 256,
        enabled_fn: Optional[Callable[[], bool]] = None,
        guards: Sequence[Callable[[], Optional[str]]] = (),
        clock: Callable[[], float] = time.monotonic,
    ):
        self.knobs = list(knobs)
        self._by_stage: dict[str, list[Knob]] = {}
        for k in self.knobs:
            self._by_stage.setdefault(k.stage, []).append(k)
        self._attribution = attribution
        self._slo = slo
        self._flight = flight
        self._logger = logger
        self.interval_s = float(interval_s)
        self.min_requests = max(1, int(min_requests))
        self.revert_threshold = float(revert_threshold)
        self.freeze_burn_rate = float(freeze_burn_rate)
        self.backoff_ticks = max(0, int(backoff_ticks))
        self._enabled_fn = enabled_fn
        self._guards = list(guards)
        self._clock = clock
        self._lock = threading.Lock()
        self._history: deque[dict] = deque(maxlen=max(1, int(history)))
        self._last: Optional[dict] = None  # previous cumulative snapshot
        self._baseline: Optional[float] = None  # checks/s before the move
        self._pending: Optional[dict] = None  # the move awaiting judgment
        self._backoff: dict[tuple[str, int], int] = {}
        self._was_frozen: Optional[str] = None
        self.moves_total = 0
        self.reverts_total = 0
        self.ticks = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._m_moves = None
        self._m_reverts = None
        self._m_frozen = None
        if metrics is not None:
            self._m_moves = metrics.counter(
                "keto_autotune_moves_total",
                "autotuner knob moves applied, by knob and direction",
                labelnames=("knob", "direction"),
            )
            self._m_reverts = metrics.counter(
                "keto_autotune_reverts_total",
                "autotuner moves reverted (objective regressed past the "
                "threshold, or a freeze guard fired mid-evaluation)",
            )
            self._m_frozen = metrics.gauge(
                "keto_autotune_frozen",
                "1 while autotuner moves are frozen (SLO burn alert or a "
                "breaker/HBM guard), else 0",
            )
            value = metrics.gauge(
                "keto_autotune_knob_value",
                "current value of each autotuned serving knob",
                labelnames=("knob",),
            )
            for k in self.knobs:
                # sampled at scrape time, so the gauge tracks reverts and
                # operator writes too, not only this controller's moves
                value.labels(knob=k.name).set_fn(
                    lambda k=k: float(k.read())
                )

    # -- daemon lifecycle -------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="autotune", daemon=True
        )
        self._thread.start()

    def stop(self, timeout_s: float = 5.0) -> None:
        t = self._thread
        if t is None:
            return
        self._stop.set()
        t.join(timeout=timeout_s)
        self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.step()
            except Exception as e:
                if self._logger is not None:
                    self._logger.warn(
                        "autotune tick failed", error=f"{type(e).__name__}: {e}"
                    )

    # -- the control tick -------------------------------------------------------

    def step(self) -> dict:
        """One control tick: diff the ledger, judge the pending move,
        freeze or make the next bounded move. Returns the event dict (the
        same payload that lands in the history ring / flight recorder)."""
        with self._lock:
            return self._step_locked()

    def _step_locked(self) -> dict:
        self.ticks += 1
        now = self._clock()
        if self._enabled_fn is not None and not self._enabled_fn():
            # the hot-reloadable kill switch: drop controller state so a
            # re-enable starts from a fresh measurement window
            self._pending = None
            self._baseline = None
            self._last = None
            return {"ts": now, "action": "disabled"}
        snap = self._attribution.snapshot()
        prev, self._last = self._last, snap
        if prev is None:
            return {"ts": now, "action": "warmup"}
        d_req = snap["requests"] - prev["requests"]
        d_wall = snap["wall_s"] - prev["wall_s"]
        stages: dict[str, float] = {}
        for s, v in snap.get("stages", {}).items():
            ds = v["seconds"] - prev.get("stages", {}).get(s, {}).get(
                "seconds", 0.0
            )
            if ds > 0:
                stages[s] = ds
        if d_req < self.min_requests or d_wall <= 0:
            # too little traffic to attribute a bottleneck; also holds the
            # pending move un-judged until a window with real signal
            return {"ts": now, "action": "idle", "window_requests": d_req}
        objective = d_req / d_wall
        frozen = self._frozen_reason()
        if self._m_frozen is not None:
            self._m_frozen.set(1.0 if frozen else 0.0)
        if self._pending is not None:
            p, self._pending = self._pending, None
            regressed = (
                self._baseline is not None
                and objective
                < self._baseline * (1.0 - self.revert_threshold)
            )
            if frozen is not None or regressed:
                return self._revert(
                    p, objective, stages, now,
                    reason=frozen if frozen is not None else "regression",
                )
            self._baseline = objective
            self._emit(
                {
                    "ts": now,
                    "action": "commit",
                    "knob": p["knob"].name,
                    "stage": p["stage"],
                    "old": p["old"],
                    "new": p["new"],
                    "direction": p["direction"],
                    "objective_checks_per_s": round(objective, 3),
                    "before": p["before"],
                    "after": _round_stages(stages),
                }
            )
        else:
            self._baseline = objective
        if frozen is not None:
            event = {"ts": now, "action": "frozen", "reason": frozen}
            if self._was_frozen != frozen:
                self._emit(event)  # record the transition, not every tick
            self._was_frozen = frozen
            return event
        self._was_frozen = None
        event = self._make_move(objective, stages, now)
        # backoffs burn down AFTER the move attempt, and only on active
        # (non-idle, non-frozen) ticks: a revert with backoff_ticks=N
        # sits its (knob, direction) out exactly N judged windows
        for key in list(self._backoff):
            self._backoff[key] -= 1
            if self._backoff[key] <= 0:
                del self._backoff[key]
        return event

    def _make_move(
        self, objective: float, stages: dict, now: float
    ) -> dict:
        for stage, _secs in sorted(stages.items(), key=lambda kv: -kv[1]):
            if stage == UNATTRIBUTED:
                continue
            for knob in self._by_stage.get(stage, ()):
                if not knob.enabled:
                    continue
                direction = 1 if knob.higher_helps else -1
                if self._backoff.get((knob.name, direction), 0) > 0:
                    continue
                old = knob.read()
                new = knob.clamp(old + direction * knob.step)
                if new == old:
                    continue  # already at the helpful bound
                try:
                    knob.apply(new)
                except Exception as e:
                    # an applier that refuses (validation, closed
                    # component) disqualifies the knob this round; the
                    # next candidate gets its shot
                    self._backoff[(knob.name, direction)] = max(
                        1, self.backoff_ticks
                    )
                    self._emit(
                        {
                            "ts": now,
                            "action": "apply_failed",
                            "knob": knob.name,
                            "stage": stage,
                            "old": old,
                            "new": new,
                            "error": f"{type(e).__name__}: {e}",
                        }
                    )
                    continue
                self.moves_total += 1
                if self._m_moves is not None:
                    self._m_moves.labels(
                        knob=knob.name,
                        direction="up" if direction > 0 else "down",
                    ).inc()
                self._pending = {
                    "knob": knob,
                    "stage": stage,
                    "old": old,
                    "new": new,
                    "direction": direction,
                    "before": _round_stages(stages),
                }
                return self._emit(
                    {
                        "ts": now,
                        "action": "move",
                        "knob": knob.name,
                        "stage": stage,
                        "old": old,
                        "new": new,
                        "direction": direction,
                        "objective_checks_per_s": round(objective, 3),
                        "before": _round_stages(stages),
                    }
                )
        return {"ts": now, "action": "steady"}

    def _revert(
        self, p: dict, objective: float, stages: dict, now: float,
        reason: str,
    ) -> dict:
        knob = p["knob"]
        try:
            knob.apply(p["old"])
        except Exception as e:
            if self._logger is not None:
                self._logger.warn(
                    "autotune revert failed; knob left at the moved value",
                    knob=knob.name,
                    error=f"{type(e).__name__}: {e}",
                )
        self.reverts_total += 1
        if self._m_reverts is not None:
            self._m_reverts.inc()
        # the (knob, direction) pair sits out; other knobs keep climbing
        self._backoff[(knob.name, p["direction"])] = self.backoff_ticks
        return self._emit(
            {
                "ts": now,
                "action": "revert",
                "knob": knob.name,
                "stage": p["stage"],
                "old": p["new"],  # the value being rolled back ...
                "new": p["old"],  # ... to the pre-move value
                "direction": -p["direction"],
                "reason": reason,
                "objective_checks_per_s": round(objective, 3),
                "baseline_checks_per_s": (
                    round(self._baseline, 3)
                    if self._baseline is not None
                    else None
                ),
                "before": p["before"],
                "after": _round_stages(stages),
            }
        )

    def _frozen_reason(self) -> Optional[str]:
        slo = self._slo
        if slo is not None:
            threshold = self.freeze_burn_rate or slo.alert_burn_rate
            if slo.burn_rate(slo.fast_window_s) >= threshold:
                return "slo_burn"
        for guard in self._guards:
            try:
                reason = guard()
            except Exception:
                reason = None
            if reason:
                return str(reason)
        return None

    def _emit(self, event: dict) -> dict:
        self._history.append(event)
        if self._flight is not None:
            try:
                self._flight.record(kind="autotune", **event)
            except Exception:
                pass
        if self._logger is not None:
            try:
                self._logger.info("autotune", **{
                    k: v for k, v in event.items()
                    if k not in ("before", "after")
                })
            except Exception:
                pass
        return event

    # -- introspection ----------------------------------------------------------

    def history(self, n: Optional[int] = None) -> list[dict]:
        """Newest-first controller events (the /debug/autotune body)."""
        with self._lock:
            out = list(self._history)
        out.reverse()
        return out if n is None else out[: max(0, int(n))]

    def knob_values(self) -> dict:
        """Current value of every registered knob."""
        return {k.name: k.read() for k in self.knobs}

    def snapshot(self) -> dict:
        enabled = (
            self._enabled_fn() if self._enabled_fn is not None else True
        )
        with self._lock:
            frozen = self._was_frozen
            baseline = self._baseline
            pending = (
                {
                    "knob": self._pending["knob"].name,
                    "old": self._pending["old"],
                    "new": self._pending["new"],
                }
                if self._pending is not None
                else None
            )
        return {
            "enabled": bool(enabled),
            "running": self._thread is not None,
            "interval_s": self.interval_s,
            "ticks": self.ticks,
            "moves_total": self.moves_total,
            "reverts_total": self.reverts_total,
            "frozen": frozen,
            "baseline_checks_per_s": (
                round(baseline, 3) if baseline is not None else None
            ),
            "pending": pending,
            "knobs": {k.name: k.describe() for k in self.knobs},
        }


def _round_stages(stages: dict) -> dict:
    return {s: round(v, 6) for s, v in stages.items()}
