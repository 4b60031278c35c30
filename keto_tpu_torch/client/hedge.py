"""Client-side hedged reads: reissue a slow single check to a second
replica and take whichever answer lands first (counterpart of
``keto_tpu/client/hedge.py``, whole).

The replica pool serves every worker on ONE port via SO_REUSEPORT, so a
client cannot address "the other replica" directly — but a NEW connection
is load-balanced by the kernel, which is exactly the reissue path hedging
needs. The tail-latency argument is the classic one (Dean & Barroso, "The
Tail at Scale"): when one replica is briefly slow (GC pause, delta drain,
an injected ``replica.slow`` fault), a duplicate request to a second
replica converts the p99 into roughly the p50 at the cost of a few percent
extra load — provided the hedge fires only after the request has already
outlived the typical latency.

Semantics, in the order they matter:

- **At most one hedge per request.** A request that outlives the hedge
  delay gets exactly one duplicate; the loser's answer is discarded.
  Checks are read-only so duplicate execution is harmless.
- **Hedge delay defaults to an online estimate**: a high quantile of
  recently observed latencies (times a safety multiplier), so the hedge
  fires for outliers only and the duplicate-load fraction stays pinned
  near ``1 - quantile``. A fixed ``delay_s`` overrides the estimate.
- **First answer wins; first error does not.** If the winner raised, the
  other attempt's answer is awaited — a hedge exists to mask slowness,
  not to double the error rate. Both failing raises the primary's error.
- Counters (any four objects with ``inc()``): ``fired`` = a hedge was
  issued, ``won`` = the hedge answered first, ``wasted`` = the primary
  answered first so the hedge's work was thrown away, ``suppressed`` =
  the primary was shed (429/RESOURCE_EXHAUSTED) so no hedge was issued —
  duplicating a shed request doubles load exactly when the server asked
  for less.

With a replicated read plane the hedge target stops being "a second
connection to the same port" and becomes "a DIFFERENT follower":
``EndpointRouter`` picks the primary and hedge endpoints per request,
snaptoken-aware — an endpoint already known to have replayed past the
token's version serves the read without a server-side freshness wait,
and the hedge always lands on another replica so it cannot queue behind
the same slow node.

``clock`` and the executor are injectable so tests drive the schedule
deterministically (same pattern as client/retry.py).
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Callable, Optional, Sequence


class HedgePolicy:
    """When to hedge: a fixed ``delay_s``, or (default) an online estimate —
    the ``quantile`` of the last ``window`` observed latencies times
    ``multiplier``, clamped to [min_delay_s, max_delay_s]. Until enough
    latencies are observed (``min_samples``), ``max_delay_s`` is used, so a
    cold client does not hedge on its very first requests."""

    def __init__(
        self,
        delay_s: Optional[float] = None,
        quantile: float = 0.95,
        multiplier: float = 1.0,
        min_delay_s: float = 0.001,
        max_delay_s: float = 1.0,
        window: int = 512,
        min_samples: int = 10,
    ):
        self.delay_s = delay_s
        self.quantile = min(1.0, max(0.0, quantile))
        self.multiplier = multiplier
        self.min_delay_s = min_delay_s
        self.max_delay_s = max_delay_s
        self.window = max(1, window)
        self.min_samples = max(1, min_samples)
        self._latencies: list[float] = []
        self._idx = 0  # ring-buffer cursor once the window is full
        self._lock = threading.Lock()
        # server-advertised delay (the autotuner's hedge_delay_ms knob,
        # surfaced via /debug/autotune): weaker than an explicit delay_s
        # override, stronger than the online estimate
        self._advertised_s: Optional[float] = None

    def observe(self, latency_s: float) -> None:
        """Record one request's time-to-first-answer (hedged or not)."""
        with self._lock:
            if len(self._latencies) < self.window:
                self._latencies.append(latency_s)
            else:
                self._latencies[self._idx] = latency_s
                self._idx = (self._idx + 1) % self.window

    def advertise(self, delay_s: Optional[float]) -> None:
        """Adopt a server-advertised hedge delay (from the /debug/autotune
        payload's ``hedge_delay_ms`` knob value, or a response header).
        None clears it, returning to the online estimate. The advertised
        value is clamped to [min_delay_s, max_delay_s] — a sick server
        must not talk the client into hedging every request."""
        with self._lock:
            if delay_s is None:
                self._advertised_s = None
            else:
                self._advertised_s = min(
                    self.max_delay_s, max(self.min_delay_s, float(delay_s))
                )

    def current_delay_s(self) -> float:
        if self.delay_s is not None:
            return self.delay_s
        with self._lock:
            if self._advertised_s is not None:
                return self._advertised_s
            lat = list(self._latencies)
        if len(lat) < self.min_samples:
            return self.max_delay_s
        lat.sort()
        q = lat[min(len(lat) - 1, int(self.quantile * len(lat)))]
        return min(
            self.max_delay_s, max(self.min_delay_s, q * self.multiplier)
        )


def is_overload_error(err: Optional[BaseException]) -> bool:
    """Structural test for a server load shed on any transport: HTTP 429
    (``status_code`` attribute, as client errors and KetoError carry) or
    gRPC RESOURCE_EXHAUSTED (a typed error's ``grpc_code`` string, or a
    live ``grpc.RpcError``'s ``code()``)."""
    if err is None:
        return False
    if getattr(err, "status_code", None) == 429:
        return True
    if getattr(err, "grpc_code", None) == "RESOURCE_EXHAUSTED":
        return True
    from .retry import grpc_code_name

    return grpc_code_name(err) == "RESOURCE_EXHAUSTED"


class HedgedCall:
    """Outcome of one hedged request: the answer plus what the hedge did."""

    __slots__ = ("result", "hedged", "hedge_won", "elapsed_s")

    def __init__(self, result, hedged: bool, hedge_won: bool, elapsed_s: float):
        self.result = result
        self.hedged = hedged  # a duplicate was issued
        self.hedge_won = hedge_won  # ... and its answer was used
        self.elapsed_s = elapsed_s  # time to the answer actually used


class Hedger:
    """Runs zero-arg callables with hedging. ``counters`` is a (fired,
    won, wasted, suppressed) tuple of objects with ``inc()`` (or None;
    legacy triples still count the first three). Owns a small
    executor unless one is injected; the two attempts of one request
    need two concurrent slots, so size accordingly."""

    def __init__(
        self,
        policy: Optional[HedgePolicy] = None,
        counters=None,
        executor: Optional[ThreadPoolExecutor] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.policy = policy or HedgePolicy()
        self._counters = counters
        self._own_executor = executor is None
        self._executor = executor or ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="hedge"
        )
        self._clock = clock

    def close(self) -> None:
        if self._own_executor:
            # abandoned losers may still be in flight; don't join them
            self._executor.shutdown(wait=False, cancel_futures=True)

    def __enter__(self) -> "Hedger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _inc(self, which: int) -> None:
        # tolerate legacy (fired, won, wasted) triples: the suppressed
        # counter (index 3) is simply not counted there
        if self._counters is not None and which < len(self._counters):
            self._counters[which].inc()

    def call(
        self,
        primary: Callable[[], object],
        hedge: Optional[Callable[[], object]] = None,
    ) -> HedgedCall:
        """Run ``primary()``; if no answer within the policy's hedge delay,
        also run ``hedge()`` (defaults to ``primary`` — the reissue-to-pool
        case) and return whichever answers first. At most one hedge.

        Overload suppression: when the primary already failed with a load
        shed (429 / RESOURCE_EXHAUSTED), NO hedge is issued — the server
        explicitly asked for less load, and a duplicate re-arrives as
        exactly the traffic that got the primary shed. The shed error is
        raised as-is (counted as suppressed)."""
        start = self._clock()
        f_primary = self._executor.submit(primary)
        delay = self.policy.current_delay_s()
        done, _ = wait((f_primary,), timeout=delay)
        if done:
            elapsed = self._clock() - start
            self.policy.observe(elapsed)
            exc = f_primary.exception()
            if exc is not None and is_overload_error(exc):
                self._inc(3)  # suppressed: never hedge a shed request
                raise exc
            return HedgedCall(f_primary.result(), False, False, elapsed)
        # the wait timed out, but the primary may have JUST failed with a
        # shed — re-check before paying for a duplicate (closes the race
        # between the shed landing and the hedge firing)
        if f_primary.done() and is_overload_error(f_primary.exception()):
            self._inc(3)  # suppressed
            raise f_primary.exception()
        self._inc(0)  # fired
        f_hedge = self._executor.submit(hedge or primary)
        pair = {f_primary, f_hedge}
        winner = None
        while pair:
            done, pair = wait(pair, return_when=FIRST_COMPLETED)
            for f in done:
                if f.exception() is None and winner is None:
                    winner = f
            if winner is not None:
                break
        if winner is None:
            # both attempts failed: surface the primary's error — the
            # hedge was a duplicate of it, not a different question
            elapsed = self._clock() - start
            self.policy.observe(elapsed)
            self._inc(2)  # wasted (it bought nothing)
            raise f_primary.exception()
        elapsed = self._clock() - start
        self.policy.observe(elapsed)
        hedge_won = winner is f_hedge
        self._inc(1 if hedge_won else 2)  # won / wasted
        return HedgedCall(winner.result(), True, hedge_won, elapsed)


class EndpointRouter:
    """Health- and snaptoken-aware endpoint picking across a replicated
    read fleet.

    Tracks, per endpoint, the newest store version it is KNOWN to have
    served (learned from successful at-least-token reads — a follower
    that answered a ``snaptoken=z7.x.y`` read has necessarily replayed
    through version 7) plus a TIME-DECAYED error score: every failure
    adds one point, and the score halves every ``cool_off_s`` seconds
    (an endpoint with one transient failure is back in rotation after
    one half-life; a flapping endpoint accumulates points and stays
    benched exponentially longer — never permanently). ``pick`` returns
    a ``(primary, hedge)`` pair:

    - the primary prefers an endpoint already at or past ``min_version``,
      so the server-side freshness wait is a no-op on the common path; a
      token newer than every known endpoint version still routes (the
      follower's bounded wait handles the catch-up);
    - the hedge is always a DIFFERENT endpoint when one exists — hedging
      to the same replica would queue behind the same slowness, which is
      the failure hedging exists to escape.

    Passive knowledge converges from routed traffic alone; feeding
    ``observe_status`` a ``/cluster/status`` rollup sharpens it: members
    rolled up red are demoted exactly like erroring endpoints, heartbeat
    versions pre-warm the freshness map, and the leader's advertised
    URLs (election lease or federation view) are remembered so the write
    path can follow a leadership change. A term change never resets the
    freshness map — store versions are preserved across promotion
    (shared-WAL replay), so snaptoken routing stays valid through the
    transition.
    """

    def __init__(
        self,
        endpoints: Sequence[str],
        cool_off_s: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
        *,
        max_error_score: float = 16.0,
    ):
        eps = [str(e).rstrip("/") for e in endpoints if str(e).strip()]
        if not eps:
            raise ValueError("EndpointRouter needs at least one endpoint")
        self.endpoints = eps
        #: the error-score half-life; the name predates the decay
        self.cool_off_s = max(1e-3, float(cool_off_s))
        self.max_error_score = float(max_error_score)
        self._clock = clock
        self._known_version = {e: 0 for e in eps}
        self._error_score = {e: 0.0 for e in eps}
        self._error_stamp = {e: 0.0 for e in eps}
        self._health = {e: "green" for e in eps}
        self._leader: Optional[dict] = None
        self._term = 0
        self._rr = 0
        self._lock = threading.Lock()

    def _decayed(self, endpoint: str, now: float) -> float:
        score = self._error_score[endpoint]
        if score <= 0.0:
            return 0.0
        dt = max(0.0, now - self._error_stamp[endpoint])
        return score * 0.5 ** (dt / self.cool_off_s)

    def _benched(self, endpoint: str, now: float) -> bool:
        # one fresh error scores exactly 1.0 -> benched; after one
        # half-life it is 0.5 -> back in rotation
        return self._decayed(endpoint, now) >= 1.0

    def observe_version(self, endpoint: str, version: int) -> None:
        """Endpoint served a read at least as fresh as ``version``."""
        endpoint = str(endpoint).rstrip("/")
        with self._lock:
            known = self._known_version.get(endpoint)
            if known is not None and int(version) > known:
                self._known_version[endpoint] = int(version)

    def observe_error(self, endpoint: str) -> None:
        """Endpoint failed a read: add one point to its decaying error
        score (repeat offenders stay benched longer; a single transient
        failure decays away within ~one ``cool_off_s``)."""
        endpoint = str(endpoint).rstrip("/")
        with self._lock:
            if endpoint not in self._error_score:
                return
            now = self._clock()
            self._error_score[endpoint] = min(
                self.max_error_score, self._decayed(endpoint, now) + 1.0
            )
            self._error_stamp[endpoint] = now

    def observe_status(self, status_doc: dict) -> None:
        """Fold a ``/cluster/status`` rollup into the routing state:
        red members are demoted, member versions pre-warm the freshness
        map, and the current leader's URLs (member views or the election
        block) are remembered for write-path follow-the-leader."""
        if not isinstance(status_doc, dict):
            return
        cluster = status_doc.get("cluster") or {}
        election = cluster.get("election") or {}
        with self._lock:
            term = int(election.get("observed_term") or 0)
            if term > self._term:
                self._term = term
        for view in status_doc.get("members") or ():
            if not isinstance(view, dict):
                continue
            read_url = str(view.get("read_url") or "").rstrip("/")
            version = view.get("version")
            if read_url and read_url in self._known_version:
                with self._lock:
                    health = str(view.get("health") or "green")
                    self._health[read_url] = (
                        health if view.get("alive", True) else "red"
                    )
                if version:
                    self.observe_version(read_url, int(version))
            if (view.get("role") or "") == "leader" and view.get(
                "alive", True
            ):
                with self._lock:
                    self._leader = {
                        "read_url": read_url,
                        "write_url": str(
                            view.get("write_url") or ""
                        ).rstrip("/"),
                        "term": self._term,
                    }

    def observe_leader(self, hint: dict) -> None:
        """A 503 envelope's ``leader_hint`` (or an election lease) names
        the current leader directly — trust it over older fleet views."""
        if not isinstance(hint, dict):
            return
        with self._lock:
            term = int(hint.get("term") or 0)
            if term and term < self._term:
                return  # stale hint from a fenced ex-leader
            self._term = max(self._term, term)
            self._leader = {
                "read_url": str(hint.get("read_url") or "").rstrip("/"),
                "write_url": str(hint.get("write_url") or "").rstrip("/"),
                "term": self._term,
            }

    def leader(self) -> Optional[dict]:
        """The newest known leader coordinates (or None)."""
        with self._lock:
            return dict(self._leader) if self._leader else None

    def snapshot(self) -> dict:
        with self._lock:
            now = self._clock()
            return {
                e: {
                    "known_version": self._known_version[e],
                    "benched": self._benched(e, now),
                    "error_score": round(self._decayed(e, now), 3),
                    "health": self._health[e],
                }
                for e in self.endpoints
            }

    def pick(self, min_version: int = 0) -> tuple[str, Optional[str]]:
        with self._lock:
            now = self._clock()
            healthy = [
                e
                for e in self.endpoints
                if not self._benched(e, now) and self._health[e] != "red"
            ] or [
                # everything red/benched: fall back to the least-bad set
                e for e in self.endpoints if not self._benched(e, now)
            ] or list(self.endpoints)  # route anyway — reads never stop
            pool = healthy
            if min_version > 0:
                fresh = [
                    e
                    for e in healthy
                    if self._known_version[e] >= min_version
                ]
                if fresh:
                    pool = fresh
            primary = pool[self._rr % len(pool)]
            self._rr += 1
            others = [e for e in healthy if e != primary] or [
                e for e in self.endpoints if e != primary
            ]
            hedge = others[self._rr % len(others)] if others else None
            return primary, hedge
