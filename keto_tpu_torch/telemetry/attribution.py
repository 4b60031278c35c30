"""Wall-clock accounting: where every microsecond of a check goes
(counterpart of ``keto_tpu/telemetry/attribution.py``).

Spans show *shape* but not *conservation*: nothing guarantees that
per-stage numbers sum to the wall time a caller saw. This module makes
time a conserved quantity:

- ``TimeLedger`` — a per-request monotonic timestamp ledger. Each
  ``mark(stage)`` attributes the time since the previous mark to that
  stage. Marks are sequential per request (pipeline stage handoffs give
  the happens-before), so no lock is needed.
- ``_current_ledger`` contextvar + ``ledger_mark`` — lets deep layers
  (batcher dispatch, device engine) attribute time without threading a
  ledger argument through every call. On the pipelined path, where the
  request hops threads, the ledger rides the batch entry tuple instead
  and stage loops mark it directly.
- ``AttributionLedger`` — process-wide aggregation: per-stage seconds,
  total wall, request count, and the conservation ratio. Anything the
  marks did not cover lands in the explicit ``unattributed`` stage, so
  ``keto_time_attribution_seconds_total{stage}`` sums to wall time by
  construction and a leak is visible instead of silent. Served at
  ``/debug/attribution``.

- ``TransportLedger`` — the ledger the REST transport opens before it
  reads a request's body (``api/daemon.py``). A check record adopts it
  instead of starting its own (``claim``), and the transport folds it in
  (``close``) once the reply's last byte is written, so the request's
  wall is the transport's: body read and parse are ``admission``, the
  router's metrics, its log line and the socket write are ``reply``. A
  request that opened no check record is not folded in.

Stage vocabulary (flow order): admission (transport handling up to the
batcher), queue (admission-queue wait), encode (vocab probe + encode +
encoded-cache probe), launch (launch-queue wait + async kernel enqueue),
kernel (block-until-materialized on device), decode (result decode +
cache population + future resolution), serialize (response body build),
reply (everything after the body until the telemetry record closes).

On the caller-thread paths ``kernel`` is exactly the time blocked on the
card: every host<->device synchronisation of the check path runs inside
``DEVSTATS.wait(site)`` (``telemetry/devstats.py``), which charges the host
time before it to the caller's stage and the block to ``kernel``, and
counts the site on the ledger (``waits``). ``AttributionLedger.snapshot``
sums them as ``device_waits``.
"""

from __future__ import annotations

import contextvars
import threading
import time
from typing import Optional

ATTRIBUTION_STAGES = (
    "admission",
    "queue",
    "encode",
    "launch",
    "kernel",
    "decode",
    "serialize",
    "reply",
)

# the residual bucket: wall time the marks did not cover. Kept as a
# first-class stage so the exported counter is conservative and the
# regression gate can alert on it growing past 5% of wall.
UNATTRIBUTED = "unattributed"

_current_ledger: contextvars.ContextVar[Optional["TimeLedger"]] = (
    contextvars.ContextVar("keto_tpu_torch_ledger", default=None)
)


class TimeLedger:
    """Per-request stage ledger. ``mark(stage)`` charges the time since
    the previous mark to ``stage``; repeated marks of one stage
    accumulate. Cheap enough for the hot path: one perf_counter call and
    one dict update per mark."""

    __slots__ = ("t0", "last", "stages", "waits")

    def __init__(self, t0: Optional[float] = None):
        now = time.perf_counter() if t0 is None else t0
        self.t0 = now
        self.last = now
        self.stages: dict[str, float] = {}
        # device-wait site -> [count, seconds] (DEVSTATS.wait)
        self.waits: dict[str, list] = {}

    def mark(self, stage: str, now: Optional[float] = None) -> None:
        if now is None:
            now = time.perf_counter()
        dt = now - self.last
        if dt > 0:
            self.stages[stage] = self.stages.get(stage, 0.0) + dt
        self.last = now

    def attributed(self) -> float:
        return sum(self.stages.values())


def add_wait(waits: dict, site: str, count: int, seconds: float) -> None:
    """Add to a ``{site: [count, seconds]}`` tally of device waits."""
    w = waits.get(site)
    if w is None:
        waits[site] = [count, seconds]
    else:
        w[0] += count
        w[1] += seconds


class TransportLedger(TimeLedger):
    """A request's ledger from the first body byte to the last reply byte
    (see the module docstring). The transport installs it as the ambient
    ledger; the request's check record ``claim``s it with its
    AttributionLedger (None when attribution is off) and batch size."""

    __slots__ = ("claimed", "_sink", "_batch")

    def __init__(self, t0: Optional[float] = None):
        super().__init__(t0)
        self.claimed = False
        self._sink = None
        self._batch = 1

    def claim(self, sink, batch_size: int) -> None:
        self.claimed = True
        self._sink = sink
        self._batch = batch_size

    def close(self) -> None:
        """The reply is written: charge the rest to ``reply`` and fold the
        ledger into the claiming record's AttributionLedger."""
        self.mark("reply")
        if self._sink is not None:
            self._sink.record(self, self.last - self.t0, self._batch)


def current_ledger() -> Optional[TimeLedger]:
    return _current_ledger.get()


def set_current_ledger(ledger: Optional[TimeLedger]):
    """Install ``ledger`` for the calling context; returns the reset
    token. The telemetry record (flight.py) owns this lifecycle."""
    return _current_ledger.set(ledger)


def reset_current_ledger(token) -> None:
    _current_ledger.reset(token)


def ledger_mark(stage: str) -> None:
    """Attribute time-since-last-mark to ``stage`` on the ambient
    ledger; no-op when none is installed (untelemetered callers, tests
    driving the batcher directly)."""
    led = _current_ledger.get()
    if led is not None:
        led.mark(stage)


class AttributionLedger:
    """Aggregates finished TimeLedgers into a process-wide breakdown.

    ``record`` folds one request's stages in and books the residual
    (wall - attributed) under ``unattributed``, then mirrors the deltas
    into ``keto_time_attribution_seconds_total{stage}`` when a metrics
    registry was supplied. ``snapshot`` is the ``/debug/attribution``
    payload."""

    def __init__(self, metrics=None):
        self._lock = threading.Lock()
        self._stages: dict[str, float] = {}
        self._wall_s = 0.0
        self._requests = 0
        self._entries = 0
        self._waits: dict[str, list] = {}
        self._counter = None
        if metrics is not None:
            from .metrics import time_attribution_counter

            self._counter = time_attribution_counter(metrics)

    def record(
        self, ledger: TimeLedger, wall_s: float, batch_size: int = 1
    ) -> None:
        if wall_s < 0:
            wall_s = 0.0
        attributed = ledger.attributed()
        # clock-skew guard: marks use perf_counter while the record's
        # wall may come from a different pair of reads; never book a
        # negative residual
        residual = max(0.0, wall_s - attributed)
        with self._lock:
            for stage, dt in ledger.stages.items():
                self._stages[stage] = self._stages.get(stage, 0.0) + dt
            if residual > 0:
                self._stages[UNATTRIBUTED] = (
                    self._stages.get(UNATTRIBUTED, 0.0) + residual
                )
            self._wall_s += max(wall_s, attributed)
            self._requests += 1
            self._entries += max(1, int(batch_size))
            for site, (n, secs) in ledger.waits.items():
                add_wait(self._waits, site, n, secs)
        if self._counter is not None:
            for stage, dt in ledger.stages.items():
                self._counter.labels(stage=stage).inc(dt)
            if residual > 0:
                self._counter.labels(stage=UNATTRIBUTED).inc(residual)

    def snapshot(self) -> dict:
        with self._lock:
            stages = dict(self._stages)
            wall = self._wall_s
            requests = self._requests
            entries = self._entries
            waits = {site: (n, secs) for site, (n, secs) in self._waits.items()}
        unattributed = stages.get(UNATTRIBUTED, 0.0)
        attributed = sum(stages.values()) - unattributed
        coverage = (attributed / wall) if wall > 0 else 1.0
        # canonical order first, then any ad-hoc stages, residual last
        ordered = [s for s in ATTRIBUTION_STAGES if s in stages]
        ordered += sorted(
            s
            for s in stages
            if s not in ATTRIBUTION_STAGES and s != UNATTRIBUTED
        )
        if UNATTRIBUTED in stages:
            ordered.append(UNATTRIBUTED)
        breakdown = {
            s: {
                "seconds": round(stages[s], 6),
                "share_of_wall": round(stages[s] / wall, 4)
                if wall > 0
                else 0.0,
            }
            for s in ordered
        }
        return {
            "requests": requests,
            "entries": entries,
            "wall_s": round(wall, 6),
            "attributed_s": round(attributed, 6),
            "unattributed_s": round(unattributed, 6),
            "coverage": round(coverage, 4),
            "stages": breakdown,
            "device_waits": {
                site: {"count": n, "seconds": round(secs, 6)}
                for site, (n, secs) in sorted(waits.items())
            },
        }

    def reset(self) -> None:
        with self._lock:
            self._stages.clear()
            self._wall_s = 0.0
            self._requests = 0
            self._entries = 0
            self._waits.clear()
