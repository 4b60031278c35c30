"""Device-memory admission: a memory model between the batcher and the card
(counterpart of ``keto_tpu/engine/hbm.py``, without the per-shard model,
which waits for the multi-device tiers, ROADMAP 12).

The budget sits *before* the allocator, so the first OOM the process sees
is not the allocator's:

- the budget is ``budget_frac`` of the smallest device's ``bytes_limit``
  (``telemetry/devstats.py``: the card's total from
  ``torch.cuda.mem_get_info``), re-sampled every 30 s;
- every launched batch reserves its modeled bytes for the (bucket,
  snapshot-version) shape it dispatches; the model starts from a
  conservative per-row constant and learns from observed
  ``peak_bytes_in_use`` deltas (EMA) as real batches fly;
- :meth:`HbmAdmission.clamp_rows` clamps the batcher's chunk size, so an
  oversized caller batch is pre-split *before* encode instead of running
  out of memory in the launch, and :meth:`HbmAdmission.wait_for_headroom`
  lets the closure engine hold a rebuild until in-flight batch memory has
  drained, so a rebuild's peak and serving's cannot stack;
- a device-resident reverse closure ``D^T`` (the list path) is charged as
  resident bytes through :meth:`HbmAdmission.set_reverse_residency`.

What the budget charges: bytes that tensors hold (PyTorch's
``memory_allocated`` and its high-water mark), not the caching allocator's
reserve (``memory_reserved``). A block the cache holds but no tensor uses
is exactly what the next batch's allocation reuses, and the allocator
frees its cache and retries before it raises an out-of-memory error, so
charging the reserve would count the same bytes twice.

Peak deltas are read as the reference reads XLA's ``peak_bytes_in_use``: a
high-water mark for the process, sampled at reserve and at release. A
positive delta is what that batch added on top of every earlier peak and
teaches the model; a zero delta (the batch fit under the mark) carries no
information. The admission never calls ``torch.cuda.reset_peak_memory_stats``:
the mark belongs to whoever measures the process, and a reset between a
batch's two samples only makes its delta negative, which is ignored.

Where no device reports memory statistics (a CPU process, or a forked read
replica, which may not touch CUDA) every admission question degrades to
"yes, unlimited" at the cost of one ``None`` check.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from ..telemetry.devstats import DEVSTATS

#: seconds between budget re-calibrations (the limit moves when other
#: processes take memory on the card)
_CALIBRATE_EVERY_S = 30.0
#: starting guess for modeled bytes per batch row before any observation:
#: 3 int32 staging columns + frontier working set, deliberately generous
_DEFAULT_BYTES_PER_ROW = 4096
#: learned-model EMA weight for a fresh peak observation
_EMA_ALPHA = 0.3
#: never clamp a batch below this many rows — the kernels' minimum bucket
_MIN_ROWS = 8


class HbmAdmission:
    """Shared by the batcher (admission/pre-split + per-batch reserve/
    release) and the closure engine (rebuild gate). Thread-safe; every
    hot-path call is O(1) under one lock."""

    def __init__(
        self,
        budget_frac: float = 0.8,
        bytes_per_row: int = _DEFAULT_BYTES_PER_ROW,
        devstats=DEVSTATS,
        clock=time.monotonic,
    ):
        self.budget_frac = min(1.0, max(0.05, float(budget_frac)))
        self._bytes_per_row = float(bytes_per_row or _DEFAULT_BYTES_PER_ROW)
        self._devstats = devstats
        self._clock = clock
        self._lock = threading.Lock()
        self._headroom_wake = threading.Condition(self._lock)
        # None until a device reports memory stats; None = admission off
        self._budget_bytes: Optional[float] = None
        self._calibrated_at: float = float("-inf")
        # (bucket, snapshot-version) -> modeled bytes for one such batch
        self._model: dict[tuple[int, int], float] = {}
        # device-resident reverse closure D^T (list serving)
        self._reverse_residency = 0.0
        # token -> (modeled cost, shape key, peak sample at reserve time —
        # None when no device reports memory stats)
        self._inflight: dict[int, tuple[float, tuple[int, int], Optional[float]]] = {}
        self._inflight_bytes = 0.0
        self._next_token = 0
        self.n_splits = 0  # caller chunks pre-split at admission

    # -- calibration -----------------------------------------------------------

    def _calibrate_locked(self) -> None:
        now = self._clock()
        if now - self._calibrated_at < _CALIBRATE_EVERY_S:
            return
        self._calibrated_at = now
        limit = None
        try:
            for dev in self._devstats.sample_devices():
                stats = dev.get("memory_stats")
                if not stats:
                    continue
                dev_limit = float(stats.get("bytes_limit") or 0)
                if dev_limit > 0 and (limit is None or dev_limit < limit):
                    limit = dev_limit
        except Exception:
            limit = None
        self._budget_bytes = limit * self.budget_frac if limit is not None else None

    def budget_bytes(self) -> Optional[float]:
        """The current batch-memory budget; None = no device memory stats,
        admission disabled."""
        with self._lock:
            self._calibrate_locked()
            return self._budget_bytes

    # -- the memory model ------------------------------------------------------

    def _modeled_bytes_locked(self, bucket: int, version: int) -> float:
        known = self._model.get((bucket, version))
        if known is not None:
            return known
        return bucket * self._bytes_per_row

    def modeled_bytes(self, bucket: int, version: int) -> float:
        with self._lock:
            return self._modeled_bytes_locked(bucket, version)

    def _observe_peak_delta(self, key: tuple[int, int], delta_bytes: float) -> None:
        """Fold an observed peak delta for one batch into the per-shape
        model and the per-row EMA. Zero deltas (the batch fit under the
        existing high-water mark) carry no information."""
        if delta_bytes <= 0:
            return
        with self._lock:
            old = self._model.get(key)
            self._model[key] = (
                delta_bytes
                if old is None
                else (1 - _EMA_ALPHA) * old + _EMA_ALPHA * delta_bytes
            )
            if len(self._model) > 256:
                self._model.pop(next(iter(self._model)))
            per_row = delta_bytes / max(1, key[0])
            self._bytes_per_row = (
                (1 - _EMA_ALPHA) * self._bytes_per_row + _EMA_ALPHA * per_row
            )

    def _peak_bytes(self) -> Optional[float]:
        """The card's ``peak_bytes_in_use`` (``max_memory_allocated``), or
        None when no device reports memory stats (a peak of 0 is a real
        sample). One allocator read per call: reserve and release run it
        once each per batch, so it must not sample the whole device list."""
        try:
            peak = self._devstats.peak_bytes()
        except Exception:
            return None
        return None if peak is None else float(peak)

    # -- admission -------------------------------------------------------------

    def set_reverse_residency(self, nbytes: float) -> None:
        """The closure engine reports the device-resident reverse closure
        D^T (engine/closure.py ``_ensure_reverse``); 0 drops the charge."""
        with self._lock:
            self._reverse_residency = max(0.0, float(nbytes))
            self._headroom_wake.notify_all()

    def clamp_rows(self, rows: int) -> int:
        """Largest batch (<= ``rows``) whose modeled footprint fits the
        headroom left by in-flight batches and the resident D^T — the
        batcher asks per chunk, so an oversized caller batch is pre-split
        at admission instead of running out of memory in the launch."""
        with self._lock:
            self._calibrate_locked()
            budget = self._budget_bytes
            if budget is None or rows <= _MIN_ROWS:
                return rows
            headroom = max(
                0.0, budget - self._inflight_bytes - self._reverse_residency
            )
            fit = int(headroom / max(1.0, self._bytes_per_row))
            if fit >= rows:
                return rows
            self.n_splits += 1
        return max(_MIN_ROWS, fit)

    def reserve(self, bucket: int, version: int) -> int:
        """Charge one (bucket, version) batch against the budget; returns
        a token for :meth:`release`. Token 0 = admission disabled, free."""
        with self._lock:
            self._calibrate_locked()
            if self._budget_bytes is None:
                return 0
            cost = self._modeled_bytes_locked(bucket, version)
            self._next_token += 1
            token = self._next_token
            self._inflight[token] = (cost, (bucket, version), None)
        peak = self._peak_bytes()
        with self._lock:
            if token in self._inflight:
                self._inflight[token] = (cost, (bucket, version), peak)
                self._inflight_bytes += cost
        return token

    def release(self, token: int) -> None:
        if token == 0:
            return
        with self._lock:
            entry = self._inflight.pop(token, None)
            if entry is None:
                return
            cost, key, peak_before = entry
            self._inflight_bytes = max(0.0, self._inflight_bytes - cost)
            self._headroom_wake.notify_all()
        peak_after = self._peak_bytes()
        if peak_before is not None and peak_after is not None:
            self._observe_peak_delta(key, peak_after - peak_before)

    # -- rebuild gating --------------------------------------------------------

    def wait_for_headroom(self, frac: float = 0.5, timeout_s: float = 30.0) -> bool:
        """Block until in-flight batch memory drops under ``frac`` of the
        budget (the closure engine calls this before a rebuild so rebuild
        peak + serving peak never stack). Returns False on timeout — the
        rebuild proceeds anyway, because a starved rebuild is unbounded
        staleness, which is worse than a risked OOM the breaker can
        absorb."""
        deadline = self._clock() + max(0.0, timeout_s)
        with self._lock:
            self._calibrate_locked()
            while True:
                budget = self._budget_bytes
                if budget is None or self._inflight_bytes <= budget * frac:
                    return True
                remaining = deadline - self._clock()
                if remaining <= 0:
                    return False
                self._headroom_wake.wait(min(remaining, 0.25))

    # -- introspection ---------------------------------------------------------

    def set_budget_frac(self, frac: float) -> None:
        """Hot-apply a new budget fraction (same clamp as the constructor);
        the next admission call recalibrates immediately."""
        with self._lock:
            self.budget_frac = min(1.0, max(0.05, float(frac)))
            self._calibrated_at = float("-inf")
            self._headroom_wake.notify_all()

    def snapshot(self) -> dict:
        """The /debug/device ``hbm`` entry. The reference's shard keys are
        kept (empty, zero) until the sharded tier reports residencies."""
        with self._lock:
            budget = self._budget_bytes
            return {
                "budget_bytes": budget,
                "budget_frac": self.budget_frac,
                "inflight_bytes": self._inflight_bytes,
                "inflight_batches": len(self._inflight),
                "headroom_bytes": (
                    None if budget is None else max(0.0, budget - self._inflight_bytes)
                ),
                "bytes_per_row": round(self._bytes_per_row, 1),
                "modeled_shapes": len(self._model),
                "shard_residency": {},
                "reverse_residency_bytes": self._reverse_residency,
                "resident_floor_bytes": self._reverse_residency,
                "modeled_shard_shapes": 0,
            }
