"""Device-memory admission: a memory model between the batcher and the card
(counterpart of ``keto_tpu/engine/hbm.py``).

The budget sits *before* the allocator, so the first OOM the process sees
is not the allocator's:

- the budget is ``budget_frac`` of the smallest device's ``bytes_limit``
  (``telemetry/devstats.py``: the card's total from
  ``torch.cuda.mem_get_info``), re-sampled every 30 s;
- every launched batch reserves its modeled bytes for the (bucket,
  snapshot-version) shape it dispatches; the model starts from a
  conservative per-row constant and learns each batch's own peak (a
  per-batch peak window, below) by EMA as real batches fly;
- :meth:`HbmAdmission.clamp_rows` clamps the batcher's chunk size, so an
  oversized caller batch is pre-split *before* encode instead of running
  out of memory in the launch, and :meth:`HbmAdmission.wait_for_headroom`
  lets the closure engine hold a rebuild until in-flight batch memory has
  drained, so a rebuild's peak and serving's cannot stack;
- a device-resident reverse closure ``D^T`` (the list path) is charged as
  resident bytes through :meth:`HbmAdmission.set_reverse_residency`;
- the sharded serving tier (``parallel/serving.py``) pushes its per-shard
  residency through :meth:`HbmAdmission.set_shard_residency`, and admission
  respects the headroom of the fullest shard; per-device peaks teach a
  per-(bucket, snapshot, shard) model (:meth:`modeled_shard_bytes`). The
  peaks are ``torch.cuda.max_memory_allocated`` of each device
  (``DEVSTATS.device_peaks``); the current device's is the batch's peak
  window's, another device's its process high-water mark, as the
  reference's per-device samples are. Where a devstats has no
  ``device_peaks`` they come from its ``sample_devices`` entries, as in the
  reference.

What the budget charges: bytes that tensors hold (PyTorch's
``memory_allocated`` and its high-water mark), not the caching allocator's
reserve (``memory_reserved``). A block the cache holds but no tensor uses
is exactly what the next batch's allocation reuses, and the allocator
frees its cache and retries before it raises an out-of-memory error, so
charging the reserve would count the same bytes twice.

A batch's bytes are its own peak, measured in a per-batch peak window
(``DEVSTATS.window_enter``/``window_exit``: the allocator's peak is reset
when a batch enters while no other is in flight, and each batch keeps the
allocator's counts at its own entry). A positive charge teaches the model.
This is a recorded difference from the reference, which reads XLA's
``peak_bytes_in_use`` as a process high-water mark at reserve and release:
after any earlier, larger peak every delta there is 0 and the model never
learns. Overlapping pipelined batches share one window, and each is
charged the smaller of the window's peak over its own entry's bytes in use
plus the bytes freed while it flew, and the bytes allocated while it flew
(``telemetry/devstats.py``). Both are at least its own rise, so the charge
is never an underestimate; its neighbours' bytes can make it an
overestimate, which only makes admission split earlier. The high-water
mark that ``/debug/device`` reports is the running maximum ``DEVSTATS``
keeps across the resets, so it never falls.

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
        metrics=None,
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
        # (bucket, snapshot-version, shard) -> modeled per-shard peak of one
        # such batch (the sharded serving tier; shard = device index)
        self._shard_model: dict[tuple[int, int, int], float] = {}
        # shard -> resident bytes the sharded tier pinned on that device (D's
        # replica + the shard's CSR stripes); admission subtracts the fullest
        self._shard_residency: dict[int, float] = {}
        # device-resident reverse closure D^T (list serving); it stacks on
        # the shard floor (_resident_floor_locked)
        self._reverse_residency = 0.0
        # token -> (modeled cost, shape key, the batch's peak-window entry,
        # per-device peaks at reserve; each None when no device reports)
        self._inflight: dict[int, tuple] = {}
        self._inflight_bytes = 0.0
        self._next_token = 0
        self.n_splits = 0  # caller chunks pre-split at admission
        self._m_splits = None
        if metrics is not None:
            metrics.gauge(
                "keto_hbm_budget_bytes",
                "HBM bytes the admission controller budgets for check "
                "batches (hbm_budget_frac of the smallest device limit; "
                "0 = no device memory stats, admission disabled)",
                fn=lambda: float(self.budget_bytes() or 0.0),
            )
            metrics.gauge(
                "keto_hbm_inflight_bytes",
                "modeled HBM bytes of currently in-flight check batches",
                fn=lambda: self._inflight_bytes,
            )
            self._m_splits = metrics.counter(
                "keto_hbm_admission_splits_total",
                "caller batches pre-split at admission because their "
                "modeled HBM footprint exceeded the budget headroom",
            )

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
        """Fold one batch's charge from its peak window into the per-shape
        model and the per-row EMA. A zero charge (the batch allocated
        nothing) carries no information."""
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

    def _window_enter(self) -> Optional[tuple]:
        try:
            return self._devstats.window_enter()
        except Exception:
            return None

    def _window_exit(self, entry: tuple) -> Optional[float]:
        try:
            charge = self._devstats.window_exit(entry)
        except Exception:
            return None
        return None if charge is None else float(charge)

    def _peak_by_shard(self) -> Optional[list]:
        """Per-device peak samples (device order = shard order), or None
        when no device reports (a peak of 0 on a fresh process is a real
        sample)."""
        try:
            peaks_fn = getattr(self._devstats, "device_peaks", None)
            if peaks_fn is not None:
                return peaks_fn()
            peaks = [
                float(dev["memory_stats"].get("peak_bytes_in_use") or 0)
                for dev in self._devstats.sample_devices()
                if dev.get("memory_stats")
            ]
        except Exception:
            return None
        return peaks or None

    def _observe_shard_peaks(self, key: tuple[int, int], before: list, after: list) -> None:
        """Fold per-device peak rises of one batch into the per-(bucket,
        snapshot, shard) model: a sharded batch lands on every shard at
        once, and the shard that peaked highest is the one a bigger batch
        runs out of memory on first."""
        with self._lock:
            for shard, (b, a) in enumerate(zip(before, after)):
                delta = a - b
                if delta <= 0:
                    continue
                skey = (key[0], key[1], shard)
                old = self._shard_model.get(skey)
                self._shard_model[skey] = (
                    delta if old is None else (1 - _EMA_ALPHA) * old + _EMA_ALPHA * delta
                )
            while len(self._shard_model) > 1024:
                self._shard_model.pop(next(iter(self._shard_model)))

    def modeled_shard_bytes(self, bucket: int, version: int, shard: int) -> Optional[float]:
        """The learned per-shard peak of one (bucket, snapshot, shard) batch
        shape, or None before any observation."""
        with self._lock:
            return self._shard_model.get((bucket, version, shard))

    # -- admission -------------------------------------------------------------

    def set_shard_residency(self, residency: dict) -> None:
        """The sharded serving tier reports its per-shard resident bytes
        (D's replica + that shard's CSR stripes) after every re-shard;
        admission subtracts the fullest shard, the device a batch runs out
        of memory on first."""
        with self._lock:
            self._shard_residency = {int(k): float(v) for k, v in residency.items()}
            self._headroom_wake.notify_all()

    def set_reverse_residency(self, nbytes: float) -> None:
        """The closure engine reports the device-resident reverse closure
        D^T (engine/closure.py ``_ensure_reverse``); 0 drops the charge."""
        with self._lock:
            self._reverse_residency = max(0.0, float(nbytes))
            self._headroom_wake.notify_all()

    def _resident_floor_locked(self) -> float:
        # the shard residencies are per-device alternatives (the fullest
        # shard runs out first); D^T is pinned beside D on every serving
        # device, so it stacks on that floor
        return max(self._shard_residency.values(), default=0.0) + self._reverse_residency

    def clamp_rows(self, rows: int) -> int:
        """Largest batch (<= ``rows``) whose modeled footprint fits the
        headroom left by in-flight batches and the resident floor (the
        fullest shard and D^T) — the batcher asks per chunk, so an
        oversized caller batch is pre-split at admission instead of running
        out of memory in the launch."""
        with self._lock:
            self._calibrate_locked()
            budget = self._budget_bytes
            if budget is None or rows <= _MIN_ROWS:
                return rows
            headroom = max(
                0.0, budget - self._inflight_bytes - self._resident_floor_locked()
            )
            fit = int(headroom / max(1.0, self._bytes_per_row))
            if fit >= rows:
                return rows
            self.n_splits += 1
        if self._m_splits is not None:
            self._m_splits.inc()
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
            self._inflight[token] = (cost, (bucket, version), None, None)
        entry = self._window_enter()
        peaks = self._peak_by_shard()
        with self._lock:
            if token in self._inflight:
                self._inflight[token] = (cost, (bucket, version), entry, peaks)
                self._inflight_bytes += cost
        return token

    def release(self, token: int) -> None:
        if token == 0:
            return
        with self._lock:
            entry = self._inflight.pop(token, None)
            if entry is None:
                return
            cost, key, window, peaks_before = entry
            self._inflight_bytes = max(0.0, self._inflight_bytes - cost)
            self._headroom_wake.notify_all()
        if peaks_before is not None and len(peaks_before) > 1:
            peaks_after = self._peak_by_shard()
            if peaks_after is not None:
                self._observe_shard_peaks(key, peaks_before, peaks_after)
        if window is None:
            return  # no window was entered: nothing to leave or learn
        charge = self._window_exit(window)
        if charge is not None:
            self._observe_peak_delta(key, charge)

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
        """The /debug/device ``hbm`` entry."""
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
                "shard_residency": dict(self._shard_residency),
                "reverse_residency_bytes": self._reverse_residency,
                "resident_floor_bytes": self._resident_floor_locked(),
                "modeled_shard_shapes": len(self._shard_model),
            }
