"""Integrity plane: continuous online scrubbing and repair (counterpart of
``keto_tpu/engine/scrub.py``).

Every parity proof the repo carries runs at test time; in production a
flipped bit in the resident closure, or an encode/cache/overlay
divergence, would serve wrong answers forever. A :class:`ScrubDaemon` runs
off the critical path under a duty-cycle budget and re-derives a random
sample of long-lived derived state from its source of truth, repairing
divergence through the seams that already exist.

Per cycle, in escalation order:

- **device rows** — a random sample of resident closure rows (D, and D^T
  when the reverse residency is built) is recomputed on the host from the
  snapshot's interior adjacency and compared byte for byte
  (``ClosureCheckEngine.scrub_residency``). It runs only while the
  residency is quiescent (at the live store version, no pending overlay
  corrections). Mismatch → ``DeviceSupervisor.reset_residency`` (or the
  engine's own ``reset_residency`` when no supervisor exists) and a flush
  of the result caches.
- **oracle replay** — a reservoir (Algorithm R) of recent live checks,
  tapped off the batcher (``CheckBatcher.scrub_observer``), is replayed
  through the host BFS oracle. Only entries observed at the current
  answering version are replayed.
- **sealed WAL segments** — up to ``wal_segments_per_cycle`` sealed
  segments of a durable store's log (round-robin) are rescanned frame by
  frame and their CRCs rechecked (``store/wal.py verify_segment``).
  Damage → a fresh checkpoint (``checkpoint_now``), which prunes every
  sealed segment at or below its version, the damaged one included.
- **checkpoints** — the newest checkpoint's payload is re-hashed against
  its recorded sha256 (``graph/checkpoint.py load_checkpoint``). Damage →
  the file is removed and a fresh checkpoint cut.

- **replica anti-entropy** — on a follower, the local state's chunked
  digest (``replication/digest.py``, ``digest_chunk_size`` rows a chunk) is
  compared with the leader's ``/replication/digest`` at the same applied
  version (lag is not divergence: a version mismatch skips the cycle).
  Divergence → the follower re-seeds from the leader's checkpoint
  (``reseed``).

Remediation is a ladder, rate-limited by ``max_repairs_per_cycle`` and
frozen while any injected guard (breaker open, HBM pressure) gives a
reason: a scrubber must never add repair load to an incident, and while the
check SLO's fast-window burn rate is at ``freeze_burn_rate`` or above (0
inherits the tracker's ``alert_burn_rate``), the cycle freezes with the
reason ``slo_burn``. With a metrics registry the scrubber exports the
reference's ``keto_scrub_*`` families; events also land in the flight
recorder when one is given.

Everything is injectable (engine/store getters, oracle, repair seam,
clock, rng seed), so the tests drive detection deterministically. The
kill switch is ``scrub.enabled`` via ``enabled_fn``; the history ring is
``/debug/scrub``.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Callable, Optional, Sequence

import numpy as np

from ..faults import FAULTS

_log = logging.getLogger("keto_tpu_torch.engine")

# mismatch kinds (the keto_scrub_mismatches_total label values)
KIND_DEVICE = "device"
KIND_REPLAY = "replay"
KIND_WAL = "wal"
KIND_CHECKPOINT = "checkpoint"
KIND_REPLICA = "replica"

# repair actions (the keto_scrub_repairs_total label values)
ACTION_RESET_RESIDENCY = "reset_residency"
ACTION_CACHE_FLUSH = "cache_flush"
ACTION_CHECKPOINT_REBUILD = "checkpoint_rebuild"
ACTION_RESEED = "reseed"


class _ReservoirEntry:
    __slots__ = ("request", "result", "version")

    def __init__(self, request, result: bool, version: int):
        self.request = request
        self.result = bool(result)
        self.version = int(version)


class ScrubDaemon:
    """The integrity scrubber. Synchronous :meth:`step` runs one full
    cycle (the tests and the smoke drill call it directly);
    :meth:`start` runs it on a daemon thread every ``interval_s``. The
    driver registry starts that thread in ``start_all`` AFTER any
    replica fork — never at construction — so it can't violate fork
    hygiene."""

    def __init__(
        self,
        engine_fn: Callable[[], object],  # the (possibly wrapped) engine
        oracle_fn: Optional[Callable[[], object]] = None,  # host oracle
        repair_fn: Optional[Callable[[], None]] = None,  # residency seam
        cache_flush_fn: Optional[Callable[[], None]] = None,
        version_fn: Optional[Callable[[], int]] = None,
        store_fn: Optional[Callable[[], object]] = None,  # durable or plain
        replicator_fn: Optional[Callable[[], object]] = None,  # a follower's
        digest_chunk_size: int = 1024,
        interval_s: float = 5.0,
        sample_rows: int = 64,
        reservoir: int = 256,
        replay_per_cycle: int = 32,
        wal_segments_per_cycle: int = 4,
        max_repairs_per_cycle: int = 2,
        history: int = 256,
        enabled_fn: Optional[Callable[[], bool]] = None,
        guards: Sequence[Callable[[], Optional[str]]] = (),
        clock: Callable[[], float] = time.monotonic,
        seed: int = 0,
        slo=None,  # SLOTracker: the burn-rate freeze
        freeze_burn_rate: float = 0.0,  # 0 = inherit slo.alert_burn_rate
        metrics=None,
        flight=None,
    ):
        self._engine_fn = engine_fn
        self._oracle_fn = oracle_fn
        self._repair_fn = repair_fn
        self._cache_flush_fn = cache_flush_fn
        self._version_fn = version_fn
        self._store_fn = store_fn
        self._replicator_fn = replicator_fn
        self.digest_chunk_size = max(1, int(digest_chunk_size))
        self.interval_s = float(interval_s)
        self.sample_rows = max(1, int(sample_rows))
        self.reservoir_capacity = max(1, int(reservoir))
        self.replay_per_cycle = max(0, int(replay_per_cycle))
        self.wal_segments_per_cycle = max(0, int(wal_segments_per_cycle))
        self._wal_cursor = 0
        self.max_repairs_per_cycle = max(0, int(max_repairs_per_cycle))
        self._enabled_fn = enabled_fn
        self._guards = list(guards)
        self._clock = clock
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        self._history: deque[dict] = deque(maxlen=max(1, int(history)))
        # Algorithm R reservoir over live check traffic; _observed counts
        # every candidate so old entries are replaced uniformly
        self._reservoir: list[_ReservoirEntry] = []
        self._observed = 0
        self._reservoir_lock = threading.Lock()
        self.cycles = 0
        self.mismatches: dict[str, int] = {}
        self.repairs: dict[str, int] = {}
        self.last_clean_version = 0
        self._was_frozen: Optional[str] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._slo = slo
        self.freeze_burn_rate = float(freeze_burn_rate)
        self._flight = flight
        self._m_cycles = None
        self._m_mismatches = None
        self._m_repairs = None
        if metrics is not None:
            self._m_cycles = metrics.counter(
                "keto_scrub_cycles_total",
                "integrity scrub cycles completed",
            )
            self._m_mismatches = metrics.counter(
                "keto_scrub_mismatches_total",
                "derived-state divergences the scrubber detected, by kind "
                "(device row, oracle replay, WAL segment, checkpoint, "
                "replica digest)",
                labelnames=("kind",),
            )
            self._m_repairs = metrics.counter(
                "keto_scrub_repairs_total",
                "scrubber remediations applied, by action",
                labelnames=("action",),
            )
            metrics.gauge(
                "keto_scrub_last_clean_version",
                "store version at the end of the last scrub cycle that "
                "found every sampled surface clean",
                fn=lambda: float(self.last_clean_version),
            )

    # -- daemon lifecycle -------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="scrub", daemon=True
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
                _log.warning("scrub cycle failed: %s: %s", type(e).__name__, e)

    # -- live-traffic tap -------------------------------------------------------

    def observe_batch(self, requests, results) -> None:
        """Reservoir-sample finished live checks (called from the
        batcher's dispatch path — must stay O(1)-ish and never throw)."""
        version = 0
        if self._version_fn is not None:
            try:
                version = int(self._version_fn())
            except Exception:
                return
        with self._reservoir_lock:
            for req, res in zip(requests, results):
                self._observed += 1
                if len(self._reservoir) < self.reservoir_capacity:
                    self._reservoir.append(
                        _ReservoirEntry(req, res, version)
                    )
                else:
                    j = int(self._rng.integers(self._observed))
                    if j < self.reservoir_capacity:
                        self._reservoir[j] = _ReservoirEntry(
                            req, res, version
                        )

    # -- the scrub cycle --------------------------------------------------------

    def step(self) -> dict:
        """One full scrub cycle. Returns the event dict (the same
        payload that lands in the history ring / flight recorder)."""
        with self._lock:
            return self._step_locked()

    def _step_locked(self) -> dict:
        now = self._clock()
        if self._enabled_fn is not None and not self._enabled_fn():
            return {"ts": now, "action": "disabled"}
        frozen = self._frozen_reason()
        if frozen is not None:
            event = {"ts": now, "action": "frozen", "reason": frozen}
            if self._was_frozen != frozen:
                self._emit(event)  # record the transition, not every tick
            self._was_frozen = frozen
            return event
        self._was_frozen = None
        self.cycles += 1
        if self._m_cycles is not None:
            self._m_cycles.inc()
        repairs_left = self.max_repairs_per_cycle
        findings: list[dict] = []

        def repair(action: str, fn: Callable[[], None]) -> bool:
            nonlocal repairs_left
            if repairs_left <= 0:
                findings.append(
                    {"action": action, "applied": False,
                     "reason": "repair_budget"}
                )
                return False
            repairs_left -= 1
            try:
                fn()
                applied = True
                err = None
            except Exception as e:
                applied = False
                err = f"{type(e).__name__}: {e}"
            self.repairs[action] = self.repairs.get(action, 0) + 1
            if self._m_repairs is not None:
                self._m_repairs.labels(action=action).inc()
            findings.append(
                {"action": action, "applied": applied, "error": err}
            )
            return applied

        clean = True
        for kind, check in (
            (KIND_DEVICE, self._scrub_device_rows),
            (KIND_REPLAY, self._scrub_replay),
            (KIND_WAL, self._scrub_wal),
            (KIND_CHECKPOINT, self._scrub_checkpoint),
            (KIND_REPLICA, self._scrub_replica),
        ):
            try:
                report = check(repair)
            except Exception as e:
                report = {"error": f"{type(e).__name__}: {e}"}
            if report is None:
                continue
            report["kind"] = kind
            findings.append(report)
            n_bad = int(report.get("mismatches", 0) or 0)
            if n_bad:
                clean = False
                self.mismatches[kind] = (
                    self.mismatches.get(kind, 0) + n_bad
                )
                if self._m_mismatches is not None:
                    self._m_mismatches.labels(kind=kind).inc(n_bad)
        if clean:
            version = 0
            if self._version_fn is not None:
                try:
                    version = int(self._version_fn())
                except Exception:
                    version = 0
            self.last_clean_version = version
        event = {
            "ts": now,
            "action": "cycle",
            "clean": clean,
            "findings": findings,
            "repairs_left": repairs_left,
        }
        # a clean cycle with no checked surfaces is not news; only emit
        # when something was found, repaired, or an error surfaced
        if not clean or any(
            f.get("error") or f.get("mismatches") for f in findings
        ):
            self._emit(event)
        return event

    # -- (a) device-resident rows ----------------------------------------------

    def _scrub_device_rows(self, repair) -> Optional[dict]:
        engine = self._engine_fn() if self._engine_fn is not None else None
        scrub = getattr(engine, "scrub_residency", None)
        if scrub is None:
            return None
        report = scrub(self.sample_rows, self._rng)
        if report is None:
            return None  # not quiescent / no resident closure: skip
        bad = report.get("bad_rows") or []
        bad_rev = report.get("bad_rev_rows") or []
        report["mismatches"] = len(bad) + len(bad_rev)
        if report["mismatches"]:
            repair(ACTION_RESET_RESIDENCY, self._reset_residency)
            repair(ACTION_CACHE_FLUSH, self._flush_caches)
        return report

    def _reset_residency(self) -> None:
        if self._repair_fn is not None:
            self._repair_fn()
            return
        engine = self._engine_fn() if self._engine_fn is not None else None
        reset = getattr(engine, "reset_residency", None)
        if reset is not None:
            reset()

    def _flush_caches(self) -> None:
        if self._cache_flush_fn is not None:
            self._cache_flush_fn()

    # -- (b) oracle replay ------------------------------------------------------

    def _scrub_replay(self, repair) -> Optional[dict]:
        if self.replay_per_cycle <= 0 or self._oracle_fn is None:
            return None
        oracle = self._oracle_fn()
        if oracle is None:
            return None
        version = 0
        if self._version_fn is not None:
            try:
                version = int(self._version_fn())
            except Exception:
                return None
        with self._reservoir_lock:
            entries = [
                e for e in self._reservoir if e.version == version
            ]
        if not entries:
            return None
        if len(entries) > self.replay_per_cycle:
            idx = self._rng.choice(
                len(entries), self.replay_per_cycle, replace=False
            )
            entries = [entries[int(i)] for i in idx]
        expected = oracle.batch_check([e.request for e in entries])
        bad = [
            {
                "request": repr(e.request),
                "served": e.result,
                "oracle": bool(exp),
            }
            for e, exp in zip(entries, expected)
            if bool(exp) != e.result
        ]
        if bad:
            # divergence between live answers and the host oracle at the
            # same version: encode/cache/overlay corruption. Rebuild the
            # residency AND flush the result caches (they are stamped
            # with the unchanged version and would keep serving the bad
            # answers past the rebuild).
            repair(ACTION_RESET_RESIDENCY, self._reset_residency)
            repair(ACTION_CACHE_FLUSH, self._flush_caches)
            with self._reservoir_lock:
                self._reservoir.clear()
                self._observed = 0
        return {
            "replayed": len(entries),
            "version": version,
            "mismatches": len(bad),
            "bad": bad[:8],
        }

    # -- (c) sealed WAL segments ------------------------------------------------

    def _scrub_wal(self, repair) -> Optional[dict]:
        if self.wal_segments_per_cycle <= 0:
            return None
        store = self._store_fn() if self._store_fn is not None else None
        wal = getattr(store, "wal", None)
        if wal is None:
            return None
        from ..store.wal import inject_bitrot, sealed_segments, verify_segment

        directory = wal.directory
        if FAULTS.should_fire("wal.bitrot"):
            # the drill: flip one byte inside a sealed segment's frame
            # region on disk; the rescan below must now detect it
            inject_bitrot(directory)
        sealed = sealed_segments(directory)
        if not sealed:
            return None
        n = min(self.wal_segments_per_cycle, len(sealed))
        start = self._wal_cursor % len(sealed)
        picked = [sealed[(start + i) % len(sealed)] for i in range(n)]
        self._wal_cursor = (start + n) % max(1, len(sealed))
        bad = []
        for first_version, path in picked:
            res = verify_segment(path)
            if not res["ok"]:
                bad.append({"path": path, "first_version": first_version, **res})
        if bad:
            # re-anchor durability past the damage: a fresh checkpoint at
            # the current version prunes every sealed segment at or below
            # it, the damaged one included
            checkpoint_now = getattr(store, "checkpoint_now", None)
            if checkpoint_now is not None:
                repair(ACTION_CHECKPOINT_REBUILD, lambda: checkpoint_now())
        return {
            "scanned": len(picked),
            "sealed": len(sealed),
            "mismatches": len(bad),
            "bad": bad,
        }

    # -- (d) checkpoint sha256 --------------------------------------------------

    def _scrub_checkpoint(self, repair) -> Optional[dict]:
        store = self._store_fn() if self._store_fn is not None else None
        ckpt_dir = getattr(store, "checkpoint_dir", None)
        if not ckpt_dir:
            return None
        from ..graph.checkpoint import (
            CheckpointError,
            list_checkpoints,
            load_checkpoint,
        )

        ckpts = list_checkpoints(ckpt_dir)
        if not ckpts:
            return None
        path = ckpts[-1][1]
        try:
            ck = load_checkpoint(path)  # verifies the payload sha256
            ck.close()
            return {"path": path, "mismatches": 0}
        except (CheckpointError, OSError) as e:
            err = str(e)

        def _rebuild():
            import os

            try:
                os.remove(path)
            except OSError:
                pass
            checkpoint_now = getattr(store, "checkpoint_now", None)
            if checkpoint_now is not None:
                checkpoint_now()

        repair(ACTION_CHECKPOINT_REBUILD, _rebuild)
        return {"path": path, "mismatches": 1, "error": err}

    # -- (e) replica anti-entropy -------------------------------------------------

    def _scrub_replica(self, repair) -> Optional[dict]:
        if self._replicator_fn is None:
            return None
        replicator = self._replicator_fn()
        if replicator is None:
            return None
        store = self._store_fn() if self._store_fn is not None else None
        if store is None:
            return None
        from ..replication.digest import compute_digest, diff_digests

        local = compute_digest(store, chunk_size=self.digest_chunk_size)
        try:
            remote = replicator.fetch_digest(chunk_size=self.digest_chunk_size)
        except Exception as e:
            return {"error": f"digest fetch: {type(e).__name__}: {e}"}
        if remote.get("version") != local["version"]:
            # replication lag, not divergence: compare only at equal applied
            # versions (the next cycle lines up)
            return {
                "skipped": "version_lag",
                "local_version": local["version"],
                "remote_version": remote.get("version"),
            }
        divergent = diff_digests(local, remote)
        if divergent:
            repair(ACTION_RESEED, replicator.reseed)
        return {
            "version": local["version"],
            "chunks": len(local["chunks"]),
            "divergent_chunks": divergent,
            "mismatches": len(divergent),
        }

    # -- guards -----------------------------------------------------------------

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
                self._flight.record(kind="scrub", **event)
            except Exception:
                pass
        _log.info(
            "scrub %s",
            {k: v for k, v in event.items() if k != "findings"},
        )
        return event

    # -- introspection ----------------------------------------------------------

    def history(self, n: Optional[int] = None) -> list[dict]:
        """Newest-first scrub events (the /debug/scrub body)."""
        with self._lock:
            out = list(self._history)
        out.reverse()
        return out if n is None else out[: max(0, int(n))]

    def snapshot(self) -> dict:
        enabled = (
            self._enabled_fn() if self._enabled_fn is not None else True
        )
        with self._reservoir_lock:
            reservoir_size = len(self._reservoir)
            observed = self._observed
        return {
            "enabled": bool(enabled),
            "running": self._thread is not None,
            "interval_s": self.interval_s,
            "cycles": self.cycles,
            "mismatches": dict(self.mismatches),
            "repairs": dict(self.repairs),
            "last_clean_version": self.last_clean_version,
            "frozen": self._was_frozen,
            "reservoir_size": reservoir_size,
            "reservoir_observed": observed,
            "sample_rows": self.sample_rows,
            "replay_per_cycle": self.replay_per_cycle,
            "wal_segments_per_cycle": self.wal_segments_per_cycle,
            "max_repairs_per_cycle": self.max_repairs_per_cycle,
        }
