"""The follower's replicator: checkpoint bootstrap and WAL tail replay
(counterpart of ``keto_tpu/replication/follower.py``).

A follower owns a plain (not durable) memory or columnar store and keeps it
converged with a leader's durable write plane:

1. **Bootstrap** — fetch ``/replication/checkpoint``, restore it into the
   local store (a raw transplant, then one rebuild notification so the
   snapshot layer re-encodes), and start tailing.
2. **Tail** — long-poll ``/replication/wal`` with a ``(segment, offset)``
   cursor; every shipped frame replays through
   ``store.apply_replicated_delta``, the store's ordered notifier, so the
   follower's snapshot layer and write overlay (which patches ``D`` on the
   card) see each delta as they would a local write. Duplicates after a
   reconnect are no-ops (version-guarded); a ``reset`` answer or an
   unreplayable bulk marker re-seeds from a fresh checkpoint.
3. **Waits** — ``wait_for_version`` blocks a snaptoken-pinned read until
   replay passes the token, within the read plane's freshness window; past
   it, it raises the typed, retryable :class:`ErrFollowerLag` with the
   current lag. A zero window bounces at once.
4. **Promotion** — ``promote(wal_dir)`` replays the leader's on-disk WAL
   suffix directly (shared-disk failover). The leader acks no write before
   its WAL frame is durable, so a promoted follower holds every acked write.

A reseed replaces the store wholesale, and its version may move back (to
the leader's newest checkpoint) before the tail replays forward again. Two
differences from the reference keep a live follower right across it: the
reseed and the tail's apply step hold one lock, and a tail answer fetched
before a reseed is dropped (in the reference a reseed from the scrubber's
thread races the tail, whose stale cursor can overwrite the reset one);
and ``on_reseed`` runs after the restore (the registry rebuilds the
residency there and drops cached answers: the write overlay takes the
rebuild notice of a version it has already passed for one it has seen).
And promotion and retargeting halt the tail without waiting for its request
in flight (the reference joins the thread, for up to the HTTP timeout when
the dead leader's connection stays open, with the new lease unrenewed).

Transport is ``urllib`` on a daemon thread: the tail loop depends on no
event loop, and the payloads are small JSON documents plus one checkpoint
file at bootstrap.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import urllib.parse
import urllib.request
from typing import Optional

from ..faults import FAULTS
from ..graph import checkpoint as ckpt_mod
from ..store.wal import WriteAheadLog, record_from_doc
from ..utils.errors import ErrFollowerLag
from .token import LATEST_SENTINEL

log = logging.getLogger("keto_tpu_torch.replication")

_KIND_OF = {"InMemoryTupleStore": "memory", "ColumnarTupleStore": "columnar"}


class ReplicationError(RuntimeError):
    """A bootstrap or tail failure the replicator could not retry through."""


def _notify_rebuild(store, version: int) -> None:
    """Fire the store's delta feed with a None delta ("unknown change,
    rebuild") after a raw checkpoint transplant — the signal a bulk load
    emits, so the snapshot layer re-encodes."""
    for fn in list(getattr(store, "_delta_listeners", ())):
        fn(version, None, None)


class FollowerReplicator:
    """Keeps ``store`` converged with the leader at ``upstream`` (the
    leader's write-plane base URL, e.g. ``http://127.0.0.1:4467``)."""

    def __init__(
        self,
        store,
        upstream: str,
        *,
        scratch_dir: str,
        poll_interval_s: float = 0.05,
        wait_ms: float = 1000.0,
        max_records: int = 512,
        http_timeout_s: float = 10.0,
        clock=time.monotonic,
    ):
        kind = _KIND_OF.get(type(store).__name__)
        if kind is None:
            raise ReplicationError(
                f"follower cannot replicate into {type(store).__name__}; "
                "expected the memory or columnar store"
            )
        self.store = store
        self.kind = kind
        self.upstream = upstream.rstrip("/")
        self.scratch_dir = scratch_dir
        self.poll_interval_s = max(0.005, float(poll_interval_s))
        self.wait_ms = max(0.0, float(wait_ms))
        self.max_records = max(1, int(max_records))
        self.http_timeout_s = float(http_timeout_s)
        self._clock = clock

        self._cursor: list[int] = [0, 0]  # [segment_first_version, offset]
        self.leader_version = 0  # newest version the leader has reported
        self.applied_total = 0
        self.reseeds_total = 0
        self.last_error: Optional[str] = None
        self.role = "follower"
        # the last checkpoint seed's cost: bytes fetched, seconds to fetch
        # it and to restore it into the store
        self.seed_stats: dict = {}
        self._last_contact: Optional[float] = None
        self._last_apply: Optional[float] = None
        self._lag_since: Optional[float] = None
        # () -> None after a reseed's restore, under the apply lock
        self.on_reseed = None
        # the reseed and the tail's apply step are serialized; a reseed bumps
        # the generation, and a tail answer of an older one is dropped
        self._apply_lock = threading.RLock()
        self._generation = 0
        self._cv = threading.Condition()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._m_applied = None
        self._m_reseeds = None

    # -- transport ----------------------------------------------------------------

    def _get(self, path: str, params: Optional[dict] = None):
        url = self.upstream + path
        if params:
            url += "?" + urllib.parse.urlencode(params)
        req = urllib.request.Request(url, method="GET")
        return urllib.request.urlopen(req, timeout=self.http_timeout_s)

    def _get_json(self, path: str, params: Optional[dict] = None) -> dict:
        with self._get(path, params) as resp:
            return json.loads(resp.read().decode("utf-8"))

    # -- bootstrap / reseed -------------------------------------------------------

    def bootstrap(self) -> dict:
        """Seed the local store from the leader's newest checkpoint and
        record the leader's position. Raises on an unreachable or
        incompatible upstream: a follower that cannot seed must not serve."""
        status = self._get_json("/replication/status")
        self.leader_version = int(status.get("version", 0))
        self._last_contact = self._clock()
        seeded = self._fetch_and_restore_checkpoint()
        with self._cv:
            self._cv.notify_all()
        return {
            "seeded_version": self.store.version if seeded else 0,
            "leader_version": self.leader_version,
        }

    def _fetch_and_restore_checkpoint(self) -> bool:
        os.makedirs(self.scratch_dir, exist_ok=True)
        seed_path = os.path.join(self.scratch_dir, "seed-checkpoint.npz")
        t0 = time.perf_counter()
        n_bytes = 0
        with self._get("/replication/checkpoint") as resp:
            if resp.status == 204:
                return False  # an empty leader: tail only, from version 0
            tmp = seed_path + ".tmp"
            with open(tmp, "wb") as f:
                while True:
                    chunk = resp.read(1 << 20)
                    if not chunk:
                        break
                    n_bytes += len(chunk)
                    f.write(chunk)
            os.replace(tmp, seed_path)
        t1 = time.perf_counter()
        ckpt = ckpt_mod.load_checkpoint(seed_path)
        if ckpt.kind != self.kind:
            raise ReplicationError(
                f"leader checkpoint is kind {ckpt.kind!r} but this "
                f"follower's store is {self.kind!r}"
            )
        ckpt.restore_into(self.store)
        _notify_rebuild(self.store, ckpt.version)
        self.seed_stats = {
            "bytes": n_bytes,
            "fetch_s": t1 - t0,
            "restore_s": time.perf_counter() - t1,
            "version": ckpt.version,
        }
        return True

    def _reseed(self) -> None:
        """Re-seed from a fresh checkpoint after a ``reset`` (cursor pruned)
        or an unreplayable bulk marker. The leader cuts a synchronous
        checkpoint after every bulk load, so the new seed covers the range."""
        with self._apply_lock:
            self._generation += 1
            self.reseeds_total += 1
            if self._m_reseeds is not None:
                self._m_reseeds.inc()
            self._fetch_and_restore_checkpoint()
            if self.on_reseed is not None:
                self.on_reseed()
        with self._cv:
            self._cv.notify_all()

    def reseed(self) -> None:
        """Throw the local state away and re-seed from the leader's newest
        checkpoint: the scrubber's repair for a digest-divergent follower."""
        with self._apply_lock:
            self._reseed()
            self._cursor = [0, 0]

    # -- anti-entropy -------------------------------------------------------------

    def fetch_digest(self, chunk_size: int = 1024) -> dict:
        """The leader's per-chunk state digest (``/replication/digest``).
        Compare with ``compute_digest(self.store, ...)`` only at the same
        version: lag is not divergence."""
        return self._get_json("/replication/digest", {"chunk_size": int(chunk_size)})

    # -- tail loop ----------------------------------------------------------------

    def start(self) -> None:
        """Bootstrap synchronously, then tail on a daemon thread."""
        self.bootstrap()
        self._start_tail()

    def _start_tail(self) -> None:
        # each tail thread has its own stop event: a halted thread still
        # waiting on its last request never runs beside its successor
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._tail_loop, args=(self._stop,), name="keto-replication-tail",
            daemon=True,
        )
        self._thread.start()

    def _halt_tail(self, wait: bool) -> None:
        """Stop the tail thread. Its generation moves on under the apply
        lock, so an answer it is still waiting for is dropped; ``wait``
        joins it. Promotion and retargeting do not wait: the request in
        flight may be to a leader that died with the connection open, which
        answers only at the HTTP timeout (seconds the reference's
        ``promote`` waits out with the lease unrenewed)."""
        self._stop.set()
        with self._apply_lock:
            self._generation += 1
        with self._cv:
            self._cv.notify_all()
        t, self._thread = self._thread, None
        if t is not None and wait:
            t.join(timeout=self.http_timeout_s + 5.0)

    def stop(self) -> None:
        self._halt_tail(wait=True)

    def _tail_loop(self, stop: threading.Event) -> None:
        while not stop.is_set():
            try:
                self.poll_once(wait_ms=self.wait_ms)
                self.last_error = None
            except Exception as e:
                # an unreachable leader is lag, not a crash: keep retrying,
                # and show the error on the lag() panel
                self.last_error = f"{type(e).__name__}: {e}"
                stop.wait(self.poll_interval_s * 4)
                continue
            if stop.is_set():
                return
            # the long-poll returned promptly with nothing: a breather
            if not self.lag_versions():
                stop.wait(self.poll_interval_s)

    def poll_once(self, wait_ms: float = 0.0) -> int:
        """One pull-and-apply cycle; returns the records applied. Public so
        tests and the gates can drive replication deterministically."""
        with self._apply_lock:  # the cursor and its generation, as one pair
            generation = self._generation
            segment, offset = self._cursor
        out = self._get_json(
            "/replication/wal",
            {
                "segment": segment,
                "offset": offset,
                "max_records": self.max_records,
                "wait_ms": int(wait_ms),
            },
        )
        with self._apply_lock:
            if generation != self._generation:
                return 0  # a reseed ran meanwhile: this answer's cursor is stale
            return self._apply_pull(out)

    def _apply_pull(self, out: dict) -> int:
        now = self._clock()
        self._last_contact = now
        self.leader_version = max(self.leader_version, int(out.get("leader_version", 0)))
        if out.get("reset"):
            log.warning(
                "replication cursor %s was pruned on the leader; re-seeding "
                "from checkpoint", self._cursor,
            )
            self._reseed()
            self._cursor = [0, 0]
            return 0
        applied = 0
        for doc in out.get("records", ()):
            rec = record_from_doc(doc)
            if rec.kind == "bulk":
                if rec.version > self.store.version:
                    self._reseed()
                continue
            if FAULTS.should_fire("replica.skip_delta"):
                # silent divergence: the version advances, the delta's tuples
                # never land; only the anti-entropy digest can see it
                if self.store.apply_replicated_delta(rec.version, [], []):
                    applied += 1
                continue
            if self.store.apply_replicated_delta(rec.version, rec.inserted, rec.deleted):
                applied += 1
        nxt = out.get("next")
        if nxt:
            self._cursor = [int(nxt[0]), int(nxt[1])]
        if applied:
            self.applied_total += applied
            self._last_apply = now
            if self._m_applied is not None:
                self._m_applied.inc(applied)
            with self._cv:
                self._cv.notify_all()
        self._update_lag_clock()
        return applied

    def _update_lag_clock(self) -> None:
        if self.lag_versions() == 0:
            self._lag_since = None
        elif self._lag_since is None:
            self._lag_since = self._clock()

    # -- lag / status -------------------------------------------------------------

    def lag_versions(self) -> int:
        return max(0, self.leader_version - self.store.version)

    def lag_seconds(self) -> float:
        if self._lag_since is None:
            return 0.0
        return self._clock() - self._lag_since

    def staleness_seconds(self) -> float:
        """Seconds since the last successful upstream contact: the "is this
        follower even connected" alert signal."""
        if self._last_contact is None:
            return float("inf")
        return self._clock() - self._last_contact

    def lag(self) -> dict:
        return {
            "role": self.role,
            "upstream": self.upstream,
            "version": self.store.version,
            "leader_version": self.leader_version,
            "lag_versions": self.lag_versions(),
            "lag_seconds": round(self.lag_seconds(), 3),
            "staleness_seconds": round(self.staleness_seconds(), 3)
            if self._last_contact is not None
            else None,
            "cursor": list(self._cursor),
            "applied_total": self.applied_total,
            "reseeds_total": self.reseeds_total,
            "last_error": self.last_error,
        }

    def bind_metrics(self, metrics) -> None:
        metrics.gauge(
            "keto_replication_lag_versions",
            "store versions the follower is behind the leader",
            fn=lambda: float(self.lag_versions()),
        )
        metrics.gauge(
            "keto_replication_lag_seconds",
            "seconds this follower has continuously been behind "
            "(0 when caught up)",
            fn=self.lag_seconds,
        )
        metrics.gauge(
            "keto_replication_staleness_seconds",
            "seconds since the follower last heard from the leader",
            fn=lambda: min(self.staleness_seconds(), 1e9),
        )
        self._m_applied = metrics.counter(
            "keto_replication_applied_total",
            "leader deltas replayed into the follower store",
        )
        self._m_reseeds = metrics.counter(
            "keto_replication_reseeds_total",
            "checkpoint re-seeds (pruned cursor or bulk marker)",
        )

    # -- snaptoken waits ----------------------------------------------------------

    def wait_for_version(self, min_version: int, timeout_s: float = 0.0):
        """Block until replay passes ``min_version`` or the freshness window
        closes. ``LATEST_SENTINEL`` or above means "the leader's newest
        version as of this request". With ``timeout_s <= 0`` a follower
        that is behind bounces at once (the at-least-token mode's reject)."""
        target = int(min_version)
        if target >= LATEST_SENTINEL:
            target = max(self.leader_version, self.store.version)
        deadline = self._clock() + max(0.0, float(timeout_s))
        with self._cv:
            while True:
                current = self.store.version
                if current >= target:
                    return current
                remaining = deadline - self._clock()
                if remaining <= 0:
                    raise ErrFollowerLag(
                        lag_versions=max(target - current, self.lag_versions()),
                        lag_seconds=self.lag_seconds(),
                    )
                self._cv.wait(min(remaining, 0.25))

    # -- retargeting --------------------------------------------------------------

    def retarget(self, upstream: str) -> None:
        """Point the tail at a new leader (the election loser's path): stop
        the tail thread, swap the upstream, resume from the same cursor. No
        re-bootstrap: the promoted leader serves the same shared WAL
        directory, so ``(segment, offset)`` positions carry over."""
        upstream = upstream.rstrip("/")
        if not upstream or upstream == self.upstream or self.role == "leader":
            return
        was_running = self._thread is not None
        if was_running:
            self._halt_tail(wait=False)
        old = self.upstream
        self.upstream = upstream
        self.last_error = None
        self._last_contact = self._clock()  # the staleness clock restarts
        log.info("replication retargeted: %s -> %s", old, upstream)
        if was_running:
            self._start_tail()

    # -- promotion ----------------------------------------------------------------

    def promote(self, wal_dir: str) -> dict:
        """Shared-disk failover: stop tailing, replay the (dead) leader's WAL
        suffix straight off disk, and become the authority. Every acked
        write is in that log (WAL before ack), so promotion loses nothing
        acknowledged. Returns a small report for the drill."""
        self._halt_tail(wait=False)
        records, stats = WriteAheadLog.replay(wal_dir)
        applied = 0
        gap = stats.gap
        with self._apply_lock:
            for rec in records:
                if rec.version <= self.store.version:
                    continue
                if rec.kind == "bulk":
                    # beyond our seed and any checkpoint the dead leader
                    # could serve: flag it loudly
                    gap = True
                    continue
                if self.store.apply_replicated_delta(rec.version, rec.inserted, rec.deleted):
                    applied += 1
            self.role = "leader"
            self.leader_version = self.store.version
        with self._cv:
            self._cv.notify_all()
        if gap:
            log.error(
                "promotion replayed a log with gaps; acked writes may be "
                "missing (notes: %s)", "; ".join(stats.notes) or "none",
            )
        return {"applied": applied, "final_version": self.store.version, "gap": gap}
