"""Lease-based leader election with fencing tokens over a shared WAL disk
(counterpart of ``keto_tpu/cluster/election.py``).

A dead leader otherwise needs an operator to call
``FollowerReplicator.promote()``. This module closes the loop for the
failure that matters most, losing the writer, off the read path: reads
never stop.

The coordination substrate is the artifact replication already trusts: the
leader's WAL directory on shared disk. Three small files live beside the
segments:

- ``election-lease.json`` — the current lease: ``{term, leader_id,
  acquired_at, expires_at, read_url, write_url}``. The **term** is the
  fencing token: it only increases, and every acquisition bumps it.
- ``election.lock`` — an ``flock`` file serializing the compare-and-swap in
  :meth:`LeaseStore.acquire` and :meth:`LeaseStore.renew`: two candidates
  racing for an expired lease cannot both win a term.
- ``election-terms.jsonl`` — the append-only term lineage; the failover
  drills hold it to one chain of strictly increasing terms.

Safety, in order:

1. A leader renews its lease every heartbeat interval; a renewal that finds
   another ``(leader_id, term)`` on disk has been **fenced** and steps down.
2. The write plane asks :meth:`ElectionManager.is_writable` before every
   mutation, a fresh read of the lease on disk, so a stale ex-leader
   rejects late writes even if its own clock still believes in its lease.
3. A candidate wins only by writing ``term + 1`` under the flock after the
   old lease expired, and promotion replays the shared WAL
   (``FollowerReplicator.promote``) before the new leader takes a write:
   with WAL-before-ack on the old leader, no acked write is lost.
4. A failed promotion releases the lease and re-enters the loop (the
   ``replica.promote_fail`` fault site drills this): the fleet re-elects
   instead of wedging behind a half-promoted node.

Candidates are ranked by replication position: each follower caches the
fleet view from the leader's ``/cluster/status`` while it is healthy and
staggers its candidacy by the number of better-placed peers (higher
``cluster.election.priority``, then higher replicated version), so the most
caught-up follower usually takes the first swing.

``PromotedReplicationSource``'s routes register on the port's ``Router``
(the reference's on aiohttp): each connection has its own server thread.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import urllib.request
from typing import Callable, Optional

try:  # pragma: no cover - always present on the POSIX hosts we target
    import fcntl
except ImportError:  # pragma: no cover
    fcntl = None

from ..faults import FAULTS
from ..store.wal import WriteAheadLog, _fsync_dir

log = logging.getLogger("keto_tpu_torch.cluster.election")

LEASE_FILE = "election-lease.json"
LOCK_FILE = "election.lock"
LINEAGE_FILE = "election-terms.jsonl"


class LeaseStore:
    """Fencing-token lease CAS over a shared directory (the WAL dir).

    All mutations run under an ``flock`` on :data:`LOCK_FILE` plus an
    in-process lock, so the critical section holds across both threads
    and processes sharing the disk. The lease file is replaced
    atomically (tmp + fsync + rename + dir fsync — the WAL's own
    durability discipline), so a reader never observes a torn lease.
    ``clock`` is injectable: the clock-skew tests give two stores
    different clocks over one directory.
    """

    def __init__(self, directory: str, *, clock: Callable[[], float] = time.time):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._clock = clock
        self._lease_path = os.path.join(directory, LEASE_FILE)
        self._lock_path = os.path.join(directory, LOCK_FILE)
        self._lineage_path = os.path.join(directory, LINEAGE_FILE)
        self._plock = threading.Lock()

    # -- plumbing -------------------------------------------------------------

    def _flocked(self):
        """Context manager: in-process lock + exclusive flock."""

        class _Ctx:
            def __init__(ctx):
                ctx.fd = None

            def __enter__(ctx):
                self._plock.acquire()
                ctx.fd = os.open(self._lock_path, os.O_CREAT | os.O_RDWR, 0o644)
                if fcntl is not None:
                    fcntl.flock(ctx.fd, fcntl.LOCK_EX)
                return ctx

            def __exit__(ctx, *exc):
                try:
                    if fcntl is not None:
                        fcntl.flock(ctx.fd, fcntl.LOCK_UN)
                    os.close(ctx.fd)
                finally:
                    self._plock.release()

        return _Ctx()

    def read(self) -> Optional[dict]:
        """The current on-disk lease, or None (missing/corrupt — a corrupt
        lease reads as vacant, which only ever delays an election)."""
        try:
            with open(self._lease_path, "r", encoding="utf-8") as f:
                doc = json.load(f)
            if not isinstance(doc, dict) or "term" not in doc:
                return None
            return doc
        except (OSError, ValueError):
            return None

    def _write(self, lease: dict) -> None:
        tmp = self._lease_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(lease, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._lease_path)
        _fsync_dir(self.directory)

    def _append_lineage(self, record: dict) -> None:
        with open(self._lineage_path, "a", encoding="utf-8") as f:
            f.write(json.dumps(record) + "\n")
            f.flush()
            os.fsync(f.fileno())

    # -- the CAS --------------------------------------------------------------

    def acquire(
        self,
        candidate_id: str,
        ttl_s: float,
        *,
        read_url: str = "",
        write_url: str = "",
    ) -> Optional[dict]:
        """Take the lease iff it is vacant, expired, or already ours.
        Returns the new lease (term bumped) or None when a live lease is
        held by someone else. The ``election.lease_stall`` slowness site
        sits before the critical section: a stalled renewal lets the
        lease expire under a live leader, a stalled candidate loses the
        race it would have won."""
        FAULTS.maybe_sleep("election.lease_stall")
        with self._flocked():
            now = self._clock()
            cur = self.read()
            if (
                cur is not None
                and str(cur.get("leader_id")) != candidate_id
                and float(cur.get("expires_at", 0.0)) > now
            ):
                return None
            prev_term = int(cur.get("term", 0)) if cur else 0
            lease = {
                "term": prev_term + 1,
                "leader_id": candidate_id,
                "acquired_at": now,
                "expires_at": now + float(ttl_s),
                "read_url": read_url,
                "write_url": write_url,
            }
            self._write(lease)
            self._append_lineage(
                {
                    "term": lease["term"],
                    "leader_id": candidate_id,
                    "prev_term": prev_term,
                    "prev_leader_id": (
                        str(cur.get("leader_id")) if cur else None
                    ),
                    "at": now,
                }
            )
            return lease

    def renew(self, leader_id: str, term: int, ttl_s: float) -> Optional[dict]:
        """Extend the lease iff ``(leader_id, term)`` still names the
        on-disk leaseholder. None means fenced: a newer term took over
        (or the lease vanished) and the caller must step down."""
        FAULTS.maybe_sleep("election.lease_stall")
        with self._flocked():
            cur = self.read()
            if (
                cur is None
                or str(cur.get("leader_id")) != leader_id
                or int(cur.get("term", 0)) != int(term)
            ):
                return None
            cur["expires_at"] = self._clock() + float(ttl_s)
            self._write(cur)
            return cur

    def release(self, leader_id: str, term: int) -> bool:
        """Expire our own lease immediately (failed promotion, clean
        shutdown) so the next candidate need not wait out the TTL."""
        with self._flocked():
            cur = self.read()
            if (
                cur is None
                or str(cur.get("leader_id")) != leader_id
                or int(cur.get("term", 0)) != int(term)
            ):
                return False
            cur["expires_at"] = self._clock()
            self._write(cur)
            return True

    def fence_check(self, leader_id: str, term: int) -> bool:
        """True iff ``(leader_id, term)`` is the current unexpired
        leaseholder — the write-path fencing predicate. Term comparison
        first: even a candidate with a badly skewed clock cannot pass
        once a newer term is on disk."""
        cur = self.read()
        if cur is None:
            return False
        if int(cur.get("term", 0)) != int(term):
            return False
        if str(cur.get("leader_id")) != leader_id:
            return False
        return float(cur.get("expires_at", 0.0)) > self._clock()

    def lineage(self) -> list[dict]:
        """Every term transition ever recorded, oldest first."""
        out: list[dict] = []
        try:
            with open(self._lineage_path, "r", encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        out.append(json.loads(line))
                    except ValueError:
                        continue
        except OSError:
            pass
        return out


class ElectionManager:
    """The per-node election loop: monitor the lease, campaign when it
    expires, renew while leading, retarget while following.

    Every collaborator is injected so the unit tests drive ticks
    synchronously with fake clocks: ``promote_fn`` replays the shared
    WAL into the local store (the registry wires
    ``FollowerReplicator.promote``), ``retarget_fn(lease)`` repoints the
    local replication tail at the new leader, ``position_fn`` reports
    our replicated version for candidate ranking, ``status_url_fn``
    yields a ``/cluster/status`` URL to refresh the peer cache from.
    """

    def __init__(
        self,
        lease_store: LeaseStore,
        *,
        instance_id: str,
        lease_ttl_s: float = 3.0,
        heartbeat_interval_s: float = 0.5,
        priority: int = 0,
        read_url: str = "",
        write_url: str = "",
        promote_fn: Optional[Callable[[], dict]] = None,
        retarget_fn: Optional[Callable[[dict], None]] = None,
        position_fn: Optional[Callable[[], int]] = None,
        status_fetch_fn=None,  # (url, timeout_s) -> dict; tests inject
        on_transition: Optional[Callable[[str, int], None]] = None,
        metrics=None,
        logger=None,
        clock: Callable[[], float] = time.time,
    ):
        self.lease = lease_store
        self.instance_id = str(instance_id)
        self.lease_ttl_s = max(0.1, float(lease_ttl_s))
        self.heartbeat_interval_s = max(0.01, float(heartbeat_interval_s))
        self.priority = int(priority)
        self.read_url = str(read_url).rstrip("/")
        self.write_url = str(write_url).rstrip("/")
        self.promote_fn = promote_fn
        self.retarget_fn = retarget_fn
        self.position_fn = position_fn
        self._status_fetch = status_fetch_fn or self._default_status_fetch
        self._on_transition = on_transition
        self._logger = logger
        self._clock = clock

        self.role = "follower"
        self.term = 0  # our own term while leading; 0 otherwise
        self.observed_term = 0  # newest term seen on disk
        self.transitions = 0
        self.last_transition: Optional[dict] = None
        self._last_lease: Optional[dict] = None
        self._peers: list[dict] = []
        self._peers_t = float("-inf")
        self._retargeted_to = ""
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._m_transitions = None
        if metrics is not None:
            self.bind_metrics(metrics)

    # -- metrics / status ------------------------------------------------------

    def bind_metrics(self, metrics) -> None:
        metrics.gauge(
            "keto_election_term",
            "newest election term (fencing token) observed on disk",
            fn=lambda: float(self.observed_term),
        )
        metrics.gauge(
            "keto_election_is_leader",
            "1 while this node holds the leader lease, else 0",
            fn=lambda: 1.0 if self.role == "leader" else 0.0,
        )
        self._m_transitions = metrics.counter(
            "keto_election_transitions_total",
            "election role transitions on this node (elected, fenced, "
            "failed promotions) — alert on churn",
        )

    def status(self) -> dict:
        with self._lock:
            lease = self._last_lease
            now = self._clock()
            return {
                "enabled": True,
                "instance_id": self.instance_id,
                "role": self.role,
                "term": self.term if self.role == "leader" else 0,
                "observed_term": self.observed_term,
                "leader_id": (
                    str(lease.get("leader_id")) if lease else None
                ),
                "lease_expires_at": (
                    float(lease.get("expires_at", 0.0)) if lease else None
                ),
                "lease_expires_in_s": (
                    round(float(lease.get("expires_at", 0.0)) - now, 3)
                    if lease
                    else None
                ),
                "lease_ttl_s": self.lease_ttl_s,
                "heartbeat_interval_s": self.heartbeat_interval_s,
                "priority": self.priority,
                "transitions": self.transitions,
                "last_transition": self.last_transition,
            }

    def _transition(self, role: str, term: int, reason: str) -> None:
        with self._lock:
            self.role = role
            self.transitions += 1
            self.last_transition = {
                "at": self._clock(),
                "role": role,
                "term": int(term),
                "reason": reason,
            }
        if self._m_transitions is not None:
            self._m_transitions.inc()
        if self._logger is not None:
            try:
                self._logger.info(
                    "election_transition",
                    role=role,
                    term=int(term),
                    reason=reason,
                    instance_id=self.instance_id,
                )
            except Exception:
                pass
        else:
            log.info(
                "election transition: %s -> %s (term %d, %s)",
                self.instance_id, role, int(term), reason,
            )
        if self._on_transition is not None:
            try:
                self._on_transition(role, int(term))
            except Exception:
                log.exception("on_transition callback failed")

    def _observe(self, lease: Optional[dict]) -> None:
        with self._lock:
            self._last_lease = lease
            if lease is not None:
                t = int(lease.get("term", 0))
                if t > self.observed_term:
                    self.observed_term = t

    # -- write-path fencing ----------------------------------------------------

    def is_writable(self) -> bool:
        """The write plane's gate: a fresh on-disk fence check per
        mutation. Deliberately *not* cached — the double-leader window
        closes the instant a newer term lands on disk, regardless of
        what this node's clock believes about its own lease."""
        if self.role != "leader":
            return False
        ok = self.lease.fence_check(self.instance_id, self.term)
        if not ok:
            self._observe(self.lease.read())
        return ok

    def leader_hint(self) -> Optional[dict]:
        """Where writes should go instead, from the last lease seen."""
        with self._lock:
            lease = self._last_lease
        if lease is None:
            return None
        if (
            str(lease.get("leader_id")) == self.instance_id
            and self.role == "leader"
        ):
            return None
        return {
            "leader_id": str(lease.get("leader_id")),
            "term": int(lease.get("term", 0)),
            "read_url": str(lease.get("read_url") or ""),
            "write_url": str(lease.get("write_url") or ""),
        }

    # -- peer ranking ----------------------------------------------------------

    @staticmethod
    def _default_status_fetch(url: str, timeout_s: float) -> dict:
        with urllib.request.urlopen(
            urllib.request.Request(url), timeout=timeout_s
        ) as resp:
            return json.loads(resp.read().decode("utf-8"))

    def observe_peers(self, status_doc: dict) -> None:
        """Cache the fleet view (``/cluster/status`` body) for candidate
        ranking. Called by the loop's periodic refresh and directly by
        tests/drills."""
        members = status_doc.get("members")
        if isinstance(members, list):
            with self._lock:
                self._peers = members
                self._peers_t = self._clock()

    def _refresh_peers(self, lease: Optional[dict]) -> None:
        """Refresh the peer cache from the live leader's rollup — while
        the leader is healthy, so the ranking is ready before it dies."""
        now = self._clock()
        with self._lock:
            if now - self._peers_t < 2.0 * self.heartbeat_interval_s:
                return
        base = str((lease or {}).get("read_url") or "").rstrip("/")
        if not base or base == self.read_url:
            return
        try:
            doc = self._status_fetch(
                f"{base}/cluster/status",
                min(1.0, self.lease_ttl_s / 2.0),
            )
            self.observe_peers(doc)
        except Exception:
            pass  # stale cache is fine; rank degrades to "go now"

    def candidacy_rank(self) -> int:
        """How many alive peers are better positioned to lead: higher
        configured priority wins, then higher replicated version, then
        lexicographically smaller instance id (a total order, so two
        candidates never compute the same slot)."""
        position = int(self.position_fn()) if self.position_fn else 0
        mine = (self.priority, position)
        with self._lock:
            peers = list(self._peers)
        rank = 0
        for p in peers:
            if not isinstance(p, dict):
                continue
            pid = str(p.get("instance_id") or "")
            if not pid or pid == self.instance_id:
                continue
            if not p.get("alive", True):
                continue
            if (p.get("role") or "") == "leader":
                continue  # the node we are replacing
            el = p.get("election") or {}
            theirs = (
                int(el.get("priority", 0)),
                int(p.get("version") or 0),
            )
            if theirs > mine or (theirs == mine and pid < self.instance_id):
                rank += 1
        return rank

    # -- the loop --------------------------------------------------------------

    def ensure_leadership(self) -> bool:
        """Bootstrap path for a configured leader: take (or re-take) the
        lease before serving writes. No promotion — the durable store is
        already authoritative here."""
        lease = self.lease.acquire(
            self.instance_id,
            self.lease_ttl_s,
            read_url=self.read_url,
            write_url=self.write_url,
        )
        if lease is None:
            self._observe(self.lease.read())
            log.warning(
                "configured leader %s could not take the lease (held by "
                "%s); starting read-only",
                self.instance_id,
                (self._last_lease or {}).get("leader_id"),
            )
            return False
        self.term = int(lease["term"])
        self._observe(lease)
        self._transition("leader", self.term, "bootstrap")
        return True

    def run_once(self) -> None:
        """One tick of the election loop (tests call this directly)."""
        if self.role == "leader":
            self._leader_tick()
        else:
            self._follower_tick()

    def _leader_tick(self) -> None:
        lease = self.lease.renew(
            self.instance_id, self.term, self.lease_ttl_s
        )
        if lease is not None:
            self._observe(lease)
            return
        # fenced: a newer term exists (or the lease vanished)
        cur = self.lease.read()
        self._observe(cur)
        fenced_by = str((cur or {}).get("leader_id") or "unknown")
        self._transition(
            "follower",
            int((cur or {}).get("term", self.term)),
            f"fenced by {fenced_by}",
        )
        self.term = 0
        self._maybe_retarget(cur)

    def _follower_tick(self) -> None:
        cur = self.lease.read()
        now = self._clock()
        self._observe(cur)
        held = (
            cur is not None
            and float(cur.get("expires_at", 0.0)) > now
            and str(cur.get("leader_id")) != self.instance_id
        )
        if held:
            # ``election.split_heartbeat``: one liveness observation is
            # lost — this follower falsely suspects a live leader and
            # campaigns early; the flock CAS must reject it
            if not FAULTS.should_fire("election.split_heartbeat"):
                self._maybe_retarget(cur)
                self._refresh_peers(cur)
                return
        self._campaign(cur)

    def _campaign(self, cur: Optional[dict]) -> None:
        rank = self.candidacy_rank()
        if rank > 0:
            # stagger: let better-positioned candidates take the first
            # swing; waking early (stop) aborts the candidacy
            if self._stop.wait(rank * self.heartbeat_interval_s):
                return
            fresh = self.lease.read()
            if fresh is not None and float(
                fresh.get("expires_at", 0.0)
            ) > self._clock() and str(
                fresh.get("leader_id")
            ) != self.instance_id:
                self._observe(fresh)
                self._maybe_retarget(fresh)
                return
        lease = self.lease.acquire(
            self.instance_id,
            self.lease_ttl_s,
            read_url=self.read_url,
            write_url=self.write_url,
        )
        if lease is None:
            # lost the race; follow whoever won
            fresh = self.lease.read()
            self._observe(fresh)
            self._maybe_retarget(fresh)
            return
        term = int(lease["term"])
        self._observe(lease)
        try:
            FAULTS.fire("replica.promote_fail")
            report = self.promote_fn() if self.promote_fn else {}
        except Exception as e:
            # release so the next candidate need not wait out the TTL;
            # this node stays a follower and the loop re-elects
            self.lease.release(self.instance_id, term)
            self._observe(self.lease.read())
            self._transition(
                "follower", term, f"promotion failed: {e}"
            )
            return
        self.term = term
        self._retargeted_to = ""
        self._transition("leader", term, "elected")
        if report:
            log.info(
                "promotion report for term %d: %s", term, report
            )

    def _maybe_retarget(self, lease: Optional[dict]) -> None:
        """Loser path: repoint the local replication tail at the current
        leaseholder's write plane (where ``/replication/*`` is served)."""
        if self.retarget_fn is None or lease is None:
            return
        target = str(lease.get("write_url") or "").rstrip("/")
        if (
            not target
            or target == self.write_url
            or target == self._retargeted_to
        ):
            return
        try:
            self.retarget_fn(dict(lease))
            self._retargeted_to = target
        except Exception:
            log.exception("retarget to %s failed", target)

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.run_once()
            except Exception:
                log.exception("election tick failed")
            self._stop.wait(self.heartbeat_interval_s)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="keto-election", daemon=True
        )
        self._thread.start()

    def stop(self, *, release: bool = False) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=self.lease_ttl_s + self.heartbeat_interval_s)
            self._thread = None
        if release and self.role == "leader" and self.term > 0:
            # clean shutdown: expire our lease so failover starts now,
            # not a TTL from now
            self.lease.release(self.instance_id, self.term)


class PromotedReplicationSource:
    """The serving half a promoted follower grows: the same three
    ``/replication/*`` routes the old leader offered, backed by the
    adopted shared-disk WAL, so the surviving followers' retargeted
    tails keep streaming without a re-bootstrap.

    ``open()`` adopts the WAL directory (truncating any torn tail, the
    log's standard contract) and subscribes to the promoted store's
    ordered delta feed, so every post-promotion write is appended before
    the mutator returns — the new leader keeps the WAL-before-ack
    durability story the old one had. ``/replication/checkpoint``
    answers 204: retargeted followers resume from their cursors and
    never need a seed; a brand-new follower must bootstrap against a
    node with a checkpoint plane.
    """

    def __init__(self, store, wal_dir: str, *, sync: str = "always"):
        self.store = store
        self.wal_dir = wal_dir
        self.sync = sync
        self.wal: Optional[WriteAheadLog] = None
        self._subscribed = False

    def open(self) -> None:
        self.wal = WriteAheadLog(self.wal_dir, sync=self.sync)
        subscribe = getattr(self.store, "subscribe_deltas", None)
        if subscribe is not None:
            subscribe(self._on_delta)
            self._subscribed = True

    def _on_delta(self, version, inserted, deleted) -> None:
        wal = self.wal
        if wal is None:
            return
        try:
            if inserted is None and deleted is None:
                wal.append_bulk_marker(version)
            else:
                wal.append(version, inserted or (), deleted or ())
        except Exception:
            # the ordered notifier swallows listener errors; log loudly —
            # a failed continuation append means this delta will not ship
            log.exception(
                "post-promotion WAL append failed at version %s", version
            )

    def close(self) -> None:
        if self._subscribed:
            unsub = getattr(self.store, "unsubscribe_deltas", None)
            if unsub is not None:
                unsub(self._on_delta)
            self._subscribed = False
        if self.wal is not None:
            try:
                self.wal.close()
            except Exception:
                pass
            self.wal = None

    # -- payloads / handlers (shape-compatible with ReplicationSource) --------

    def status(self) -> dict:
        segment, offset = self.wal.position() if self.wal else (0, 0)
        return {
            "role": "leader",
            "promoted": True,
            "version": self.store.version,
            "wal": {"segment": segment, "offset": offset},
            "checkpoint_version": 0,
            "t": time.time(),
        }

    def handle_status(self, req):
        from ..api.rest import json_response

        return json_response(self.status())

    def handle_checkpoint(self, req):
        from ..api.rest import Response

        return Response(204)

    def handle_wal(self, req):
        from ..api.rest import json_response
        from ..replication.leader import _MALFORMED_CURSOR, _wal_query, read_wal_from

        try:
            segment, offset, max_records, _ = _wal_query(req)
        except ValueError:
            return json_response(_MALFORMED_CURSOR, 400)
        out = read_wal_from(self.wal_dir, segment, offset, max_records)
        out["leader_version"] = self.store.version
        return json_response(out)
