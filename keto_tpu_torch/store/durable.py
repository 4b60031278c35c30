"""Durable write plane: WAL + checkpoints over the memory and columnar
stores (counterpart of ``keto_tpu/store/durable.py``).

``DurableTupleStore`` wraps an ``InMemoryTupleStore`` or
``ColumnarTupleStore`` and makes its write plane crash-durable:

- every mutator's exact ``(version, inserted, deleted)`` delta — captured
  from the store's own ``OrderedNotifier`` feed, so the log records what
  subscribers observed — is appended to a
  :class:`~keto_tpu_torch.store.wal.WriteAheadLog` BEFORE the mutator
  returns. Under ``sync=always`` the append fsyncs, so an acked write
  survives SIGKILL. Subscribers (the snapshot layer, the closure engine's
  write overlay, which patches D on the card) see the delta before the
  append, as in the reference; the caller is acked only after it. A failed
  append propagates (the write is not acked) and fail-stops the wrapper:
  it refuses further writes rather than ack unlogged mutations.
- checkpoints (:mod:`keto_tpu_torch.graph.checkpoint`) are cut in the
  background on a version or age trigger; each prunes the WAL segments it
  made redundant. Recovery = newest checkpoint + WAL-suffix replay, before
  the append handle opens (the open truncates a torn tail).
- ``bulk_load_edges`` (unreplayable: the columnar bulk path delivers no
  per-tuple delta) logs a bulk marker and cuts a SYNCHRONOUS checkpoint
  before returning.

Reads, subscriptions, snapshot surfaces and other attributes delegate to
the inner store, and ``process_private`` stays true so the replica pool
forks it as before; a forked child's capture hook is a no-op (the parent
owns the log). ``current_token`` is the structured snaptoken of the newest
acked write: the version and the WAL position its frame ended at
(``replication/token.py``).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional, Sequence

from ..graph import checkpoint as ckpt_mod
from ..relationtuple.definitions import RelationQuery, RelationTuple
from .wal import WalError, WalRecord, WriteAheadLog

log = logging.getLogger("keto_tpu_torch.store")

_KIND_OF = {"InMemoryTupleStore": "memory", "ColumnarTupleStore": "columnar"}


@dataclass
class RecoveryReport:
    """What boot-time recovery did: the payload of the registry's startup
    log line and of ``/debug/device``'s ``recovery`` entry."""

    checkpoint_version: int = 0
    checkpoint_path: Optional[str] = None
    replayed_deltas: int = 0
    skipped_records: int = 0
    final_version: int = 0
    duration_s: float = 0.0
    #: acked writes may be missing (mid-log damage, unreplayable bulk
    #: marker, version discontinuity): serve stale + log loudly
    gap: bool = False
    torn_tail_bytes: int = 0
    notes: list[str] = field(default_factory=list)
    #: CSR arrays embedded in the checkpoint, for snapshot priming
    csr: Optional[tuple] = None
    csr_version: Optional[int] = None
    #: seconds spent loading and restoring the checkpoint, and replaying
    #: the WAL suffix (parts of ``duration_s``)
    checkpoint_s: float = 0.0
    replay_s: float = 0.0


def recover_store(
    inner,
    wal_dir: str,
    checkpoint_dir: str,
) -> RecoveryReport:
    """Load the newest checkpoint into ``inner`` and replay the WAL suffix.

    Read-only with respect to the log (no append handle is opened, no
    truncation happens), so a verifier process can run this against a live
    directory. Raw state application on purpose: replay bypasses
    validation and notifications — the deltas already passed validation
    when first written, and nothing subscribes this early in boot.
    """
    t0 = time.monotonic()
    report = RecoveryReport()
    kind = _KIND_OF.get(type(inner).__name__)
    if kind is None:
        raise WalError(
            f"cannot recover store type {type(inner).__name__}; expected "
            "the memory or columnar store"
        )

    t_ckpt = time.monotonic()
    ckpt = ckpt_mod.load_latest(checkpoint_dir)
    if ckpt is not None and ckpt.kind != kind:
        report.notes.append(
            f"checkpoint {os.path.basename(ckpt.path)} is kind "
            f"{ckpt.kind!r} but the store is {kind!r}; ignoring it"
        )
        ckpt = None
    if ckpt is not None:
        ckpt.restore_into(inner)
        report.checkpoint_version = ckpt.version
        report.checkpoint_path = ckpt.path
        report.csr = ckpt.csr
        report.csr_version = ckpt.csr_version
        for note in ckpt.meta.get("skipped_damaged", ()):
            report.notes.append(f"skipped damaged checkpoint: {note}")
    t_replay = time.monotonic()
    report.checkpoint_s = t_replay - t_ckpt

    records, stats = WriteAheadLog.replay(wal_dir)
    report.torn_tail_bytes = stats.torn_tail_bytes
    report.notes.extend(stats.notes)
    if stats.gap:
        report.gap = True

    applied_upto = report.checkpoint_version
    for rec in records:
        if rec.version <= applied_upto:
            report.skipped_records += 1  # already inside the checkpoint
            continue
        if rec.version > applied_upto + 1:
            report.gap = True
            report.notes.append(
                f"WAL version discontinuity: have {applied_upto}, "
                f"next record is {rec.version}"
            )
        if rec.kind == "bulk":
            # the bulk load itself is not in the log; if it is not inside
            # the checkpoint either, its tuples are gone
            report.gap = True
            report.notes.append(
                f"unreplayable bulk-load marker at version {rec.version} "
                "beyond the checkpoint"
            )
            _force_version(inner, rec.version)
            applied_upto = rec.version
            continue
        _apply_record(inner, rec)
        applied_upto = rec.version
        report.replayed_deltas += 1

    report.final_version = applied_upto
    report.replay_s = time.monotonic() - t_replay
    report.duration_s = time.monotonic() - t0
    return report


def _apply_record(inner, rec: WalRecord) -> None:
    """Raw state application: both stores' own locked insert and delete
    (no validation, no notification)."""
    with inner._lock:
        if _KIND_OF[type(inner).__name__] == "memory":
            inner._insert_locked(rec.inserted)
            inner._delete_locked(rec.deleted)
        else:
            for t in rec.inserted:
                inner._insert_locked(t)
            for t in rec.deleted:
                inner._delete_locked(t)
        inner._version = rec.version


def _force_version(inner, version: int) -> None:
    with inner._lock:
        inner._version = version


class DurableTupleStore:
    """WAL-backed wrapper; see the module docstring for the contract."""

    # forks fine: children serve reads from inherited memory and never
    # touch the parent's log (pid-guarded capture hook)
    process_private = True

    def __init__(
        self,
        inner,
        wal_dir: str,
        *,
        checkpoint_dir: Optional[str] = None,
        sync: str = "always",
        sync_interval_ms: float = 50.0,
        segment_bytes: int = 16 << 20,
        checkpoint_interval_versions: int = 10_000,
        checkpoint_interval_s: float = 300.0,
        checkpoint_keep: int = 2,
    ):
        if _KIND_OF.get(type(inner).__name__) is None:
            raise WalError(
                f"DurableTupleStore cannot wrap {type(inner).__name__}"
            )
        self.inner = inner
        self.wal_dir = wal_dir
        self.checkpoint_dir = checkpoint_dir or os.path.join(
            wal_dir, "checkpoints"
        )
        self.checkpoint_interval_versions = int(checkpoint_interval_versions)
        self.checkpoint_interval_s = float(checkpoint_interval_s)
        self.checkpoint_keep = int(checkpoint_keep)
        #: optional ``() -> (version, (indptr, indices)) | None`` hook the
        #: registry wires to the snapshot layer so checkpoints can embed
        #: the derived CSR
        self.csr_provider = None
        #: optional ``(errno_or_none: int | None) -> None`` hook, called
        #: once per failed append BEFORE the failure propagates (the
        #: registry logs it and counts ``keto_wal_append_errors_total``)
        self.append_error_cb = None

        self._pid = os.getpid()
        self._mutate_lock = threading.Lock()
        self._ckpt_lock = threading.Lock()
        self._ckpt_thread: Optional[threading.Thread] = None
        self._captured: deque = deque()
        self._broken: Optional[BaseException] = None
        self._closed = False

        # boot-time recovery happens BEFORE the append handle opens: the
        # replay must observe the log exactly as the crash left it (the
        # append-side open truncates the torn tail)
        self.recovery = recover_store(inner, wal_dir, self.checkpoint_dir)
        if self.recovery.gap:
            log.error(
                "store recovery found a WAL gap — serving possibly-stale "
                "state (version %d): %s",
                self.recovery.final_version,
                "; ".join(self.recovery.notes) or "no detail",
            )

        self.wal = WriteAheadLog(
            wal_dir,
            sync=sync,
            sync_interval_ms=sync_interval_ms,
            segment_bytes=segment_bytes,
        )
        self._last_ckpt_version = self.recovery.checkpoint_version
        self._last_ckpt_monotonic = time.monotonic()
        self._last_ckpt_wall = time.time()
        inner.subscribe_deltas(self._capture)

    # -- delegation ------------------------------------------------------------

    def __getattr__(self, name):
        # reads, subscriptions, snapshot surfaces, namespace_manager, …
        return getattr(self.inner, name)

    def __len__(self) -> int:
        return len(self.inner)

    @property
    def version(self) -> int:
        return self.inner.version

    # -- capture + logging -----------------------------------------------------

    def current_token(self):
        """The zookie for the newest acked write: the store version plus
        the WAL position its frame ended at. Version first, position second
        keeps the pair conservative under concurrent writes (the offset may
        already include a newer frame, never an older one: a token must
        never under-promise durability)."""
        from ..replication.token import SnapToken

        version = self.inner.version
        segment, offset = self.wal.position()
        return SnapToken(version=version, segment=segment, offset=offset)

    def _capture(self, version, inserted, deleted) -> None:
        # runs inside the inner store's ordered drain, before the mutator
        # returns (read-your-notification); forked children inherit the
        # subscription but must never append to the parent's log
        if os.getpid() != self._pid:
            return
        self._captured.append((version, inserted, deleted))

    def _check_writable(self) -> None:
        if self._broken is not None:
            raise WalError(
                "durable store is fail-stopped after a WAL append failure"
            ) from self._broken
        if self._closed:
            raise WalError("durable store is closed")

    def _flush_captured(self) -> None:
        """Append every captured delta to the WAL, in capture (= version)
        order. Any failure marks the wrapper broken and propagates — the
        caller's write is NOT acknowledged."""
        try:
            while self._captured:
                version, inserted, deleted = self._captured.popleft()
                if inserted is None and deleted is None:
                    self.wal.append_bulk_marker(version)
                else:
                    self.wal.append(version, inserted, deleted)
        except BaseException as e:
            self._broken = e
            cb = self.append_error_cb
            if cb is not None:
                try:
                    cb(getattr(e, "errno", None))
                except Exception:
                    pass  # the hook must not mask the failure
            raise

    # -- mutators (the durable surface) ----------------------------------------

    def write_relation_tuples(self, *tuples: RelationTuple) -> None:
        with self._mutate_lock:
            self._check_writable()
            self.inner.write_relation_tuples(*tuples)
            self._flush_captured()
        self._maybe_checkpoint_async()

    def delete_relation_tuples(self, *tuples: RelationTuple) -> None:
        with self._mutate_lock:
            self._check_writable()
            self.inner.delete_relation_tuples(*tuples)
            self._flush_captured()
        self._maybe_checkpoint_async()

    def delete_all_relation_tuples(self, query: RelationQuery) -> None:
        with self._mutate_lock:
            self._check_writable()
            self.inner.delete_all_relation_tuples(query)
            self._flush_captured()
        self._maybe_checkpoint_async()

    def transact_relation_tuples(
        self,
        insert: Sequence[RelationTuple],
        delete: Sequence[RelationTuple],
    ) -> None:
        with self._mutate_lock:
            self._check_writable()
            self.inner.transact_relation_tuples(insert, delete)
            self._flush_captured()
        self._maybe_checkpoint_async()

    def bulk_load_edges(self, src_keys, dst_keys) -> None:
        with self._mutate_lock:
            self._check_writable()
            self.inner.bulk_load_edges(src_keys, dst_keys)
            self._flush_captured()  # appends the bulk marker
        # a bulk load is unreplayable: only a checkpoint at (or past) its
        # version makes the store recoverable again — cut one NOW, not on
        # the background trigger
        self.checkpoint_now()

    # -- checkpointing ---------------------------------------------------------

    def checkpoint_now(self) -> Optional[str]:
        """Cut a checkpoint synchronously; returns its path (None when the
        store is empty at version 0). Exceptions propagate — the crash
        drill needs ``checkpoint.crash_mid_write`` to surface."""
        with self._ckpt_lock:
            if self.inner.version == 0 and len(self.inner) == 0:
                return None
            csr = None
            csr_version = None
            provider = self.csr_provider
            if provider is not None:
                try:
                    got = provider()
                    if got is not None:
                        csr_version, csr = got
                except Exception:
                    log.exception("csr provider failed; checkpoint "
                                  "proceeds without CSR arrays")
            path = ckpt_mod.write_checkpoint(
                self.checkpoint_dir,
                self.inner,
                keep=self.checkpoint_keep,
                csr=csr,
                csr_version=csr_version,
            )
            version = int(
                os.path.basename(path)[len("ckpt-"):-len(".npz")]
            )
            self._last_ckpt_version = version
            self._last_ckpt_monotonic = time.monotonic()
            self._last_ckpt_wall = time.time()
            self.wal.prune_upto(version)
            return path

    def checkpoint_age_s(self) -> float:
        """Seconds since the last successful checkpoint (gauge fodder)."""
        return time.monotonic() - self._last_ckpt_monotonic

    def last_checkpoint_version(self) -> int:
        return self._last_ckpt_version

    def _maybe_checkpoint_async(self) -> None:
        if self._closed or os.getpid() != self._pid:
            return
        due = (
            self.inner.version - self._last_ckpt_version
            >= self.checkpoint_interval_versions
            or (
                self.checkpoint_interval_s > 0
                and time.monotonic() - self._last_ckpt_monotonic
                >= self.checkpoint_interval_s
                and self.inner.version > self._last_ckpt_version
            )
        )
        if not due:
            return
        t = self._ckpt_thread
        if t is not None and t.is_alive():
            return  # single flight
        t = threading.Thread(
            target=self._background_checkpoint,
            name="keto-checkpointer",
            daemon=True,
        )
        self._ckpt_thread = t
        t.start()

    def _background_checkpoint(self) -> None:
        try:
            self.checkpoint_now()
        except Exception:
            log.exception("background checkpoint failed; WAL retains the "
                          "full suffix and the next trigger retries")

    # -- shutdown --------------------------------------------------------------

    def close_durable(self) -> None:
        """Final checkpoint (best effort) + WAL close. Idempotent."""
        if self._closed or os.getpid() != self._pid:
            return
        self._closed = True
        t = self._ckpt_thread
        if t is not None and t.is_alive():
            t.join(timeout=30.0)
        if self._broken is None:
            try:
                if self.inner.version > self._last_ckpt_version:
                    self.checkpoint_now()
            except Exception:
                log.exception("final checkpoint failed; recovery will "
                              "replay the WAL suffix instead")
        self.wal.close()
