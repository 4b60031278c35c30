"""In-memory relation-tuple store (counterpart of ``keto_tpu/store/memory.py``).

Implements the ``relationtuple.Manager`` contract — write/get/delete/
delete-all/transact with opaque-token pagination and namespace validation —
over an insertion-ordered dict. It is the write-side source of truth; the
snapshot layer subscribes to its monotonically increasing version counter.
The tests use it as the oracle store.
"""

from __future__ import annotations

import threading
from typing import Sequence

from ..namespace.definitions import NamespaceManager
from ..relationtuple.definitions import Manager, RelationQuery, RelationTuple
from ..utils.errors import ErrInvalidTuple
from ..utils.pagination import (
    PaginationOptions,
    decode_page_token,
    encode_page_token,
)
from .notify import OrderedNotifier


class InMemoryTupleStore(OrderedNotifier, Manager):
    """Insertion-ordered, deduplicated, thread-safe tuple store. Writing an
    already-existing tuple is an idempotent no-op."""

    # the replica pool may fork this store: its state is process memory
    # (a SQL store's is the database, and it is spawned instead)
    process_private = True

    def __init__(
        self,
        namespace_manager: NamespaceManager | None = None,
    ):
        self._lock = threading.RLock()
        # insertion-ordered mapping tuple -> insert sequence number
        self._tuples: dict[RelationTuple, int] = {}
        self._seq = 0
        self._version = 0
        self.namespace_manager = namespace_manager
        self._init_notify()

    @property
    def version(self) -> int:
        """Monotonic write counter; the snapshot layer's snaptoken source."""
        with self._lock:
            return self._version

    def _bump(self) -> int:
        self._version += 1
        return self._version

    def _validate(self, t: RelationTuple) -> None:
        if t.subject is None:
            raise ErrInvalidTuple("subject must not be nil")
        if self.namespace_manager is not None:
            self.namespace_manager.get_namespace_by_name(t.namespace)

    def _insert_locked(self, tuples) -> list[RelationTuple]:
        fresh = []
        for t in tuples:
            if t not in self._tuples:
                self._tuples[t] = self._seq
                self._seq += 1
                fresh.append(t)
        return fresh

    def _delete_locked(self, tuples) -> list[RelationTuple]:
        return [t for t in tuples if self._tuples.pop(t, None) is not None]

    # -- Manager contract -----------------------------------------------------

    def get_relation_tuples(
        self, query: RelationQuery, pagination: PaginationOptions | None = None
    ) -> tuple[list[RelationTuple], str]:
        pagination = pagination or PaginationOptions()
        offset = decode_page_token(pagination.token)
        per_page = pagination.per_page
        if self.namespace_manager is not None and query.namespace is not None:
            self.namespace_manager.get_namespace_by_name(query.namespace)
        with self._lock:
            matched = [t for t in self._tuples if query.matches(t)]
        page = matched[offset : offset + per_page]
        next_token = (
            encode_page_token(offset + per_page)
            if offset + per_page < len(matched)
            else ""
        )
        return page, next_token

    def write_relation_tuples(self, *tuples: RelationTuple) -> None:
        self.transact_relation_tuples(tuples, ())

    def delete_relation_tuples(self, *tuples: RelationTuple) -> None:
        self.transact_relation_tuples((), tuples)

    def delete_all_relation_tuples(self, query: RelationQuery) -> None:
        with self._lock:
            gone = self._delete_locked(
                [t for t in self._tuples if query.matches(t)]
            )
            v = self._bump()
            self._enqueue_notification(v, deleted=gone)
        self._drain_notifications(upto=v)

    def transact_relation_tuples(
        self,
        insert: Sequence[RelationTuple],
        delete: Sequence[RelationTuple],
    ) -> None:
        """Atomic insert+delete: a validation failure rejects the whole
        batch before anything is applied."""
        for t in insert:
            self._validate(t)
        with self._lock:
            fresh = self._insert_locked(insert)
            gone = self._delete_locked(delete)
            v = self._bump()
            self._enqueue_notification(v, inserted=fresh, deleted=gone)
        self._drain_notifications(upto=v)

    # -- replication ----------------------------------------------------------

    def apply_replicated_delta(
        self,
        version: int,
        inserted: Sequence[RelationTuple],
        deleted: Sequence[RelationTuple],
    ) -> bool:
        """Apply one leader-shipped delta at the leader's version number.
        Unlike boot-time WAL replay, this runs while the store is live on a
        follower, so it goes through the ordered notifier: the snapshot
        layer and the write overlay see it as they would a local write.
        Validation is skipped (the delta passed it on the leader). False,
        a no-op, for a version at or below the current one: replay after a
        reconnect may resend the overlap."""
        with self._lock:
            if version <= self._version:
                return False
            fresh = self._insert_locked(inserted)
            gone = self._delete_locked(deleted)
            self._version = version
            self._enqueue_notification(version, inserted=fresh, deleted=gone)
        self._drain_notifications(upto=version)
        return True

    # -- snapshot support -----------------------------------------------------

    def all_tuples(self) -> list[RelationTuple]:
        with self._lock:
            return list(self._tuples)

    def snapshot(self) -> tuple[list[RelationTuple], int]:
        """Consistent (tuples, version) pair for the encoder."""
        with self._lock:
            return list(self._tuples), self._version

    def __len__(self) -> int:
        with self._lock:
            return len(self._tuples)
