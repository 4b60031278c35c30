"""Dialect-neutral SQL tuple store: the Manager contract on any DB-API
driver (counterpart of ``keto_tpu/persistence/sqlstore.py``; the
reference's internal/persistence/sql persister).

One ``keto_relation_tuples`` table, network-id (nid) scoping on every
query, the subject split across NULL-disjoint columns, offset page tokens,
one transaction per call, uuid shard ids. Rows keep insertion order through
``seq``, so pagination is totally ordered.

Everything engine-specific comes from a ``persistence.dialect.SQLDialect``;
``SQLiteTupleStore`` (sqlite.py) and ``PostgresTupleStore`` (postgres.py)
are thin bindings of this class.

It exposes the same version/delta feed as the in-memory store, so the
snapshot layer sits on any backend unchanged; the write counter is durable
(``keto_store_version``), so snaptokens survive restarts. The store is not
process-private (``process_private = False``): the database is the shared
state, so the registry scales its read plane out by spawning fresh workers
(``driver/spawn_workers.py``), never by forking.
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from contextlib import contextmanager
from typing import Optional, Sequence

from ..namespace.definitions import NamespaceManager
from ..relationtuple.definitions import (
    Manager,
    RelationQuery,
    RelationTuple,
    SubjectID,
    SubjectSet,
)
from ..utils.errors import ErrInvalidTuple
from ..utils.pagination import (
    PaginationOptions,
    decode_page_token,
    encode_page_token,
)
from ..store.notify import OrderedNotifier
from .dialect import SQLDialect

_MIGRATIONS_DIR = os.path.join(os.path.dirname(__file__), "migrations", "sql")

_TUPLE_COLUMNS = (
    "namespace, object, relation, subject_id, "
    "subject_set_namespace, subject_set_object, subject_set_relation"
)


def _row_to_tuple(row) -> RelationTuple:
    (namespace, object_, relation, subject_id, sns, sobj, srel) = row
    if subject_id is not None:
        subject = SubjectID(id=subject_id)
    else:
        subject = SubjectSet(namespace=sns, object=sobj, relation=srel)
    return RelationTuple(
        namespace=namespace, object=object_, relation=relation, subject=subject
    )


def _rows_to_tuples(rows) -> list[RelationTuple]:
    """A bulk read's rows as tuples, each distinct subject built once and
    shared (a user or a group is the subject of many tuples; subjects are
    immutable)."""
    subjects: dict = {}
    out = []
    append = out.append
    for namespace, object_, relation, subject_id, sns, sobj, srel in rows:
        key = (subject_id, sns, sobj, srel)
        subject = subjects.get(key)
        if subject is None:
            subject = subjects[key] = (
                SubjectID(subject_id)
                if subject_id is not None
                else SubjectSet(sns, sobj, srel)
            )
        append(RelationTuple(namespace, object_, relation, subject))
    return out


_UUID_VARIANT = {c: "89ab"[int(c, 16) & 3] for c in "0123456789abcdef"}


def _shard_ids(n: int) -> list[str]:
    """``n`` random version-4 UUID strings, as ``str(uuid.uuid4())`` spells
    them, from one ``os.urandom`` call: a bulk write needs one per row, and
    ``uuid4`` costs several microseconds each."""
    h = os.urandom(16 * n).hex()
    return [
        f"{h[i:i + 8]}-{h[i + 8:i + 12]}-4{h[i + 13:i + 16]}-"
        f"{_UUID_VARIANT[h[i + 16]]}{h[i + 17:i + 20]}-{h[i + 20:i + 32]}"
        for i in range(0, 32 * n, 32)
    ]


def _subject_columns(t: RelationTuple):
    if isinstance(t.subject, SubjectID):
        return (t.subject.id, None, None, None)
    return (None, t.subject.namespace, t.subject.object, t.subject.relation)


class SQLTupleStore(OrderedNotifier, Manager):
    # NOT fork-shareable: replicas re-applying deltas over fork-inherited
    # connections would double-commit against the shared database
    process_private = False

    def __init__(
        self,
        dialect: SQLDialect,
        dsn: str,
        namespace_manager: Optional[NamespaceManager] = None,
        network_id: Optional[str] = None,
        auto_migrate: bool = True,
    ):
        self.dialect = dialect
        self.dsn = dsn
        self.namespace_manager = namespace_manager
        self._lock = threading.RLock()
        self._conn = dialect.connect(dsn)
        from .migrator import Migrator

        self.migrator = Migrator(
            self._conn, _MIGRATIONS_DIR, dialect=dialect
        )
        if auto_migrate:
            self.migrator.up()
        if network_id is not None:
            self.network_id = network_id
        else:
            self.network_id = self._determine_network()
        # the insert statement, built once (a bulk write runs it per row)
        self._insert_sql = dialect.sql(
            dialect.insert_ignore("keto_relation_tuples", self._INSERT_COLUMNS)
        )
        self._init_notify()

    # -- low-level helpers -----------------------------------------------------

    def _exec(self, sql: str, params: Sequence = ()):
        """Cursor-based execute with dialect placeholder rewriting (sqlite3
        allows conn.execute, generic DB-API drivers do not)."""
        cur = self._conn.cursor()
        cur.execute(self.dialect.sql(sql), tuple(params))
        return cur

    @contextmanager
    def _txn(self):
        """One transaction over the held connection (DB-API commit model:
        the driver opens the transaction implicitly on first statement)."""
        try:
            yield
            self._conn.commit()
        except BaseException:
            self._conn.rollback()
            raise

    def _determine_network(self) -> str:
        """Adopt the database's oldest network, creating one on a fresh
        database — a restarted server keeps seeing its own rows (reference
        determineNetwork, registry_default.go:207-225)."""
        try:
            row = self._exec(
                "SELECT id FROM keto_networks ORDER BY created_at LIMIT 1"
            ).fetchone()
        except Exception:
            # migrations not applied yet (auto_migrate=False): ephemeral id;
            # re-determined once the operator migrates and reopens
            self._conn.rollback()
            return str(uuid.uuid4())
        if row is not None:
            self._conn.rollback()  # release the read snapshot
            return row[0]
        with self._txn():
            self._exec(
                "INSERT INTO keto_networks (id, created_at) VALUES (?, ?)",
                (nid := str(uuid.uuid4()), time.time()),
            )
        return nid

    # -- version / change feed (same surface as InMemoryTupleStore) -----------

    @property
    def version(self) -> int:
        with self._lock:
            row = self._exec(
                "SELECT version FROM keto_store_version WHERE nid = ?",
                (self.network_id,),
            ).fetchone()
            self._conn.rollback()  # read-only: release the snapshot
            return row[0] if row else 0

    # subscribe/subscribe_deltas/unsubscribe_deltas come from
    # OrderedNotifier: deltas enqueue under the write lock, deliver in
    # strict version order.

    def _bump_locked(self) -> int:
        return self.dialect.bump_version(self._exec, self.network_id)

    # -- validation ------------------------------------------------------------

    def _validate(self, t: RelationTuple) -> None:
        if t.subject is None:
            raise ErrInvalidTuple("subject must not be nil")
        if self.namespace_manager is not None:
            self.namespace_manager.get_namespace_by_name(t.namespace)

    # -- query building --------------------------------------------------------

    def _where(self, query: RelationQuery):
        clauses = ["nid = ?"]
        params: list = [self.network_id]
        if query.namespace is not None:
            clauses.append("namespace = ?")
            params.append(query.namespace)
        if query.object is not None:
            clauses.append("object = ?")
            params.append(query.object)
        if query.relation is not None:
            clauses.append("relation = ?")
            params.append(query.relation)
        if query.subject is not None:
            sid, sns, sobj, srel = _subject_columns(
                RelationTuple("", "", "", query.subject)
            )
            if sid is not None:
                clauses.append("subject_id = ?")
                params.append(sid)
            else:
                clauses.append(
                    "subject_set_namespace = ? AND subject_set_object = ? "
                    "AND subject_set_relation = ?"
                )
                params.extend([sns, sobj, srel])
        return " AND ".join(clauses), params

    # -- Manager contract ------------------------------------------------------

    def get_relation_tuples(
        self, query: RelationQuery, pagination: PaginationOptions | None = None
    ) -> tuple[list[RelationTuple], str]:
        pagination = pagination or PaginationOptions()
        offset = decode_page_token(pagination.token)
        per_page = pagination.per_page
        if self.namespace_manager is not None and query.namespace is not None:
            self.namespace_manager.get_namespace_by_name(query.namespace)
        where, params = self._where(query)
        with self._lock:
            rows = self._exec(
                f"SELECT {_TUPLE_COLUMNS} "
                f"FROM keto_relation_tuples WHERE {where} "
                "ORDER BY seq LIMIT ? OFFSET ?",
                params + [per_page + 1, offset],
            ).fetchall()
            self._conn.rollback()
        has_more = len(rows) > per_page
        page = [_row_to_tuple(r) for r in rows[:per_page]]
        next_token = encode_page_token(offset + per_page) if has_more else ""
        return page, next_token

    _INSERT_COLUMNS = (
        "shard_id",
        "nid",
        "namespace",
        "object",
        "relation",
        "subject_id",
        "subject_set_namespace",
        "subject_set_object",
        "subject_set_relation",
        "commit_time",
    )

    def _insert_locked(self, t: RelationTuple, cur=None, shard_id=None) -> bool:
        """Insert one row unless it exists; True when it was fresh. A caller
        inserting many rows passes one cursor and their shard ids."""
        sid, sns, sobj, srel = _subject_columns(t)
        cur = cur if cur is not None else self._conn.cursor()
        cur.execute(
            self._insert_sql,
            (
                shard_id or str(uuid.uuid4()),
                self.network_id,
                t.namespace,
                t.object,
                t.relation,
                sid,
                sns,
                sobj,
                srel,
                time.time(),
            ),
        )
        return cur.rowcount > 0

    def _delete_locked(self, t: RelationTuple) -> bool:
        where, params = self._where(t.to_query())
        cur = self._exec(
            f"DELETE FROM keto_relation_tuples WHERE {where}", params
        )
        return cur.rowcount > 0

    def write_relation_tuples(self, *tuples: RelationTuple) -> None:
        for t in tuples:
            self._validate(t)
        with self._lock:
            with self._txn():
                cur = self._conn.cursor()
                fresh = [
                    t
                    for t, shard in zip(tuples, _shard_ids(len(tuples)))
                    if self._insert_locked(t, cur, shard)
                ]
                v = self._bump_locked()
            # enqueue only AFTER commit (still under the lock, preserving
            # version order): a rolled-back write must never surface a
            # phantom delta to replicas/overlays
            self._enqueue_notification(v, inserted=fresh)
        self._drain_notifications(upto=v)

    def delete_relation_tuples(self, *tuples: RelationTuple) -> None:
        with self._lock:
            with self._txn():
                gone = [t for t in tuples if self._delete_locked(t)]
                v = self._bump_locked()
            self._enqueue_notification(v, deleted=gone)
        self._drain_notifications(upto=v)

    def delete_all_relation_tuples(self, query: RelationQuery) -> None:
        where, params = self._where(query)
        with self._lock:
            with self._txn():
                rows = self._exec(
                    f"SELECT {_TUPLE_COLUMNS} "
                    f"FROM keto_relation_tuples WHERE {where} ORDER BY seq",
                    params,
                ).fetchall()
                self._exec(
                    f"DELETE FROM keto_relation_tuples WHERE {where}", params
                )
                v = self._bump_locked()
            self._enqueue_notification(
                v, deleted=[_row_to_tuple(r) for r in rows]
            )
        self._drain_notifications(upto=v)

    def transact_relation_tuples(
        self,
        insert: Sequence[RelationTuple],
        delete: Sequence[RelationTuple],
    ) -> None:
        for t in insert:
            self._validate(t)
        with self._lock:
            with self._txn():
                fresh = [t for t in insert if self._insert_locked(t)]
                gone = [t for t in delete if self._delete_locked(t)]
                v = self._bump_locked()
            self._enqueue_notification(v, inserted=fresh, deleted=gone)
        self._drain_notifications(upto=v)

    # -- snapshot support ------------------------------------------------------

    def all_tuples(self) -> list[RelationTuple]:
        with self._lock:
            rows = self._exec(
                f"SELECT {_TUPLE_COLUMNS} "
                "FROM keto_relation_tuples WHERE nid = ? ORDER BY seq",
                (self.network_id,),
            ).fetchall()
            self._conn.rollback()
        return _rows_to_tuples(rows)

    def snapshot(self) -> tuple[list[RelationTuple], int]:
        with self._lock:
            return self.all_tuples(), self.version

    def __len__(self) -> int:
        with self._lock:
            n = self._exec(
                "SELECT COUNT(*) FROM keto_relation_tuples WHERE nid = ?",
                (self.network_id,),
            ).fetchone()[0]
            self._conn.rollback()
            return n

    def close(self) -> None:
        with self._lock:
            self._conn.close()
