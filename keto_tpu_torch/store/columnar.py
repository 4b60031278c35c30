"""Columnar relation-tuple store (counterpart of ``keto_tpu/store/columnar.py``).

Keeps tuples as interned int32 numpy columns instead of Python objects:

    ns | obj | rel | sub_is_set | sub_ns | sub_obj | sub_rel | sub_id

plus the graph-node encoding the snapshot layer needs (``src_node`` /
``dst_node`` against a shared NodeVocab, maintained at write time). That
makes ``snapshot_ids()`` a column slice: SnapshotManager feeds the encoder
without materializing tuple objects, which is what lets a million-tuple
store load in seconds (``bulk_load_edges``).

Implements the same Manager surface as the in-memory store. Deletes
tombstone a row. Duplicate writes are idempotent. The NodeVocab is
append-only (deleted nodes keep their ids — snapshots handle orphans).
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

import numpy as np

from ..graph.vocab import NodeVocab, bulk_intern, set_key, subject_node_key
from ..namespace.definitions import NamespaceManager
from ..relationtuple.definitions import (
    Manager,
    RelationQuery,
    RelationTuple,
    Subject,
    SubjectID,
    SubjectSet,
)
from ..utils.errors import ErrInvalidTuple
from ..utils.pagination import (
    PaginationOptions,
    decode_page_token,
    encode_page_token,
)
from .notify import OrderedNotifier

_GROW = 1.5  # column growth factor


class _StringPool:
    """Append-only str <-> int32 interning."""

    def __init__(self) -> None:
        self._id_of: dict[str, int] = {}
        self._strings: list[str] = []

    def intern(self, s: str) -> int:
        i = self._id_of.get(s)
        if i is None:
            i = len(self._strings)
            self._id_of[s] = i
            self._strings.append(s)
        return i

    def intern_bulk(self, strings: Sequence[str]) -> np.ndarray:
        return bulk_intern(self._id_of, self._strings, strings)

    def lookup(self, s: str) -> Optional[int]:
        return self._id_of.get(s)

    def value(self, i: int) -> str:
        return self._strings[i]


class ColumnarTupleStore(OrderedNotifier, Manager):
    # the replica pool may fork this store: its state is process memory
    # (a SQL store's is the database, and it is spawned instead)
    process_private = True

    def __init__(
        self,
        namespace_manager: NamespaceManager | None = None,
    ):
        self._lock = threading.RLock()
        self.namespace_manager = namespace_manager
        self.vocab = NodeVocab()  # shared with the snapshot layer
        self._ns = _StringPool()
        self._obj = _StringPool()
        self._rel = _StringPool()
        self._sid = _StringPool()
        self._n = 0  # rows in use (including tombstones)
        self._live = 0  # rows alive
        cap = 1024
        self._cols = {
            "ns": np.empty(cap, np.int32),
            "obj": np.empty(cap, np.int32),
            "rel": np.empty(cap, np.int32),
            "sub_is_set": np.empty(cap, bool),
            "sub_ns": np.empty(cap, np.int32),
            "sub_obj": np.empty(cap, np.int32),
            "sub_rel": np.empty(cap, np.int32),
            "sub_id": np.empty(cap, np.int32),
            "src_node": np.empty(cap, np.int32),
            "dst_node": np.empty(cap, np.int32),
            "alive": np.empty(cap, bool),
        }
        # Row lookup for dedup/delete, two tiers that together cover every
        # live row without a dict entry per bulk-loaded row:
        # - _row_of: overlay dict for rows added by point writes;
        # - _key_chunks: per-bulk-load (sorted keys, rows in key order)
        #   pairs, binary-searched by point lookups.
        # A key found in either tier still checks the alive column.
        self._row_of: dict[int, int] = {}
        self._key_chunks: list[tuple[np.ndarray, np.ndarray]] = []
        # node id -> string-pool ids, extended lazily as the vocab grows;
        # -1 marks "not applicable". Bulk loads leave the per-row string
        # columns unfilled until a query or decode needs them.
        self._node_cols_len = 0
        self._node_ns = np.empty(0, np.int32)
        self._node_obj = np.empty(0, np.int32)
        self._node_rel = np.empty(0, np.int32)
        self._node_sid = np.empty(0, np.int32)
        self._derived_len = 0  # rows [0, _derived_len) have string columns
        self._version = 0
        self._init_notify()

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    # -- internals ------------------------------------------------------------

    def _ensure_capacity(self, extra: int) -> None:
        need = self._n + extra
        cap = len(self._cols["ns"])
        if need <= cap:
            return
        new_cap = max(need, int(cap * _GROW))
        for k, a in self._cols.items():
            grown = np.empty(new_cap, a.dtype)
            grown[: self._n] = a[: self._n]
            self._cols[k] = grown

    def _validate(self, t: RelationTuple) -> None:
        if t.subject is None:
            raise ErrInvalidTuple("subject must not be nil")
        if self.namespace_manager is not None:
            self.namespace_manager.get_namespace_by_name(t.namespace)

    def _encode_row(self, t: RelationTuple, row: int) -> tuple[int, int]:
        c = self._cols
        c["ns"][row] = self._ns.intern(t.namespace)
        c["obj"][row] = self._obj.intern(t.object)
        c["rel"][row] = self._rel.intern(t.relation)
        s = t.subject
        src = self.vocab.intern(set_key(t.namespace, t.object, t.relation))
        dst = self.vocab.intern(subject_node_key(s))
        c["src_node"][row] = src
        c["dst_node"][row] = dst
        if isinstance(s, SubjectSet):
            c["sub_is_set"][row] = True
            c["sub_ns"][row] = self._ns.intern(s.namespace)
            c["sub_obj"][row] = self._obj.intern(s.object)
            c["sub_rel"][row] = self._rel.intern(s.relation)
            c["sub_id"][row] = -1
        else:
            c["sub_is_set"][row] = False
            c["sub_ns"][row] = -1
            c["sub_obj"][row] = -1
            c["sub_rel"][row] = -1
            c["sub_id"][row] = self._sid.intern(s.id)
        c["alive"][row] = True
        return src, dst

    def _decode_row(self, row: int) -> RelationTuple:
        if row >= self._derived_len:
            self._ensure_derived()
        c = self._cols
        if c["sub_is_set"][row]:
            subject: Subject = SubjectSet(
                namespace=self._ns.value(int(c["sub_ns"][row])),
                object=self._obj.value(int(c["sub_obj"][row])),
                relation=self._rel.value(int(c["sub_rel"][row])),
            )
        else:
            subject = SubjectID(id=self._sid.value(int(c["sub_id"][row])))
        return RelationTuple(
            namespace=self._ns.value(int(c["ns"][row])),
            object=self._obj.value(int(c["obj"][row])),
            relation=self._rel.value(int(c["rel"][row])),
            subject=subject,
        )

    def _row_for_key(self, key: int) -> Optional[int]:
        """Row currently holding `key` (alive or tombstoned), or None. Rows
        are append-ordered in time, so the current owner is the maximum row
        across the overlay dict and every bulk chunk."""
        best = self._row_of.get(key, -1)
        for chunk_keys, chunk_rows in self._key_chunks:
            pos = int(np.searchsorted(chunk_keys, key))
            if pos < len(chunk_keys) and chunk_keys[pos] == key:
                best = max(best, int(chunk_rows[pos]))
        return None if best < 0 else best

    def _alive_row_for_key(self, key: int) -> Optional[int]:
        row = self._row_for_key(key)
        if row is not None and self._cols["alive"][row]:
            return row
        return None

    def _bulk_existing(self, keys: np.ndarray) -> np.ndarray:
        """bool[n]: key currently LIVE?"""
        n = len(keys)
        rows = np.full(n, -1, dtype=np.int64)
        if self._row_of:
            got = list(map(self._row_of.get, keys.tolist()))
            rows = np.array(
                [r if r is not None else -1 for r in got], dtype=np.int64
            )
        for chunk_keys, chunk_rows in self._key_chunks:
            pos = np.searchsorted(chunk_keys, keys)
            in_range = pos < len(chunk_keys)
            hit = np.zeros(n, dtype=bool)
            hit[in_range] = chunk_keys[pos[in_range]] == keys[in_range]
            cand = np.where(
                hit, chunk_rows[np.minimum(pos, len(chunk_rows) - 1)], -1
            )
            rows = np.maximum(rows, cand)
        mask = rows >= 0
        mask[mask] = self._cols["alive"][rows[mask]]
        return mask

    def _compact_chunks(self) -> None:
        """Merge the 16 smallest chunks once there are more than 32, keeping
        only the HIGHEST row of a duplicate key (the current owner)."""
        if len(self._key_chunks) <= 32:
            return
        self._key_chunks.sort(key=lambda c: len(c[0]), reverse=True)
        small = [self._key_chunks.pop() for _ in range(16)]
        keys = np.concatenate([c[0] for c in small])
        rows = np.concatenate([c[1] for c in small])
        order = np.lexsort((rows, keys))
        keys = keys[order]
        rows = rows[order]
        last = np.append(keys[1:] != keys[:-1], True)
        self._key_chunks.append((keys[last], rows[last]))

    def _ensure_derived(self) -> None:
        """Materialize the per-row string-pool columns bulk loads defer."""
        n = self._n
        if self._derived_len >= n:
            return
        self._extend_node_cols()
        sl = slice(self._derived_len, n)
        c = self._cols
        src_ids = c["src_node"][sl]
        dst_ids = c["dst_node"][sl]
        c["ns"][sl] = self._node_ns[src_ids]
        c["obj"][sl] = self._node_obj[src_ids]
        c["rel"][sl] = self._node_rel[src_ids]
        c["sub_is_set"][sl] = self._node_sid[dst_ids] < 0
        c["sub_ns"][sl] = self._node_ns[dst_ids]
        c["sub_obj"][sl] = self._node_obj[dst_ids]
        c["sub_rel"][sl] = self._node_rel[dst_ids]
        c["sub_id"][sl] = self._node_sid[dst_ids]
        self._derived_len = n

    def _insert_locked(self, t: RelationTuple) -> Optional[RelationTuple]:
        """Insert one tuple; returns it when fresh, None when duplicate."""
        self._ensure_capacity(1)
        row = self._n
        src, dst = self._encode_row(t, row)
        key = (src << 32) | dst
        if self._alive_row_for_key(key) is not None:
            return None  # idempotent duplicate
        self._row_of[key] = row
        self._n += 1
        self._live += 1
        if self._derived_len == row:
            self._derived_len = row + 1  # _encode_row filled this row
        return t

    def _delete_locked(self, t: RelationTuple) -> Optional[RelationTuple]:
        src = self.vocab.lookup(set_key(t.namespace, t.object, t.relation))
        dst = self.vocab.lookup(subject_node_key(t.subject))
        if src is None or dst is None:
            return None
        key = (src << 32) | dst
        row = self._alive_row_for_key(key)
        if row is None:
            return None
        self._cols["alive"][row] = False
        self._live -= 1
        self._row_of.pop(key, None)  # chunk entries tombstone via `alive`
        return t

    def _query_mask(self, query: RelationQuery) -> np.ndarray:
        """bool[n] over rows [0, n): alive and matching the partial filter."""
        c = self._cols
        n = self._n
        mask = c["alive"][:n].copy()
        if (
            query.namespace is not None
            or query.object is not None
            or query.relation is not None
        ):
            self._ensure_derived()
        for field, pool in (
            ("namespace", self._ns),
            ("object", self._obj),
            ("relation", self._rel),
        ):
            value = getattr(query, field)
            if value is None:
                continue
            col = {"namespace": "ns", "object": "obj", "relation": "rel"}[field]
            i = pool.lookup(value)
            mask &= c[col][:n] == i if i is not None else np.zeros(n, bool)
        if query.subject is not None:
            dst = self.vocab.lookup(subject_node_key(query.subject))
            mask &= (
                c["dst_node"][:n] == dst if dst is not None else np.zeros(n, bool)
            )
        return mask

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
            rows = np.nonzero(self._query_mask(query))[0]
            page_rows = rows[offset : offset + per_page]
            page = [self._decode_row(int(r)) for r in page_rows]
            total = len(rows)
        next_token = (
            encode_page_token(offset + per_page)
            if offset + per_page < total
            else ""
        )
        return page, next_token

    def write_relation_tuples(self, *tuples: RelationTuple) -> None:
        self.transact_relation_tuples(tuples, ())

    def delete_relation_tuples(self, *tuples: RelationTuple) -> None:
        self.transact_relation_tuples((), tuples)

    def delete_all_relation_tuples(self, query: RelationQuery) -> None:
        with self._lock:
            rows = np.nonzero(self._query_mask(query))[0]
            gone = [self._decode_row(int(r)) for r in rows]
            self._cols["alive"][rows] = False
            self._live -= len(rows)
            c = self._cols
            for r in rows:
                key = (int(c["src_node"][r]) << 32) | int(c["dst_node"][r])
                self._row_of.pop(key, None)
            self._version += 1
            v = self._version
            self._enqueue_notification(v, deleted=gone)
        self._drain_notifications(upto=v)

    def transact_relation_tuples(
        self,
        insert: Sequence[RelationTuple],
        delete: Sequence[RelationTuple],
    ) -> None:
        for t in insert:
            self._validate(t)
        with self._lock:
            fresh = [
                f for t in insert if (f := self._insert_locked(t)) is not None
            ]
            gone = [
                g for t in delete if (g := self._delete_locked(t)) is not None
            ]
            self._version += 1
            v = self._version
            self._enqueue_notification(v, inserted=fresh, deleted=gone)
        self._drain_notifications(upto=v)

    # -- replication ----------------------------------------------------------

    def apply_replicated_delta(
        self,
        version: int,
        inserted: Sequence[RelationTuple],
        deleted: Sequence[RelationTuple],
    ) -> bool:
        """Apply one leader-shipped delta at the leader's version number,
        through the ordered notifier (the follower's snapshot layer and
        write overlay subscribe as to any local write). Validation is
        skipped: the delta passed it on the leader. No-op (False) for a
        version at or below the current one."""
        with self._lock:
            if version <= self._version:
                return False
            fresh = [f for t in inserted if (f := self._insert_locked(t)) is not None]
            gone = [g for t in deleted if (g := self._delete_locked(t)) is not None]
            self._version = version
            self._enqueue_notification(version, inserted=fresh, deleted=gone)
        self._drain_notifications(upto=version)
        return True

    # -- bulk + snapshot support ----------------------------------------------

    def _extend_node_cols(self) -> None:
        """Extend the node-id -> pool-id arrays to cover every interned
        vocab key (one pass over NEW keys only)."""
        n = len(self.vocab)
        m = n - self._node_cols_len
        if m <= 0:
            return
        new_keys = self.vocab.keys()[self._node_cols_len : n]
        is_set = np.fromiter(
            (len(k) == 3 for k in new_keys), dtype=bool, count=m
        )
        ns = np.full(m, -1, np.int32)
        ob = np.full(m, -1, np.int32)
        rl = np.full(m, -1, np.int32)
        sid = np.full(m, -1, np.int32)
        set_keys = [k for k in new_keys if len(k) == 3]
        id_keys = [k for k in new_keys if len(k) != 3]
        if set_keys:
            ns[is_set] = self._ns.intern_bulk([k[0] for k in set_keys])
            ob[is_set] = self._obj.intern_bulk([k[1] for k in set_keys])
            rl[is_set] = self._rel.intern_bulk([k[2] for k in set_keys])
        if id_keys:
            sid[~is_set] = self._sid.intern_bulk([k[0] for k in id_keys])
        self._node_ns = np.concatenate([self._node_ns, ns])
        self._node_obj = np.concatenate([self._node_obj, ob])
        self._node_rel = np.concatenate([self._node_rel, rl])
        self._node_sid = np.concatenate([self._node_sid, sid])
        self._node_cols_len = n

    def bulk_load_edges(self, src_keys: Sequence, dst_keys: Sequence) -> None:
        """Bulk ingest pre-built node keys: src_keys are (ns, obj, rel)
        triples, dst_keys are (id,) or (ns, obj, rel). Skips per-tuple
        namespace validation (trusted input, e.g. a generator) but keeps
        write idempotence: duplicates within the input and against existing
        rows are dropped. All passes are dict/numpy operations."""
        if len(src_keys) == 0:
            return
        with self._lock:
            src_all = self.vocab.intern_bulk(src_keys)
            dst_all = self.vocab.intern_bulk(dst_keys)
            keys_all = (src_all.astype(np.int64) << 32) | dst_all.astype(
                np.int64
            )
            _, first = np.unique(keys_all, return_index=True)
            first.sort()
            existing = self._bulk_existing(keys_all[first])
            take = first[~existing]
            n_new = len(take)
            if n_new:
                self._ensure_capacity(n_new)
                n0 = self._n
                sl = slice(n0, n0 + n_new)
                c = self._cols
                # only the graph columns are written here; the per-row
                # string columns materialize lazily (_ensure_derived)
                c["src_node"][sl] = src_all[take]
                c["dst_node"][sl] = dst_all[take]
                c["alive"][sl] = True
                new_keys = keys_all[take]
                order = np.argsort(new_keys)
                self._key_chunks.append(
                    (new_keys[order], (n0 + order).astype(np.int64))
                )
                self._compact_chunks()
                self._n += n_new
                self._live += n_new
            self._version += 1
            v = self._version
        # bulk: no per-tuple delta; None signals "unknown change, rebuild"
        for fn in list(self._delta_listeners):
            fn(v, None, None)

    def snapshot_ids(self) -> tuple[np.ndarray, np.ndarray, NodeVocab, int]:
        """(src_node, dst_node, vocab, version) — the zero-object path for
        SnapshotManager / SnapshotBuilder.build_from_ids."""
        with self._lock:
            n = self._n
            alive = self._cols["alive"][:n]
            src = self._cols["src_node"][:n][alive].copy()
            dst = self._cols["dst_node"][:n][alive].copy()
            return src, dst, self.vocab, self._version

    def all_tuples(self) -> list[RelationTuple]:
        with self._lock:
            rows = np.nonzero(self._cols["alive"][: self._n])[0]
            return [self._decode_row(int(r)) for r in rows]

    def snapshot(self) -> tuple[list[RelationTuple], int]:
        with self._lock:
            return self.all_tuples(), self._version

    def __len__(self) -> int:
        with self._lock:
            return self._live
