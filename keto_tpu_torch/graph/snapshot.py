"""Graph snapshots: the tuple store encoded as padded COO arrays
(counterpart of ``keto_tpu/graph/snapshot.py``).

A snapshot is an immutable value:

- ``src``/``dst``: int32 COO edge list, one edge per relation tuple,
  ``intern(ns,obj,rel) -> intern(subject)``. Padding edges point
  dummy->dummy.
- ``padded_nodes``/``padded_edges`` are bucketed to powers of two, with the
  same buckets as ``keto_tpu`` so the two packages' arrays compare equal.
- ``version`` is the store's monotonic write counter (the snaptoken).

Inserts that arrive in version order and fit spare capacity are appended
to the previous snapshot (the closure engine's incremental path relies on
the unchanged prefix); anything else rebuilds on the next read.

The forward CSR (``csr``/``out_neighbors``, successors in insertion order)
is derived lazily for Expand and the list path. An append carries the
derived CSR forward with the appended successors beside it, so an Expand
after a write does not re-sort every edge.
"""

from __future__ import annotations

import dataclasses
import threading
import weakref
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from ..relationtuple.definitions import RelationTuple, Subject
from .vocab import NodeVocab, set_key, subject_node_key

_MIN_NODES = 1024
_MIN_EDGES = 1024


def _bucket(n: int, minimum: int) -> int:
    """Next power of two >= max(n, minimum)."""
    n = max(n, minimum)
    return 1 << (n - 1).bit_length()


@dataclass
class GraphSnapshot:
    """Immutable encoded graph at one store version."""

    vocab: NodeVocab
    src: np.ndarray  # int32[padded_edges]
    dst: np.ndarray  # int32[padded_edges]
    num_nodes: int  # live interned nodes
    num_edges: int  # live edges (edges [0, num_edges) are real)
    padded_nodes: int  # dummy node = padded_nodes - 1
    padded_edges: int
    version: int  # store version at encode time == snaptoken
    _csr: Optional[tuple[np.ndarray, np.ndarray]] = field(
        default=None, repr=False, compare=False
    )
    # edges covered by _csr: deriving sets it to num_edges; an append
    # carries the previous CSR forward with a smaller coverage and the
    # appended successors in _csr_extra (node id -> [successor ids])
    _csr_edges: int = field(default=0, repr=False, compare=False)
    _csr_extra: Optional[dict] = field(default=None, repr=False, compare=False)

    @property
    def dummy_node(self) -> int:
        return self.padded_nodes - 1

    def node_for_subject(self, subject: Subject) -> int:
        """Node id, or the dummy node when the subject is unknown to this
        snapshot (unknown subjects check to False)."""
        nid = self.vocab.lookup(subject_node_key(subject))
        if nid is None or nid >= self.padded_nodes:
            return self.dummy_node
        return nid

    def node_for_set(self, namespace: str, object: str, relation: str) -> int:
        nid = self.vocab.lookup(set_key(namespace, object, relation))
        if nid is None or nid >= self.padded_nodes:
            return self.dummy_node
        return nid

    def encode_requests(
        self,
        requests: Sequence[RelationTuple],
        out_start: Optional[np.ndarray] = None,
        out_target: Optional[np.ndarray] = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Bulk vocab-encode: requests -> (start, target) node ids, unknown
        or beyond-this-snapshot ids clamped to the inert dummy node: one hash
        pass and one vectorized index probe (``NodeVocab.lookup_requests``,
        in C where the native tier loads). When
        `out_start`/`out_target` are given, rows [0, n) are written in place
        (persistent staging buffers) and the same arrays are returned."""
        n = len(requests)
        s_ids, t_ids, _ = self.vocab.lookup_requests(requests)
        pn = self.padded_nodes
        dummy = self.dummy_node
        s = np.where((s_ids < 0) | (s_ids >= pn), dummy, s_ids)
        t = np.where((t_ids < 0) | (t_ids >= pn), dummy, t_ids)
        if out_start is None or out_target is None:
            return s.astype(np.int32), t.astype(np.int32)
        out_start[:n] = s
        out_target[:n] = t
        return out_start, out_target

    def encode_requests_columnar(
        self,
        cols,
        out_start: Optional[np.ndarray] = None,
        out_target: Optional[np.ndarray] = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Columnar twin of ``encode_requests``: a ``CheckColumns`` batch
        goes straight from its parallel string lists to vocab ids (the key
        tuples feeding ``lookup_bulk`` are zipped from the columns, never
        built through ``RelationTuple``/``Subject`` objects). Same clamp and
        staging-buffer contract as ``encode_requests``."""
        n = len(cols)
        s_ids = self.vocab.lookup_bulk(cols.start_keys())
        t_ids = self.vocab.lookup_bulk(cols.target_keys())
        pn = self.padded_nodes
        dummy = self.dummy_node
        s = np.where((s_ids < 0) | (s_ids >= pn), dummy, s_ids)
        t = np.where((t_ids < 0) | (t_ids >= pn), dummy, t_ids)
        if out_start is None or out_target is None:
            return s.astype(np.int32), t.astype(np.int32)
        out_start[:n] = s
        out_target[:n] = t
        return out_start, out_target

    def csr(self) -> tuple[np.ndarray, np.ndarray]:
        """(indptr int32[padded_nodes+1], indices int32[padded_edges]) sorted
        by source (stable: insertion order within a source) over all live
        edges; derived on demand and cached. A carried partial CSR is
        replaced by a full derive here; out_neighbors() prefers the carried
        CSR plus the appended successors and never forces this."""
        if self._csr is None or self._csr_edges != self.num_edges:
            s = self.src[: self.num_edges]
            d = self.dst[: self.num_edges]
            order = np.argsort(s, kind="stable")
            counts = np.bincount(s, minlength=self.padded_nodes)
            indptr = np.zeros(self.padded_nodes + 1, dtype=np.int32)
            indptr[1:] = np.cumsum(counts).astype(np.int32)
            indices = np.full(self.padded_edges, self.dummy_node, dtype=np.int32)
            indices[: self.num_edges] = d[order]
            self._csr = (indptr, indices)
            self._csr_edges = self.num_edges
            self._csr_extra = None
        return self._csr

    def out_neighbors(self, nid: int) -> np.ndarray:
        """Successor node ids of `nid`, in insertion order."""
        if nid >= self.padded_nodes:
            return np.empty(0, dtype=np.int32)
        if (
            self._csr is not None
            and self._csr_edges < self.num_edges
            and self._csr_extra is not None
        ):
            # carried CSR + appended successors: no re-derive
            indptr, indices = self._csr
            base = indices[indptr[nid] : indptr[nid + 1]]
            extra = self._csr_extra.get(nid)
            if extra:
                return np.concatenate([base, np.asarray(extra, dtype=np.int32)])
            return base
        indptr, indices = self.csr()
        return indices[indptr[nid] : indptr[nid + 1]]


class SnapshotBuilder:
    """Full encode: tuples -> GraphSnapshot. The vocab may be carried over
    from a previous snapshot so node ids stay stable across rebuilds."""

    def __init__(
        self,
        vocab: Optional[NodeVocab] = None,
        min_nodes: int = _MIN_NODES,
        min_edges: int = _MIN_EDGES,
    ):
        self.vocab = vocab if vocab is not None else NodeVocab()
        self.min_nodes = min_nodes
        self.min_edges = min_edges

    def build(
        self, tuples: Sequence[RelationTuple], version: int
    ) -> GraphSnapshot:
        vocab = self.vocab
        src_ids = vocab.intern_bulk(
            [(t.namespace, t.object, t.relation) for t in tuples]
        )
        dst_ids = vocab.intern_bulk([subject_node_key(t.subject) for t in tuples])
        return self.build_from_ids(src_ids, dst_ids, version)

    def build_from_ids(
        self, src_ids: np.ndarray, dst_ids: np.ndarray, version: int
    ) -> GraphSnapshot:
        """Snapshot from already vocab-encoded edges (the columnar store's
        path, and the way another package's COO arrays load here)."""
        n = len(self.vocab)
        e = len(src_ids)
        padded_nodes = _bucket(n + 1, self.min_nodes)
        padded_edges = _bucket(e, self.min_edges)
        dummy = padded_nodes - 1
        src = np.full(padded_edges, dummy, dtype=np.int32)
        dst = np.full(padded_edges, dummy, dtype=np.int32)
        src[:e] = src_ids
        dst[:e] = dst_ids
        return GraphSnapshot(
            vocab=self.vocab,
            src=src,
            dst=dst,
            num_nodes=n,
            num_edges=e,
            padded_nodes=padded_nodes,
            padded_edges=padded_edges,
            version=version,
        )


class SnapshotManager:
    """Keeps a GraphSnapshot in sync with a tuple store through the store's
    delta feed (weakly subscribed: the store does not keep a dead manager
    alive)."""

    def __init__(
        self,
        store,
        min_nodes: int = _MIN_NODES,
        min_edges: int = _MIN_EDGES,
    ):
        self._store = store
        self._lock = threading.RLock()
        self.min_nodes = min_nodes
        self.min_edges = min_edges
        self._dirty = False
        self._snap: Optional[GraphSnapshot] = None
        self._snap = self._encode()
        self._delta_cb = None
        subscribe = getattr(store, "subscribe_deltas", None)
        if subscribe is not None:
            ref = weakref.ref(self)

            def _cb(version, inserted, deleted, _ref=ref, _store=store):
                mgr = _ref()
                if mgr is None:
                    _store.unsubscribe_deltas(_cb)
                    return
                mgr._on_delta(version, inserted, deleted)

            self._delta_cb = _cb
            subscribe(_cb)

    @property
    def store(self):
        """The write-side source of truth this manager mirrors."""
        return self._store

    def close(self) -> None:
        """Detach from the store's delta feed."""
        if self._delta_cb is not None:
            self._store.unsubscribe_deltas(self._delta_cb)
            self._delta_cb = None

    def snapshot(self) -> GraphSnapshot:
        """Current snapshot; rebuilds first if marked dirty or stale."""
        with self._lock:
            if self._dirty or self._snap.version != self._store.version:
                self._snap = self._encode()
                self._dirty = False
            return self._snap

    def _encode(self) -> GraphSnapshot:
        snapshot_ids = getattr(self._store, "snapshot_ids", None)
        if snapshot_ids is not None:
            # columnar store: pre-encoded edges against its own vocab
            src, dst, vocab, version = snapshot_ids()
            return SnapshotBuilder(
                vocab=vocab, min_nodes=self.min_nodes, min_edges=self.min_edges
            ).build_from_ids(src, dst, version)
        tuples, version = self._store.snapshot()
        # persistent vocab across rebuilds: node ids are append-only for
        # the life of the manager (deletes orphan their ids)
        prev = self._snap
        return SnapshotBuilder(
            vocab=prev.vocab if prev is not None else None,
            min_nodes=self.min_nodes,
            min_edges=self.min_edges,
        ).build(tuples, version)

    def _on_delta(
        self,
        version: int,
        inserted: Optional[Sequence[RelationTuple]],
        deleted: Optional[Sequence[RelationTuple]],
    ) -> None:
        with self._lock:
            snap = self._snap
            if inserted is None or deleted is None:
                self._dirty = True  # bulk change of unknown shape
                return
            if not self._dirty and version <= snap.version:
                return  # a snapshot() rebuild already read this version
            if self._dirty or version != snap.version + 1 or deleted:
                self._dirty = True
                return
            if not inserted:
                # version-only change (e.g. a duplicate write)
                self._snap = dataclasses.replace(snap, version=version)
                return
            vocab = snap.vocab  # append-only: ids stay valid
            e_new = snap.num_edges + len(inserted)
            src_ids = [
                vocab.intern((t.namespace, t.object, t.relation))
                for t in inserted
            ]
            dst_ids = [vocab.intern(subject_node_key(t.subject)) for t in inserted]
            n_new = len(vocab)
            if e_new > snap.padded_edges or n_new + 1 > snap.padded_nodes:
                self._dirty = True  # outgrew capacity: rebuild on next read
                return
            src = snap.src.copy()
            dst = snap.dst.copy()
            src[snap.num_edges : e_new] = src_ids
            dst[snap.num_edges : e_new] = dst_ids
            # carry a derived CSR forward with the appended successors;
            # past 4096 touched sources the carry is dropped and the next
            # reader re-derives
            csr = csr_extra = None
            csr_edges = 0
            if snap._csr is not None:
                prev_extra = snap._csr_extra
                if snap._csr_edges == snap.num_edges:
                    prev_extra = {}  # fully covered CSR: a fresh delta
                if prev_extra is not None and len(prev_extra) < 4096:
                    csr = snap._csr
                    csr_edges = min(snap._csr_edges, snap.num_edges)
                    csr_extra = {k: list(v) for k, v in prev_extra.items()}
                    for s_id, d_id in zip(src_ids, dst_ids):
                        csr_extra.setdefault(int(s_id), []).append(int(d_id))
            self._snap = GraphSnapshot(
                vocab=vocab,
                src=src,
                dst=dst,
                num_nodes=n_new,
                num_edges=e_new,
                padded_nodes=snap.padded_nodes,
                padded_edges=snap.padded_edges,
                version=version,
                _csr=csr,
                _csr_edges=csr_edges,
                _csr_extra=csr_extra,
            )
