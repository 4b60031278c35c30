"""Node vocabulary: subjects <-> dense int32 node ids (counterpart of
``keto_tpu/graph/vocab.py``).

Nodes of the permission graph are either subject-set vertices
``(namespace, object, relation)`` or subject-id vertices ``(id,)``. Both kinds
are interned into one id space, so a relation tuple ``ns:obj#rel@subject``
is the edge ``intern(ns,obj,rel) -> intern(subject)``. The vocabulary is
append-only: ids are stable across incremental snapshot updates, and the
same insertion order gives the same ids in both packages.
"""

from __future__ import annotations

import threading
from typing import Hashable, Iterable, Optional, Sequence

import numpy as np

from .. import native
from ..relationtuple.definitions import Subject, SubjectID, SubjectSet

# A 1-tuple cannot collide with a 3-tuple, so one dict serves both kinds.
NodeKey = Hashable


def set_key(namespace: str, object: str, relation: str) -> NodeKey:
    return (namespace, object, relation)


def id_key(subject_id: str) -> NodeKey:
    return (subject_id,)


def subject_node_key(subject: Subject) -> NodeKey:
    if isinstance(subject, SubjectID):
        return id_key(subject.id)
    return set_key(subject.namespace, subject.object, subject.relation)


def mix64(keys: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer, vectorized (uint64 wraparound is the point)."""
    with np.errstate(over="ignore"):
        x = keys.astype(np.uint64)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


def bulk_intern(id_of: dict, values: list, items) -> np.ndarray:
    """Append-only bulk intern into an (id_of dict, values list) pair in
    dict passes (no per-item Python loop): resolve via map(), dedupe new
    items with dict.fromkeys (insertion-ordered), assign their ids with one
    dict.update(zip(...))."""
    ids = list(map(id_of.get, items))
    if None in ids:
        seen = dict.fromkeys(items)
        new = [k for k in seen if k not in id_of]
        n0 = len(values)
        id_of.update(zip(new, range(n0, n0 + len(new))))
        values.extend(new)
        ids = list(map(id_of.__getitem__, items))
    return np.fromiter(ids, dtype=np.int32, count=len(ids))


class NodeVocab:
    """Append-only bidirectional mapping NodeKey <-> int32 id."""

    def __init__(self) -> None:
        self._id_of: dict[NodeKey, int] = {}
        self._key_of: list[NodeKey] = []
        self._is_set_cache: Optional[np.ndarray] = None
        # vectorized lookup index (lookup_bulk): open-addressing table of
        # (key hash -> id), built lazily and extended as the vocab grows.
        # All of it lives in ONE tuple published atomically, so lock-free
        # readers always see a consistent (mask, slots, ids, collisions,
        # upto) family.
        self._h_table: Optional[tuple] = None
        self._h_lock = threading.Lock()  # serializes index extension

    @classmethod
    def from_keys(cls, keys: Iterable[NodeKey]) -> "NodeVocab":
        """A vocab whose id i is keys[i] — loads another package's vocab
        (its key list in id order) so node ids agree across the two."""
        v = cls()
        keys = [tuple(k) for k in keys]
        v.intern_bulk(keys)
        if len(v) != len(keys):
            raise ValueError("vocab keys must be unique")
        return v

    def __len__(self) -> int:
        return len(self._key_of)

    def keys(self) -> list[NodeKey]:
        """The interned keys in id order (read-only by contract)."""
        return self._key_of

    def intern(self, key: NodeKey) -> int:
        nid = self._id_of.get(key)
        if nid is None:
            nid = len(self._key_of)
            self._id_of[key] = nid
            self._key_of.append(key)
        return nid

    def intern_bulk(self, keys: Sequence[NodeKey]) -> np.ndarray:
        """Vectorized intern of many keys -> int32 ids."""
        return bulk_intern(self._id_of, self._key_of, keys)

    def is_set_array(self) -> np.ndarray:
        """bool[len(self)]: True where the node denotes a subject set
        (3-tuple key). Cached; extended incrementally as the vocab grows."""
        n = len(self._key_of)
        cache = self._is_set_cache
        if cache is None or len(cache) != n:
            start = 0 if cache is None else len(cache)
            fresh = np.fromiter(
                (len(k) == 3 for k in self._key_of[start:]),
                dtype=bool,
                count=n - start,
            )
            cache = fresh if cache is None else np.concatenate([cache, fresh])
            self._is_set_cache = cache
        return cache

    def lookup(self, key: NodeKey) -> Optional[int]:
        return self._id_of.get(key)

    # -- vectorized lookup -----------------------------------------------------
    #
    # lookup_bulk replaces a chain of dict probes per key with one numpy
    # gather into a flat open-addressing table keyed by the keys' Python
    # hashes. Hashes that collide within the vocab are detected at index
    # build time and routed to the exact dict.

    def _extend_hash_index(self) -> tuple:
        table = self._h_table
        if table is not None and table[4] >= len(self._key_of):
            return table
        with self._h_lock:
            table = self._h_table
            upto = table[4] if table is not None else 0
            n = len(self._key_of)
            if table is not None and upto >= n:
                return table
            new_hashes = np.fromiter(
                (hash(k) for k in self._key_of[upto:n]),
                dtype=np.int64,
                count=n - upto,
            )
            need = 1 << int(n / 0.6).bit_length()
            if table is None or need > len(table[1]):
                # build a fresh table off to the side; readers keep the
                # published one until the single atomic swap below
                mask = need - 1
                slots = np.zeros(need, dtype=np.int64)
                slot_ids = np.full(need, -1, dtype=np.int32)
                collisions: set = set()
                old = np.fromiter(
                    (hash(k) for k in self._key_of[:upto]),
                    dtype=np.int64,
                    count=upto,
                )
                hashes = np.concatenate([old, new_hashes])
                ids = np.arange(n, dtype=np.int32)
            else:
                mask, slots, slot_ids, collisions, _ = table
                hashes = new_hashes
                ids = np.arange(upto, n, dtype=np.int32)
            _insert_hashes(mask, slots, slot_ids, collisions, hashes, ids)
            table = (mask, slots, slot_ids, collisions, n)
            self._h_table = table  # one atomic publish
            return table

    def lookup_bulk(self, keys: Sequence[NodeKey]) -> np.ndarray:
        """int64 ids for `keys`, -1 where unknown; equivalent to
        [self.lookup(k) for k in keys]. The keys are hashed in one C loop
        (native.object_hashes) where the native tier loads."""
        n = len(keys)
        if n == 0:
            return np.full(0, -1, dtype=np.int64)
        if native.lib is not None:
            h = native.object_hashes(keys)
        else:
            h = np.fromiter((hash(k) for k in keys), dtype=np.int64, count=n)
        return self.lookup_hashes(h, keys.__getitem__)

    def lookup_hashes(self, h: np.ndarray, key_fn) -> np.ndarray:
        """int64 ids for keys whose Python hashes are `h`, -1 where unknown.
        The encode path with no key tuples: callers hash straight off their
        request objects (native.request_hashes) and build a key with
        `key_fn(i)` only for the rare rows whose hash collides inside the
        vocab (the exact-dict fallback). Concurrent interns may be invisible
        to an in-flight lookup (a transient miss, treated as unknown)."""
        n = len(h)
        out = np.full(n, -1, dtype=np.int64)
        if n == 0 or not self._key_of:
            return out
        mask, slots, slot_ids, collisions, _ = self._extend_hash_index()
        if native.lib is not None:
            out = native.probe_index(slots, slot_ids, mask, h)
        else:
            idx = (mix64(h) & np.uint64(mask)).astype(np.int64)
            active = np.arange(n, dtype=np.int64)
            while len(active):
                cur = idx[active]
                occ = slot_ids[cur]
                hit = (occ >= 0) & (slots[cur] == h[active])
                out[active[hit]] = occ[hit]
                active = active[(occ >= 0) & ~hit]
                idx[active] = (idx[active] + 1) & mask
        if collisions:
            get = self._id_of.get
            for i in np.nonzero(np.isin(h, list(collisions)))[0]:
                v = get(key_fn(int(i)))
                out[i] = -1 if v is None else v
        return out

    def lookup_requests(self, requests) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The batched encode of relation tuples: the ids of each request's
        start key (ns, obj, rel) and of its subject's node key, -1 where
        unknown, and whether each subject is a subject id. Where the native
        tier loads and its tuple hash is this interpreter's, the key hashes
        come straight off the request objects in one C loop
        (native.request_hashes) and no key tuple is built."""
        if native.lib is not None and native.tuple_hash_ok:
            hs, ht, is_id = native.request_hashes(requests, SubjectID)

            def skey(i: int):
                r = requests[i]
                return (r.namespace, r.object, r.relation)

            def tkey(i: int):
                return subject_node_key(requests[i].subject)

            return self.lookup_hashes(hs, skey), self.lookup_hashes(ht, tkey), is_id
        tkeys = [subject_node_key(r.subject) for r in requests]
        s_ids = self.lookup_bulk([(r.namespace, r.object, r.relation) for r in requests])
        is_id = np.fromiter((len(k) == 1 for k in tkeys), dtype=bool, count=len(tkeys))
        return s_ids, self.lookup_bulk(tkeys), is_id

    def key(self, nid: int) -> NodeKey:
        return self._key_of[nid]

    def subject_of(self, nid: int) -> Subject:
        """Reconstruct the Subject a node id denotes."""
        k = self._key_of[nid]
        if len(k) == 1:
            return SubjectID(id=k[0])
        return SubjectSet(namespace=k[0], object=k[1], relation=k[2])

    def intern_subject(self, subject: Subject) -> int:
        return self.intern(subject_node_key(subject))

    def lookup_subject(self, subject: Subject) -> Optional[int]:
        return self.lookup(subject_node_key(subject))


def _insert_hashes(mask, slots, slot_ids, collisions, hashes, ids) -> None:
    idx = (mix64(hashes) & np.uint64(mask)).astype(np.int64)
    pending = np.arange(len(hashes), dtype=np.int64)
    while len(pending):
        cur = idx[pending]
        h = hashes[pending]
        free = slot_ids[cur] < 0
        slots[cur[free]] = h[free]
        slot_ids[cur[free]] = ids[pending[free]]
        # examine the slot's POST-write state: entries sharing a hash must
        # be detected here, or the first slot would answer for both keys
        now_ids = slot_ids[idx[pending]]
        now_h = slots[idx[pending]]
        placed = now_ids == ids[pending]
        collide = ~placed & (now_ids >= 0) & (now_h == h)
        if collide.any():
            collisions.update(h[collide].tolist())
        pending = pending[~(placed | collide)]
        idx[pending] = (idx[pending] + 1) & mask
