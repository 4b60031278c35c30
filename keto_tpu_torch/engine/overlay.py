"""Write overlay: exact serving-time deltas over a resident closure
(counterpart of ``keto_tpu/engine/overlay.py``).

Rebuilding the closure residency (interior decomposition + the all-pairs
distance matrix D) costs a host decomposition and a device build, yet most
writes never touch the part of the graph the closure summarizes. Every
write is decomposed by where its edge sits (``graph/interior.py``):

- **boundary/leaf edges** (grants to users, object->group edges): appear in
  a query only via the F0(start) row, the L(target) row, or the
  direct-edge probe. None of those touch D, so an insert or delete is
  served exactly by consulting a small per-node delta at query time.
- **interior edge inserts**: D absorbs them by the exact O(M^2)
  single-edge relaxation (``ops.closure.closure_insert_edge``). New
  interior NODES take a spare index from D's INF padding (diag zeroed).
- **interior edge deletes**: absorbed by a bounded exact RE-CLOSE of the
  affected D rows or columns against the CURRENT interior adjacency (base
  edges + overlay-inserted - deleted). A delete whose candidate row set
  exceeds ``max_delete_rows`` breaks the overlay instead.
- **overlay overflow** (budgets exhausted): the overlay marks itself
  BROKEN and the engine falls back to the rebuild path. Breaking deltas
  are rejected whole (two-phase apply), so a broken overlay still exactly
  describes its last covered version.

Both D residencies are supported. A device-resident D is never written
while a query may be gathering from it: the relaxation returns a new
tensor, and row, column and diagonal stores ``clone()`` D before
``index_put_``; the new tensor is swapped into ``art.d`` (a reference swap,
atomic under the interpreter lock). The swap drops the list path's ``D^T``
(``art.d_rev``) under ``art.rev_lock``: it is rebuilt from the patched D
when a list query next needs it. The host D of host query mode
(``art.d_host``, numpy) is patched in place (``closure_insert_edge_host``
and uint8 row, column and diagonal stores, each entry atomic), and every
patch is mirrored onto a host ``d_rev`` under ``art.rev_lock``, so D^T stays
D's transpose and an incremental rebuild can carry it forward. The host
branch runs numpy only: a forked read replica serves from it.

Concurrency: deltas arrive on writer threads into a pending deque; query
threads drain it under the overlay lock before serving. Point dict reads
on the query path are GIL-atomic against writer mutation; the vectorized
affected-row filter uses sorted-array snapshots rebuilt inside the drain.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Optional, Sequence

import numpy as np
import torch

from ..graph.vocab import set_key, subject_node_key
from ..ops.closure import INF_DIST, closure_insert_edge, closure_insert_edge_host
from ..relationtuple.definitions import RelationTuple, SubjectSet

_PAIR_SHIFT = 32  # ids < 2^31: (s << 32) | t packs a direct-edge pair


def _pair_key(s: int, t: int) -> int:
    return (s << _PAIR_SHIFT) | t


def _isin_sorted(values: np.ndarray, table: Optional[np.ndarray]) -> np.ndarray:
    """bool[n]: values ∈ table (table sorted, possibly None/empty)."""
    if table is None or len(table) == 0:
        return np.zeros(len(values), dtype=bool)
    idx = np.searchsorted(table, values)
    idx[idx >= len(table)] = 0
    return table[idx] == values


class WriteOverlay:
    """Delta state over ONE closure-artifacts generation (art.version is
    the base; `version` advances as contiguous store deltas apply)."""

    def __init__(
        self,
        art,
        max_events: int = 65536,
        max_interior_edges: int = 64,
        max_delete_rows: int = 1024,
    ):
        self.art = art
        self.version = art.version
        self.max_events = max_events
        self.max_interior_edges = max_interior_edges
        self.max_delete_rows = max_delete_rows
        self.broken = False
        self.broken_reason = ""
        self.n_events = 0
        self.n_interior_edges = 0
        self.n_interior_deletes = 0
        self._lock = threading.Lock()
        self._pending: deque = deque()
        # current interior adjacency in D-index space, for the delete
        # re-close: base groupings built once (lazily) per generation;
        # deleted base edges are neutralized in place as self-loops
        # (positions recorded for restore-on-re-add), overlay-added edges
        # live in the small extras set. Edge multiplicity is 1: a
        # (src,dst) index pair maps 1:1 to a relation tuple, which the
        # stores dedup.
        self._int_edges_cache: Optional[tuple] = None
        self._groupings_build_lock = threading.Lock()
        self._removed_pos: dict[int, tuple[int, int]] = {}
        self._int_extras: set[int] = set()
        self.warm_groupings_async()
        # net per-edge deltas: +1 overlay-added, -1 base-edge deleted
        self.f0_delta: dict[int, dict[int, int]] = {}  # start -> idx -> ±1
        self.l_delta: dict[int, dict[int, int]] = {}  # target -> idx -> ±1
        self.direct_delta: dict[int, int] = {}  # pair key -> ±1
        self.new_interior: dict[int, int] = {}  # node id -> D index >= ig.m
        self._m_grow = art.ig.m
        # sorted-array snapshots for the vectorized affected-row filter
        self._filter_dirty = True
        self._starts_arr: Optional[np.ndarray] = None
        self._targets_arr: Optional[np.ndarray] = None
        self._pairs_arr: Optional[np.ndarray] = None
        self._newint_arr: Optional[np.ndarray] = None

    # -- write side ------------------------------------------------------------

    def enqueue(
        self,
        version: int,
        inserted: Optional[Sequence[RelationTuple]],
        deleted: Optional[Sequence[RelationTuple]],
    ) -> None:
        """Called from the store's delta feed (writer thread): cheap append,
        no device work; the classification and D patches run on the next
        drain."""
        self._pending.append((version, inserted, deleted))

    def drain(self) -> None:
        """Apply all pending deltas in order. Query threads call this before
        serving; idempotent and cheap when nothing is pending."""
        if not self._pending:
            return
        with self._lock:
            while self._pending:
                version, inserted, deleted = self._pending.popleft()
                if self.broken:
                    continue  # keep draining so the deque cannot grow
                if version <= self.version:
                    continue  # already covered (pre-snapshot delta)
                if version != self.version + 1:
                    self._break("version gap")  # a bulk change we never saw
                    continue
                if inserted is None or deleted is None:
                    self._break("bulk load of unknown shape")
                    continue
                if self._apply_locked(inserted, deleted):
                    self.version = version
                # on failure the overlay is broken but CONSISTENT at its
                # previous version: pinned readers keep getting exact
                # answers as of that version while the rebuild runs
            if self._filter_dirty:
                # rebuilt inside the same locked drain: a query thread must
                # never pair a drained version with filter arrays from
                # before the drain
                self._rebuild_filters_locked()

    def _interior_index_of(self, nid: int) -> int:
        """D index of a node, -1 when not interior. Covers both the base
        decomposition and overlay-grown interior nodes."""
        ig = self.art.ig
        if nid < ig.padded_nodes:
            base = int(ig.interior_index[nid])
            if base >= 0:
                return base
        return self.new_interior.get(nid, -1)

    # -- D access: the host copy is patched in place and mirrored onto the
    # host D^T; a device D is replaced by a new tensor (swapped into art.d)
    # and its D^T dropped ----------------------------------------------------

    def _index(self, idx: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(idx, dtype=np.int64)).to(
            self.art.d.device
        )

    def _swap_d(self, d: torch.Tensor) -> None:
        art = self.art
        with art.rev_lock:
            art.d = d
            art.d_rev = None  # the transpose of the old D

    def _d_set_diag(self, idx: int) -> None:
        art = self.art
        if art.d_host is not None:
            with art.rev_lock:
                art.d_host[idx, idx] = 0
                if art.d_rev is not None:
                    art.d_rev[idx, idx] = 0
            return
        d = art.d.clone()
        d[idx, idx] = 0
        self._swap_d(d)

    def _d_insert_edge(self, u: int, v: int) -> None:
        # record for the delete re-close's current-adjacency view
        self._note_int_edge_added(u, v)
        art = self.art
        if art.d_host is not None:
            # inserting (u, v) into D is inserting (v, u) into D^T
            with art.rev_lock:
                closure_insert_edge_host(art.d_host, u, v, art.k_max)
                if art.d_rev is not None:
                    closure_insert_edge_host(art.d_rev, v, u, art.k_max)
            return
        self._swap_d(closure_insert_edge(art.d, u, v, art.k_max))

    def _d_min(self, rows: np.ndarray, cols: np.ndarray) -> int:
        art = self.art
        if art.d_host is not None:
            return int(
                art.d_host[
                    rows.astype(np.int64)[:, None], cols.astype(np.int64)[None, :]
                ].min()
            )
        # one tiny device gather per affected row; affected rows are few
        # by construction
        d = art.d
        return int(d[self._index(rows)[:, None], self._index(cols)[None, :]].min())

    def _d_col(self, u: int) -> np.ndarray:
        art = self.art
        if art.d_host is not None:
            return art.d_host[:, u]
        return art.d[:, u].cpu().numpy()

    def _d_row_vec(self, v: int) -> np.ndarray:
        art = self.art
        if art.d_host is not None:
            return art.d_host[v, :]
        return art.d[v, :].cpu().numpy()

    def _d_full_rows(self, rows: np.ndarray) -> np.ndarray:
        art = self.art
        if art.d_host is not None:
            return art.d_host[rows.astype(np.int64)]
        return art.d[self._index(rows)].cpu().numpy()

    def _d_set_rows(self, rows: np.ndarray, vals: np.ndarray) -> None:
        art = self.art
        if art.d_host is not None:
            # uint8 stores are per-entry atomic: a concurrent reader sees
            # each entry before or after the delete, the same between-versions
            # guarantee the monotone insert gives
            r = rows.astype(np.int64)
            with art.rev_lock:
                art.d_host[r] = vals
                if art.d_rev is not None:
                    art.d_rev[:, r] = vals.T
            return
        d = art.d.clone()
        d[self._index(rows)] = torch.from_numpy(vals).to(d.device)
        self._swap_d(d)

    def _d_set_cols(self, cols: np.ndarray, vals: np.ndarray) -> None:
        art = self.art
        if art.d_host is not None:
            c = cols.astype(np.int64)
            with art.rev_lock:
                art.d_host[:, c] = vals
                if art.d_rev is not None:
                    art.d_rev[c, :] = vals.T
            return
        d = art.d.clone()
        d[:, self._index(cols)] = torch.from_numpy(vals).to(d.device)
        self._swap_d(d)

    # -- current interior adjacency (for the delete re-close) ------------------

    # flips True the first time ANY overlay in this process absorbs an
    # interior delete: later generations then pre-warm the groupings in
    # the background instead of paying the O(E log E) build inside a
    # write's staleness window
    _deletes_seen = False

    def warm_groupings_async(self) -> None:
        if (
            type(self)._deletes_seen
            and self._int_edges_cache is None
            and len(self.art.ig.ii_src) > 1_000_000
        ):
            threading.Thread(
                target=self._base_groupings,
                name="overlay-groupings-warm",
                daemon=True,
            ).start()

    def _base_groupings(self):
        """Base ii edges sorted+grouped BOTH ways for the reduceat sweeps,
        built ONCE per overlay generation. Overlay deltas never re-sort:

        - a DELETED base edge is neutralized IN PLACE as a self-loop
          (by-src grouping keeps src order, so overwriting its dst with
          the src is sort-stable and relaxation-neutral; symmetrically
          src:=dst in the by-dst grouping);
        - an ADDED edge (including re-adding a previously-deleted base
          edge, which instead restores the original values) lands in the
          small ``_int_extras`` set, relaxed explicitly inside each
          sweep iteration.
        """
        if self._int_edges_cache is None:
            with self._groupings_build_lock:
                if self._int_edges_cache is not None:
                    return self._int_edges_cache
                ig = self.art.ig
                src = ig.ii_src.astype(np.int64)
                dst = ig.ii_dst.astype(np.int64)
                by_src = np.argsort(src, kind="stable")
                src_s, dst_s = src[by_src], dst[by_src].copy()
                uniq_src, starts_src = np.unique(src_s, return_index=True)
                by_dst = np.argsort(dst, kind="stable")
                src_d, dst_d = src[by_dst].copy(), dst[by_dst]
                uniq_dst, starts_dst = np.unique(dst_d, return_index=True)
                self._int_edges_cache = (
                    (src_s, dst_s, uniq_src, starts_src),  # dst_s writable
                    (src_d, dst_d, uniq_dst, starts_dst),  # src_d writable
                )
        return self._int_edges_cache

    def _note_int_edge_added(self, u: int, v: int) -> None:
        if u == v:
            # self-loops are relaxation-neutral (d(u,u) is already 0) AND
            # the neutralization encoding below stores a deleted edge AS a
            # self-loop — tracking real ones would collide with ghosts
            return
        key = _pair_key(u, v)
        pos = self._removed_pos.pop(key, None)
        if pos is not None:
            # re-adding a neutralized base edge: restore it in place
            (src_s, dst_s, *_), (src_d, dst_d, *_) = self._base_groupings()
            dst_s[pos[0]] = v
            src_d[pos[1]] = u
            return
        self._int_extras.add(key)

    def _note_int_edge_removed(self, u: int, v: int) -> None:
        if u == v:
            # a self-loop never lies on a shortest path; searching for it
            # here would match the (u,u) ghosts of OTHER neutralized edges
            return
        type(self)._deletes_seen = True
        key = _pair_key(u, v)
        if key in self._int_extras:
            self._int_extras.discard(key)
            return  # an overlay-added edge: just drop it
        if key in self._removed_pos:
            return  # already neutralized (shouldn't recur: multiplicity 1)
        (src_s, dst_s, *_), (src_d, dst_d, *_) = self._base_groupings()
        lo = np.searchsorted(src_s, u)
        hi = np.searchsorted(src_s, u, side="right")
        hits = np.nonzero(dst_s[lo:hi] == v)[0]
        if hits.size == 0:
            return  # not a base edge either (nothing to neutralize)
        p_src = int(lo + hits[0])
        lo = np.searchsorted(dst_d, v)
        hi = np.searchsorted(dst_d, v, side="right")
        hits = np.nonzero(src_d[lo:hi] == u)[0]
        if hits.size == 0:
            return  # groupings disagree: not a (whole) base edge
        p_dst = int(lo + hits[0])
        dst_s[p_src] = u  # self-loop: relaxation-neutral
        src_d[p_dst] = v
        self._removed_pos[key] = (p_src, p_dst)

    def _extras_pairs(self):
        mask = (1 << _PAIR_SHIFT) - 1
        return [(k >> _PAIR_SHIFT, k & mask) for k in self._int_extras]

    def _sweep_rows(self, init_rows: np.ndarray) -> np.ndarray:
        """Exact bounded distances FROM each node in init_rows over the
        current interior edges: batched Bellman-Ford, k_max sweeps of
        grouped min-plus on the host (paths are <= k_max hops by
        construction). Returns uint8 (len(init_rows), m_pad) with INF_DIST
        beyond k_max."""
        art = self.art
        _, (src, dst, uniq, starts) = self._base_groupings()
        extras = self._extras_pairs()
        big = np.int16(1 << 14)
        est = np.full((len(init_rows), art.m_pad), big, np.int16)
        est[np.arange(len(init_rows)), init_rows] = 0
        one = np.int16(1)
        for _ in range(art.k_max):
            changed = False
            if len(src):
                # relax dist(i -> j) >= dist(i -> w) + 1 for edges w->j:
                # fixed sources advance along IN-edges of each target,
                # so the reduceat groups by dst
                mins = np.minimum.reduceat(est[:, src] + one, starts, axis=1)
                new = np.minimum(est[:, uniq], mins)
                changed |= bool((new < est[:, uniq]).any())
                est[:, uniq] = new
            for a, b in extras:
                nb = np.minimum(est[:, b], est[:, a] + one)
                changed |= bool((nb < est[:, b]).any())
                est[:, b] = nb
            if not changed:
                break
        return np.where(est > art.k_max, np.int16(INF_DIST), est).astype(
            np.uint8
        )

    def _sweep_cols(self, init_cols: np.ndarray) -> np.ndarray:
        """Exact bounded distances TO each node in init_cols (one D column
        per target), same sweep transposed: fixed targets advance along
        OUT-edges of each source, so the reduceat groups by src. Returns
        uint8 (m_pad, len(init_cols))."""
        art = self.art
        (src, dst, uniq, starts), _ = self._base_groupings()
        extras = self._extras_pairs()
        big = np.int16(1 << 14)
        dist = np.full((art.m_pad, len(init_cols)), big, np.int16)
        dist[init_cols, np.arange(len(init_cols))] = 0
        one = np.int16(1)
        for _ in range(art.k_max):
            changed = False
            if len(src):
                # relax dist(u -> t) >= 1 + dist(v -> t) for edges u->v
                mins = np.minimum.reduceat(dist[dst] + one, starts, axis=0)
                new = np.minimum(dist[uniq], mins)
                changed |= bool((new < dist[uniq]).any())
                dist[uniq] = new
            for a, b in extras:
                na = np.minimum(dist[a], dist[b] + one)
                changed |= bool((na < dist[a]).any())
                dist[a] = na
            if not changed:
                break
        return np.where(dist > art.k_max, np.int16(INF_DIST), dist).astype(
            np.uint8
        )

    def _delete_interior_edge(self, u: int, v: int) -> None:
        """Exact bounded re-close of D after removing interior edge (u,v).

        Removing an edge can only LENGTHEN distances, and only for pairs
        (i,j) whose shortest path used it: pairs where D[i,u] + 1 +
        D[v,j] == D[i,j]. The tight pairs project onto affected ROWS
        (sources reaching u) and affected COLUMNS (targets reachable from
        v); recomputing either side from scratch restores exactness, so
        the smaller projection is recomputed by a batched k_max-sweep
        Bellman-Ford over the current interior edge list."""
        if u == v:
            return  # self-loops never carry a shortest path
        art = self.art
        k_max = art.k_max

        # 1. tight projections (against D BEFORE any mutation)
        du = self._d_col(u).astype(np.int16)
        dv = self._d_row_vec(v).astype(np.int16)
        cand_rows = np.nonzero(du <= k_max)[0]
        row_hits = []
        col_hit = np.zeros(art.m_pad, dtype=bool)
        chunk_rows = 512
        for c0 in range(0, len(cand_rows), chunk_rows):
            chunk = cand_rows[c0 : c0 + chunk_rows]
            sub = self._d_full_rows(chunk).astype(np.int16)
            tight = (du[chunk][:, None] + 1 + dv[None, :]) == sub
            hit = tight.any(axis=1)
            if hit.any():
                row_hits.append(chunk[hit])
                col_hit |= tight.any(axis=0)

        # 2. drop the edge from the current-adjacency view
        self._note_int_edge_removed(u, v)
        self.n_interior_deletes += 1
        if not row_hits:
            return  # no shortest path used the edge: D is already exact

        # 3. recompute the smaller projection, chunked so the sweep's
        # (chunk x edges) int16 temporary stays bounded
        rows = np.concatenate(row_hits)
        cols = np.nonzero(col_hit)[0]
        (src0, _, _, _), _ = self._base_groupings()
        step = max(1, (1 << 25) // max(1, len(src0)))
        if len(cols) <= len(rows):
            for c0 in range(0, len(cols), step):
                chunk = cols[c0 : c0 + step]
                self._d_set_cols(chunk, self._sweep_cols(chunk))
        else:
            for c0 in range(0, len(rows), step):
                chunk = rows[c0 : c0 + step]
                self._d_set_rows(chunk, self._sweep_rows(chunk))

    def _base_out_neighbors(self, nid: int) -> np.ndarray:
        """One node's base successors in insertion order. Uses the
        snapshot's CSR only when it is ALREADY derived (an Expand or a list
        query derived it, or an append carried it forward): promotion runs
        inside the locked drain, and forcing the full O(E log E) CSR sort
        there would stall every query thread behind one routine write. An
        O(E) masked scan of the COO arrays is bounded and lock-friendly."""
        snap = self.art.snap
        if snap._csr is not None:
            return snap.out_neighbors(nid)
        e = snap.num_edges
        return snap.dst[:e][snap.src[:e] == nid]

    def _grow_interior(self, nid: int) -> int:
        """Allocate a D index for a newly-interior set node from the INF
        padding (diag zeroed so self-paths cost 0). -1 when out of room
        (caller marks the overlay broken).

        Promotion reclassifies the node's PRE-EXISTING base edges: a set
        node with no in-edges was excluded from the interior decomposition,
        so its outgoing edges live only in the F0 CSR — once it gains an
        in-edge, paths may run *through* it, and its out-edges must join
        the interior closure (set successors) and the L rows (id
        successors)."""
        idx = self._interior_index_of(nid)
        if idx >= 0:
            return idx
        art = self.art
        if self._m_grow >= art.pad:  # pad index itself must stay inert
            return -1
        idx = self._m_grow
        self._m_grow += 1
        self._d_set_diag(idx)
        ig = art.ig
        is_set = art.snap.vocab.is_set_array()
        # (a) BASE out-edges, minus any the overlay already deleted
        if nid < ig.padded_nodes:
            succ = self._base_out_neighbors(nid)
            if succ.size:
                self.n_events += int(succ.size)
                for v in succ.tolist():
                    if self.direct_delta.get(_pair_key(nid, v), 0) < 0:
                        continue  # base edge deleted since the snapshot
                    if is_set[v]:
                        v_idx = int(ig.interior_index[v])
                        if (
                            v_idx < 0
                            or self.n_interior_edges >= self.max_interior_edges
                        ):
                            return -1
                        self.n_interior_edges += 1
                        self._d_insert_edge(idx, v_idx)
                    else:
                        self._bump2(self.l_delta, v, idx, +1)
        # (b) OVERLAY out-edges recorded while the node was still exterior:
        # set successors live in its f0 delta (already as D indices); id
        # successors only in the direct-edge delta
        f0d = self.f0_delta.get(nid)
        if f0d:
            for v_idx, cnt in list(f0d.items()):
                if cnt <= 0:
                    continue
                if self.n_interior_edges >= self.max_interior_edges:
                    return -1
                self.n_interior_edges += 1
                self._d_insert_edge(idx, v_idx)
        lo = nid << _PAIR_SHIFT
        hi = lo + (1 << _PAIR_SHIFT)
        for key, cnt in list(self.direct_delta.items()):
            if cnt <= 0 or not (lo <= key < hi):
                continue
            v = key - lo
            if v < len(is_set) and is_set[v]:
                continue  # set successor: covered by the f0 delta above
            self._bump2(self.l_delta, v, idx, +1)
        self.new_interior[nid] = idx
        return idx

    def _encode_delta(self, inserted, deleted):
        """(inserts, deletes) as (kind, src_id, dst_id, dst_is_set).
        INSERTS FIRST — the stores' transact order. A transact inserting
        and deleting the same set-subject tuple must see the insert's
        promotion before the delete's decrement, or the delete misses the
        not-yet-allocated interior index and leaves a phantom F0 entry."""
        vocab = self.art.snap.vocab
        out = []
        for kind, tuples in (("ins", inserted), ("del", deleted)):
            for t in tuples:
                s = vocab.intern(set_key(t.namespace, t.object, t.relation))
                d = vocab.intern(subject_node_key(t.subject))
                out.append((kind, s, d, isinstance(t.subject, SubjectSet)))
        return out

    def _plan_breaks(self, ops) -> Optional[str]:
        """Dry-run classification of one delta: the break reason it WOULD
        hit, or None. Run before any mutation so a breaking delta leaves
        the overlay consistent at its previous version (D relaxations are
        irreversible)."""
        ig = self.art.ig
        is_set_arr = self.art.snap.vocab.is_set_array()
        hypo_interior: set[int] = set()  # nodes this delta would promote
        n_grow = 0
        n_int_edges = self.n_interior_edges
        n_events = self.n_events
        n_del_rows = 0  # candidate re-close rows this delta would pay for

        def interior(nid: int) -> bool:
            return self._interior_index_of(nid) >= 0 or nid in hypo_interior

        for kind, s, d, is_set in ops:
            n_events += 1
            if kind == "del":
                if is_set and interior(s):
                    # interior edge delete: charge the SMALLER projection
                    # of the candidate tight set — rows reaching s vs
                    # columns reachable from d — matching the orientation
                    # the re-close will pick. A node promoted earlier in
                    # this same delta has no D row/column yet: charge 1.
                    s_idx = self._interior_index_of(s)
                    d_idx = self._interior_index_of(d)
                    k_max = self.art.k_max
                    if s_idx >= 0 and d_idx >= 0:
                        n_rows = int(np.count_nonzero(self._d_col(s_idx) <= k_max))
                        n_cols = int(
                            np.count_nonzero(self._d_row_vec(d_idx) <= k_max)
                        )
                        n_del_rows += min(n_rows, n_cols)
                    else:
                        n_del_rows += 1
                    if n_del_rows > self.max_delete_rows:
                        return "interior delete too wide"
                continue
            if not is_set:
                continue
            if not interior(d):
                n_grow += 1
                hypo_interior.add(d)
                # promotion reclassifies existing set successors into D
                if d < ig.padded_nodes:
                    succ = self._base_out_neighbors(d)
                    if succ.size:
                        n_events += int(succ.size)
                        sets = succ[is_set_arr[succ]]
                        n_int_edges += int(sets.size)
                f0d = self.f0_delta.get(d)
                if f0d:
                    n_int_edges += sum(1 for c in f0d.values() if c > 0)
            if interior(s):
                n_int_edges += 1
        if self._m_grow + n_grow >= self.art.pad:
            return "interior growth exhausted"
        if n_int_edges > self.max_interior_edges:
            return "interior edge budget"
        if n_events > self.max_events:
            return "event budget"
        return None

    def _apply_locked(self, inserted, deleted) -> bool:
        """Two-phase apply: classify first (no mutation), then mutate.
        Returns False (and marks broken) when the delta cannot be
        absorbed; the overlay state is then untouched and still exactly
        describes its previous version."""
        ops = self._encode_delta(inserted, deleted)
        reason = self._plan_breaks(ops)
        if reason is not None:
            self._break(reason)
            return False
        for kind, s, d, is_set in ops:
            sign = 1 if kind == "ins" else -1
            self._bump(self.direct_delta, _pair_key(s, d), sign)
            if is_set:
                d_idx = (
                    self._grow_interior(d)
                    if kind == "ins"
                    else self._interior_index_of(d)
                )
                if kind == "ins" and d_idx < 0:
                    # unreachable: the plan pass accounted for every grow.
                    # Defensive break anyway — never serve half-state.
                    self._break("interior growth exhausted")
                    return False
                if d_idx >= 0:
                    self._bump2(self.f0_delta, s, d_idx, sign)
                s_idx = self._interior_index_of(s)
                if kind == "ins" and s_idx >= 0:
                    # interior edge: exact O(M^2) relaxation into D
                    self.n_interior_edges += 1
                    self._d_insert_edge(s_idx, d_idx)
                elif kind == "del" and s_idx >= 0 and d_idx >= 0:
                    # interior edge delete: bounded exact re-close of the
                    # affected D rows (budgeted in _plan_breaks)
                    self._delete_interior_edge(s_idx, d_idx)
            else:
                s_idx = self._interior_index_of(s)
                if s_idx >= 0:
                    self._bump2(self.l_delta, d, s_idx, sign)
            self.n_events += 1
        self._filter_dirty = True
        return True

    def _break(self, reason: str) -> None:
        """Mark the overlay unusable; the engine falls back to the rebuild
        path. The first reason is kept."""
        self.broken = True
        if not self.broken_reason:
            self.broken_reason = reason

    @staticmethod
    def _bump(m: dict, key, delta: int) -> None:
        v = m.get(key, 0) + delta
        if v == 0:
            m.pop(key, None)
        else:
            m[key] = v

    @staticmethod
    def _bump2(m: dict, key, idx: int, delta: int) -> None:
        inner = m.get(key)
        if inner is None:
            inner = m[key] = {}
        v = inner.get(idx, 0) + delta
        if v == 0:
            inner.pop(idx, None)
            if not inner:
                m.pop(key, None)
        else:
            inner[idx] = v

    # -- read side -------------------------------------------------------------

    def active(self, store_version: int) -> bool:
        """True when every write up to store_version is absorbed: answers
        with overlay corrections are exact at store_version."""
        return not self.broken and self.version == store_version

    def _rebuild_filters_locked(self) -> None:
        self._starts_arr = np.sort(
            np.fromiter(self.f0_delta, np.int64, len(self.f0_delta))
        )
        self._targets_arr = np.sort(
            np.fromiter(self.l_delta, np.int64, len(self.l_delta))
        )
        self._pairs_arr = np.sort(
            np.fromiter(self.direct_delta, np.int64, len(self.direct_delta))
        )
        self._newint_arr = np.sort(
            np.fromiter(self.new_interior, np.int64, len(self.new_interior))
        )
        self._filter_dirty = False

    def _filters(self):
        if self._filter_dirty:
            with self._lock:
                if self._filter_dirty:
                    self._rebuild_filters_locked()
        return (
            self._starts_arr,
            self._targets_arr,
            self._pairs_arr,
            self._newint_arr,
        )

    def affected_rows(
        self, start: np.ndarray, target: np.ndarray, is_id: np.ndarray
    ) -> np.ndarray:
        """bool[n] marking rows whose answer may differ from the base
        closure's — the only rows the correction path re-evaluates.
        `start`/`target` are RAW node ids (pre-dummy-clamp) so overlay
        edges on nodes interned after the base snapshot are seen."""
        starts, targets, pairs, newint = self._filters()
        hit = _isin_sorted(start, starts)
        hit |= _isin_sorted(target, targets)
        hit |= _isin_sorted((start << _PAIR_SHIFT) | target, pairs)
        if len(newint):
            hit |= ~is_id & _isin_sorted(target, newint)
        return hit

    def check_rows(
        self,
        start: np.ndarray,
        target: np.ndarray,
        is_id: np.ndarray,
        depth: np.ndarray,
    ) -> np.ndarray:
        """Exact re-evaluation of (few) affected rows with merged
        F0/L/direct state. Same decomposition as the base engine
        (closure.py _check_arrays), full true-degree rows."""
        art = self.art
        ig = art.ig
        pn = ig.padded_nodes
        out = np.zeros(len(start), dtype=bool)
        for i in range(len(start)):
            s = int(start[i])
            t = int(target[i])
            dep = int(depth[i])
            if dep < 1:
                continue
            if s < 0 or t < 0:
                # unknown endpoint (raw -1 from a vocab miss): no overlay
                # edge can touch it — and letting it through would wrap
                # the numpy gathers below onto the LAST node's rows
                continue
            # direct edge: base XOR delta
            delta = self.direct_delta.get(_pair_key(s, t), 0)
            if delta > 0:
                out[i] = True
                continue
            base_direct = (
                s < pn
                and t < pn
                and bool(
                    ig.direct_edge(
                        np.array([s], np.int64), np.array([t], np.int64)
                    )[0]
                )
            )
            if base_direct and delta >= 0:
                out[i] = True
                continue
            # F0 = (base row − deleted) ∪ added
            f0d = self.f0_delta.get(s)
            if s < pn:
                row = ig.set_out_vals[ig.set_out_indptr[s] : ig.set_out_indptr[s + 1]]
            else:
                row = np.empty(0, np.int32)
            if f0d:
                removed = [k for k, c in f0d.items() if c < 0]
                added = [k for k, c in f0d.items() if c > 0]
                if removed:
                    row = row[~np.isin(row, removed)]
                if added:
                    row = np.concatenate([row, np.asarray(added, row.dtype)])
            if len(row) == 0:
                continue
            # L and the final-hop budget
            if is_id[i]:
                ld = self.l_delta.get(t)
                if t < pn:
                    lrow = ig.id_in_vals[ig.id_in_indptr[t] : ig.id_in_indptr[t + 1]]
                else:
                    lrow = np.empty(0, np.int32)
                if ld:
                    removed = [k for k, c in ld.items() if c < 0]
                    added = [k for k, c in ld.items() if c > 0]
                    if removed:
                        lrow = lrow[~np.isin(lrow, removed)]
                    if added:
                        lrow = np.concatenate([lrow, np.asarray(added, lrow.dtype)])
                extra = 1
            else:
                t_idx = self._interior_index_of(t)
                lrow = (
                    np.asarray([t_idx], np.int32)
                    if t_idx >= 0
                    else np.empty(0, np.int32)
                )
                extra = 0
            if len(lrow) == 0:
                continue
            best = self._d_min(row, lrow)
            if best < INF_DIST and 1 + best + extra <= dep:
                out[i] = True
        return out
