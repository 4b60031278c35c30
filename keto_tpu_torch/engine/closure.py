"""Closure check engine: a snapshot-time closure on the GPU, gather-only
queries (counterpart of ``keto_tpu/engine/closure.py``, trimmed to its
device query path).

The engine pays the graph traversal ONCE per snapshot — a bounded
all-pairs-distance closure ``D`` over the small interior subgraph
(``graph/interior.py``), built on the device by the masked-SpMV kernel
(``engine/masked_spmv.py``) — and answers every check of the snapshot's
lifetime with gathers:

    host    encode requests -> (start, target) node ids     (vocab probe)
    host    F0/L CSR row gathers + direct-edge hash probe   (numpy)
    device  D[F0 x L] gather, min-reduce, depth compare     (ops.closure)

Correctness contract is identical to the host oracle (CheckEngine): allowed
iff a tuple path of length <= depth exists.

Freshness is ``strong``: a write makes the next check rebuild before it
answers. An append-only delta whose new interior edges (at most 8) connect
existing interior nodes updates the resident ``D`` in O(M^2) per edge
(``ops.closure.closure_insert_edge``) instead of rebuilding. ``auto``
resolves to strong below ``strong_freshness_edges`` live edges; the
``bounded`` policy (and ``auto`` above the threshold) is a later slice of
the port and raises ValueError. Also left to later slices: the write
overlay, host query mode, the reverse index, scrubbing, metrics and tracing.

Rows whose F0/L fan-out overflows the padded width, and snapshots whose
interior exceeds ``interior_limit`` (D is O(M^2) bytes), are answered by an
exact fallback engine — by default the host BFS oracle over the same store.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..graph.interior import InteriorGraph, build_interior, gather_padded_rows
from ..graph.snapshot import GraphSnapshot, SnapshotManager
from ..ops.closure import (
    INF_DIST,
    closure_insert_edge,
    closure_query,
    pack_adjacency,
)
from ..relationtuple.definitions import RelationTuple, SubjectID
from ..utils.kernels import resolve_device
from .check import DEFAULT_MAX_DEPTH, CheckEngine
from .masked_spmv import build_closure_semiring

# the closure stores distances in uint8 with INF_DIST=255 reserved, so the
# deepest resolvable path is 254 interior steps
_MAX_CLOSURE_DEPTH = INF_DIST

# up to this many appended interior edges the per-edge O(M^2) relax is
# cheaper than a full rebuild
_MAX_INCR_EDGES = 8

# rows whose F0 and L fan-outs both fit this width take the narrow gather
# path; the heavy tail is processed separately at full width
_NARROW_WIDTH = 8

# spare D rows the JAX engine reserves for interior nodes grown between
# rebuilds; kept so D has the same shape in both packages
_GROW_RESERVE = 512

_BOUNDED_MSG = (
    "bounded freshness (serving the previous closure while a background "
    "rebuild runs) is not ported yet; it arrives with the write-overlay "
    "slice of keto_tpu_torch. Use freshness='strong'."
)


def _m_pad_for(m: int) -> int:
    """Padded closure width for a live interior of m nodes: at least one
    INF row (the PAD index) plus the grow reserve, bucketed to 256."""
    n = m + 1 + _GROW_RESERVE
    return ((n + 255) // 256) * 256


class _ClosureArtifacts:
    """Per-snapshot residency: the snapshot, its interior decomposition and
    the closure matrix D on the device."""

    def __init__(
        self,
        snap: GraphSnapshot,
        ig: InteriorGraph,
        k_max: int,
        d: torch.Tensor,
    ):
        self.snap = snap
        self.ig = ig
        self.k_max = k_max
        self.m_pad = _m_pad_for(ig.m)
        self.pad = self.m_pad - 1
        self.d = d

    @property
    def version(self) -> int:
        return self.snap.version

    @property
    def num_edges(self) -> int:
        return self.snap.num_edges


@dataclass
class _TooBig:
    """Snapshot whose interior exceeds the closure limit (or whose depth
    exceeds the uint8 range): checks route to the exact fallback engine,
    which reads the live store."""

    version: int
    num_edges: int


_State = Union[_ClosureArtifacts, _TooBig]


class ClosureCheckEngine:
    def __init__(
        self,
        snapshots: SnapshotManager,
        max_depth: int = DEFAULT_MAX_DEPTH,
        interior_limit: int = 16384,
        f0_max: int = 32,
        l_max: int = 32,
        freshness: str = "auto",  # auto | strong
        strong_freshness_edges: int = 1 << 21,
        device=None,
    ):
        if freshness == "bounded":
            raise ValueError(_BOUNDED_MSG)
        if freshness not in ("auto", "strong"):
            raise ValueError(f"unknown freshness {freshness!r}")
        self.device = resolve_device(device)
        self.snapshots = snapshots
        self.global_max_depth = max_depth
        self.interior_limit = interior_limit
        self.f0_max = f0_max
        self.l_max = l_max
        self.freshness = freshness
        self.strong_freshness_edges = strong_freshness_edges
        self._fallback: Optional[CheckEngine] = None
        self._build_lock = threading.Lock()  # serializes state builds
        self._state: Optional[_State] = None
        # build telemetry (read by tests and the smoke run)
        self.n_full_builds = 0
        self.n_incremental_builds = 0
        # seconds of the most recent build: interior / kernel / incremental
        self.last_build_phases: dict[str, float] = {}

    @classmethod
    def from_closure(
        cls, snapshots: SnapshotManager, d: np.ndarray, **kwargs
    ) -> "ClosureCheckEngine":
        """An engine serving a closure matrix computed elsewhere (for
        example by ``keto_tpu``) for the manager's current snapshot. `d` is
        uint8[m_pad, m_pad] for that snapshot's interior and the engine's
        max_depth."""
        eng = cls(snapshots, **kwargs)
        snap = snapshots.snapshot()
        ig = build_interior(snap)
        m_pad = _m_pad_for(ig.m)
        d = np.asarray(d)
        if d.dtype != np.uint8 or d.shape != (m_pad, m_pad):
            raise ValueError(
                f"closure must be uint8[{m_pad}, {m_pad}] for this snapshot, "
                f"got {d.dtype}{list(d.shape)}"
            )
        if ig.m > eng.interior_limit or eng.global_max_depth > _MAX_CLOSURE_DEPTH:
            raise ValueError("this snapshot is served by the fallback engine")
        eng._state = _ClosureArtifacts(
            snap,
            ig,
            eng.global_max_depth - 1,
            torch.from_numpy(np.array(d, copy=True)).to(eng.device),
        )
        return eng

    def fallback_engine(self) -> CheckEngine:
        """The exact engine for rows and snapshots D cannot answer: the
        host BFS oracle over the live store."""
        if self._fallback is None:
            self._fallback = CheckEngine(
                self.snapshots.store, max_depth=self.global_max_depth
            )
        return self._fallback

    def closure(self) -> Optional[np.ndarray]:
        """The serving closure D as a host array (building it first when
        stale), or None when the snapshot is served by the fallback."""
        state = self._serving()
        if not isinstance(state, _ClosureArtifacts):
            return None
        return state.d.cpu().numpy()

    # -- residency ------------------------------------------------------------

    def _serving(self) -> _State:
        """The state answering this batch: fresh under strong freshness."""
        state = self._state
        if state is not None and state.version == self.snapshots.store.version:
            return state
        if (
            state is not None
            and self.freshness == "auto"
            and state.num_edges >= self.strong_freshness_edges
        ):
            raise ValueError(_BOUNDED_MSG)
        return self._build_sync()

    def _build_sync(self) -> _State:
        with self._build_lock:
            state = self._state
            if state is not None and state.version == self.snapshots.store.version:
                return state  # a concurrent builder got there first
            snap = self.snapshots.snapshot()
            state = self._build_state(snap, prev=state)
            self._state = state
            return state

    def _build_state(
        self, snap: GraphSnapshot, prev: Optional[_State]
    ) -> _State:
        t_build = time.perf_counter()
        phases: dict[str, float] = {}
        self.last_build_phases = phases
        t0 = time.perf_counter()
        ig = build_interior(snap)
        phases["interior"] = time.perf_counter() - t0
        if ig.m > self.interior_limit or self.global_max_depth > _MAX_CLOSURE_DEPTH:
            # depths beyond the uint8 distance range cannot be resolved by
            # the closure: exact fallback for the whole snapshot
            phases["total"] = time.perf_counter() - t_build
            return _TooBig(version=snap.version, num_edges=snap.num_edges)
        k_max = self.global_max_depth - 1
        t0 = time.perf_counter()
        if isinstance(prev, _ClosureArtifacts):
            new_ii = self._appended_interior_edges(prev, snap, ig)
            if new_ii is not None and len(new_ii) <= _MAX_INCR_EDGES:
                self.n_incremental_builds += 1
                d = prev.d
                for u, v in new_ii:
                    d = closure_insert_edge(d, int(u), int(v), k_max)
                art = _ClosureArtifacts(snap, ig, k_max, d)
                phases["incremental"] = time.perf_counter() - t0
                phases["total"] = time.perf_counter() - t_build
                return art
        self.n_full_builds += 1
        m_pad = _m_pad_for(ig.m)
        packed = pack_adjacency(ig.ii_src, ig.ii_dst, m_pad)
        d = build_closure_semiring(
            packed, ig.m, m_pad=m_pad, k_max=k_max, device=self.device
        )
        phases["kernel"] = time.perf_counter() - t0
        phases["total"] = time.perf_counter() - t_build
        return _ClosureArtifacts(snap, ig, k_max, d)

    @staticmethod
    def _appended_interior_edges(
        prev: _ClosureArtifacts, snap: GraphSnapshot, ig: InteriorGraph
    ) -> Optional[np.ndarray]:
        """If `snap` is an append-only extension of prev.snap with the same
        interior node set, the interior-index pairs of its new interior
        edges (possibly empty); else None (full rebuild required)."""
        old = prev.snap
        pe = old.num_edges
        if (
            snap.vocab is not old.vocab
            or snap.padded_nodes != old.padded_nodes
            or snap.num_edges < pe
            or not np.array_equal(snap.src[:pe], old.src[:pe])
            or not np.array_equal(snap.dst[:pe], old.dst[:pe])
            or not np.array_equal(ig.interior_ids, prev.ig.interior_ids)
        ):
            return None
        src = snap.src[pe : snap.num_edges]
        dst = snap.dst[pe : snap.num_edges]
        si = ig.interior_index[src]
        di = ig.interior_index[dst]
        both = (si >= 0) & (di >= 0)
        return np.stack([si[both], di[both]], axis=1)

    # -- public API -----------------------------------------------------------

    def subject_is_allowed(
        self, requested: RelationTuple, max_depth: int = 0
    ) -> bool:
        return self.batch_check([requested], max_depth)[0]

    def _depths(self, n: int, max_depth: int, depths) -> np.ndarray:
        gmax = self.global_max_depth
        if depths is not None:
            want = np.asarray(depths, dtype=np.int32)
        else:
            want = np.full(n, max_depth, dtype=np.int32)
        return np.where((want <= 0) | (want > gmax), gmax, want).astype(
            np.int32
        )

    def batch_check(
        self,
        requests: Sequence[RelationTuple],
        max_depth: int = 0,
        depths: Optional[Sequence[int]] = None,
    ) -> list[bool]:
        if not requests:
            return []
        state = self._serving()
        if not isinstance(state, _ClosureArtifacts):
            return self.fallback_engine().batch_check(
                list(requests), max_depth, None if depths is None else list(depths)
            )
        n = len(requests)
        vocab = state.snap.vocab
        tkeys = [
            (s.id,) if type(s) is SubjectID else (s.namespace, s.object, s.relation)
            for s in (r.subject for r in requests)
        ]
        s_ids = vocab.lookup_bulk(
            [(r.namespace, r.object, r.relation) for r in requests]
        )
        t_ids = vocab.lookup_bulk(tkeys)
        is_id = np.fromiter((len(k) == 1 for k in tkeys), dtype=bool, count=n)
        depth = self._depths(n, max_depth, depths)
        allowed = self._check_arrays(state, s_ids, t_ids, is_id, depth, requests)
        return allowed.tolist()

    def check_ids(
        self,
        start: np.ndarray,
        target: np.ndarray,
        is_id: np.ndarray,
        depths: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Array-native check: vocab-encoded (start, target) node ids in,
        bool[n] out. Unknown nodes must already be mapped to the snapshot's
        dummy id."""
        start = np.asarray(start, dtype=np.int64)
        if len(start) == 0:
            return np.zeros(0, dtype=bool)
        target = np.asarray(target, dtype=np.int64)
        is_id = np.asarray(is_id, dtype=bool)
        depth = self._depths(len(start), 0, depths)
        state = self._serving()
        if not isinstance(state, _ClosureArtifacts):
            snap = self.snapshots.snapshot()
            reqs = self._decode_requests(snap, start, target)
            res = np.asarray(
                self.fallback_engine().batch_check(
                    reqs, depths=[int(d) for d in depth]
                )
            )
            # rows with unknown endpoints are always denied (bounded by the
            # SNAPSHOT's node count, not the live vocab)
            n_snap = min(snap.num_nodes, snap.dummy_node)
            res[(start >= n_snap) | (target >= n_snap)] = False
            return res
        return self._check_arrays(state, start, target, is_id, depth)

    def _decode_requests(self, snap, start, target) -> list[RelationTuple]:
        """ids -> RelationTuples (overflow/fallback paths only)."""
        vocab = snap.vocab
        n_live = len(vocab)
        out = []
        for s, tt in zip(start, target):
            if int(s) < n_live:
                ns, obj, rel = vocab.key(int(s))
            else:  # dummy/unknown start: resolves to no tuples downstream
                ns = obj = rel = ""
            subject = (
                vocab.subject_of(int(tt)) if int(tt) < n_live else SubjectID(id="")
            )
            out.append(
                RelationTuple(namespace=ns, object=obj, relation=rel, subject=subject)
            )
        return out

    def _check_arrays(
        self,
        art: _ClosureArtifacts,
        start_raw: np.ndarray,
        target_raw: np.ndarray,
        is_id: np.ndarray,
        depth: np.ndarray,
        requests: Optional[Sequence[RelationTuple]] = None,
    ) -> np.ndarray:
        """`start_raw`/`target_raw` are raw vocab ids (-1 unknown, or beyond
        this snapshot's width): both are clamped to the inert dummy node."""
        snap = art.snap
        ig = art.ig
        n = len(start_raw)
        pn = snap.padded_nodes
        dummy = snap.dummy_node
        # rows sorted by start id: requests sharing a start gather the same
        # CSR and closure rows back to back; results scatter back at the end
        order = np.argsort(start_raw, kind="stable")
        start_raw = start_raw[order]
        target_raw = target_raw[order]
        is_id = is_id[order]
        depth = depth[order]
        start = np.where((start_raw < 0) | (start_raw >= pn), dummy, start_raw)
        target = np.where((target_raw < 0) | (target_raw >= pn), dummy, target_raw)

        direct = ig.direct_edge(start, target)
        # split by fan-out: one hot row would otherwise widen the whole
        # batch's D gather to [B, 32, 32]
        f0_deg = ig.set_out_indptr[start + 1] - ig.set_out_indptr[start]
        l_deg = np.where(
            is_id, ig.id_in_indptr[target + 1] - ig.id_in_indptr[target], 1
        )
        narrow = (f0_deg <= _NARROW_WIDTH) & (l_deg <= _NARROW_WIDTH)
        allowed = np.zeros(n, dtype=bool)
        overflow = np.zeros(n, dtype=bool)
        if narrow.all() or not narrow.any():
            parts = [np.arange(n)]
        else:
            parts = [np.nonzero(narrow)[0], np.nonzero(~narrow)[0]]
        for idx in parts:
            a, ov = self._query_rows(
                art, start[idx], target[idx], is_id[idx], depth[idx], direct[idx]
            )
            allowed[idx] = a
            overflow[idx] = ov

        # exact fallback for overflowing rows (wide F0/L fan-out)
        if overflow.any():
            idxs = np.nonzero(overflow)[0]
            if requests is not None:
                over_reqs = [requests[order[i]] for i in idxs]
            else:
                over_reqs = self._decode_requests(snap, start[idxs], target[idxs])
            res = self.fallback_engine().batch_check(
                over_reqs, depths=[int(depth[i]) for i in idxs]
            )
            allowed[idxs] = res
        out = np.empty(n, dtype=bool)
        out[order] = allowed
        return out

    def _query_rows(
        self, art, start, target, is_id, depth, direct
    ) -> tuple[np.ndarray, np.ndarray]:
        """Gather + closure query for one fan-out class of rows. Returns
        (allowed, overflow) for the subset."""
        ig = art.ig
        f0_w = self._adaptive_width(ig.set_out_indptr, start, self.f0_max)
        l_w = self._adaptive_width(ig.id_in_indptr, target, self.l_max)
        f0, f0_over = gather_padded_rows(
            ig.set_out_indptr, ig.set_out_vals, start, f0_w, art.pad
        )
        l, l_over = gather_padded_rows(
            ig.id_in_indptr, ig.id_in_vals, target, l_w, art.pad
        )
        # set targets: L = {target} when the target is itself interior
        set_rows = ~is_id
        if set_rows.any():
            t_int = ig.interior_index[target[set_rows]]
            l[set_rows] = art.pad
            l[set_rows, 0] = np.where(t_int >= 0, t_int, art.pad)
        l_over &= is_id  # set-target rows never overflow
        dev = self.device
        allowed = closure_query(
            art.d,
            torch.from_numpy(f0).to(dev),
            torch.from_numpy(l).to(dev),
            torch.from_numpy(is_id.astype(np.int32)).to(dev),
            torch.from_numpy(depth).to(dev),
            torch.from_numpy(direct).to(dev),
        )
        return allowed.cpu().numpy(), f0_over | l_over

    @staticmethod
    def _adaptive_width(indptr, rows, cap: int) -> int:
        """The subset's max degree, bucketed to a power of two, capped."""
        deg_max = int(np.max(indptr[rows + 1] - indptr[rows]))
        width = 1 << max(deg_max - 1, 0).bit_length() if deg_max > 1 else 1
        return min(max(width, 1), cap)
