"""Closure check engine: a snapshot-time closure, gather-only queries
(counterpart of ``keto_tpu/engine/closure.py``).

The engine pays the graph traversal ONCE per snapshot — a bounded
all-pairs-distance closure ``D`` over the small interior subgraph
(``graph/interior.py``), built on the device by the masked-SpMV kernel
(``engine/masked_spmv.py``) — and answers every check of the snapshot's
lifetime with gathers:

    host    encode requests -> (start, target) node ids     (vocab probe)
    host    F0/L CSR row gathers + direct-edge hash probe   (numpy)
    device  D[F0 x L] gather, min-reduce, depth compare     (ops.closure)

The encode hashes the requests in one C loop where the native host tier
(``native/``) loads; in host query mode the C tier's ``closure_check``
fuses the direct-edge probe and the D gathers of the last two lines into
one prefetched pass over the host D, with no width caps. Without a C
compiler both fall back to their numpy twins.

Correctness contract is identical to the host oracle (CheckEngine): allowed
iff a tuple path of length <= depth exists.

Query placement (``query_mode``): ``device`` keeps D on the engine's device
and answers each batch with one gather there; ``host`` keeps D as a
writable numpy array and answers from it with no device work at all, which
is what a forked read replica needs (``driver/replicas.py``: a forked
child cannot touch CUDA). ``auto`` probes the card's round trip on a CUDA
device (``_probe_roundtrip_slow``) and picks; on a CPU torch device it
resolves to ``device``, so the plain versions of the device path run
there. Placement changes where D lives, never an answer. In host mode the
default ``semiring`` builder builds D on the host (``engine/semiring.py``)
and the ``matmul`` builder builds it on the device
(``ops.closure.build_closure_packed``) and downloads it once.

Writes are absorbed by the write overlay (``engine/overlay.py``), which
subscribes to the store's delta feed and keeps answers exact at the live
store version without a rebuild: leaf and boundary edges as per-node
deltas, interior inserts and deletes as patches of ``D``. When the overlay
cannot absorb a write (a budget, a bulk load), ``freshness`` decides:

- ``strong``  — the next check rebuilds synchronously before answering;
- ``bounded`` — checks keep serving the previous closure (and its
  overlay) while a background thread rebuilds; ``served_version()`` names
  the store version that answered, so the snaptoken is honest;
- ``auto``    — strong below ``strong_freshness_edges`` live edges,
  bounded above it.

An append-only delta whose new interior edges (at most 8) connect existing
interior nodes rebuilds incrementally, in O(M^2) per edge
(``ops.closure.closure_insert_edge``, or its host twin with the D^T carry).
In host mode a larger delta over the same interior node set, deletes
included, takes the dirty-row rebuild (``_semiring_incremental``), which
re-runs the BFS of only the rows the delta can reach. The background
rebuild runs on the
same CUDA stream as the queries, so a query never reads a ``D`` whose
build has not finished on the card; queries issued meanwhile queue behind
the build's launches.

The list path (``engine/listing.py``) reads the reverse residency: the
transposed closure ``D^T``, next to ``D`` on the card, and the reverse
boundary CSRs (``graph/reverse.py``), both built lazily on the first list
query against a snapshot (``reverse_artifacts``). A write the overlay has
absorbed forces a rebuild there, since the reverse CSRs are snapshot-time.

A ``CheckColumns`` batch (``batch_check_columns``) takes the same path with
no tuple objects, and ``check_ids`` takes pre-encoded vocab ids (the
id-native wire tier).

Integrity and supervision seams: ``reset_residency`` drops the resident
closure (D, D^T and the overlay) and rebuilds it synchronously (the
scrubber's repair, the device supervisor's re-init), and
``scrub_residency`` holds a random sample of resident rows against a host
BFS of the snapshot (``engine/scrub.py``; the ``scrub.device_bitflip``
fault site poisons the serving D in place first). ``rebuild_gate`` holds a
background rebuild until the device has memory headroom
(``HbmAdmission.wait_for_headroom``), and ``reverse_residency_cb`` reports
a device-resident D^T's bytes to the same admission. ``set_host_queries``
moves the residency between the card and host memory at the next build:
the device supervisor's CPU failover.

Telemetry, as in the reference: with a metrics registry the engine counts
``keto_checks_total``, ``keto_check_batch_seconds`` and
``keto_closure_builds_total{kind}`` (``full``, ``incremental``); with a
tracer a build runs under ``closure.build`` with the child spans
``snapshot.encode``, ``closure.interior``, ``closure.blocks`` (the host
semiring builder's independent blocks), ``closure.semiring`` and
``closure.matmul``. A deliberate difference from the reference: a build on
the card waits on a CUDA event recorded after its last launch before it
closes ``closure.semiring`` (or ``closure.matmul``) and reads the phase, so
the span and ``last_build_phases["kernel"]`` time the kernels, not their
queueing. The build runs on the rebuild worker or in the warmup (under
strong freshness, on the check that is waiting for it anyway), so the wait
holds up no check that would not wait for the build. The device semiring
build needs no block decomposition, so it has no ``closure.blocks`` span.

Rows whose F0/L fan-out overflows the padded width, and snapshots whose
interior exceeds ``interior_limit`` (D is O(M^2) bytes), are answered by an
exact fallback engine — by default the host BFS oracle over the same store.
"""

from __future__ import annotations

import logging
import os
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Optional, Sequence, Union

import numpy as np
import torch

from .. import native
from ..faults import FAULTS
from ..graph.interior import (
    InteriorGraph,
    build_interior,
    gather_padded_rows,
    interior_blocks,
)
from ..graph.reverse import ReverseIndex, build_reverse
from ..graph.snapshot import GraphSnapshot, SnapshotManager
from ..ops.closure import (
    INF_DIST,
    build_closure_packed,
    closure_insert_edge,
    closure_insert_edge_host,
    closure_query,
    pack_adjacency,
)
from ..relationtuple.definitions import RelationTuple, SubjectID, SubjectSet
from ..telemetry.tracing import NOOP_TRACER
from ..utils.errors import ErrUnavailable
from ..utils.kernels import resolve_device
from .check import DEFAULT_MAX_DEPTH, CheckEngine
from .masked_spmv import build_closure_semiring
from .overlay import WriteOverlay
from .semiring import (
    _bfs_rows_into,
    build_closure_bitset,
    transpose_closure,
    update_closure_bitset_ex,
    update_transpose,
)

# the closure stores distances in uint8 with INF_DIST=255 reserved, so the
# deepest resolvable path is 254 interior steps
_MAX_CLOSURE_DEPTH = INF_DIST

# up to this many appended interior edges the per-edge O(M^2) relax is
# cheaper than a full rebuild
_MAX_INCR_EDGES = 8

# rows whose F0 and L fan-outs both fit this width take the narrow gather
# path; the heavy tail is processed separately at full width
_NARROW_WIDTH = 8

# spare D rows reserved for overlay-grown interior nodes (new subject sets
# gaining their first in-edge) between rebuilds
_GROW_RESERVE = 512

# a host-to-device-to-host round trip slower than this puts queries on the
# host
_PROBE_SLOW_S = 0.005

# how long a check waits for a write's delta to reach the engine once the
# store has made the write's version visible (normally microseconds)
_DELIVERY_WAIT_S = 5.0

_log = logging.getLogger("keto_tpu_torch.engine")


def _m_pad_for(m: int) -> int:
    """Padded closure width for a live interior of m nodes: at least one
    INF row (the PAD index) plus the grow reserve, bucketed to 256."""
    n = m + 1 + _GROW_RESERVE
    return ((n + 255) // 256) * 256


def _scrub_expected_rows(
    adj_packed: np.ndarray, rows: np.ndarray, m_pad: int, k_max: int
) -> np.ndarray:
    """Host truth for a sampled set of closure rows: the masked-SpMV BFS of
    the host semiring build (``engine/semiring.py``) into a compact
    (n, m_pad) array, so scrubbing a handful of rows never allocates the
    full m_pad^2 matrix. Diagonal 0 for the (live) sampled rows, INF
    elsewhere — byte-identical to every closure build."""
    n = len(rows)
    exp = np.full((n, m_pad), INF_DIST, dtype=np.uint8)
    if n:
        _bfs_rows_into(exp, adj_packed, adj_packed.any(axis=1), rows, m_pad, k_max,
                       out_rows=np.arange(n))
        # diagonal last, as the builders do: a cycle's BFS distance back to
        # the source is overwritten by the 0 self-distance
        exp[np.arange(n), rows] = 0
    return exp


def _probe_roundtrip_slow(device: torch.device) -> bool:
    """Tiny host-to-device-to-host round trips on `device`; True when the
    link is latency-bound and per-batch device queries would drown in it.
    The median of several probes, so one scheduling hiccup at first use
    does not pin a local card to host mode for the process's lifetime. The
    decision is logged."""
    (torch.zeros(8).to(device) + 1).cpu()  # warm any lazy initialisation
    samples = []
    for _ in range(5):
        t0 = time.perf_counter()
        (torch.ones(8).to(device) + 1).cpu()
        samples.append(time.perf_counter() - t0)
    rt = float(np.median(samples))
    slow = rt > _PROBE_SLOW_S
    _log.info(
        "query placement probe: median roundtrip %.2fms over %d samples "
        "(threshold %.0fms) -> query_mode=%s",
        1000 * rt,
        len(samples),
        1000 * _PROBE_SLOW_S,
        "host" if slow else "device",
    )
    return slow


class _ClosureArtifacts:
    """Per-snapshot residency: the snapshot, its interior decomposition, the
    closure matrix D (``d`` on the device, or ``d_host``, a writable numpy
    array, in host query mode) and, once a list query asks or an
    incremental build carries it, the reverse residency (D^T beside D, the
    reverse boundary CSRs)."""

    def __init__(
        self,
        snap: GraphSnapshot,
        ig: InteriorGraph,
        k_max: int,
        d: Optional[torch.Tensor] = None,
        d_host: Optional[np.ndarray] = None,
        d_rev: Optional[np.ndarray] = None,
    ):
        self.snap = snap
        self.ig = ig
        self.k_max = k_max
        self.m_pad = _m_pad_for(ig.m)
        self.pad = self.m_pad - 1
        self.d = d
        self.d_host = d_host
        # reverse residency, built by ClosureCheckEngine._ensure_reverse (or
        # carried by a host incremental build). rev_lock pairs D with d_rev:
        # a device patch swaps d and drops d_rev under it, a host patch
        # writes d_host and mirrors onto d_rev under it, so a D^T is always
        # the transpose of the current D
        self.d_rev = d_rev
        self.rev: Optional[ReverseIndex] = None
        self.rev_lock = threading.Lock()

    @property
    def version(self) -> int:
        return self.snap.version

    @property
    def num_edges(self) -> int:
        return self.snap.num_edges


@dataclass(frozen=True)
class ReverseView:
    """What one list query reads: a snapshot's decomposition and reverse
    CSRs with one consistent (D, D^T) pair, taken together under the
    artifacts' rev_lock (an overlay patch may swap ``art.d`` right after)."""

    snap: GraphSnapshot
    ig: InteriorGraph
    rev: ReverseIndex
    d: Union[torch.Tensor, np.ndarray]  # numpy in host query mode
    d_rev: Union[torch.Tensor, np.ndarray]

    @property
    def version(self) -> int:
        return self.snap.version


@dataclass
class _TooBig:
    """Snapshot whose interior exceeds the closure limit (or whose depth
    exceeds the uint8 range): checks route to the exact fallback engine,
    which reads the live store."""

    version: int
    num_edges: int


_State = Union[_ClosureArtifacts, _TooBig]


class _ColumnRows:
    """A ``CheckColumns`` batch indexed like a list of requests: the
    overflow rows of a columnar batch materialize one tuple each."""

    __slots__ = ("cols",)

    def __init__(self, cols):
        self.cols = cols

    def __getitem__(self, i) -> RelationTuple:
        return self.cols.tuple_at(int(i))


class ClosureCheckEngine:
    def __init__(
        self,
        snapshots: SnapshotManager,
        max_depth: int = DEFAULT_MAX_DEPTH,
        interior_limit: int = 16384,
        f0_max: int = 32,
        l_max: int = 32,
        query_mode: str = "auto",  # auto | host | device
        freshness: str = "auto",  # auto | strong | bounded
        builder: str = "auto",  # auto | matmul | semiring
        block_workers: int = 0,  # host semiring build threads (0 = auto)
        strong_freshness_edges: int = 1 << 21,
        rebuild_debounce_s: float = 0.05,
        rebuild_gate=None,  # zero-arg callable run before each background
        # rebuild (blocks until the device has room for one)
        device=None,
        tracer=None,
        metrics=None,
    ):
        if query_mode not in ("auto", "host", "device"):
            raise ValueError(f"unknown query_mode {query_mode!r}")
        if freshness not in ("auto", "strong", "bounded"):
            raise ValueError(f"unknown freshness {freshness!r}")
        if builder not in ("auto", "matmul", "semiring"):
            raise ValueError(f"unknown builder {builder!r}")
        self.device = resolve_device(device)
        self.query_mode = query_mode
        self._host_queries: Optional[bool] = (
            None if query_mode == "auto" else query_mode == "host"
        )
        # the closure build: "semiring" = the masked-SpMV BFS (kernel B1 on
        # the device, engine/semiring.py on the host), "matmul" = the dense
        # product ladder on the device (downloaded once in host mode);
        # "auto" = semiring
        self.builder = "semiring" if builder == "auto" else builder
        self.block_workers = block_workers
        # forked read replicas clear this: a replica past its overlay serves
        # from the live-store oracle instead of building (a forked child
        # must not touch CUDA, and it owns no build worth sharing)
        self.allow_device_builds = True
        self._fallback_logged = False
        self.snapshots = snapshots
        self.global_max_depth = max_depth
        self.interior_limit = interior_limit
        self.f0_max = f0_max
        self.l_max = l_max
        self.freshness = freshness
        self.strong_freshness_edges = strong_freshness_edges
        self.rebuild_debounce_s = rebuild_debounce_s
        self._rebuild_gate = rebuild_gate
        self._fallback: Optional[CheckEngine] = None
        self._lock = threading.Lock()  # guards _rebuilding
        self._build_lock = threading.Lock()  # serializes state builds
        self._state_cv = threading.Condition()  # notified on state swap
        # the newest version the store's delta feed has handed this engine
        # (to whichever overlay was live), guarded by _state_cv
        self._handed_upto = 0
        self._state: Optional[_State] = None
        self._rebuilding = False
        # write overlay: exact serving-time deltas over the resident
        # closure (engine/overlay.py), fed by the store's delta feed;
        # subscribed weakly so a dead engine neither leaks nor taxes writes
        self._overlay: Optional[WriteOverlay] = None
        subscribe = getattr(snapshots.store, "subscribe_deltas", None)
        if subscribe is not None:
            ref = weakref.ref(self)
            store = snapshots.store

            def _cb(version, inserted, deleted, _ref=ref, _store=store):
                eng = _ref()
                if eng is None:
                    _store.unsubscribe_deltas(_cb)
                    return
                eng._on_delta(version, inserted, deleted)

            subscribe(_cb)
        # reverse residency for the list path (engine/listing.py); the
        # registry sets reverse_enabled from engine.reverse_index and points
        # reverse_residency_cb at HbmAdmission.set_reverse_residency, so a
        # device-resident D^T is charged against the memory budget
        self.reverse_enabled = True
        self.reverse_residency_cb = None  # callable(bytes) or None
        self.last_reverse_build_s = 0.0
        # build telemetry (read by tests and the smoke run)
        self.n_full_builds = 0
        self.n_incremental_builds = 0
        # seconds of the most recent build: snapshot_encode / interior /
        # blocks / kernel, matmul or incremental / total
        self.last_build_phases: dict[str, float] = {}
        self.last_dirty_rows = 0  # rows the last dirty-row rebuild re-ran
        self.closure_built_at: Optional[float] = None  # the graph panel's age
        self.tracer = tracer if tracer is not None else NOOP_TRACER
        if metrics is not None:
            self._m_checks = metrics.counter(
                "keto_checks_total", "checks evaluated by the engine"
            )
            self._m_batch_s = metrics.histogram(
                "keto_check_batch_seconds", "engine batch evaluation time"
            )
            self._m_builds = metrics.counter(
                "keto_closure_builds_total",
                "closure builds by kind",
                labelnames=("kind",),
            )
        else:
            self._m_checks = self._m_batch_s = self._m_builds = None

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
        k_max = eng.global_max_depth - 1
        if eng.host_queries():
            art = _ClosureArtifacts(snap, ig, k_max, d_host=np.array(d, copy=True))
        else:
            art = _ClosureArtifacts(
                snap, ig, k_max, torch.from_numpy(np.array(d, copy=True)).to(eng.device)
            )
        eng._overlay = WriteOverlay(art)
        eng._state = art
        return eng

    def set_host_queries(self, host: bool) -> None:
        """Place queries (and D) on the host or on the device from the next
        residency build on; ``reset_residency`` applies it at once. The
        device supervisor's CPU failover: while the card is gone the
        closure lives in host memory, built by the numpy semiring builder,
        and answers are unchanged."""
        self._host_queries = bool(host)

    def host_queries(self) -> bool:
        """Whether queries read a host D. ``auto`` resolves once: on a CUDA
        device by the round-trip probe, on a CPU torch device to the device
        path (a placement choice; the answers are the same either way)."""
        if self._host_queries is None:
            if self.device.type == "cuda":
                self._host_queries = _probe_roundtrip_slow(self.device)
            else:
                self._host_queries = False
        return self._host_queries

    def fallback_engine(self) -> CheckEngine:
        """The exact engine for rows and snapshots D cannot answer: the
        host BFS oracle over the live store."""
        if self._fallback is None:
            self._fallback = CheckEngine(
                self.snapshots.store, max_depth=self.global_max_depth
            )
        return self._fallback

    def closure(self) -> Optional[np.ndarray]:
        """The serving closure D as a host array, overlay patches included
        (building it first when the policy requires), or None when the
        snapshot is served by the fallback."""
        state = self._serving()
        if not isinstance(state, _ClosureArtifacts):
            return None
        if state.d_host is not None:
            return state.d_host.copy()
        return state.d.cpu().numpy()

    # -- reverse residency (list serving) --------------------------------------

    def reverse_artifacts(self) -> Optional[ReverseView]:
        """The serving snapshot's reverse residency for the list path, or
        None when the reverse path cannot answer exactly: reverse serving
        is disabled (engine.reverse_index false) or no closure is resident
        (the snapshot is served by the fallback).

        A pinned write overlay is not a decline: the reverse boundary CSRs
        are snapshot-time, so a rebuild folds the overlay's deltas in here
        (``_build_sync``). Callers answer from the live-store oracle when
        this returns None."""
        if not self.reverse_enabled:
            return None
        state, pinned = self._serving_pinned()
        if pinned is not None:
            self._build_sync()
            state, pinned = self._serving_pinned()
        if pinned is not None or not isinstance(state, _ClosureArtifacts):
            return None
        return self._ensure_reverse(state)

    def _ensure_reverse(self, art: _ClosureArtifacts) -> ReverseView:
        """Build (or finish) `art`'s reverse residency, on the first list
        query against the snapshot, so closure builds pay nothing where no
        one lists: D^T next to D (one materialized transpose of the current
        D, on the card or in host memory; an incremental host build may have
        carried it already), and the reverse CSRs on the host."""
        with art.rev_lock:
            if art.rev is None or art.d_rev is None:
                t0 = time.perf_counter()
                if art.rev is None:
                    art.rev = build_reverse(art.snap, art.ig)
                if art.d_rev is None:
                    if art.d_host is not None:
                        art.d_rev = transpose_closure(art.d_host)
                    else:
                        art.d_rev = art.d.t().contiguous()
                        if art.d_rev.is_cuda:
                            torch.cuda.synchronize(art.d_rev.device)
                        # only a device D^T counts against the memory
                        # budget; the host transpose lives in ordinary RAM
                        cb = self.reverse_residency_cb
                        if cb is not None:
                            cb(art.d_rev.numel() * art.d_rev.element_size())
                self.last_reverse_build_s = time.perf_counter() - t0
            d = art.d_host if art.d_host is not None else art.d
            return ReverseView(art.snap, art.ig, art.rev, d, art.d_rev)

    # -- write overlay ---------------------------------------------------------

    def _on_delta(self, version, inserted, deleted) -> None:
        """Store delta feed (writer thread): enqueue onto the live overlay,
        no device work; classification and D patches run on the next
        query's drain."""
        ov = self._overlay
        if ov is not None:
            ov.enqueue(version, inserted, deleted)
        with self._state_cv:
            self._handed_upto = max(self._handed_upto, version)
            self._state_cv.notify_all()  # freshness waiters re-check

    # -- residency ------------------------------------------------------------

    def served_version(self) -> int:
        """The store version checks are currently answered at. Equals the
        live store version except in bounded freshness mid-rebuild, where it
        names the (older) snapshot still serving. An active write overlay
        advances it to the live version without any rebuild."""
        state = self._state
        if isinstance(state, _ClosureArtifacts):
            ov = self._overlay
            if ov is not None and ov.art is state:
                ov.drain()
                if not ov.broken:
                    return ov.version
            return state.version
        return self.snapshots.store.version

    def answering_version(self) -> int:
        """The version the NEXT check will be answered at. Differs from
        served_version under strong freshness right after a write the
        overlay cannot absorb: the serving state still names the old
        version, but the next check rebuilds and answers at the store's."""
        state = self._state
        store_version = self.snapshots.store.version
        if state is not None and state.version == store_version:
            return store_version
        if isinstance(state, _ClosureArtifacts):
            ov = self._overlay
            if ov is not None and ov.art is state:
                ov.drain()
                if ov.active(store_version):
                    return ov.version  # overlay-corrected: live-exact
        if self._bounded(state) and isinstance(state, _ClosureArtifacts):
            # serving stale while rebuilding — kick the rebuild here too,
            # so bounded staleness cannot turn unbounded. (_TooBig states
            # answer from the LIVE store and stamp store_version below.)
            self._kick_rebuild()
            return state.version
        return store_version  # synchronous rebuild / live-store fallback

    def _bounded(self, state: Optional[_State]) -> bool:
        if state is None:
            return False  # nothing to serve stale from: must build
        if self.freshness == "strong":
            return False
        if self.freshness == "bounded":
            return True
        return state.num_edges >= self.strong_freshness_edges

    def _serving(self) -> _State:
        """The serving state, for callers that need no overlay corrections."""
        return self._serving_pinned()[0]

    def _serving_pinned(self) -> tuple[_State, Optional[WriteOverlay]]:
        """The (state, pinned overlay) pair answering this batch — fresh,
        overlay-corrected (exact at the live version, no rebuild), or
        stale-with-rebuild under bounded freshness. Never stalls on a
        rebuild once a state exists and the policy is bounded.

        State and overlay are read together and returned as HELD
        references: re-reading self._overlay later would race the
        rebuild's generation swap and drop the corrections promised here."""
        while True:
            # read before the drain: every delta up to here was enqueued on
            # the overlay that was live when it was handed over
            handed = self._handed_upto
            state = self._state
            ov = self._overlay
            if not (
                isinstance(state, _ClosureArtifacts)
                and ov is not None
                and ov.art is state
            ):
                ov = None
            if ov is not None:
                ov.drain()
            store_version = self.snapshots.store.version
            pinned = ov if (ov is not None and ov.n_events) else None
            if state is not None and state.version == store_version:
                return state, pinned
            if ov is not None and ov.active(store_version):
                # every write since the snapshot is absorbed: serve the
                # resident closure + overlay corrections, exact at the
                # live version under ANY freshness policy
                if ov.n_events > ov.max_events // 2:
                    # proactive compaction: fold a large overlay back into
                    # a fresh closure in the background while it serves
                    self._kick_rebuild()
                return state, pinned
            if (
                ov is not None
                and not ov.broken
                and handed < store_version
                and self._delta_in_flight(store_version)
                and self._await_delta(store_version)
            ):
                continue  # the write's delta was handed over since: drain it
            if self._bounded(state):
                self._kick_rebuild()
                return state, pinned
            self._build_sync()
            # loop: re-read state AND overlay together for the fresh pin

    def _delta_in_flight(self, version: int) -> bool:
        """Whether this process's store enqueued the delta of ``version``
        (``OrderedNotifier.enqueued_upto``), so that waiting for its
        hand-over can succeed. A version written by another process on a
        shared SQL database (a spawned read worker's store) has no delta
        here: the engine rebuilds at once instead of waiting out
        ``_DELIVERY_WAIT_S``."""
        enqueued = getattr(self.snapshots.store, "enqueued_upto", None)
        return enqueued is None or enqueued >= version

    def _await_delta(self, version: int) -> bool:
        """The store bumps its version under its lock and hands the write's
        delta to its listeners (this engine among them) after releasing it,
        so a check can see a version whose delta has not reached the engine
        yet. Wait for that hand-over instead of rebuilding (a forked
        replica, which may not build, would otherwise answer from the live
        store for good); False at the deadline. Called only while the
        version is ahead of every delta handed over, so a delta that went
        to an overlay swapped out since (_build_sync) rebuilds instead of
        waiting again."""
        deadline = time.monotonic() + _DELIVERY_WAIT_S
        with self._state_cv:
            while self._handed_upto < version:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._state_cv.wait(timeout=remaining)
        return True

    def _build_sync(self) -> _State:
        with self._build_lock:
            state = self._state
            if state is not None and state.version == self.snapshots.store.version:
                return state  # a concurrent builder got there first
            t_snap = time.perf_counter()
            with self.tracer.span("snapshot.encode"):
                snap = self.snapshots.snapshot()
            snap_s = time.perf_counter() - t_snap
            state = self._build_state(snap, prev=state)
            self.last_build_phases["snapshot_encode"] = snap_s
            self.last_build_phases["total"] += snap_s
            if isinstance(state, _ClosureArtifacts):
                # fresh overlay generation for the new residency. A delta
                # racing this swap may land on the outgoing overlay and be
                # missed here; the new overlay then sees a version gap and
                # breaks — a conservative rebuild, never a wrong answer.
                self._overlay = WriteOverlay(state)
            else:
                self._overlay = None
            self._state = state
            self.closure_built_at = time.time()
            with self._state_cv:
                self._state_cv.notify_all()  # wake wait_for_version
            return state

    def _kick_rebuild(self) -> None:
        with self._lock:
            if self._rebuilding:
                return
            self._rebuilding = True
        threading.Thread(
            target=self._rebuild_worker, name="closure-rebuild", daemon=True
        ).start()

    def _rebuild_worker(self) -> None:
        try:
            while True:
                if self.rebuild_debounce_s > 0:
                    time.sleep(self.rebuild_debounce_s)  # coalesce bursts
                if self._rebuild_gate is not None:
                    # hold the rebuild's device peak off in-flight batch
                    # memory; the gate times out rather than starving the
                    # rebuild, so staleness stays bounded either way
                    try:
                        self._rebuild_gate()
                    except Exception:
                        _log.exception("rebuild gate failed; rebuilding anyway")
                state = self._build_sync()
                # exit check and flag clear are atomic wrt _kick_rebuild:
                # otherwise a write landing between them would see
                # _rebuilding=True, skip the kick, and strand a stale state
                with self._lock:
                    if self.snapshots.store.version == state.version:
                        self._rebuilding = False
                        return
        except BaseException:
            with self._lock:
                self._rebuilding = False
            raise

    def _build_state(
        self, snap: GraphSnapshot, prev: Optional[_State]
    ) -> _State:
        t_build = time.perf_counter()
        phases: dict[str, float] = {}
        self.last_build_phases = phases
        with self.tracer.span(
            "closure.build", edges=snap.num_edges, version=snap.version
        ) as span:
            state = self._build_state_in(snap, prev, phases, span)
            phases["total"] = time.perf_counter() - t_build
            return state

    def _build_state_in(
        self, snap: GraphSnapshot, prev: Optional[_State], phases: dict, span
    ) -> _State:
        if not self.allow_device_builds:
            # a forked replica past its overlay: no build, exact answers from
            # the live store. Checked before build_interior: the O(E) scan
            # would be discarded, and rebuild kicks recur per write
            span.set_attr("kind", "replica-fallback")
            if not self._fallback_logged:
                self._fallback_logged = True
                _log.warning(
                    "read replica pid %d is past its write overlay and may not "
                    "build: answering from the live store", os.getpid(),
                )
            return _TooBig(version=snap.version, num_edges=snap.num_edges)
        t0 = time.perf_counter()
        with self.tracer.span("closure.interior"):
            ig = build_interior(snap)
        phases["interior"] = time.perf_counter() - t0
        span.set_attr("interior", ig.m)
        if ig.m > self.interior_limit or self.global_max_depth > _MAX_CLOSURE_DEPTH:
            # depths beyond the uint8 distance range cannot be resolved by
            # the closure: exact fallback for the whole snapshot
            span.set_attr("kind", "fallback")
            return _TooBig(version=snap.version, num_edges=snap.num_edges)
        k_max = self.global_max_depth - 1
        host = self.host_queries()
        if isinstance(prev, _ClosureArtifacts):
            new_ii = self._appended_interior_edges(prev, snap, ig)
            if new_ii is not None and len(new_ii) <= _MAX_INCR_EDGES:
                self._count_build("incremental", span)
                t0 = time.perf_counter()
                art = self._incremental_artifacts(prev, snap, ig, k_max, new_ii)
                phases["incremental"] = time.perf_counter() - t0
                return art
            if (
                self.builder != "matmul"
                and host
                and prev.d_host is not None
                and self._same_interior(prev, snap, ig)
            ):
                # a larger delta (or deletes) over an unchanged interior node
                # set: the dirty-row rebuild, bounded by the delta's reach
                return self._semiring_incremental(prev, snap, ig, k_max, phases, span)
        self._count_build("full", span)
        m_pad = _m_pad_for(ig.m)
        if self.builder == "semiring" and host:
            t0 = time.perf_counter()
            with self.tracer.span("closure.blocks", interior=ig.m):
                blocks = interior_blocks(ig)
            phases["blocks"] = time.perf_counter() - t0
            span.set_attr("blocks", blocks.n_blocks)
            t0 = time.perf_counter()
            with self.tracer.span("closure.semiring", interior=ig.m):
                d_host = build_closure_bitset(
                    ig.ii_src, ig.ii_dst, ig.m, m_pad, k_max,
                    workers=self._build_workers(), blocks=blocks,
                )
            phases["kernel"] = time.perf_counter() - t0
            return _ClosureArtifacts(snap, ig, k_max, d_host=d_host)
        t0 = time.perf_counter()
        semiring = self.builder == "semiring"
        with self.tracer.span(
            "closure.semiring" if semiring else "closure.matmul", interior=ig.m
        ):
            packed = pack_adjacency(ig.ii_src, ig.ii_dst, m_pad)
            build = build_closure_semiring if semiring else build_closure_packed
            d = build(packed, ig.m, m_pad=m_pad, k_max=k_max, device=self.device)
            if d.is_cuda:
                # the span and the phase close when the card has run the
                # last launch, not when it was queued
                done = torch.cuda.Event()
                done.record()
                done.synchronize()
        if host:
            # the matmul builder in host mode: one download, then the device
            # copy is dropped (the host copy is writable: the overlay
            # patches it in place)
            art = _ClosureArtifacts(snap, ig, k_max, d_host=d.cpu().numpy())
        else:
            art = _ClosureArtifacts(snap, ig, k_max, d)
        phases["kernel" if semiring else "matmul"] = time.perf_counter() - t0
        return art

    def _count_build(self, kind: str, span) -> None:
        if kind == "full":
            self.n_full_builds += 1
        else:
            self.n_incremental_builds += 1
        span.set_attr("kind", kind)
        if self._m_builds is not None:
            self._m_builds.labels(kind=kind).inc()

    def _build_workers(self) -> int:
        if self.block_workers > 0:
            return self.block_workers
        return min(8, max(1, (os.cpu_count() or 1) // 2))

    @staticmethod
    def _same_interior(
        prev: _ClosureArtifacts, snap: GraphSnapshot, ig: InteriorGraph
    ) -> bool:
        """D depends only on the interior adjacency over a stable interior
        index space: the same vocab object (interning is append-only), the
        same padded width, the same interior node set. Any edge delta over
        it is then updatable row by row."""
        old = prev.snap
        return (
            snap.vocab is old.vocab
            and snap.padded_nodes == old.padded_nodes
            and np.array_equal(ig.interior_ids, prev.ig.interior_ids)
        )

    def _semiring_incremental(
        self,
        prev: _ClosureArtifacts,
        snap: GraphSnapshot,
        ig: InteriorGraph,
        k_max: int,
        phases: dict,
        span,
    ) -> _ClosureArtifacts:
        """The dirty-row closure update for any interior edge delta
        (engine/semiring.py): a reverse BFS finds the rows the delta can
        reach, and only those are re-run on the new adjacency."""
        t0 = time.perf_counter()
        blocks = interior_blocks(prev.ig)
        phases["blocks"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        d_host, rows = update_closure_bitset_ex(
            prev.d_host, prev.ig.ii_src, prev.ig.ii_dst, ig.ii_src, ig.ii_dst,
            ig.m, prev.m_pad, k_max,
            workers=self._build_workers(), blocks=blocks,
        )
        phases["kernel"] = phases["incremental"] = time.perf_counter() - t0
        self.last_dirty_rows = int(rows.size)
        self._count_build("incremental", span)
        span.set_attr("dirty_rows", int(rows.size))
        # carry D^T: the dirty rows of D are the dirty columns of D^T. Sound
        # because prev.d_rev is always prev.d_host's transpose: the overlay
        # mirrors every in-place patch of D onto it
        d_rev = None
        with prev.rev_lock:
            if prev.d_rev is not None:
                t0 = time.perf_counter()
                d_rev = update_transpose(prev.d_rev, d_host, rows)
                phases["reverse_incremental"] = time.perf_counter() - t0
        return _ClosureArtifacts(snap, ig, k_max, d_host=d_host, d_rev=d_rev)

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

    def _incremental_artifacts(
        self,
        prev: _ClosureArtifacts,
        snap: GraphSnapshot,
        ig: InteriorGraph,
        k_max: int,
        new_ii: np.ndarray,
    ) -> _ClosureArtifacts:
        """Reuse the resident closure: one exact O(M^2) relax per appended
        interior edge instead of a build. build_interior has already
        rebuilt the CSRs; only D (and, on the host, D^T) carries over."""
        if prev.d_host is None:
            d = prev.d
            for u, v in new_ii:
                d = closure_insert_edge(d, int(u), int(v), k_max)
            return _ClosureArtifacts(snap, ig, k_max, d)
        # inserting (u, v) into D is the same relax as inserting (v, u)
        # into D^T, so the transpose is carried with no re-transpose
        with prev.rev_lock:
            d_host, d_rev = prev.d_host, prev.d_rev
            if len(new_ii):
                d_host = d_host.copy()
                d_rev = d_rev.copy() if d_rev is not None else None
        for u, v in new_ii:
            closure_insert_edge_host(d_host, int(u), int(v), k_max)
            if d_rev is not None:
                closure_insert_edge_host(d_rev, int(v), int(u), k_max)
        return _ClosureArtifacts(snap, ig, k_max, d_host=d_host, d_rev=d_rev)

    def warmup(self, batch: int = 1) -> None:
        """Build the closure for the current snapshot and run the query path
        once at one row and once at `batch` rows (serve paths call this at
        boot, so the first live request pays neither the build nor the
        device's first-launch costs at the largest batch)."""
        dummy = RelationTuple(
            namespace="", object="", relation="",
            subject=SubjectSet(namespace="", object="", relation=""),
        )
        self.batch_check([dummy])
        if (
            batch > 1
            and isinstance(self._state, _ClosureArtifacts)
            and not self.host_queries()
        ):
            self.batch_check([dummy] * batch)

    # -- integrity scrubbing (engine/scrub.py) ---------------------------------

    def reset_residency(self) -> None:
        """Drop the resident closure (D, the lazy D^T, and the write
        overlay) and rebuild synchronously from the store — the scrubber's
        quarantine + re-upload seam, and the device supervisor's re-init."""
        with self._build_lock:
            self._state = None
            self._overlay = None
        self._build_sync()

    def scrub_residency(self, sample_rows: int = 64, rng=None):
        """Hold a random sample of resident closure rows against host truth
        (the masked-SpMV BFS of the host builder over the snapshot's
        interior adjacency). Returns a report dict, or None when there is
        nothing scrubbable right now:

        - no resident closure (the fallback state, or not built), or
        - the residency is not quiescent — the state lags the live store
          version or the write overlay holds absorbed corrections. The
          overlay patches D in place *by design*, so a patched D diverging
          from the pure snapshot closure is not corruption; scrubbing
          resumes after the next rebuild folds it in.

        The ``scrub.device_bitflip`` fault site fires here: it poisons one
        element of the serving copy in place (the tensor on the card, or
        the host D), so a drill proves that the sampled comparison detects
        and the repair restores the buffer queries read."""
        state = self._state
        if not isinstance(state, _ClosureArtifacts):
            return None
        if state.version != self.snapshots.store.version:
            return None
        ov = self._overlay
        if ov is not None and ov.art is state:
            ov.drain()
            if ov.n_events or ov.broken:
                return None
        ig, m_pad = state.ig, state.m_pad
        if ig.m == 0:
            return {"sampled": 0, "version": state.version,
                    "bad_rows": [], "bad_rev_rows": []}
        if rng is None:
            rng = np.random.default_rng()
        if FAULTS.should_fire("scrub.device_bitflip"):
            r = int(rng.integers(ig.m))
            c = int(rng.integers(m_pad))
            if state.d_host is not None:
                cur = int(state.d_host[r, c])
                state.d_host[r, c] = 0 if cur else 1
            else:
                cur = int(state.d[r, c])
                state.d[r, c] = 0 if cur else 1
        n = min(max(1, int(sample_rows)), ig.m)
        rows = np.sort(rng.choice(ig.m, size=n, replace=False).astype(np.int64))
        packed = pack_adjacency(ig.ii_src, ig.ii_dst, m_pad)
        expected = _scrub_expected_rows(packed, rows, m_pad, state.k_max)
        if state.d_host is not None:
            served = state.d_host[rows]
        else:
            served = state.d[torch.from_numpy(rows).to(state.d.device)].cpu().numpy()
        diff = np.any(served != expected, axis=1)
        bad_rows = [int(r) for r in rows[diff]]
        # cross-check the transposed residency when the list path built
        # it: D^T[:, r] must equal D's recomputed row r
        bad_rev_rows: list[int] = []
        with state.rev_lock:
            d_rev = state.d_rev
        if d_rev is not None:
            if isinstance(d_rev, np.ndarray):
                rev_rows = d_rev[:, rows].T
            else:
                rev_rows = d_rev[:, torch.from_numpy(rows).to(d_rev.device)].t().cpu().numpy()
            rev_diff = np.any(rev_rows != expected, axis=1)
            bad_rev_rows = [int(r) for r in rows[rev_diff]]
        return {
            "sampled": int(n),
            "version": state.version,
            "resident": "host" if state.d_host is not None else "device",
            "bad_rows": bad_rows,
            "bad_rev_rows": bad_rev_rows,
        }

    def device_view(self) -> "ClosureCheckEngine":
        """A second engine over the same snapshots that serves the same
        resident closure with ``query_mode="device"``: one upload of D
        instead of a second build. It measures the device query path beside
        the host one; the serving registry keeps the engine it built."""
        if self._state is None:
            self._serving_pinned()  # the first build
        state = self._state
        if not isinstance(state, _ClosureArtifacts):
            raise RuntimeError("no resident closure to view (fallback state)")
        eng = ClosureCheckEngine(
            self.snapshots,
            max_depth=self.global_max_depth,
            interior_limit=self.interior_limit,
            f0_max=self.f0_max,
            l_max=self.l_max,
            query_mode="device",
            freshness=self.freshness,
            device=self.device,
        )
        # a copy even on the CPU: the overlay patches d_host in place
        d = state.d if state.d is not None else torch.tensor(state.d_host, device=self.device)
        eng._state = _ClosureArtifacts(state.snap, state.ig, state.k_max, d)
        return eng

    # -- public API -----------------------------------------------------------

    def subject_is_allowed(
        self, requested: RelationTuple, max_depth: int = 0
    ) -> bool:
        return self.batch_check([requested], max_depth)[0]

    def wait_for_version(self, min_version: int, timeout_s: float = 30.0) -> None:
        """Block until checks are answered at >= min_version (clamped to
        the store's current version): the at-least-as-fresh half of the
        snaptoken contract. Under strong freshness this returns at once
        (the next check rebuilds anyway); under bounded freshness it kicks
        the background rebuild once and waits on the state-swap condition.
        Raises ErrUnavailable (503) when the snapshot cannot catch up
        within the deadline."""
        target = min(min_version, self.snapshots.store.version)
        deadline = time.monotonic() + timeout_s
        kicked = False
        while True:
            state = self._state
            if state is None or not isinstance(state, _ClosureArtifacts):
                return  # fallback/first-build paths answer from live data
            if state.version >= target:
                return
            ov = self._overlay
            if ov is not None and ov.art is state:
                ov.drain()
                if not ov.broken and ov.version >= target:
                    return  # overlay absorbs the writes: already fresh
            if not self._bounded(state):
                return  # strong freshness: the check itself rebuilds
            if not kicked:
                self._kick_rebuild()
                kicked = True
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise ErrUnavailable(
                    f"snapshot did not reach version {target} within "
                    f"{timeout_s:.1f}s (serving {state.version})"
                )
            with self._state_cv:
                if self._state is state:  # not yet swapped: sleep on it
                    self._state_cv.wait(timeout=min(remaining, 1.0))

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
        return self.batch_check_array(requests, max_depth, depths).tolist()

    def batch_check_array(
        self,
        requests: Sequence[RelationTuple],
        max_depth: int = 0,
        depths: Optional[Sequence[int]] = None,
    ) -> np.ndarray:
        """``batch_check``'s answers as a bool array: the seam the device
        breaker validates by dtype and shape before one ``tolist``."""
        if not requests:
            return np.zeros(0, dtype=bool)
        t0 = time.perf_counter()
        state, pinned = self._serving_pinned()
        if not isinstance(state, _ClosureArtifacts):
            return np.array(
                self.fallback_engine().batch_check(
                    list(requests), max_depth,
                    None if depths is None else list(depths),
                ),
                dtype=bool,
            )
        n = len(requests)
        s_ids, t_ids, is_id = state.snap.vocab.lookup_requests(requests)
        depth = self._depths(n, max_depth, depths)
        allowed = self._check_arrays(
            state, s_ids, t_ids, is_id, depth, pinned, requests
        )
        self._count_checks(n, t0)
        return allowed

    def _count_checks(self, n: int, t0: float) -> None:
        if self._m_checks is not None:
            self._m_checks.inc(n)
            self._m_batch_s.observe(time.perf_counter() - t0)

    def batch_check_columns(
        self,
        cols,
        max_depth: int = 0,
        depths: Optional[Sequence[int]] = None,
    ) -> list[bool]:
        """Columnar batch check: the ``CheckColumns`` string lists are
        vocab-encoded directly (zipped key tuples -> lookup_bulk) with no
        ``RelationTuple``/``Subject`` objects on the answer path. Tuples
        materialize only on the oversized-interior fallback and, one row at
        a time, for the overflow rows ``_check_arrays`` hands the exact
        fallback."""
        if not len(cols):
            return []
        return self.batch_check_columns_array(cols, max_depth, depths).tolist()

    def batch_check_columns_array(
        self,
        cols,
        max_depth: int = 0,
        depths: Optional[Sequence[int]] = None,
    ) -> np.ndarray:
        """``batch_check_columns``'s answers as a bool array (the breaker's
        seam, as ``batch_check_array``)."""
        n = len(cols)
        if not n:
            return np.zeros(0, dtype=bool)
        t0 = time.perf_counter()
        state, pinned = self._serving_pinned()
        if not isinstance(state, _ClosureArtifacts):
            # interior too large for a closure: the exact fallback, the only
            # path that needs every row as a tuple object
            return np.array(
                self.fallback_engine().batch_check(
                    cols.materialize(), max_depth,
                    None if depths is None else list(depths),
                ),
                dtype=bool,
            )
        vocab = state.snap.vocab
        tkeys = cols.target_keys()
        s_ids = vocab.lookup_bulk(cols.start_keys())
        t_ids = vocab.lookup_bulk(tkeys)
        is_id = np.fromiter((len(k) == 1 for k in tkeys), dtype=bool, count=n)
        depth = self._depths(n, max_depth, depths)
        allowed = self._check_arrays(
            state, s_ids, t_ids, is_id, depth, pinned, _ColumnRows(cols)
        )
        self._count_checks(n, t0)
        return allowed

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
        state, pinned = self._serving_pinned()
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
        return self._check_arrays(state, start, target, is_id, depth, pinned)

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
        pinned_overlay: Optional[WriteOverlay] = None,
        requests: Optional[Sequence[RelationTuple]] = None,
    ) -> np.ndarray:
        """`start_raw`/`target_raw` are raw vocab ids (-1 unknown, or beyond
        this snapshot's width): the base path clamps both to the inert dummy
        node, while the write-overlay correction needs the real ids to see
        edges on nodes interned after the snapshot."""
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

        if art.d_host is not None and native.lib is not None:
            # the fused C kernel: the direct-edge probe and the true-degree
            # D gathers in one prefetched pass, exact for every row (no
            # width caps, so no oracle fallback on this path)
            allowed = native.closure_check(
                art.d_host, ig, start, target, is_id, depth
            )
            allowed = self._apply_overlay(
                pinned_overlay, allowed, start_raw, target_raw, is_id, depth
            )
            out = np.empty(n, dtype=bool)
            out[order] = allowed
            return out

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
        allowed = self._apply_overlay(
            pinned_overlay,
            allowed,
            start_raw,
            target_raw,
            is_id,
            depth,
            skip=overflow,  # oracle rows read the live store: already exact
        )
        out = np.empty(n, dtype=bool)
        out[order] = allowed
        return out

    @staticmethod
    def _apply_overlay(
        ov: Optional[WriteOverlay],
        allowed: np.ndarray,
        start_raw: np.ndarray,
        target_raw: np.ndarray,
        is_id: np.ndarray,
        depth: np.ndarray,
        skip: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Correct the (few) rows the pinned write overlay says may differ
        from the base closure answer — exact at the overlay's version."""
        if ov is None:
            return allowed
        mask = ov.affected_rows(start_raw, target_raw, is_id)
        if skip is not None:
            mask &= ~skip
        if mask.any():
            allowed[mask] = ov.check_rows(
                start_raw[mask], target_raw[mask], is_id[mask], depth[mask]
            )
        return allowed

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
        if art.d_host is not None:
            # the host twin of ops.closure.closure_query: the same math with
            # no device work (a forked replica never touches the card)
            sub = art.d_host[f0[:, :, None], l[:, None, :]]
            best = sub.min(axis=(1, 2)).astype(np.int32)
            best[best >= INF_DIST] = 1 << 30  # INF never satisfies a budget
            total = 1 + best + is_id.astype(np.int32)
            allowed = (direct & (depth >= 1)) | (total <= depth)
            return allowed, f0_over | l_over
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
