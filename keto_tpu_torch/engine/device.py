"""Frontier check engine: batched BFS over the whole tuple graph on the GPU
(counterpart of ``keto_tpu/engine/device.py``, its ``DeviceCheckEngine``).

``DeviceCheckEngine`` answers the same contract as the host ``CheckEngine``
but evaluates whole batches on the device: requests are vocab-encoded to
(start, target, depth) int32 triples, padded to a batch bucket, and handed
to the frontier functions. Depth clamping matches the reference (the
global max-depth wins when smaller or when the request depth is <= 0).

Modes (``mode``):

- ``dense``: a bf16 [N, N] adjacency per snapshot, one matmul per step
  (``ops.frontier``);
- ``scatter``: COO edges, gather and scatter-OR per step (``ops.frontier``);
- ``packed``: bitpacked frontiers, 32 requests per int32 word, one pass of
  the ``packed_propagate`` kernel per step (``ops.packed``). It serves
  graphs too large for the closure engine's interior limit;
- ``auto``: dense up to ``dense_threshold`` padded nodes, else scatter.

Unknown subjects and sets map to the snapshot's dummy node, which nothing
reaches. The engine reads through a ``SnapshotManager``, so every answer is
at least as fresh as the store version at call time.

The check runs in three stages (``encode_batch``/``encode_columns``/
``encode_ids`` -> ``launch_encoded`` -> ``decode_launched``) so the
pipelined ``CheckBatcher`` can overlap the host encode and decode of
neighbouring batches with the device stage. Every stage uses the current
CUDA stream. The host-to-device copy in ``launch_encoded`` is synchronous
(pageable numpy source), so the staging buffers may go back to the pool as
soon as ``decode_launched`` has copied the result back.

``SnapshotExpandEngine`` builds Expand trees from a snapshot's forward
CSR (host work: no kernel runs), for every engine mode but ``host``.

``launch_encoded`` carries the device fault sites (``faults.py``):
``device.compile_error``, ``device.oom``, ``device.compile_fail``,
``device.lost`` raise as those failures would, ``device.slow`` stalls, and
``device.batch_nan`` returns a garbage batch (NaN answers) as a sick card
would; the breaker in ``engine/fallback.py`` is tested against them. The
staging copies are tallied in ``DEVSTATS`` (``/debug/graph``). The three
uploads (``device.upload``) and the decode's copy back (``device.decode``)
block the host, and each runs inside ``DEVSTATS.wait`` with the packed,
dense and scatter loops' own syncs (``telemetry/devstats.py``): on the
caller-thread batch paths the blocks are ``kernel`` on the ambient request
ledger (``telemetry/attribution.py``) and the host work between them
``launch``, so the host-side conversion after the copy back lands in
``decode``.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

import numpy as np
import torch

from ..faults import FAULTS
from ..graph.snapshot import GraphSnapshot, SnapshotManager, _bucket
from ..ops.frontier import (
    batched_check_dense,
    batched_check_scatter,
    batched_distances_dense,
    batched_distances_scatter,
    build_dense_adjacency,
    pick_edge_chunk,
)
from ..ops.packed import PACKED_BATCH_MULTIPLE, csr_row_ptr, packed_batched_check
from ..relationtuple.definitions import RelationTuple, Subject, SubjectID, SubjectSet
from ..telemetry.devstats import DEVSTATS
from ..utils.kernels import resolve_device
from .check import DEFAULT_MAX_DEPTH, clamp_depth
from .expand import (
    FALLBACK_PAGE_SIZE,
    ExpandPage,
    decode_expand_page_token,
    encode_expand_page_token,
)
from .tree import NodeType, Tree

_MIN_BATCH = 8
_DENSE_THRESHOLD_DEFAULT = 8192  # adj = bf16 N*N: 8192^2 = 128 MiB


def _bucket_batch(b: int) -> int:
    return _bucket(b, _MIN_BATCH)


def _batch_size(mode: str, n: int) -> int:
    if mode == "packed":  # W = B/32 lanes must fill 128-lane tiles
        m = PACKED_BATCH_MULTIPLE
        return m * ((n + m - 1) // m)
    return _bucket_batch(n)


def _decode_ids(snap, start, target) -> list:
    """Vocab-decode id pairs back to RelationTuples (the lazy ``requests``
    of a pre-encoded batch; the hot path never runs this)."""
    vocab = snap.vocab
    n_live = len(vocab)
    out = []
    for s, t in zip(start, target):
        if int(s) < n_live:
            ns, obj, rel = vocab.key(int(s))
        else:  # dummy/unknown start: resolves to no tuples downstream
            ns = obj = rel = ""
        subject = vocab.subject_of(int(t)) if int(t) < n_live else SubjectID(id="")
        out.append(
            RelationTuple(namespace=ns, object=obj, relation=rel, subject=subject)
        )
    return out


class EncodedBatch:
    """A vocab-encoded batch parked between pipeline stages: staging
    buffers filled, kernel not yet dispatched. Keeps the original requests
    (or, on the columnar path, the raw columns) so the exact requests of
    this batch can be recovered; columnar and id batches materialize their
    ``RelationTuple`` objects lazily, only if asked."""

    __slots__ = (
        "_requests", "_cols", "depths", "deadlines", "n", "b", "snap", "dg",
        "start", "target", "depth",
    )

    def __init__(
        self, requests, depths, n, b, snap, dg, start, target, depth, cols=None
    ):
        self._requests = requests
        self._cols = cols
        # the clamped per-request depths, before the packed mode's
        # unknown-node override (what a host oracle would be asked)
        self.depths = depths
        # per-row absolute caller deadlines (monotonic seconds), stamped by
        # the batcher after encode
        self.deadlines = None
        self.n = n
        self.b = b
        self.snap = snap
        self.dg = dg
        self.start = start
        self.target = target
        self.depth = depth

    @property
    def requests(self) -> list:
        """Per-item RelationTuples. Columnar batches build them here on
        first access; pure-id batches decode through the snapshot vocab."""
        if self._requests is None:
            if self._cols is not None:
                self._requests = self._cols.materialize()
            else:
                self._requests = _decode_ids(
                    self.snap, self.start[: self.n], self.target[: self.n]
                )
        return self._requests

    @property
    def version(self) -> int:
        return self.snap.version

    def keys(self) -> list[tuple[int, int, int]]:
        """Per-request (start, target, depth) id triples — the
        snapshot-versioned encoded-request cache key."""
        n = self.n
        return list(
            zip(
                self.start[:n].tolist(),
                self.target[:n].tolist(),
                self.depth[:n].tolist(),
            )
        )

    def compact(self, keep: Sequence[int]) -> None:
        """Shrink to the `keep` rows (increasing indices) in place — cache
        hits drop out before the kernel ever sees them. Freed tail rows are
        reset to the inert padding state (the dummy node; depth 0 in packed
        mode, else 1)."""
        m = len(keep)
        if m == self.n:
            return
        idx = np.asarray(keep, dtype=np.int64)
        self.start[:m] = self.start[idx]
        self.target[:m] = self.target[idx]
        self.depth[:m] = self.depth[idx]
        dummy = self.dg.dummy
        self.start[m : self.n] = dummy
        self.target[m : self.n] = dummy
        self.depth[m : self.n] = 0 if self.dg.mode == "packed" else 1
        if self._requests is not None:
            self._requests = [self._requests[i] for i in keep]
        if self._cols is not None:
            self._cols = self._cols.select(keep)
        if self.depths is not None:
            self.depths = [self.depths[i] for i in keep]
        if self.deadlines is not None:
            self.deadlines = [self.deadlines[i] for i in keep]
        self.n = m

    def release(self) -> None:
        """Return the staging buffers to the per-bucket free-list (idempotent)."""
        if self.start is not None:
            self.dg.return_staging((self.start, self.target, self.depth))
            self.start = self.target = self.depth = None


class LaunchedBatch:
    """A dispatched batch: the device result, not yet copied to the host.
    CUDA launches return at enqueue; decode blocks on the copy. ``garbage``
    marks the ``device.batch_nan`` drill's batch, which decodes to NaNs."""

    __slots__ = ("enc", "hit", "garbage")

    def __init__(self, enc: EncodedBatch, hit: Optional[torch.Tensor] = None,
                 garbage: bool = False):
        self.enc = enc
        self.hit = hit
        self.garbage = garbage


class _DeviceGraph:
    """Per-snapshot device residency: COO edge tensors, the dense
    adjacency, or (``packed``) the dst-sorted edges with their CSR row
    pointers.

    Also owns the per-bucket staging buffers: the (start, target, depth)
    int32 arrays a batch is encoded into are allocated once per (bucket,
    snapshot) and recycled through a bounded free-list. The dummy fill value
    is snapshot-dependent (padded_nodes - 1), which is why the buffers live
    here and not on the engine: a snapshot swap retires them."""

    # free-list depth per bucket
    _STAGING_KEEP = 8

    def __init__(self, snap: GraphSnapshot, mode: str, device: torch.device):
        self.host_src = snap.src  # identity keys for the residency cache:
        self.host_dst = snap.dst  # equal arrays => equal device contents
        self.padded_nodes = snap.padded_nodes
        self.padded_edges = snap.padded_edges
        self.dummy = snap.dummy_node
        self.mode = mode
        self.adj = self.src = self.dst = None
        self.src_by_dst = self.dst_by_dst = self.row_ptr = None
        self._staging_lock = threading.Lock()
        self._staging: dict[int, list] = {}
        if mode == "dense":
            self.adj = build_dense_adjacency(
                torch.from_numpy(snap.src).to(device),
                torch.from_numpy(snap.dst).to(device),
                snap.padded_nodes,
            )
        elif mode == "packed":
            # in-CSR (dst-sorted) order of the live edges, and the row
            # pointers the kernel walks; the padding edges are left out
            e = snap.num_edges
            order = np.argsort(snap.dst[:e], kind="stable")
            self.src_by_dst = torch.from_numpy(snap.src[:e][order]).to(device)
            self.dst_by_dst = torch.from_numpy(snap.dst[:e][order]).to(device)
            self.row_ptr = csr_row_ptr(self.dst_by_dst, snap.padded_nodes)
        else:
            self.src = torch.from_numpy(snap.src).to(device)
            self.dst = torch.from_numpy(snap.dst).to(device)

    @property
    def dense(self) -> bool:
        return self.mode == "dense"

    def checkout_staging(
        self, b: int
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(start, target, depth) int32[b] buffers, reset to the inert
        state (start/target = dummy, depth = 1) so stale rows from the
        previous batch can never leak past the new batch's length."""
        with self._staging_lock:
            pool = self._staging.get(b)
            bufs = pool.pop() if pool else None
        if bufs is None:
            return (
                np.full(b, self.dummy, dtype=np.int32),
                np.full(b, self.dummy, dtype=np.int32),
                np.ones(b, dtype=np.int32),
            )
        start, target, depth = bufs
        start.fill(self.dummy)
        target.fill(self.dummy)
        depth.fill(1)
        return start, target, depth

    def return_staging(self, bufs) -> None:
        b = len(bufs[0])
        with self._staging_lock:
            pool = self._staging.setdefault(b, [])
            if len(pool) < self._STAGING_KEEP:
                pool.append(bufs)


class DeviceCheckEngine:
    def __init__(
        self,
        snapshots: SnapshotManager,
        max_depth: int = DEFAULT_MAX_DEPTH,
        mode: str = "auto",  # auto | dense | scatter | packed
        dense_threshold: int = _DENSE_THRESHOLD_DEFAULT,
        device=None,
    ):
        if mode not in ("auto", "dense", "scatter", "packed"):
            raise ValueError(f"unknown mode {mode!r}")
        self.device = resolve_device(device)
        self.snapshots = snapshots
        self.global_max_depth = max_depth
        self.mode = mode
        self.dense_threshold = dense_threshold
        self._lock = threading.Lock()
        self._cached: Optional[_DeviceGraph] = None
        self._scatter_companion: Optional[_DeviceGraph] = None

    # -- device residency ----------------------------------------------------

    def _device_graph(self, snap: GraphSnapshot) -> _DeviceGraph:
        with self._lock:
            cached = self._cached
            # keyed on edge-array identity, not snapshot identity: version-only
            # snapshots (duplicate writes) share arrays and must not trigger a
            # re-upload or dense-adjacency rebuild
            if (
                cached is not None
                and cached.host_src is snap.src
                and cached.host_dst is snap.dst
            ):
                return cached
            if self.mode != "auto":
                mode = self.mode
            else:
                mode = (
                    "dense"
                    if snap.padded_nodes <= self.dense_threshold
                    else "scatter"
                )
            self._cached = None  # let the old residency go before the upload
            dg = _DeviceGraph(snap, mode, self.device)
            self._cached = dg
            return dg

    def reset_residency(self) -> None:
        """Drop every device-resident artifact: the edge tensors / dense
        adjacency, the staging free-lists hanging off them, and the packed
        mode's scatter companion. The next dispatch re-uploads from the
        live snapshot."""
        with self._lock:
            self._cached = None
            self._scatter_companion = None

    def warmup(self, batch: int = 1) -> None:
        """Run the current snapshot's path once at the `batch` bucket (the
        configured maximum) and at the smallest bucket: builds the kernel
        and the residency before live traffic arrives."""
        dummy = RelationTuple(
            namespace="", object="", relation="",
            subject=SubjectSet(namespace="", object="", relation=""),
        )
        batch = max(1, batch)
        self.batch_check([dummy] * batch)
        if _bucket_batch(batch) != _bucket_batch(1):
            self.batch_check([dummy])

    def subject_is_allowed(
        self, requested: RelationTuple, max_depth: int = 0
    ) -> bool:
        return self.batch_check([requested], max_depth)[0]

    def batch_check(
        self,
        requests: Sequence[RelationTuple],
        max_depth: int = 0,
        depths: Optional[Sequence[int]] = None,
    ) -> list[bool]:
        """Evaluate a batch; `depths` (per-request) overrides `max_depth`.
        Serial composition of the pipeline stages — one batch in flight."""
        if not requests:
            return []
        return self.batch_check_array(requests, max_depth, depths).tolist()

    def batch_check_array(
        self,
        requests: Sequence[RelationTuple],
        max_depth: int = 0,
        depths: Optional[Sequence[int]] = None,
    ) -> np.ndarray:
        """``batch_check``'s answers as an array: the seam the device
        breaker validates by dtype and shape before one ``tolist``."""
        if not requests:
            return np.zeros(0, dtype=bool)
        return self.decode_launched_array(
            self.launch_encoded(self.encode_batch(requests, max_depth, depths))
        )

    # -- pipelined dispatch: encode -> launch -> decode ----------------------

    def _fill_depths(self, dg, n, start, target, depth, want) -> list:
        """Clamp the requested depths into `depth`; returns the clamped
        depths before the packed mode's unknown-node override."""
        gmax = self.global_max_depth
        depth[:n] = np.where((want <= 0) | (want > gmax), gmax, want)
        clamped = depth[:n].tolist()
        if dg.mode == "packed":
            # unknown-node contract: a dummy start must not "reach" the
            # dummy target through the shared dummy row — force depth 0,
            # and the same for the batch's padding rows
            dummy = dg.dummy
            depth[:n] = np.where(
                (start[:n] == dummy) | (target[:n] == dummy), 0, depth[:n]
            )
            depth[n:] = 0
        return clamped

    def _want(self, n, max_depth, depths) -> np.ndarray:
        if depths is not None:
            return np.asarray(depths, dtype=np.int32)
        return np.full(n, max_depth, dtype=np.int32)

    def encode_batch(
        self,
        requests: Sequence[RelationTuple],
        max_depth: int = 0,
        depths: Optional[Sequence[int]] = None,
    ) -> EncodedBatch:
        """Stage 1 (host): vocab-encode into persistent per-(bucket,
        snapshot) staging buffers."""
        snap = self.snapshots.snapshot()
        dg = self._device_graph(snap)
        n = len(requests)
        b = _batch_size(dg.mode, n)
        start, target, depth = dg.checkout_staging(b)
        snap.encode_requests(requests, out_start=start, out_target=target)
        fb = self._fill_depths(
            dg, n, start, target, depth, self._want(n, max_depth, depths)
        )
        return EncodedBatch(list(requests), fb, n, b, snap, dg, start, target, depth)

    def encode_columns(
        self,
        cols,
        max_depth: int = 0,
        depths: Optional[Sequence[int]] = None,
    ) -> EncodedBatch:
        """Columnar stage 1: a ``CheckColumns`` batch vocab-encodes straight
        from its parallel string lists into the staging buffers — no
        ``RelationTuple``/``Subject`` objects on the hot path."""
        snap = self.snapshots.snapshot()
        dg = self._device_graph(snap)
        n = len(cols)
        b = _batch_size(dg.mode, n)
        start, target, depth = dg.checkout_staging(b)
        snap.encode_requests_columnar(cols, out_start=start, out_target=target)
        fb = self._fill_depths(
            dg, n, start, target, depth, self._want(n, max_depth, depths)
        )
        return EncodedBatch(
            None, fb, n, b, snap, dg, start, target, depth, cols=cols
        )

    def batch_check_columns(
        self,
        cols,
        max_depth: int = 0,
        depths: Optional[Sequence[int]] = None,
    ) -> list[bool]:
        """Serial columnar dispatch — the zero-object twin of batch_check."""
        if not len(cols):
            return []
        return self.batch_check_columns_array(cols, max_depth, depths).tolist()

    def batch_check_columns_array(
        self,
        cols,
        max_depth: int = 0,
        depths: Optional[Sequence[int]] = None,
    ) -> np.ndarray:
        """``batch_check_columns``'s answers as an array (the breaker's
        seam, as ``batch_check_array``)."""
        if not len(cols):
            return np.zeros(0, dtype=bool)
        return self.decode_launched_array(
            self.launch_encoded(self.encode_columns(cols, max_depth, depths))
        )

    def check_ids(
        self,
        start,
        target,
        is_id=None,
        depths: Optional[Sequence[int]] = None,
    ) -> np.ndarray:
        """Array-native check over pre-encoded vocab ids: bool[n] out (the
        frontier paths do not distinguish subject-id from subject-set
        targets, so ``is_id`` is accepted for signature parity with the
        closure engine and ignored). Unknown or beyond-snapshot ids are
        clamped to the inert dummy node."""
        if len(start) == 0:
            return np.zeros(0, dtype=bool)
        enc = self.encode_ids(start, target, depths)
        return np.asarray(
            self.decode_launched(self.launch_encoded(enc)), dtype=bool
        )

    def encode_ids(
        self,
        start,
        target,
        depths: Optional[Sequence[int]] = None,
    ) -> EncodedBatch:
        """Stage 1 for pre-encoded id batches: the ids go straight into
        staging — no vocab probe at all."""
        return self.encode_ids_at(
            self.snapshots.snapshot(), start, target, depths
        )

    def encode_ids_at(
        self,
        snap: GraphSnapshot,
        start,
        target,
        depths: Optional[Sequence[int]] = None,
    ) -> EncodedBatch:
        """encode_ids pinned to an explicit snapshot. Node ids are only
        meaningful against the vocab that produced them (the dummy id in
        particular is ``padded_nodes - 1``, which moves as the graph
        grows), so a retry of part of a batch re-encodes against the
        parent batch's snapshot."""
        dg = self._device_graph(snap)
        n = len(start)
        b = _batch_size(dg.mode, n)
        dummy = snap.dummy_node
        pn = snap.padded_nodes
        st, tg, dp = dg.checkout_staging(b)
        s = np.asarray(start, dtype=np.int64)
        t = np.asarray(target, dtype=np.int64)
        st[:n] = np.where((s < 0) | (s >= pn), dummy, s)
        tg[:n] = np.where((t < 0) | (t >= pn), dummy, t)
        fb = self._fill_depths(dg, n, st, tg, dp, self._want(n, 0, depths))
        return EncodedBatch(None, fb, n, b, snap, dg, st, tg, dp)

    def launch_encoded(self, enc: EncodedBatch) -> LaunchedBatch:
        """Stage 2 (the device stage): copy the batch to the device and
        enqueue the steps. The loop tests for done rows once per step, so
        it returns once the last step is enqueued; the result stays on the
        device."""
        # fault sites: stand-ins for a failed kernel build, an
        # out-of-memory, a lost device, a launch refused for one shape, a
        # numerically sick card returning garbage, and a slow dispatch —
        # what the breaker (engine/fallback.py), the device supervisor
        # (driver/registry.py) and the batcher's deadline culls are tested
        # against
        FAULTS.fire("device.compile_error")
        FAULTS.fire("device.oom")
        FAULTS.fire("device.compile_fail")
        FAULTS.fire("device.lost")
        FAULTS.maybe_sleep("device.slow")
        if FAULTS.should_fire("device.batch_nan"):
            return LaunchedBatch(enc, garbage=True)
        DEVSTATS.record_transfer(
            enc.start.nbytes + enc.target.nbytes + enc.depth.nbytes, "h2d"
        )
        dg = enc.dg
        dev = self.device
        # torch.tensor copies: the staging buffers are recycled after decode
        with DEVSTATS.wait("device.upload"):
            start = torch.tensor(enc.start, device=dev)
        with DEVSTATS.wait("device.upload"):
            target = torch.tensor(enc.target, device=dev)
        with DEVSTATS.wait("device.upload"):
            depth = torch.tensor(enc.depth, device=dev)
        if dg.mode == "packed":
            hit = packed_batched_check(
                dg.src_by_dst,
                dg.dst_by_dst,
                start,
                target,
                depth,
                padded_nodes=dg.padded_nodes,
                max_steps=self.global_max_depth,
                row_ptr=dg.row_ptr,
            )
        elif dg.dense:
            hit = batched_check_dense(
                dg.adj, start, target, depth, max_steps=self.global_max_depth
            )
        else:
            hit = batched_check_scatter(
                dg.src,
                dg.dst,
                start,
                target,
                depth,
                padded_nodes=dg.padded_nodes,
                edge_chunk=pick_edge_chunk(dg.padded_edges, enc.b),
                max_steps=self.global_max_depth,
            )
        return LaunchedBatch(enc, hit)

    def decode_launched(self, launched: LaunchedBatch) -> list[bool]:
        """Stage 3: copy the result to the host (the blocking step) and
        recycle the staging buffers."""
        return self.decode_launched_array(launched).tolist()

    def decode_launched_array(self, launched: LaunchedBatch) -> np.ndarray:
        """Stage 3's answers as an array: bool, one per row, except the
        ``device.batch_nan`` drill's batch, which decodes to float NaNs."""
        enc = launched.enc
        try:
            if launched.garbage:
                return np.full(enc.n, np.nan)
            # the copy back waits for the steps: "kernel" on the ambient
            # request ledger of the caller-thread batch paths
            with DEVSTATS.wait("device.decode"):
                hit = launched.hit[: enc.n].cpu()
            DEVSTATS.record_transfer(hit.numel() * hit.element_size(), "d2h")
            return hit.numpy()
        finally:
            enc.release()

    def distances(
        self, subject_sets: Sequence[SubjectSet], max_depth: int = 0
    ) -> np.ndarray:
        """BFS levels int32[n, padded_nodes] from each subject set
        (UNREACHED where unreachable) — bulk expand support."""
        snap = self.snapshots.snapshot()
        dg = self._device_graph(snap)
        n = len(subject_sets)
        b = _bucket_batch(n)
        start = np.full(b, snap.dummy_node, dtype=np.int32)
        for i, s in enumerate(subject_sets):
            start[i] = snap.node_for_set(s.namespace, s.object, s.relation)
        d = clamp_depth(max_depth, self.global_max_depth)
        dev = self.device
        start_t = torch.tensor(start, device=dev)
        depth_t = torch.full((b,), d, dtype=torch.int32, device=dev)
        if dg.mode == "packed":
            # distances are an expand-support query, not the packed check's
            # hot path: reuse the COO scatter path, cached per snapshot
            with self._lock:
                companion = self._scatter_companion
                if not (
                    companion is not None
                    and companion.host_src is snap.src
                    and companion.host_dst is snap.dst
                ):
                    self._scatter_companion = None
                    companion = _DeviceGraph(snap, "scatter", dev)
                    self._scatter_companion = companion
            dg = companion
        if dg.dense:
            dist = batched_distances_dense(
                dg.adj, start_t, depth_t, max_steps=self.global_max_depth
            )
        else:
            dist = batched_distances_scatter(
                dg.src,
                dg.dst,
                start_t,
                depth_t,
                padded_nodes=dg.padded_nodes,
                edge_chunk=pick_edge_chunk(dg.padded_edges, b),
                max_steps=self.global_max_depth,
            )
        return dist[:n].cpu().numpy()


class _SnapFrame:
    """One open Union node on the snapshot engine's explicit traversal
    stack (the CSR twin of ``engine.expand._Frame``)."""

    __slots__ = ("subject", "children", "successors", "i", "rest", "path")

    def __init__(self, subject, successors, rest, path):
        self.subject = subject
        self.children: list[Tree] = []
        self.successors = successors  # child node ids, CSR insertion order
        self.i = 0
        self.rest = rest
        self.path = path


class SnapshotExpandEngine:
    """Expand trees over the snapshot's forward CSR, with no store round
    trips (counterpart of ``keto_tpu/engine/device.py:677``).

    Matches the host ``ExpandEngine`` node for node: SubjectID -> Leaf; a
    subject set already visited or with no tuples -> no node; remaining
    depth <= 1 -> Leaf; otherwise a Union over the expansions of each
    tuple's subject, in store insertion order (the CSR's stable sort keeps
    it).

    The traversal is DFS-preorder, as in the reference: which occurrence of
    a repeated set is expanded depends on the order the visited set
    mutates. It runs on an explicit stack (no recursion limit); child ids
    come straight from the CSR, the visited set is a bool array, and the
    bottom level of the tree (where every child renders as a Leaf whatever
    its own edges) is built in one bulk pass per node. The same stack
    drives paged Expand (``build_tree_page``)."""

    def __init__(
        self,
        snapshots: SnapshotManager,
        max_depth: int = DEFAULT_MAX_DEPTH,
        default_page_size: int = 0,
    ):
        self.snapshots = snapshots
        self.global_max_depth = max_depth
        self.default_page_size = default_page_size

    def build_tree(self, subject: Subject, max_depth: int = 0) -> Optional[Tree]:
        depth = clamp_depth(max_depth, self.global_max_depth)
        snap = self.snapshots.snapshot()
        if not isinstance(subject, SubjectSet):
            return Tree(type=NodeType.LEAF, subject=subject)
        nid = snap.vocab.lookup_subject(subject)
        if nid is None or nid >= snap.padded_nodes:
            # the set never appears in a tuple (or was interned after this
            # snapshot): no tuples
            return None
        visited = np.zeros(snap.padded_nodes, dtype=bool)
        return self._expand_one(
            snap, subject, nid, depth, [], visited, [float("inf")], []
        )

    def build_tree_page(
        self,
        subject: Subject,
        max_depth: int = 0,
        page_size: int = 0,
        page_token: str = "",
    ) -> ExpandPage:
        """Frontier-bounded paged Expand over the CSR: the host engine's
        work-queue machinery; the token carries node ids and pins the
        snapshot version."""
        depth = clamp_depth(max_depth, self.global_max_depth)
        snap = self.snapshots.snapshot()
        if page_size <= 0:
            page_size = self.default_page_size or FALLBACK_PAGE_SIZE
        if not isinstance(subject, SubjectSet):
            return ExpandPage(tree=Tree(type=NodeType.LEAF, subject=subject))
        visited = np.zeros(snap.padded_nodes, dtype=bool)
        key_of = snap.vocab.keys()
        if page_token:
            pending, vis = decode_expand_page_token(page_token, "snap", snap.version)
            visited[np.asarray(vis, dtype=np.int64)] = True
            work = [(path, int(nid), rest) for path, nid, rest in pending]
            first = False
        else:
            nid = snap.vocab.lookup_subject(subject)
            if nid is None or nid >= snap.padded_nodes:
                return ExpandPage(tree=None)
            work = [([], nid, depth)]
            first = True
        budget = [page_size]
        tree: Optional[Tree] = None
        patches = []
        while work and budget[0] > 0:
            path, nid, rest = work.pop(0)
            k = key_of[nid]
            subj = SubjectSet(namespace=k[0], object=k[1], relation=k[2])
            deferred: list = []
            t = self._expand_one(
                snap, subj, nid, rest, path, visited, budget, deferred
            )
            # deferred descendants resume BEFORE later pending items:
            # their DFS-preorder position in the unpaged walk
            work = deferred + work
            if first:
                tree = t
                first = False
            elif t is not None:
                patches.append((path, t))
        token = ""
        if work:
            token = encode_expand_page_token(
                "snap", snap.version, work, np.nonzero(visited)[0].tolist()
            )
        return ExpandPage(tree=tree, patches=patches, next_page_token=token)

    def _enter(self, snap, subject, nid, rest, path, visited, budget):
        """The visited/successors/depth gate of one subject set: a terminal
        Optional[Tree], an open _SnapFrame, or the bulk bottom level."""
        if visited[nid]:
            return None  # cycle suppression (engine.go:42-45)
        visited[nid] = True
        successors = snap.out_neighbors(nid)
        if successors.size == 0:
            return None  # no tuples (engine.go:67-69)
        budget[0] -= 1
        if rest <= 1:
            return Tree(type=NodeType.LEAF, subject=subject)
        if rest == 2:
            # the whole bottom level in one pass; the budget is charged for
            # every Leaf, so a page overshoots by at most one node's fan-out
            budget[0] -= int(successors.size)
            return self._union_of_leaves(snap, subject, successors, visited)
        return _SnapFrame(subject, successors.tolist(), rest, path)

    def _expand_one(
        self, snap, subject, nid, rest, path, visited, budget, deferred
    ) -> Optional[Tree]:
        """DFS-preorder expansion of one work item on an explicit stack.
        Once `budget` is spent, not-yet-entered subject sets render as
        placeholder Leaves and queue on `deferred` in preorder."""
        res = self._enter(snap, subject, nid, rest, path, visited, budget)
        if not isinstance(res, _SnapFrame):
            return res
        key_of = snap.vocab.keys()
        stack = [res]
        while True:
            fr = stack[-1]
            if fr.i >= len(fr.successors):
                stack.pop()
                tree = Tree(
                    type=NodeType.UNION, subject=fr.subject, children=fr.children
                )
                if not stack:
                    return tree
                stack[-1].children.append(tree)
                continue
            idx = fr.i
            fr.i += 1
            child_nid = fr.successors[idx]
            k = key_of[child_nid]
            if len(k) == 1:
                budget[0] -= 1
                fr.children.append(
                    Tree(type=NodeType.LEAF, subject=SubjectID(id=k[0]))
                )
                continue
            child_subject = SubjectSet(namespace=k[0], object=k[1], relation=k[2])
            if budget[0] <= 0:
                # page budget spent: a placeholder Leaf now, the expansion
                # on a later page (whose _enter re-checks visited)
                fr.children.append(Tree(type=NodeType.LEAF, subject=child_subject))
                deferred.append((fr.path + [idx], child_nid, fr.rest - 1))
                continue
            res = self._enter(
                snap, child_subject, child_nid, fr.rest - 1, fr.path + [idx],
                visited, budget,
            )
            if isinstance(res, _SnapFrame):
                stack.append(res)
            else:
                # a nil child (visited, or a set with no tuples) renders as
                # a Leaf for that subject, never dropped (engine.go:80-86)
                fr.children.append(
                    res
                    if res is not None
                    else Tree(type=NodeType.LEAF, subject=child_subject)
                )

    @staticmethod
    def _union_of_leaves(
        snap: GraphSnapshot,
        subject: SubjectSet,
        successors: np.ndarray,
        visited: np.ndarray,
    ) -> Tree:
        """The tree's bottom level: with one depth step left every child
        renders as a Leaf whatever its own edges, so the child loop becomes
        bulk Leaf construction. The one side effect to keep is the visited
        bookkeeping: the walk would have marked each not-yet-visited SET
        child before its depth check."""
        is_set = snap.vocab.is_set_array()
        set_ids = successors[is_set[successors]]
        if set_ids.size:
            visited[set_ids] = True
        leaf = NodeType.LEAF
        key_of = snap.vocab.keys()
        children = [
            Tree(type=leaf, subject=SubjectID(id=k[0]))
            if len(k) == 1
            else Tree(
                type=leaf,
                subject=SubjectSet(namespace=k[0], object=k[1], relation=k[2]),
            )
            for k in map(key_of.__getitem__, successors.tolist())
        ]
        return Tree(type=NodeType.UNION, subject=subject, children=children)
