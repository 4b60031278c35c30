"""Edge-partitioned batched check over a grid of devices (counterpart of
``keto_tpu/parallel/sharded.py``).

The reference shards over a ``jax.sharding.Mesh`` with ``shard_map``. The
port keeps its layout and drives it from one process:

- a :class:`Mesh` is a ``[data, edge]`` grid of ``torch.device``\\ s (axes
  ``("data", "edge")``, as there): requests are data-parallel over
  ``data``; the COO edge arrays are split into ``edge`` contiguous stripes
  (each device holds E/n_edge edges);
- each stripe's phase is plain torch gathers and scatters on its own
  device, and the reference's one collective, ``lax.pmax`` over ``edge``,
  copies the stripes' partials to the data row's first device and reduces
  them there (:func:`pmax`, :func:`pmin`);
- the frontier ``F[B_local, N]`` lives on the row's first device and is
  copied to each stripe device per step; the early-exit depth loop runs on
  the host, one step per iteration, as the reference's ``while_loop``
  does inside its program.

A device list may repeat a device (``[cpu] * 8`` in the tests,
``[cuda:0] * 2`` on one card): the stripes then share the device and its
copies are no-ops. JAX needs distinct devices and gets them from
``--xla_force_host_platform_device_count``; the port has no such flag.
There is no hand-written kernel here: the reference's sharded bodies are
plain XLA gathers, scatters and reductions, and so are these.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

import numpy as np
import torch

from ..engine.check import DEFAULT_MAX_DEPTH
from ..graph.snapshot import GraphSnapshot, SnapshotManager
from ..relationtuple.definitions import RelationTuple, SubjectSet
from ..utils.kernels import resolve_device


class Mesh:
    """A ``[data, edge]`` grid of devices: ``devices[r][k]`` runs stripe
    ``k`` of data row ``r``."""

    axis_names = ("data", "edge")

    def __init__(self, devices: Sequence[Sequence[torch.device]]):
        self.devices = [list(row) for row in devices]
        self.shape = {"data": len(self.devices), "edge": len(self.devices[0])}

    def row(self, r: int) -> list[torch.device]:
        return self.devices[r]

    def column(self, k: int) -> list[torch.device]:
        """The distinct devices that hold stripe ``k``."""
        return list(dict.fromkeys(row[k] for row in self.devices))

    def distinct(self) -> list[torch.device]:
        return list(dict.fromkeys(d for row in self.devices for d in row))


def make_mesh(devices=None, data: int = 1, edge: Optional[int] = None) -> Mesh:
    """(data, edge) mesh over the given devices (default: every CUDA
    device; without CUDA it raises, as every entry point of the port does)."""
    if devices is None:
        resolve_device(None)
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if edge is None:
        edge = n // data
    if data * edge != n:
        raise ValueError(f"mesh {data}x{edge} != {n} devices")
    return Mesh([devices[r * edge:(r + 1) * edge] for r in range(data)])


def pmax(parts: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """``lax.pmax`` over the edge axis: the stripes' partials, reduced on
    the data row's first device."""
    return torch.stack([p.to(device) for p in parts]).amax(0)


def pmin(parts: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """``lax.pmin`` over the edge axis (see :func:`pmax`)."""
    return torch.stack([p.to(device) for p in parts]).amin(0)


def _local_propagate(f, src, dst, padded_nodes: int, edge_chunk: int):
    """Successor set of ``f`` along this device's edge stripe, in chunks of
    ``edge_chunk`` edges (the reference's scan) when that is smaller."""
    n = src.shape[0]
    step = edge_chunk if 0 < edge_chunk < n else max(n, 1)
    hits = torch.zeros(f.shape, dtype=torch.int32, device=f.device)
    for lo in range(0, n, step):
        s = src[lo:lo + step]
        d = dst[lo:lo + step]
        hits.index_add_(1, d, f[:, s].to(torch.int32))
    p = hits > 0
    p[:, padded_nodes - 1] = False
    return p


def sharded_check(
    src, dst, start, target, depth, *, mesh: Mesh, padded_nodes: int, edge_chunk: int,
    max_steps: int,
) -> np.ndarray:
    """allowed: bool[B]. ``src[r][k]``/``dst[r][k]`` are stripe ``k``'s edges
    on ``mesh.devices[r][k]``; the batch (int32 numpy arrays, B a multiple
    of the data axis) is split over the data rows; the partial successor
    sets meet in :func:`pmax` once per step."""
    n_data = mesh.shape["data"]
    bl = len(start) // n_data
    out = []
    for r in range(n_data):
        row = mesh.row(r)
        home = row[0]
        sl = slice(r * bl, (r + 1) * bl)
        s = torch.from_numpy(start[sl]).to(home, torch.int64)
        t = torch.from_numpy(target[sl]).to(home, torch.int64)
        dp = torch.from_numpy(depth[sl]).to(home)
        f = torch.arange(padded_nodes, device=home)[None, :] == s[:, None]
        rows = torch.arange(bl, device=home)
        hit = torch.zeros(bl, dtype=torch.bool, device=home)
        done = torch.zeros(bl, dtype=torch.bool, device=home)
        i = 0
        while i < max_steps and not bool(done.all()):
            p = pmax(
                [
                    _local_propagate(f.to(dev), src[r][k], dst[r][k], padded_nodes, edge_chunk)
                    for k, dev in enumerate(row)
                ],
                home,
            )
            changed = (p & ~f).any(1)
            hit |= p[rows, t] & (i < dp)
            f |= p
            done |= hit | ~changed | ((i + 1) >= dp)
            i += 1
        out.append(hit.cpu())
    return torch.cat(out).numpy()


class ShardedCheckEngine:
    """DeviceCheckEngine's multi-device sibling: the same contract, edges
    spread over the mesh. For a graph beyond one device's memory or a check
    volume beyond one device's throughput."""

    def __init__(
        self,
        snapshots: SnapshotManager,
        mesh: Optional[Mesh] = None,
        max_depth: int = DEFAULT_MAX_DEPTH,
    ):
        self.snapshots = snapshots
        self.mesh = mesh if mesh is not None else make_mesh()
        self.global_max_depth = max_depth
        self._lock = threading.Lock()
        self._cached = None  # (host src, host dst, src stripes, dst stripes)
        self.n_data = self.mesh.shape["data"]
        self.n_edge = self.mesh.shape["edge"]

    def _device_arrays(self, snap: GraphSnapshot):
        with self._lock:
            cached = self._cached
            if cached is not None and cached[0] is snap.src and cached[1] is snap.dst:
                return cached[2], cached[3]
            dev_src = self._stripes(snap.src)
            dev_dst = self._stripes(snap.dst)
            self._cached = (snap.src, snap.dst, dev_src, dev_dst)
            return dev_src, dev_dst

    def _stripes(self, arr: np.ndarray) -> list[list[torch.Tensor]]:
        """``arr`` split into n_edge contiguous stripes, stripe k on every
        device of mesh column k (one copy per distinct device)."""
        per = len(arr) // self.n_edge
        placed = {}
        for k in range(self.n_edge):
            host = torch.from_numpy(np.ascontiguousarray(arr[k * per:(k + 1) * per]))
            for dev in self.mesh.column(k):
                placed[(k, dev)] = host.to(dev, torch.int64)
        return [
            [placed[(k, dev)] for k, dev in enumerate(self.mesh.row(r))]
            for r in range(self.n_data)
        ]

    def _bucket_batch(self, n: int) -> int:
        # the batch divides evenly across the data axis: the per-device slice
        # is bucketed to a power of two, then multiplied back out (any n_data)
        per_device = -(-max(n, 8) // self.n_data)
        per_device = 1 << (per_device - 1).bit_length()
        return per_device * self.n_data

    def batch_check(
        self,
        requests: Sequence[RelationTuple],
        max_depth: int = 0,
        depths: Optional[Sequence[int]] = None,
    ) -> list[bool]:
        if not requests:
            return []
        snap = self.snapshots.snapshot()
        n = len(requests)
        pn = snap.padded_nodes
        dummy = snap.dummy_node
        skeys = [(r.namespace, r.object, r.relation) for r in requests]
        tkeys = [
            (s.id,) if not isinstance(s, SubjectSet) else (s.namespace, s.object, s.relation)
            for s in (r.subject for r in requests)
        ]
        s_ids = snap.vocab.lookup_bulk(skeys)
        t_ids = snap.vocab.lookup_bulk(tkeys)
        start = np.where((s_ids < 0) | (s_ids >= pn), dummy, s_ids)
        target = np.where((t_ids < 0) | (t_ids >= pn), dummy, t_ids)
        if depths is not None:
            want = np.asarray(depths, dtype=np.int32)
        else:
            want = np.full(n, max_depth, dtype=np.int32)
        return self.check_ids(start, target, depths=want).tolist()

    def check_ids(
        self,
        start: np.ndarray,
        target: np.ndarray,
        is_id: Optional[np.ndarray] = None,
        depths: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Array-native sharded check: vocab-encoded node ids in, bool[n]
        out (``is_id`` is accepted for interface parity: the lockstep BFS
        treats id and set targets alike). Unknown or overflow ids clamp to
        the inert dummy node."""
        del is_id
        start = np.asarray(start, dtype=np.int64)
        if len(start) == 0:
            return np.zeros(0, dtype=bool)
        target = np.asarray(target, dtype=np.int64)
        snap = self.snapshots.snapshot()
        dev_src, dev_dst = self._device_arrays(snap)
        n = len(start)
        b = self._bucket_batch(n)
        dummy = snap.dummy_node
        gmax = self.global_max_depth
        s = np.full(b, dummy, dtype=np.int32)
        t = np.full(b, dummy, dtype=np.int32)
        depth = np.ones(b, dtype=np.int32)
        s[:n] = np.where(start >= snap.padded_nodes, dummy, start)
        t[:n] = np.where(target >= snap.padded_nodes, dummy, target)
        if depths is None:
            depth[:n] = gmax
        else:
            want = np.asarray(depths, dtype=np.int32)
            depth[:n] = np.where((want <= 0) | (want > gmax), gmax, want)
        local_edges = snap.padded_edges // self.n_edge
        chunk = local_edges
        while chunk > 1024 and (b // self.n_data) * chunk > (1 << 23):
            chunk //= 2
        hit = sharded_check(
            dev_src, dev_dst, s, t, depth,
            mesh=self.mesh,
            padded_nodes=snap.padded_nodes,
            edge_chunk=chunk,
            max_steps=self.global_max_depth,
        )
        return hit[:n].copy()

    def subject_is_allowed(self, requested: RelationTuple, max_depth: int = 0) -> bool:
        return self.batch_check([requested], max_depth)[0]

    def warmup(self, batch: int = 1) -> None:
        """Place the stripes and run one batch at the production bucket."""
        dummy = RelationTuple(
            namespace="", object="", relation="",
            subject=SubjectSet(namespace="", object="", relation=""),
        )
        batch = max(1, batch)
        self.batch_check([dummy] * batch)
        if self._bucket_batch(batch) != self._bucket_batch(1):
            self.batch_check([dummy])
