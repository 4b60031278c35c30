"""Sharded closure check: the closure engine's layout over a grid of
devices (counterpart of ``keto_tpu/parallel/closure_sharded.py``).

The single-device closure engine holds three memory classes:

1. the interior distance matrix D, O(M^2) in the interior (group and role
   nesting) count, which does not grow with users or objects:
   **replicated** on every device;
2. the boundary CSRs (F0 = set successors by node, L = interior
   in-neighbours by node) and the direct-edge table, O(E), the scale axis:
   **node-striped** over the mesh's ``edge`` axis: stripe k owns the CSR
   rows of the nodes with ``node % n_shards == k``;
3. the vocab, on the host: the front end encodes.

A batched check needs the reference's two reductions over the stripes:

  phase 1  owner(start) gathers its F0 row and folds D rows:
           dvec[q, :] = min over a in F0(start_q) of D[a, :]
           -> pmin over 'edge' (non-owners contribute INF)
  phase 2  owner(target) gathers its L row (or the target's interior
           index for a set target) and reduces best_q = min_b dvec[q, b];
           the direct edge is a vectorised binary search of the owner's
           full-out CSR row (dst-sorted within the row)
           -> pmin / pmax over 'edge'
  allowed  = (direct & depth >= 1) | (1 + best + extra <= depth)

The port runs each stripe's gathers on its own device and the reductions on
the data row's first device (``sharded.pmin``/``pmax``). In phase 2 the
stripes' L rows travel to that device, where dvec already is, instead of
dvec travelling to every stripe as the reference's pmin leaves it: the
same minimum over the same values, with the smaller operand moved. Rows
whose fan-out exceeds the static gather widths report an overflow flag and
are answered again by a second pass at escalated widths, then by the exact
host oracle.

Live check traffic reaches this layout through :class:`.serving.
ShardedServingEngine`; :class:`ShardedClosureEngine` used directly is the
mesh-correctness oracle against that serving path.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

import numpy as np
import torch

from ..engine.check import DEFAULT_MAX_DEPTH, CheckEngine
from ..graph.interior import build_interior
from ..graph.snapshot import GraphSnapshot, SnapshotManager
from ..ops.closure import INF_DIST, build_closure_packed, pack_adjacency
from ..relationtuple.definitions import RelationTuple, SubjectID, SubjectSet
from .sharded import Mesh, make_mesh, pmax, pmin

#: the resident components: D is replicated, the rest are node stripes
#: ([n_shards, ...] host arrays, stripe k on the devices of mesh column k)
REPLICATED = ("d",)
STRIPED = ("f0_ip", "f0_v", "l_ip", "l_v", "int", "out_ip", "out_v")


def _stripe_csr(
    indptr: np.ndarray, vals: np.ndarray, pn: int, n_shards: int
) -> tuple[np.ndarray, np.ndarray, int]:
    """Node-stripe a CSR: rows of node n go to shard n % n_shards at local
    row n // n_shards. Returns (indptr [n_shards, local_rows+1],
    vals [n_shards, max_nnz] PAD-padded, local_rows)."""
    local_rows = -(-pn // n_shards)
    out_indptr = np.zeros((n_shards, local_rows + 1), dtype=np.int32)
    shard_vals = []
    for k in range(n_shards):
        nodes = np.arange(k, pn, n_shards, dtype=np.int64)
        counts = np.zeros(local_rows, dtype=np.int64)
        row_counts = (indptr[nodes + 1] - indptr[nodes]).astype(np.int64)
        counts[: len(nodes)] = row_counts
        out_indptr[k, 1:] = np.cumsum(counts).astype(np.int32)
        # ragged gather of the rows' values in stripe order, vectorised
        total = int(row_counts.sum())
        if total:
            starts_rep = np.repeat(indptr[nodes].astype(np.int64), row_counts)
            within = np.arange(total, dtype=np.int64) - np.repeat(
                np.cumsum(row_counts) - row_counts, row_counts
            )
            shard_vals.append(vals[starts_rep + within])
        else:
            shard_vals.append(np.empty(0, vals.dtype))
    max_nnz = max(1, max(len(v) for v in shard_vals))
    out_vals = np.full((n_shards, max_nnz), 0, dtype=np.int32)
    for k, v in enumerate(shard_vals):
        out_vals[k, : len(v)] = v
    return out_indptr, out_vals, local_rows


def _stripe_vector(vec: np.ndarray, pn: int, n_shards: int, fill) -> np.ndarray:
    """[pn] -> [n_shards, local_rows]: entry of node n at
    [n % n_shards, n // n_shards]."""
    local_rows = -(-pn // n_shards)
    out = np.full((n_shards, local_rows), fill, dtype=vec.dtype)
    for k in range(n_shards):
        nodes = np.arange(k, pn, n_shards, dtype=np.int64)
        out[k, : len(nodes)] = vec[nodes]
    return out


class Placement:
    """One residency's tensors on the mesh: D once per distinct device, each
    stripe once per distinct device of its mesh column. A component whose
    host array is the same object as the previous placement's keeps that
    placement's tensors: an untouched stripe is not copied again."""

    def __init__(self, mesh: Mesh, host: dict, prev: Optional["Placement"] = None):
        self.mesh = mesh
        self.host = host
        self.tensors: dict = {}
        for name, arr in host.items():
            if prev is not None and prev.host.get(name) is arr:
                self.tensors[name] = prev.tensors[name]
            elif name in REPLICATED:
                t = torch.from_numpy(arr) if isinstance(arr, np.ndarray) else arr
                self.tensors[name] = {dev: t.to(dev) for dev in mesh.distinct()}
            else:
                self.tensors[name] = {
                    (k, dev): torch.from_numpy(np.ascontiguousarray(arr[k])).to(dev)
                    for k in range(len(arr))
                    for dev in mesh.column(k)
                }

    def stripe(self, r: int, k: int) -> dict:
        """Stripe k's tensors (and D) on ``mesh.devices[r][k]``."""
        dev = self.mesh.devices[r][k]
        out = {name: self.tensors[name][(k, dev)] for name in STRIPED}
        out["d"] = self.tensors["d"][dev]
        return out


def _padded_rows(indptr, vals, nodes, own, n_shards: int, width: int, pad: int):
    """[b, width] local CSR row gather (PAD where absent) + per-row overflow
    flag. The gather stops at the widest owned row of the batch: the
    columns past it are all PAD."""
    local = torch.where(own, nodes // n_shards, 0)
    off = indptr[local].long()
    deg = torch.where(own, indptr[local + 1].long() - off, 0)
    used = min(width, int(deg.max())) if len(deg) else 0
    j = torch.arange(max(used, 1), device=nodes.device)[None, :]
    idx = (off[:, None] + j).clamp(0, vals.shape[0] - 1)
    valid = j < deg.clamp(max=width)[:, None]
    out = torch.where(valid, vals[idx].long(), pad)
    return out, deg > width


def _stripe_phase1(t: dict, s, me: int, n_shards: int, m_pad: int, f0_max: int):
    """Stripe ``me``'s dvec partial and its F0 overflow flags. dvec stays
    uint8: D is uint8 with INF_DIST as its top value, so the minimum is the
    reference's int16 minimum."""
    pad = m_pad - 1
    own_s = (s % n_shards) == me
    f0, f0_over = _padded_rows(t["f0_ip"], t["f0_v"], s, own_s, n_shards, f0_max, pad)
    d = t["d"]
    dvec = torch.full((len(s), m_pad), INF_DIST, dtype=torch.uint8, device=s.device)
    for j in range(f0.shape[1]):
        torch.minimum(dvec, d[f0[:, j]], out=dvec)
    return dvec, f0_over


def _stripe_phase2(t: dict, s, tg, is_id, me: int, n_shards: int, m_pad: int, l_max: int):
    """Stripe ``me``'s L rows (or set-target interior index), their owner
    mask and overflow flags, and its direct-edge hits."""
    pad = m_pad - 1
    b = len(s)
    own_t = (tg % n_shards) == me
    l_id, l_over = _padded_rows(t["l_ip"], t["l_v"], tg, own_t, n_shards, l_max, pad)
    t_local = torch.where(own_t, tg // n_shards, 0)
    t_int = t["int"][t_local].long()
    l_set = torch.where((t_int >= 0) & own_t, t_int, pad)[:, None]
    width = max(l_id.shape[1], 1)
    l_set = torch.cat([l_set, torch.full((b, width - 1), pad, device=s.device)], 1)
    l = torch.where(is_id[:, None], l_id, l_set)
    l_over = l_over & is_id  # set targets never overflow
    # direct edge: owner(start) binary-searches its full-out CSR row
    # (dst-sorted within the row), a vectorised lower_bound
    own_s = (s % n_shards) == me
    out_ip, out_v = t["out_ip"], t["out_v"]
    s_local = torch.where(own_s, s // n_shards, 0)
    lo = out_ip[s_local].long()
    hi0 = out_ip[s_local + 1].long()
    hi = hi0
    size = out_v.shape[0]
    n_steps = max(1, int(np.ceil(np.log2(max(size, 2))))) + 1
    for _ in range(n_steps):
        active = lo < hi
        mid = (lo + hi) // 2
        less = out_v[mid.clamp(0, size - 1)] < tg
        lo = torch.where(active & less, mid + 1, lo)
        hi = torch.where(active & ~less, mid, hi)
    found = (lo < hi0) & (out_v[lo.clamp(0, size - 1)] == tg)
    return l, own_t, l_over, own_s & found


def _sharded_closure_check(
    placement: Placement, start, target, is_id, depth,
    *, mesh: Mesh, n_shards: int, m_pad: int, f0_max: int, l_max: int, pn: int,
):
    """(allowed, overflow): per data row, bool tensors on the row's first
    device (unmaterialised: the caller's ``.cpu()`` waits). D replicated,
    CSRs node-striped over 'edge', the batch (numpy, a multiple of the data
    axis) split over 'data'."""
    del pn  # the stripes carry their own row counts
    n_data = mesh.shape["data"]
    bl = len(start) // n_data
    allowed_rows, overflow_rows = [], []
    for r in range(n_data):
        row = mesh.row(r)
        home = row[0]
        sl = slice(r * bl, (r + 1) * bl)
        host = (
            torch.from_numpy(np.ascontiguousarray(start[sl])).long(),
            torch.from_numpy(np.ascontiguousarray(target[sl])).long(),
            torch.from_numpy(np.ascontiguousarray(is_id[sl])),
        )
        stripes = [placement.stripe(r, k) for k in range(n_shards)]
        inputs = {}
        for dev in dict.fromkeys(row):
            inputs[dev] = tuple(x.to(dev) for x in host)
        # phase 1, then the pmin over 'edge'
        parts = [
            _stripe_phase1(stripes[k], inputs[dev][0], k, n_shards, m_pad, f0_max)
            for k, dev in enumerate(row)
        ]
        dvec = pmin([p[0] for p in parts], home)
        f0_over = pmax([p[1] for p in parts], home)
        # phase 2: each stripe's L rows meet dvec on the row's first device
        s, tg, isid = inputs[home]
        rows = torch.arange(bl, device=home)[:, None]
        inf = torch.tensor(INF_DIST, dtype=torch.uint8, device=home)
        best_parts, l_over_parts, direct_parts = [], [], []
        for k, dev in enumerate(row):
            l, own_t, l_over, hit = _stripe_phase2(
                stripes[k], *inputs[dev], k, n_shards, m_pad, l_max)
            picked = dvec[rows, l.to(home)]
            best_local = picked.amin(1)
            best_parts.append(torch.where(own_t.to(home) | isid, best_local, inf))
            l_over_parts.append(l_over)
            direct_parts.append(hit)
        best = pmin(best_parts, home)
        direct = pmax(direct_parts, home)
        overflow = f0_over | pmax(l_over_parts, home)
        dp = torch.from_numpy(np.ascontiguousarray(depth[sl])).to(home).int()
        best32 = best.int()
        best32 = torch.where(best32 >= INF_DIST, 1 << 30, best32)
        allowed = (direct & (dp >= 1)) | (1 + best32 + isid.int() <= dp)
        allowed_rows.append(allowed)
        overflow_rows.append(overflow)
    return allowed_rows, overflow_rows


def to_host(rows) -> np.ndarray:
    """Per-row device results -> one host array (waits for the devices)."""
    return torch.cat([r.cpu() for r in rows]).numpy()


class ShardedClosureEngine:
    """ClosureCheckEngine's multi-device sibling: D replicated, boundary
    CSRs node-striped over the mesh's 'edge' axis, the batch data-parallel
    over 'data'. The engine for graphs whose CSRs exceed one device."""

    def __init__(
        self,
        snapshots: SnapshotManager,
        mesh: Optional[Mesh] = None,
        max_depth: int = DEFAULT_MAX_DEPTH,
        f0_max: int = 32,
        l_max: int = 32,
        f0_max_escalated: int = 512,
        l_max_escalated: int = 512,
        fallback=None,
    ):
        self.snapshots = snapshots
        self.mesh = mesh if mesh is not None else make_mesh()
        self.global_max_depth = max_depth
        self.f0_max = f0_max
        self.l_max = l_max
        # second-pass gather widths for the wide fan-out tail (a user in
        # hundreds of groups): wide enough that the host oracle is rare,
        # narrow enough that the escalated pass stays cheap
        self.f0_max_escalated = f0_max_escalated
        self.l_max_escalated = l_max_escalated
        self.n_data = self.mesh.shape["data"]
        self.n_edge = self.mesh.shape["edge"]
        self._lock = threading.Lock()
        self._resident = None  # (snap, ig, m_pad, Placement, shard_bytes)
        self._fallback = fallback
        # rows seen / escalated to the wide pass / beyond it (host oracle)
        self.overflow_stats = {"rows": 0, "escalated": 0, "host_fallback": 0}

    def fallback_engine(self):
        if self._fallback is None:
            self._fallback = CheckEngine(self.snapshots.store, max_depth=self.global_max_depth)
        return self._fallback

    # -- residency -------------------------------------------------------------

    def _shard_bytes(self, host: dict, m_pad: int) -> dict:
        n = self.n_edge
        shard_bytes = {
            "d_replicated": int(m_pad) * int(m_pad),
            "f0_indptr": host["f0_ip"].nbytes // n,
            "f0_vals": host["f0_v"].nbytes // n,
            "l_indptr": host["l_ip"].nbytes // n,
            "l_vals": host["l_v"].nbytes // n,
            "interior_index": host["int"].nbytes // n,
            "out_indptr": host["out_ip"].nbytes // n,
            "out_vals": host["out_v"].nbytes // n,
        }
        shard_bytes["total_per_shard"] = sum(shard_bytes.values())
        return shard_bytes

    def _build_resident(self, snap: GraphSnapshot):
        ig = build_interior(snap)
        n = self.n_edge
        pn = snap.padded_nodes
        m_pad = -(-(ig.m + 1) // 256) * 256
        packed = pack_adjacency(ig.ii_src, ig.ii_dst, m_pad)
        d = build_closure_packed(
            packed, ig.m, m_pad=m_pad, k_max=self.global_max_depth - 1,
            device=self.mesh.devices[0][0],
        )
        f0_ip, f0_v, _ = _stripe_csr(ig.set_out_indptr, ig.set_out_vals, pn, n)
        l_ip, l_v, _ = _stripe_csr(ig.id_in_indptr, ig.id_in_vals, pn, n)
        int_idx = _stripe_vector(ig.interior_index, pn, n, -1)
        # the direct-edge probe: the full-out CSR (all successors by src)
        # with dsts sorted within each row, binary-searched in int32
        e = snap.num_edges
        src = snap.src[:e]
        dst = snap.dst[:e]
        order = np.lexsort((dst, src))
        counts = np.bincount(src, minlength=pn)
        full_indptr = np.zeros(pn + 1, dtype=np.int64)
        np.cumsum(counts, out=full_indptr[1:])
        out_ip, out_v, _ = _stripe_csr(full_indptr.astype(np.int64), dst[order], pn, n)
        host = {"d": d, "f0_ip": f0_ip, "f0_v": f0_v, "l_ip": l_ip, "l_v": l_v,
                "int": int_idx, "out_ip": out_ip, "out_v": out_v}
        return (snap, ig, m_pad, Placement(self.mesh, host), self._shard_bytes(host, m_pad))

    def _residency(self, snap: GraphSnapshot):
        with self._lock:
            r = self._resident
            if r is not None and r[0] is snap:
                return r
            r = self._build_resident(snap)
            self._resident = r
            return r

    def shard_bytes(self) -> dict:
        """Per-shard residency byte accounting."""
        r = self._residency(self.snapshots.snapshot())
        return dict(r[-1])

    # -- query -----------------------------------------------------------------

    def _bucket_batch(self, k: int) -> int:
        per_device = -(-max(k, 8) // self.n_data)
        per_device = 1 << (per_device - 1).bit_length()
        return per_device * self.n_data

    def _device_pass(self, r, sv, tv, fv, dv, f0_w, l_w):
        """Dispatch one pass over the mesh; returns per-row device results
        (unmaterialised: reading them waits)."""
        snap, _ig, m_pad, placement, _bytes = r
        return _sharded_closure_check(
            placement, sv, tv, fv, dv,
            mesh=self.mesh, n_shards=self.n_edge, m_pad=m_pad,
            f0_max=f0_w, l_max=l_w, pn=snap.padded_nodes,
        )

    def check_ids(
        self,
        start: np.ndarray,
        target: np.ndarray,
        is_id: Optional[np.ndarray] = None,
        depths: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        start = np.asarray(start, dtype=np.int64)
        if len(start) == 0:
            return np.zeros(0, dtype=bool)
        target = np.asarray(target, dtype=np.int64)
        snap = self.snapshots.snapshot()
        r = self._residency(snap)
        n = len(start)
        b = self._bucket_batch(n)
        pn = snap.padded_nodes
        dummy = snap.dummy_node
        gmax = self.global_max_depth
        s = np.full(b, dummy, dtype=np.int32)
        t = np.full(b, dummy, dtype=np.int32)
        flag = np.zeros(b, dtype=bool)
        depth = np.ones(b, dtype=np.int32)
        s[:n] = np.where((start < 0) | (start >= pn), dummy, start)
        t[:n] = np.where((target < 0) | (target >= pn), dummy, target)
        if is_id is None:
            # inferred from the vocab when the caller did not say
            is_set = snap.vocab.is_set_array()
            if len(is_set):
                safe = np.clip(t[:n], 0, len(is_set) - 1)
                flag[:n] = ~is_set[safe]
            else:
                # an empty vocab (boot warmup before any write): every
                # target is an unknown id, clamped to dummy and denied
                flag[:n] = True
        else:
            flag[:n] = np.asarray(is_id, dtype=bool)[:n]
        if depths is None:
            depth[:n] = gmax
        else:
            want = np.asarray(depths, dtype=np.int32)
            depth[:n] = np.where((want <= 0) | (want > gmax), gmax, want)
        allowed, overflow = self._device_pass(r, s, t, flag, depth, self.f0_max, self.l_max)
        allowed = to_host(allowed)[:n].copy()
        overflow = to_host(overflow)[:n]
        self.overflow_stats["rows"] += n
        return self._resolve_overflow(r, snap, allowed, overflow, s, t, flag, depth, n)

    def _resolve_overflow(self, r, snap, allowed, overflow, s, t, flag, depth, n) -> np.ndarray:
        """Wide fan-out rows: a second pass at the escalated gather widths;
        rows past those too go to the exact host oracle (dummy and unknown
        endpoints decode to inert empties the oracle denies)."""
        if overflow.any():
            idxs = np.nonzero(overflow)[0]
            self.overflow_stats["escalated"] += len(idxs)
            k = len(idxs)
            dummy = snap.dummy_node
            b2 = self._bucket_batch(k)
            s2 = np.full(b2, dummy, dtype=np.int32)
            t2 = np.full(b2, dummy, dtype=np.int32)
            flag2 = np.zeros(b2, dtype=bool)
            depth2 = np.ones(b2, dtype=np.int32)
            s2[:k], t2[:k] = s[idxs], t[idxs]
            flag2[:k], depth2[:k] = flag[idxs], depth[idxs]
            allowed2, overflow2 = self._device_pass(
                r, s2, t2, flag2, depth2, self.f0_max_escalated, self.l_max_escalated)
            allowed[idxs] = to_host(allowed2)[:k]
            overflow = np.zeros(n, dtype=bool)
            overflow[idxs[to_host(overflow2)[:k]]] = True
        if overflow.any():
            fb = self.fallback_engine()
            idxs = np.nonzero(overflow)[0]
            self.overflow_stats["host_fallback"] += len(idxs)
            res = fb.batch_check(
                self._decode(snap, s[idxs], t[idxs]),
                depths=[int(depth[i]) for i in idxs],
            )
            allowed[idxs] = res
        return allowed

    @staticmethod
    def _decode(snap, s, t) -> list:
        vocab = snap.vocab
        n_live = min(len(vocab), snap.dummy_node)
        reqs = []
        for si, ti in zip(s.tolist(), t.tolist()):
            ns, obj, rel = vocab.key(si) if si < n_live else ("", "", "")
            subject = vocab.subject_of(ti) if ti < n_live else SubjectID(id="")
            reqs.append(RelationTuple(namespace=ns, object=obj, relation=rel, subject=subject))
        return reqs

    def batch_check(
        self,
        requests: Sequence[RelationTuple],
        max_depth: int = 0,
        depths: Optional[Sequence[int]] = None,
    ) -> list[bool]:
        if not requests:
            return []
        snap = self.snapshots.snapshot()
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
        is_id = np.fromiter((len(k) == 1 for k in tkeys), bool, count=len(requests))
        if depths is not None:
            want = np.asarray(depths, dtype=np.int32)
        else:
            want = np.full(len(requests), max_depth, dtype=np.int32)
        return self.check_ids(start, target, is_id, want).tolist()

    def subject_is_allowed(self, requested: RelationTuple, max_depth: int = 0) -> bool:
        return self.batch_check([requested], max_depth)[0]
