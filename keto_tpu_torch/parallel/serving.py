"""Sharded serving tier: the node-striped mesh closure engine as a serving
path (counterpart of ``keto_tpu/parallel/serving.py``).

:class:`ShardedServingEngine` wraps :class:`.closure_sharded.
ShardedClosureEngine` with what ``CheckBatcher`` and the circuit breaker
need to route live check traffic into the mesh:

- the split ``encode_ids``/``launch_encoded``/``decode_launched`` API (the
  contract of ``DeviceCheckEngine``), so the batcher's encoded and
  columnar paths, the breaker's host-oracle fallback and its OOM bisection
  work unchanged. Overflow rows (fan-out past the escalated gather widths)
  are answered by the exact host oracle, the funnel the breaker uses for
  failed batches;
- residency that survives snapshot rebuilds: the replicated interior
  distance matrix D is kept as a host uint8 bitset and updated with the
  semiring dirty-row machinery (``update_closure_bitset``) on append-only
  deltas, and only the node stripes whose shards own a touched node are
  gathered again. Device tensors of untouched components are reused (keyed
  on the host array's identity), so a delta that only appends direct edges
  uploads the full-out stripes and nothing else;
- per-shard residency accounting pushed into HBM admission
  (``HbmAdmission.set_shard_residency``), so batch admission respects the
  headroom of the fullest shard, and exported as
  ``keto_shard_residency_bytes{shard}``, with
  ``keto_shard_escalations_total{path}`` counting the wide-pass and
  host-oracle tail and ``keto_shard_reshards_total{kind}`` the rebuilds.

The single-device engines stay the right choice below one device's memory;
the registry routes here only when ``engine.sharding.enabled`` is set and
the mesh has more than one device (``driver/registry.py``). D is built on
the host (``build_closure_bitset``), so this tier launches no B1.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from ..engine.check import DEFAULT_MAX_DEPTH
from ..engine.device import _decode_ids
from ..engine.semiring import build_closure_bitset, update_closure_bitset
from ..faults import FAULTS
from ..graph.interior import build_interior
from ..graph.snapshot import GraphSnapshot, SnapshotManager
from .closure_sharded import (
    Placement,
    ShardedClosureEngine,
    _stripe_csr,
    _stripe_vector,
    to_host,
)
from .sharded import Mesh


class _ShardedEncodedBatch:
    """A pure-id batch parked between encode and launch on the sharded
    path: plain numpy arrays (no staging pool), with exactly the attributes
    the breaker's fallback and bisection read (``n``, ``b``, ``snap``,
    ``start``, ``target``, ``depths``, lazy ``requests``)."""

    __slots__ = (
        "_requests", "_cols", "depths", "deadlines", "n", "b", "snap",
        "start", "target", "depth", "flag",
    )

    def __init__(self, depths, n, b, snap, start, target, flag, depth):
        self._requests = None
        self._cols = None
        self.depths = depths
        self.deadlines = None
        self.n = n
        self.b = b
        self.snap = snap
        self.start = start
        self.target = target
        self.depth = depth
        self.flag = flag

    @property
    def requests(self):
        """Per-item RelationTuples, decoded through the snapshot vocab on
        first access: only the breaker's host-oracle fallback reads this."""
        if self._requests is None:
            self._requests = _decode_ids(self.snap, self.start[: self.n], self.target[: self.n])
        return self._requests

    @property
    def version(self) -> int:
        return self.snap.version

    def keys(self) -> list[tuple[int, int, int]]:
        n = self.n
        return list(zip(self.start[:n].tolist(), self.target[:n].tolist(),
                        self.depth[:n].tolist()))

    def compact(self, keep: Sequence[int]) -> None:
        m = len(keep)
        if m == self.n:
            return
        idx = np.asarray(keep, dtype=np.int64)
        self.start[:m] = self.start[idx]
        self.target[:m] = self.target[idx]
        self.depth[:m] = self.depth[idx]
        self.flag[:m] = self.flag[idx]
        dummy = self.snap.dummy_node
        self.start[m : self.n] = dummy
        self.target[m : self.n] = dummy
        self.depth[m : self.n] = 1
        self.flag[m : self.n] = False
        if self._requests is not None:
            self._requests = [self._requests[i] for i in keep]
        if self.depths is not None:
            self.depths = [self.depths[i] for i in keep]
        if self.deadlines is not None:
            self.deadlines = [self.deadlines[i] for i in keep]
        self.n = m

    def release(self) -> None:
        """No staging pool on this path: the breaker's and the batcher's
        release contract, a no-op."""


class _ShardedLaunched:
    """A dispatched sharded batch: per-row device results not yet read.
    Reading them (and the overflow escalation) happens in
    :meth:`ShardedServingEngine.decode_launched`."""

    __slots__ = ("enc", "allowed", "overflow")

    def __init__(self, enc, allowed, overflow):
        self.enc = enc
        self.allowed = allowed
        self.overflow = overflow


class ShardedServingEngine(ShardedClosureEngine):
    """The serving wrapper around the node-striped mesh closure check. The
    query math is inherited; this class owns the residency's lifetime, the
    split batch API, escalation accounting and the admission and metrics
    seams."""

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
        edge_chunk: int = 0,
        escalation_budget: float = 0.05,
        hbm=None,
        metrics=None,
        logger=None,
    ):
        super().__init__(
            snapshots,
            mesh=mesh,
            max_depth=max_depth,
            f0_max=f0_max,
            l_max=l_max,
            f0_max_escalated=f0_max_escalated,
            l_max_escalated=l_max_escalated,
            fallback=fallback,
        )
        # bound on the ragged-gather temporaries of one re-stripe pass
        # (values gathered per chunk); 0 = unchunked
        self.edge_chunk = int(edge_chunk)
        # tolerated host-oracle fraction per batch before the breach is
        # logged and counted: the rebalance signal, not a hard limit
        self.escalation_budget = float(escalation_budget)
        self.hbm = hbm
        self.logger = logger
        # the host artifacts the incremental re-shard carries across
        # snapshots: {"snap", "ig", "m_pad", "d", "f0", "l", "int", "out",
        # "n_dirty", "shards"}; stripe pairs are (indptr, vals) stacked
        # [n_shards, ...] numpy arrays
        self._host: Optional[dict] = None
        self.n_full_reshards = 0
        self.n_incremental_reshards = 0
        self.last_reshard: dict = {}
        self.n_budget_breaches = 0
        self._m_residency = self._m_escalations = self._m_reshards = None
        if metrics is not None:
            self._m_residency = metrics.gauge(
                "keto_shard_residency_bytes",
                "bytes resident on each mesh shard for the sharded "
                "serving tier (replicated D + this shard's CSR stripes; "
                "logical nnz, excluding stripe padding)",
                labelnames=("shard",),
            )
            self._m_escalations = metrics.counter(
                "keto_shard_escalations_total",
                "sharded-serving rows escalated past the narrow device "
                "pass, by path (wide_pass = second device pass at "
                "escalated gather widths; host_oracle = exact host "
                "fallback beyond even those)",
                labelnames=("path",),
            )
            self._m_reshards = metrics.counter(
                "keto_shard_reshards_total",
                "mesh residency rebuilds by kind (full = re-shard the "
                "world; incremental = dirty-row D update + affected-"
                "shard re-stripe only)",
                labelnames=("kind",),
            )

    # -- residency -------------------------------------------------------------

    def _workers(self) -> int:
        return min(8, max(1, (os.cpu_count() or 1) // 2))

    def _stripe_one(
        self, indptr: np.ndarray, vals: np.ndarray, pn: int, k: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """One shard's node-striped CSR rows: the single-shard body of
        ``_stripe_csr``, its ragged gather chunked to ``edge_chunk`` values so
        a hot shard's re-stripe has bounded temporaries."""
        n = self.n_edge
        local_rows = -(-pn // n)
        nodes = np.arange(k, pn, n, dtype=np.int64)
        row_counts = (indptr[nodes + 1] - indptr[nodes]).astype(np.int64)
        out_ip = np.zeros(local_rows + 1, dtype=np.int32)
        counts = np.zeros(local_rows, dtype=np.int64)
        counts[: len(nodes)] = row_counts
        out_ip[1:] = np.cumsum(counts).astype(np.int32)
        total = int(row_counts.sum())
        out_v = np.empty(total, dtype=np.int32)
        if total == 0:
            return out_ip, out_v
        cum = np.cumsum(row_counts)
        chunk = self.edge_chunk
        i = pos = 0
        while i < len(nodes):
            if chunk <= 0:
                j = len(nodes)
            else:
                base = cum[i - 1] if i else 0
                j = int(np.searchsorted(cum, base + chunk, side="left")) + 1
                j = min(max(j, i + 1), len(nodes))
            rc = row_counts[i:j]
            tot = int(rc.sum())
            if tot:
                starts_rep = np.repeat(indptr[nodes[i:j]].astype(np.int64), rc)
                within = np.arange(tot, dtype=np.int64) - np.repeat(np.cumsum(rc) - rc, rc)
                out_v[pos : pos + tot] = vals[starts_rep + within]
                pos += tot
            i = j
        return out_ip, out_v

    def _restripe(
        self,
        prev: tuple[np.ndarray, np.ndarray],
        indptr: np.ndarray,
        vals: np.ndarray,
        pn: int,
        shards: np.ndarray,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Gather only ``shards``' rows again from a fresh full CSR, reusing
        the previous stripe rows of every other shard. Returns the previous
        pair itself when no shard is affected: the upload keys device-tensor
        reuse on that identity."""
        if len(shards) == 0:
            return prev
        prev_ip, prev_v = prev
        n = self.n_edge
        rows = {}
        width = prev_v.shape[1]
        need = width
        for k in shards:
            row_ip, row_v = self._stripe_one(indptr, vals, pn, int(k))
            rows[int(k)] = (row_ip, row_v)
            need = max(need, len(row_v), 1)
        if need > width:
            new_v = np.zeros((n, need), dtype=np.int32)
            new_v[:, :width] = prev_v
        else:
            new_v = prev_v.copy()
        new_ip = prev_ip.copy()
        for k, (row_ip, row_v) in rows.items():
            new_ip[k] = row_ip
            new_v[k, : len(row_v)] = row_v
            new_v[k, len(row_v) :] = 0
        return new_ip, new_v

    def _full_out_shard(self, snap: GraphSnapshot, k: int) -> tuple[np.ndarray, np.ndarray]:
        """One shard's direct-edge probe rows (dst-sorted within the row),
        rebuilt from that shard's edges alone: O(E_k log E_k) instead of the
        global lexsort."""
        n = self.n_edge
        pn = snap.padded_nodes
        local_rows = -(-pn // n)
        e = snap.num_edges
        src = snap.src[:e]
        dst = snap.dst[:e]
        mask = (src % n) == k
        s_k = src[mask]
        d_k = dst[mask]
        order = np.lexsort((d_k, s_k))
        s_k = s_k[order]
        local = (s_k // n).astype(np.int64)
        counts = np.bincount(local, minlength=local_rows)
        row_ip = np.zeros(local_rows + 1, dtype=np.int32)
        np.cumsum(counts, out=row_ip[1:])
        return row_ip, d_k[order].astype(np.int32)

    def _restripe_out(
        self,
        prev: tuple[np.ndarray, np.ndarray],
        snap: GraphSnapshot,
        shards: np.ndarray,
    ) -> tuple[np.ndarray, np.ndarray]:
        if len(shards) == 0:
            return prev
        prev_ip, prev_v = prev
        n = self.n_edge
        rows = {int(k): self._full_out_shard(snap, int(k)) for k in shards}
        width = prev_v.shape[1]
        need = max([width] + [len(v) for _, v in rows.values()] + [1])
        if need > width:
            new_v = np.zeros((n, need), dtype=np.int32)
            new_v[:, :width] = prev_v
        else:
            new_v = prev_v.copy()
        new_ip = prev_ip.copy()
        for k, (row_ip, row_v) in rows.items():
            new_ip[k] = row_ip
            new_v[k, : len(row_v)] = row_v
            new_v[k, len(row_v) :] = 0
        return new_ip, new_v

    def _reshard_full(self, snap: GraphSnapshot) -> dict:
        ig = build_interior(snap)
        n = self.n_edge
        pn = snap.padded_nodes
        m_pad = -(-(ig.m + 1) // 256) * 256
        # D built and kept on the host (uint8 bitset BFS, byte-equal to the
        # device builders), so writes update its dirty rows instead of
        # recomputing the O(M^2) matrix per snapshot
        d_host = build_closure_bitset(
            ig.ii_src, ig.ii_dst, ig.m, m_pad,
            self.global_max_depth - 1, workers=self._workers(),
        )
        f0 = _stripe_csr(ig.set_out_indptr, ig.set_out_vals, pn, n)[:2]
        l = _stripe_csr(ig.id_in_indptr, ig.id_in_vals, pn, n)[:2]
        int_idx = _stripe_vector(ig.interior_index, pn, n, -1)
        e = snap.num_edges
        src = snap.src[:e]
        dst = snap.dst[:e]
        order = np.lexsort((dst, src))
        counts = np.bincount(src, minlength=pn)
        full_indptr = np.zeros(pn + 1, dtype=np.int64)
        np.cumsum(counts, out=full_indptr[1:])
        out = _stripe_csr(full_indptr, dst[order], pn, n)[:2]
        return {
            "snap": snap, "ig": ig, "m_pad": m_pad, "d": d_host,
            "f0": f0, "l": l, "int": int_idx, "out": out,
            "n_dirty": ig.m, "shards": list(range(n)),
        }

    def _reshard_incremental(self, host: dict, snap: GraphSnapshot) -> Optional[dict]:
        """An append-only delta over the resident snapshot with a stable
        interior set: update D's dirty rows, gather again only the shards
        owning a touched node. None when those conditions do not hold (a
        vocab swap, a compaction, a change of the interior set): the
        caller re-shards in full."""
        old = host["snap"]
        pe = old.num_edges
        if (
            snap.vocab is not old.vocab
            or snap.padded_nodes != old.padded_nodes
            or snap.num_edges < pe
            or not np.array_equal(snap.src[:pe], old.src[:pe])
            or not np.array_equal(snap.dst[:pe], old.dst[:pe])
        ):
            return None
        ig = build_interior(snap)
        prev_ig = host["ig"]
        if not np.array_equal(ig.interior_ids, prev_ig.interior_ids):
            return None
        n = self.n_edge
        pn = snap.padded_nodes
        m_pad = host["m_pad"]
        d_new, n_dirty = update_closure_bitset(
            host["d"], prev_ig.ii_src, prev_ig.ii_dst,
            ig.ii_src, ig.ii_dst, ig.m, m_pad,
            self.global_max_depth - 1, workers=self._workers(),
        )
        new_src = snap.src[pe : snap.num_edges]
        new_dst = snap.dst[pe : snap.num_edges]
        # shard ownership of the touched CSR rows: F0 and the direct-edge
        # probe are source CSRs, L is a destination CSR
        src_shards = np.unique(new_src % n)
        dst_shards = np.unique(new_dst % n)
        return {
            "snap": snap, "ig": ig, "m_pad": m_pad, "d": d_new,
            "f0": self._restripe(host["f0"], ig.set_out_indptr, ig.set_out_vals, pn,
                                 src_shards),
            "l": self._restripe(host["l"], ig.id_in_indptr, ig.id_in_vals, pn, dst_shards),
            # the same interior set and padded width: the same index stripe
            "int": host["int"],
            "out": self._restripe_out(host["out"], snap, src_shards),
            "n_dirty": n_dirty,
            "shards": sorted(set(src_shards.tolist()) | set(dst_shards.tolist())),
        }

    def _upload(self, host: dict, prev_r):
        """Host artifacts -> the resident tuple (the parent's layout, so every
        inherited query path works). A component whose host array is the
        same object as the previous re-shard's keeps its device tensors:
        nothing is copied for an untouched stripe."""
        n = self.n_edge
        m_pad = host["m_pad"]
        f0_ip, f0_v = host["f0"]
        l_ip, l_v = host["l"]
        out_ip, out_v = host["out"]
        arrays = {"d": host["d"], "f0_ip": f0_ip, "f0_v": f0_v, "l_ip": l_ip, "l_v": l_v,
                  "int": host["int"], "out_ip": out_ip, "out_v": out_v}
        shard_bytes = self._shard_bytes(arrays, m_pad)
        # logical (nnz, unpadded) per-shard residency: the skew signal; the
        # padded stripe widths are equal across shards by construction
        fixed = (
            shard_bytes["d_replicated"]
            + shard_bytes["f0_indptr"]
            + shard_bytes["l_indptr"]
            + shard_bytes["out_indptr"]
            + shard_bytes["interior_index"]
        )
        shard_bytes["per_shard_logical"] = [
            fixed + 4 * (int(f0_ip[k, -1]) + int(l_ip[k, -1]) + int(out_ip[k, -1]))
            for k in range(n)
        ]
        prev = prev_r[3] if prev_r is not None else None
        return (host["snap"], host["ig"], m_pad, Placement(self.mesh, arrays, prev), shard_bytes)

    def _residency(self, snap: GraphSnapshot):
        with self._lock:
            r = self._resident
            if r is not None and r[0] is snap:
                return r
            prev_host = self._host
            new_host = None
            if prev_host is not None:
                new_host = self._reshard_incremental(prev_host, snap)
            if new_host is None:
                kind = "full"
                new_host = self._reshard_full(snap)
                self.n_full_reshards += 1
            else:
                kind = "incremental"
                self.n_incremental_reshards += 1
            r = self._upload(new_host, self._resident if prev_host is not None else None)
            self._host = new_host
            self._resident = r
            self.last_reshard = {
                "kind": kind,
                "dirty_rows": int(new_host["n_dirty"]),
                "shards": list(new_host["shards"]),
            }
            self._after_reshard(kind, r[-1])
            return r

    def _after_reshard(self, kind: str, shard_bytes: dict) -> None:
        per_shard = shard_bytes.get("per_shard_logical", [])
        if self._m_reshards is not None:
            self._m_reshards.labels(kind=kind).inc()
        if self._m_residency is not None:
            for k, b in enumerate(per_shard):
                self._m_residency.labels(shard=str(k)).set(float(b))
        if self.hbm is not None:
            push = getattr(self.hbm, "set_shard_residency", None)
            if push is not None:
                push({k: float(b) for k, b in enumerate(per_shard)})

    def reset_residency(self) -> None:
        """Drop every resident tensor (the device supervisor's re-init
        hook); the next batch rebuilds from scratch."""
        with self._lock:
            self._resident = None
            self._host = None

    # -- versions / lifecycle --------------------------------------------------

    def served_version(self) -> int:
        return self.snapshots.store.version

    def answering_version(self) -> int:
        return self.snapshots.store.version

    def wait_for_version(self, min_version: int, timeout_s: float = 5.0):
        """Each batch takes a fresh snapshot, so answers are always at the
        live store version: a local client token can never run ahead of it,
        and there is nothing to wait on."""
        return None

    def pipeline_supported(self) -> bool:
        # no string-path encode_batch: the encoded and columnar entry
        # points run on the caller's thread through encode_ids/launch/decode
        return False

    def warmup(self, batch: int = 8) -> None:
        """Build the residency of the current snapshot and run one narrow
        pass at a small bucket (boot and failover priming)."""
        n = max(1, min(int(batch) or 1, 64))
        self.check_ids(np.zeros(n, dtype=np.int64), np.zeros(n, dtype=np.int64))

    # -- escalation accounting -------------------------------------------------

    def _note_escalations(self, before: dict, n_rows: int) -> None:
        esc = self.overflow_stats["escalated"] - before["escalated"]
        host = self.overflow_stats["host_fallback"] - before["host_fallback"]
        if self._m_escalations is not None:
            if esc:
                self._m_escalations.labels(path="wide_pass").inc(esc)
            if host:
                self._m_escalations.labels(path="host_oracle").inc(host)
        if n_rows and host / n_rows > self.escalation_budget:
            self.n_budget_breaches += 1
            if self.logger is not None:
                self.logger.warning(
                    "sharded escalation budget breached",
                    host_oracle_rows=host,
                    batch_rows=n_rows,
                    budget=self.escalation_budget,
                )

    @staticmethod
    def _decode(snap, s, t) -> list:
        return _decode_ids(snap, s, t)

    def check_ids(
        self,
        start: np.ndarray,
        target: np.ndarray,
        is_id: Optional[np.ndarray] = None,
        depths: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        before = dict(self.overflow_stats)
        out = super().check_ids(start, target, is_id, depths)
        self._note_escalations(before, len(out))
        return out

    # -- split encode/launch/decode (the CheckBatcher and breaker seam) --------

    def encode_ids(self, start, target, depths=None):
        return self.encode_ids_at(self.snapshots.snapshot(), start, target, depths)

    def encode_ids_at(self, snap, start, target, depths=None):
        start = np.asarray(start, dtype=np.int64)
        target = np.asarray(target, dtype=np.int64)
        n = len(start)
        b = self._bucket_batch(max(n, 1))
        pn = snap.padded_nodes
        dummy = snap.dummy_node
        gmax = self.global_max_depth
        s = np.full(b, dummy, dtype=np.int32)
        t = np.full(b, dummy, dtype=np.int32)
        dp = np.ones(b, dtype=np.int32)
        flag = np.zeros(b, dtype=bool)
        s[:n] = np.where((start < 0) | (start >= pn), dummy, start)
        t[:n] = np.where((target < 0) | (target >= pn), dummy, target)
        if depths is None:
            dp[:n] = gmax
        else:
            want = np.asarray(depths, dtype=np.int32)
            dp[:n] = np.where((want <= 0) | (want > gmax), gmax, want)
        is_set = snap.vocab.is_set_array()
        if len(is_set):
            safe = np.clip(t[:n], 0, len(is_set) - 1)
            flag[:n] = ~is_set[safe]
        else:
            # an empty vocab (boot warmup before any write): every target is
            # an unknown id, clamped to dummy and denied anyway
            flag[:n] = True
        return _ShardedEncodedBatch(dp[:n].tolist(), n, b, snap, s, t, flag, dp)

    def launch_encoded(self, enc: _ShardedEncodedBatch) -> _ShardedLaunched:
        FAULTS.fire("shard.launch_fail")
        FAULTS.maybe_sleep("shard.launch_slow")
        r = self._residency(enc.snap)
        allowed, overflow = self._device_pass(
            r, enc.start, enc.target, enc.flag, enc.depth, self.f0_max, self.l_max,
        )
        return _ShardedLaunched(enc, allowed, overflow)

    def decode_launched(self, launched: _ShardedLaunched) -> list[bool]:
        enc = launched.enc
        n = enc.n
        allowed = to_host(launched.allowed)[:n].copy()
        overflow = to_host(launched.overflow)[:n]
        before = dict(self.overflow_stats)
        self.overflow_stats["rows"] += n
        r = self._residency(enc.snap)
        allowed = self._resolve_overflow(
            r, enc.snap, allowed, overflow, enc.start, enc.target, enc.flag, enc.depth, n,
        )
        self._note_escalations(before, n)
        return allowed.tolist()
