"""Host closure builder: masked bitset SpMV over numpy (counterpart of
``keto_tpu/engine/semiring.py``).

The closure matrix D (``ops/closure.py``) is row-separable: D[i, :] is a
depth-bounded BFS from interior node i, independent of every other row. So
the build is a batched multi-source BFS under the boolean (OR, AND)
semiring:

    frontier_k = (frontier_{k-1} x A)  AND NOT reached      (masked SpMV)

with bitset rows (1 bit per node, the ``np.packbits`` layout of
``ops.closure.pack_adjacency``), so one OR over a byte advances 8 adjacency
slots, and only newly reached nodes contribute adjacency rows to the next
step. This is what host query mode builds D with: the same masked step
that kernel B1 runs on the card, here in numpy, so a process that serves
from a host D never touches the card.

Row groups are ordered by the snapshot's SCC/level blocks
(``graph.interior.interior_blocks``) and built by a small thread pool
(numpy releases the interpreter lock for the large bit operations).

Incremental rebuilds: an interior edge delta invalidates exactly the rows
that can reach a changed edge's source within k_max - 1 hops (every
affected path crosses its first changed edge after a prefix of unchanged
edges, which a reverse BFS over the union adjacency sees).
``update_closure_bitset`` recomputes only those dirty rows, refined to
condensation-ancestor blocks for delete-only deltas; every other row
carries over byte for byte.

Parity contract: the same uint8 D as ``ops.closure.build_closure_packed``
and ``engine.masked_spmv.build_closure_semiring``: distances clamped at
k_max, INF_DIST (255) elsewhere, diagonal 0 on live rows, padding rows all
INF.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from ..graph.interior import InteriorBlocks
from ..ops.closure import INF_DIST, pack_adjacency

# row-group granularity of the batched BFS: the unit of thread-pool work
# and of the unpackbits staging buffer (group x m_pad bytes, ~4 MB at the
# 16k interior limit)
_ROW_GROUP = 256


def _bfs_rows_into(
    d_out: np.ndarray,
    adj_packed: np.ndarray,
    has_out: np.ndarray,
    rows: np.ndarray,
    m_pad: int,
    k_max: int,
    out_rows: Optional[np.ndarray] = None,
) -> None:
    """Masked-SpMV BFS from each of `rows`, writing uint8 distance rows into
    d_out[rows] (pre-filled with INF), or into d_out[out_rows] when given (a
    compact output, as the scrubber's). `has_out` (bool[m_pad]) marks the
    nodes with an out-edge: only their adjacency rows are ORed, since a
    sink's row is all zero (at rbac1m 10 000 of the 11 000 interior nodes
    are groups, sinks of the interior graph)."""
    n = len(rows)
    if n == 0:
        return
    # distance 1 = the sources' own adjacency rows
    frontier = adj_packed[rows].copy()  # uint8[n, m_pad / 8] bitset
    reached = frontier.copy()
    k = 1
    while True:
        fb = np.unpackbits(frontier, axis=1)  # the frontier, one byte per bit
        rs, vs = np.nonzero(fb)
        if rs.size == 0:
            return
        d_out[(rows if out_rows is None else out_rows)[rs], vs] = k
        if k == k_max:
            return
        k += 1
        # the masked step: OR the adjacency rows of newly reached nodes into
        # each source's next frontier, then drop every node already settled
        nxt = np.zeros_like(frontier)
        keep = has_out[vs]
        np.bitwise_or.at(nxt, rs[keep], adj_packed[vs[keep]])
        frontier = nxt & ~reached
        reached |= frontier


def _bfs_groups(
    d: np.ndarray,
    adj_packed: np.ndarray,
    groups: list[np.ndarray],
    m_pad: int,
    k_max: int,
    workers: int,
    name: str,
) -> None:
    """Run _bfs_rows_into over row groups, on `workers` threads when > 1."""
    has_out = adj_packed.any(axis=1)

    def run(g):
        _bfs_rows_into(d, adj_packed, has_out, g, m_pad, k_max)

    if workers > 1 and len(groups) > 1:
        with ThreadPoolExecutor(max_workers=workers, thread_name_prefix=name) as ex:
            list(ex.map(run, groups))
    else:
        for g in groups:
            run(g)


def build_closure_bitset(
    ii_src: np.ndarray,
    ii_dst: np.ndarray,
    m: int,
    m_pad: int,
    k_max: int,
    *,
    workers: int = 0,
    blocks: Optional[InteriorBlocks] = None,
    adj_packed: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Full closure build on the host: uint8[m_pad, m_pad], byte-equal to
    the device builders. `workers` > 1 builds row groups concurrently;
    `blocks` orders the groups block-coherently."""
    if adj_packed is None:
        adj_packed = pack_adjacency(ii_src, ii_dst, m_pad)
    d = np.full((m_pad, m_pad), INF_DIST, dtype=np.uint8)
    if m > 0:
        if blocks is not None and blocks.m == m:
            order = blocks.build_order
        else:
            order = np.arange(m, dtype=np.int32)
        groups = [order[i : i + _ROW_GROUP] for i in range(0, m, _ROW_GROUP)]
        _bfs_groups(d, adj_packed, groups, m_pad, k_max, workers, "closure-blk")
        # diagonal 0 on live rows only; the padding diagonal stays INF so the
        # PAD index is inert in queries
        live = np.arange(m)
        d[live, live] = 0
    return d


def interior_edge_delta(
    prev_src: np.ndarray,
    prev_dst: np.ndarray,
    new_src: np.ndarray,
    new_dst: np.ndarray,
    m_pad: int,
) -> tuple[np.ndarray, np.ndarray]:
    """(inserted int64[ni], deleted int64[nd]) edge keys u * m_pad + v
    between two interior COO edge sets over the same interior index space.
    Duplicates collapse (the adjacency is boolean)."""
    pk = np.unique(prev_src.astype(np.int64) * m_pad + prev_dst.astype(np.int64))
    nk = np.unique(new_src.astype(np.int64) * m_pad + new_dst.astype(np.int64))
    inserted = np.setdiff1d(nk, pk, assume_unique=True)
    deleted = np.setdiff1d(pk, nk, assume_unique=True)
    return inserted, deleted


def _reverse_reach(
    rev_packed: np.ndarray,
    seeds: np.ndarray,
    m_pad: int,
    steps: int,
) -> np.ndarray:
    """bool[m_pad]: nodes that reach any seed within <= steps hops, one
    multi-source BFS over the reversed bitset adjacency."""
    seed_bits = np.zeros(m_pad, dtype=np.uint8)
    seed_bits[seeds] = 1
    frontier = np.packbits(seed_bits)
    reached = frontier.copy()
    for _ in range(steps):
        vs = np.nonzero(np.unpackbits(frontier))[0]
        if vs.size == 0:
            break
        nxt = np.bitwise_or.reduce(rev_packed[vs], axis=0)
        frontier = nxt & ~reached
        reached |= frontier
    return np.unpackbits(reached).astype(bool)[:m_pad]


def dirty_rows(
    inserted: np.ndarray,
    deleted: np.ndarray,
    prev_src: np.ndarray,
    prev_dst: np.ndarray,
    new_src: np.ndarray,
    new_dst: np.ndarray,
    m: int,
    m_pad: int,
    k_max: int,
    blocks: Optional[InteriorBlocks] = None,
) -> np.ndarray:
    """int32 rows whose closure may differ after the edge delta.

    A path the delta affects crosses its first changed edge (u, v) after a
    prefix of unchanged edges (present in both graphs, hence in the union)
    of length <= k_max - 1. So a reverse BFS from the changed sources over
    the union adjacency, k_max - 1 steps, is a sound dirty superset. For a
    delete-only delta with block metadata the set is intersected with the
    condensation ancestors of the changed blocks: the blocks were computed
    on the previous adjacency, which covers the union only when nothing was
    inserted."""
    changed_u = np.unique(np.concatenate([inserted, deleted]) // m_pad).astype(
        np.int64
    )
    if changed_u.size == 0:
        return np.zeros(0, dtype=np.int32)
    union_src = np.concatenate([prev_src, new_src])
    union_dst = np.concatenate([prev_dst, new_dst])
    rev_packed = pack_adjacency(union_dst, union_src, m_pad)
    dirty = _reverse_reach(rev_packed, changed_u, m_pad, k_max - 1)
    dirty[changed_u] = True
    dirty[m:] = False
    if (
        blocks is not None
        and blocks.m == m
        and blocks.n_blocks
        and inserted.size == 0
    ):
        changed_blocks = np.unique(blocks.comp[changed_u])
        ancestor = _block_ancestors(blocks, changed_blocks, prev_src, prev_dst)
        dirty[:m] &= ancestor[blocks.comp[np.arange(m)]]
    return np.nonzero(dirty)[0].astype(np.int32)


def _block_ancestors(
    blocks: InteriorBlocks,
    changed_blocks: np.ndarray,
    ii_src: np.ndarray,
    ii_dst: np.ndarray,
) -> np.ndarray:
    """bool[n_blocks]: blocks that reach any changed block in the
    condensation DAG (the changed blocks included)."""
    mark = np.zeros(blocks.n_blocks, dtype=bool)
    mark[changed_blocks] = True
    cs = blocks.comp[ii_src]
    cd = blocks.comp[ii_dst]
    # propagate backwards; the DAG has at most n_levels frontiers
    for _ in range(max(blocks.n_levels, 1)):
        nxt = mark.copy()
        nxt[cs[mark[cd]]] = True
        if (nxt == mark).all():
            break
        mark = nxt
    return mark


def update_closure_bitset(
    d_prev: np.ndarray,
    prev_src: np.ndarray,
    prev_dst: np.ndarray,
    new_src: np.ndarray,
    new_dst: np.ndarray,
    m: int,
    m_pad: int,
    k_max: int,
    *,
    workers: int = 0,
    blocks: Optional[InteriorBlocks] = None,
) -> tuple[np.ndarray, int]:
    """Incremental closure update for any interior edge delta (inserts and
    deletes): (d_new, number of dirty rows); d_prev is not modified."""
    d, rows = update_closure_bitset_ex(
        d_prev, prev_src, prev_dst, new_src, new_dst, m, m_pad, k_max,
        workers=workers, blocks=blocks,
    )
    return d, int(rows.size)


def update_closure_bitset_ex(
    d_prev: np.ndarray,
    prev_src: np.ndarray,
    prev_dst: np.ndarray,
    new_src: np.ndarray,
    new_dst: np.ndarray,
    m: int,
    m_pad: int,
    k_max: int,
    *,
    workers: int = 0,
    blocks: Optional[InteriorBlocks] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """``update_closure_bitset`` returning (d_new, dirty rows int32[]): the
    rows whose bytes may differ, which is what ``update_transpose`` needs to
    re-gather only the touched columns of D^T. Dirty rows are recomputed
    from scratch on the new adjacency; the others carry over."""
    inserted, deleted = interior_edge_delta(prev_src, prev_dst, new_src, new_dst, m_pad)
    if inserted.size == 0 and deleted.size == 0:
        return d_prev, np.zeros(0, dtype=np.int32)
    rows = dirty_rows(
        inserted, deleted, prev_src, prev_dst, new_src, new_dst, m, m_pad,
        k_max, blocks=blocks,
    )
    d = d_prev.copy()
    if rows.size:
        adj_packed = pack_adjacency(new_src, new_dst, m_pad)
        d[rows] = INF_DIST
        if rows.size > _ROW_GROUP:
            groups = [rows[i : i + _ROW_GROUP] for i in range(0, rows.size, _ROW_GROUP)]
        else:
            groups = [rows]
        _bfs_groups(d, adj_packed, groups, m_pad, k_max, workers, "closure-incr")
        d[rows, rows] = 0  # dirty rows are live by construction
    return d, rows


def transpose_closure(d: np.ndarray) -> np.ndarray:
    """D^T materialized contiguously: row j is column j of D, every interior
    source within distance D[i, j] of j (the list_objects gather)."""
    return np.ascontiguousarray(d.T)


def update_transpose(d_rev: np.ndarray, d_new: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """Incremental D^T: the dirty rows of D are exactly the dirty columns of
    D^T, so only those are re-gathered. Returns a new array; d_rev is not
    modified (an older snapshot may still serve it)."""
    if rows.size == 0:
        return d_rev
    out = d_rev.copy()
    out[:, rows] = d_new[rows, :].T
    return out
