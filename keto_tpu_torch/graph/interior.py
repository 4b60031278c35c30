"""Interior-graph decomposition (counterpart of ``keto_tpu/graph/interior.py``).

In a relation-tuple graph every edge's *source* is a subject-set node, and
subject-id nodes are sinks. So every node that can appear in the middle of
a path is a subject set **with at least one incoming edge** — an *interior*
node. Real graphs have few of them (the 1M-tuple RBAC graph has ~520k nodes
but ~11k interior ones). Any check ``start ⇝ target`` is then either a
direct edge (depth 1) or ``start → s ⇝ s' → target`` with ``s ⇝ s'`` inside
the interior: total depth ``2 + d(s, s')`` for subject-id targets,
``1 + d(s, target)`` for set targets. The closure engine precomputes
``d`` over the interior once per snapshot; a check is CSR row gathers at
the boundary plus a lookup into ``d``.

Everything here is vectorized numpy over a snapshot's COO arrays.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .snapshot import GraphSnapshot
from .vocab import mix64


@dataclass
class InteriorGraph:
    """Vectorized decomposition artifacts for one snapshot."""

    padded_nodes: int
    m: int  # number of interior nodes
    interior_ids: np.ndarray  # int32[m]: node id of each interior index
    interior_index: np.ndarray  # int32[padded_nodes]: node -> idx or -1
    # interior adjacency, COO over interior indices (both endpoints interior)
    ii_src: np.ndarray  # int32[e_ii]
    ii_dst: np.ndarray  # int32[e_ii]
    # CSR by src over edges whose dst is a subject set (dst always interior);
    # values are interior indices of dst. Feeds F0 = set-successors of start.
    set_out_indptr: np.ndarray  # int32[padded_nodes + 1]
    set_out_vals: np.ndarray  # int32[e_set]
    # CSR by dst over edges whose dst is a subject id, keeping only interior
    # sources; values are interior indices of src. Feeds L(target).
    id_in_indptr: np.ndarray  # int32[padded_nodes + 1]
    id_in_vals: np.ndarray  # int32[e_id_interior]
    # open-addressing hash set of int64 keys src * padded_nodes + dst for
    # the vectorized direct-edge membership test
    edge_table: np.ndarray  # int64[2^k], -1 = empty
    edge_mask: int

    def direct_edge(self, src_ids: np.ndarray, dst_ids: np.ndarray) -> np.ndarray:
        """bool[n]: does the edge (src, dst) exist? Vectorized hash probe."""
        keys = src_ids.astype(np.int64) * self.padded_nodes + dst_ids.astype(
            np.int64
        )
        return _hash_contains(self.edge_table, self.edge_mask, keys)


def _build_edge_hash(keys: np.ndarray) -> tuple[np.ndarray, int]:
    """(table int64[2^k], mask): open-addressing set of `keys` (>= 0;
    duplicates fine) at <= 0.6 load, built with vectorized probe rounds."""
    n = max(len(keys), 1)
    size = 1 << int(n / 0.6).bit_length()
    mask = size - 1
    table = np.full(size, -1, dtype=np.int64)
    if len(keys) == 0:
        return table, mask
    k = keys.astype(np.int64)
    idx = (mix64(k) & np.uint64(mask)).astype(np.int64)
    pending = np.arange(len(k), dtype=np.int64)
    while len(pending):
        slots = idx[pending]
        occ = table[slots]
        placeable = (occ == -1) | (occ == k[pending])
        # concurrent writers to one slot: numpy keeps the last — verify
        # placement and linear-probe the losers onward
        table[slots[placeable]] = k[pending[placeable]]
        placed = table[idx[pending]] == k[pending]
        pending = pending[~placed]
        idx[pending] = (idx[pending] + 1) & mask
    return table, mask


def _hash_contains(
    table: np.ndarray, mask: int, keys: np.ndarray
) -> np.ndarray:
    k = keys.astype(np.int64)
    idx = (mix64(k) & np.uint64(mask)).astype(np.int64)
    out = np.zeros(len(k), dtype=bool)
    active = np.arange(len(k), dtype=np.int64)
    while len(active):
        v = table[idx[active]]
        hit = v == k[active]
        out[active[hit]] = True
        active = active[~hit & (v != -1)]  # an empty slot ends the chain
        idx[active] = (idx[active] + 1) & mask
    return out


def _csr_by(
    group: np.ndarray, vals: np.ndarray, n_groups: int
) -> tuple[np.ndarray, np.ndarray]:
    """(indptr int32[n_groups+1], vals sorted by group) via stable argsort."""
    order = np.argsort(group, kind="stable")
    counts = np.bincount(group, minlength=n_groups)
    indptr = np.zeros(n_groups + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr.astype(np.int32), vals[order]


def build_interior(snap: GraphSnapshot) -> InteriorGraph:
    """Decompose a snapshot's COO edges. All array passes, no per-edge loops."""
    e = snap.num_edges
    pn = snap.padded_nodes
    src = snap.src[:e]
    dst = snap.dst[:e]

    flags_live = snap.vocab.is_set_array()
    is_set = np.zeros(pn, dtype=bool)
    n_live = min(len(flags_live), pn)
    is_set[:n_live] = flags_live[:n_live]

    dst_is_set = is_set[dst]

    # interior = subject sets with at least one incoming edge
    interior_mask = np.zeros(pn, dtype=bool)
    interior_mask[dst[dst_is_set]] = True
    interior_ids = np.nonzero(interior_mask)[0].astype(np.int32)
    m = len(interior_ids)
    interior_index = np.full(pn, -1, dtype=np.int32)
    interior_index[interior_ids] = np.arange(m, dtype=np.int32)

    # set-dst edges -> F0 CSR by src (dst mapped to interior indices)
    s_src = src[dst_is_set]
    s_dst_idx = interior_index[dst[dst_is_set]]
    set_out_indptr, set_out_vals = _csr_by(s_src, s_dst_idx, pn)

    # interior-interior adjacency: set-dst edges whose src is interior too
    src_int_idx = interior_index[s_src]
    keep = src_int_idx >= 0
    ii_src = src_int_idx[keep]
    ii_dst = s_dst_idx[keep]

    # id-dst edges with interior src -> L CSR by dst
    id_mask = ~dst_is_set
    i_src_idx = interior_index[src[id_mask]]
    i_dst = dst[id_mask]
    keep_l = i_src_idx >= 0
    id_in_indptr, id_in_vals = _csr_by(i_dst[keep_l], i_src_idx[keep_l], pn)

    edge_table, edge_mask = _build_edge_hash(
        src.astype(np.int64) * pn + dst.astype(np.int64)
    )

    return InteriorGraph(
        padded_nodes=pn,
        m=m,
        interior_ids=interior_ids,
        interior_index=interior_index,
        ii_src=ii_src.astype(np.int32),
        ii_dst=ii_dst.astype(np.int32),
        set_out_indptr=set_out_indptr,
        set_out_vals=set_out_vals.astype(np.int32),
        id_in_indptr=id_in_indptr,
        id_in_vals=id_in_vals.astype(np.int32),
        edge_table=edge_table,
        edge_mask=edge_mask,
    )


@dataclass
class InteriorBlocks:
    """SCC/level block structure of the interior adjacency (counterpart of
    ``keto_tpu/graph/interior.py InteriorBlocks``).

    Strongly-connected components condense the interior digraph into a DAG;
    each component gets the topological *level*: the longest condensed path
    from any source component. Two uses (``engine/semiring.py``):

    - build scheduling: closure rows grouped by (level, component) walk the
      adjacency in dependency order, so concurrent row-group workers hit
      warm frontier pages;
    - incremental invalidation: after an interior edge change only rows in
      blocks that can reach a changed block (condensation ancestors) can see
      different bounded distances.
    """

    m: int
    n_blocks: int
    comp: np.ndarray  # int32[m]: interior index -> component id
    level: np.ndarray  # int32[n_blocks]: topological level per component
    n_levels: int
    # row order sorted by (level, comp): the block-coherent build schedule
    build_order: np.ndarray  # int32[m]

    def block_sizes(self) -> np.ndarray:
        return np.bincount(self.comp, minlength=self.n_blocks)


def interior_blocks(ig: InteriorGraph) -> InteriorBlocks:
    """SCC condensation and topological levels of ig's interior adjacency,
    cached on the InteriorGraph (one decomposition per snapshot)."""
    cached = getattr(ig, "_blocks", None)
    if cached is not None:
        return cached
    m = ig.m
    if m == 0:
        blocks = InteriorBlocks(
            m=0,
            n_blocks=0,
            comp=np.zeros(0, dtype=np.int32),
            level=np.zeros(0, dtype=np.int32),
            n_levels=0,
            build_order=np.zeros(0, dtype=np.int32),
        )
        ig._blocks = blocks
        return blocks
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    adj = coo_matrix(
        (np.ones(len(ig.ii_src), dtype=np.int8), (ig.ii_src, ig.ii_dst)),
        shape=(m, m),
    )
    n_comp, comp = connected_components(adj, directed=True, connection="strong")
    comp = comp.astype(np.int32)
    # condensation edges (cross-component only), deduplicated
    cs = comp[ig.ii_src]
    cd = comp[ig.ii_dst]
    cross = cs != cd
    ckeys = np.unique(
        cs[cross].astype(np.int64) * n_comp + cd[cross].astype(np.int64)
    )
    e_src = (ckeys // n_comp).astype(np.int32)
    e_dst = (ckeys % n_comp).astype(np.int32)
    # Kahn longest-path levels over the condensation DAG
    level = np.zeros(n_comp, dtype=np.int32)
    indeg = np.bincount(e_dst, minlength=n_comp)
    order = np.argsort(e_src, kind="stable")
    e_src_s, e_dst_s = e_src[order], e_dst[order]
    indptr = np.zeros(n_comp + 1, dtype=np.int64)
    np.cumsum(np.bincount(e_src_s, minlength=n_comp), out=indptr[1:])
    ready = list(np.nonzero(indeg == 0)[0])
    while ready:
        c = ready.pop()
        for d in e_dst_s[indptr[c] : indptr[c + 1]]:
            if level[d] < level[c] + 1:
                level[d] = level[c] + 1
            indeg[d] -= 1
            if indeg[d] == 0:
                ready.append(int(d))
    n_levels = int(level.max()) + 1 if n_comp else 0
    build_order = np.lexsort((comp, level[comp])).astype(np.int32)
    blocks = InteriorBlocks(
        m=m,
        n_blocks=int(n_comp),
        comp=comp,
        level=level,
        n_levels=n_levels,
        build_order=build_order,
    )
    ig._blocks = blocks
    return blocks


def gather_padded_rows(
    indptr: np.ndarray,
    vals: np.ndarray,
    rows: np.ndarray,
    width: int,
    pad: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Gather CSR rows into a padded [n, width] matrix (vectorized).

    Returns (padded int32[n, width], overflow bool[n]) where overflow marks
    rows whose true degree exceeds `width` (callers route those to a
    fallback engine rather than silently truncating).
    """
    rows = rows.astype(np.int64)
    off = indptr[rows]
    deg = indptr[rows + 1] - off
    overflow = deg > width
    j = np.arange(width, dtype=np.int64)[None, :]
    idx = off[:, None] + j
    valid = j < np.minimum(deg, width)[:, None]
    out = np.full((len(rows), width), pad, dtype=np.int32)
    if vals.size:
        np.copyto(out, vals[np.minimum(idx, vals.size - 1)], where=valid)
    return out, overflow
