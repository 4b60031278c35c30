"""Reverse boundary CSRs for list queries, the companions of ``D^T``
(counterpart of ``keto_tpu/graph/reverse.py``).

The interior decomposition (``graph/interior.py``) is oriented for Check:
from a start node it gathers F0 (set successors), from a target L
(interior predecessors). List queries ask the opposite questions:

- ``list_objects(subject)``: which set nodes reach the subject? Once the
  transposed closure ``D^T`` has said which interior sources reach
  L(target) within the budget, two boundary hops remain:

  * ``set_in``: interior index -> source node ids of the edges into that
    set (the reverse of F0);
  * ``in``: node id -> source node ids over all edges (the depth-1
    predecessors).

- ``list_subjects(object#relation)``: which subject ids does a set reach?
  ``id_out``: interior index -> subject-id node ids of the edges out of
  that set (the reverse of L), with the start's own id successors (depth
  1, from the snapshot's forward CSR).

All are int32 CSRs built by the same stable-argsort pass as the forward
decomposition (``interior._csr_by``), so they equal ``keto_tpu``'s byte for
byte.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .interior import InteriorGraph, _csr_by
from .snapshot import GraphSnapshot


@dataclass
class ReverseIndex:
    """Reverse boundary CSRs of one snapshot's interior decomposition."""

    padded_nodes: int
    m: int
    # interior idx -> node ids with an edge INTO that interior set
    set_in_indptr: np.ndarray  # int32[m + 1]
    set_in_vals: np.ndarray  # int32[e_set]
    # interior idx -> subject-id node ids that set points at directly
    id_out_indptr: np.ndarray  # int32[m + 1]
    id_out_vals: np.ndarray  # int32[e_id_interior]
    # node id -> source node ids over ALL edges (direct predecessors)
    in_indptr: np.ndarray  # int32[padded_nodes + 1]
    in_vals: np.ndarray  # int32[e]

    def residency_bytes(self) -> int:
        """Host bytes of the CSRs (D^T is counted apart)."""
        return int(
            self.set_in_indptr.nbytes
            + self.set_in_vals.nbytes
            + self.id_out_indptr.nbytes
            + self.id_out_vals.nbytes
            + self.in_indptr.nbytes
            + self.in_vals.nbytes
        )

    def direct_preds(self, nid: int) -> np.ndarray:
        """Source node ids of all edges into `nid`."""
        return self.in_vals[self.in_indptr[nid] : self.in_indptr[nid + 1]]


def build_reverse(snap: GraphSnapshot, ig: InteriorGraph) -> ReverseIndex:
    """The reverse CSRs from the snapshot's COO edges: the passes of
    build_interior, grouped the other way."""
    e = snap.num_edges
    pn = snap.padded_nodes
    src = snap.src[:e]
    dst = snap.dst[:e]

    dst_idx = ig.interior_index[dst]
    dst_is_set = dst_idx >= 0  # every set with an in-edge is interior

    m = max(ig.m, 1)  # _csr_by wants >= 1 group; m == 0 leaves empty vals
    set_in_indptr, set_in_vals = _csr_by(dst_idx[dst_is_set], src[dst_is_set], m)

    id_mask = ~dst_is_set
    i_src_idx = ig.interior_index[src[id_mask]]
    i_dst = dst[id_mask]
    keep = i_src_idx >= 0
    id_out_indptr, id_out_vals = _csr_by(i_src_idx[keep], i_dst[keep], m)

    in_indptr, in_vals = _csr_by(dst, src, pn)

    return ReverseIndex(
        padded_nodes=pn,
        m=ig.m,
        set_in_indptr=set_in_indptr,
        set_in_vals=set_in_vals.astype(np.int32),
        id_out_indptr=id_out_indptr,
        id_out_vals=id_out_vals.astype(np.int32),
        in_indptr=in_indptr,
        in_vals=in_vals.astype(np.int32),
    )
