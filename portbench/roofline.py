"""Peaks of the card and the bytes a kernel's work needs, frozen here so
that no change to the program moves the yardstick.

Peaks: NVIDIA H100 SXM5 80GB data sheet, dense rates without sparsity, at
the full 700 W power limit: HBM3 3.35 TB/s; 989 TFLOP/s bf16. The traced
run prints the card's power limit beside every share.

B2 (``packed_propagate_kernel``, ``keto_tpu_torch/csrc/packed_propagate.cu``)
is one pass of the packed check loop: for every output row, the bitwise
OR of the frontier rows of its in-edges' sources, W = rows / 32 words a
row. The least traffic one pass needs: each distinct source row read once
(the graph's real sources and the batch's probe targets), each output row
written once (one per real node and one probe row per check), and each
edge's source and destination indices (two int32) read once. Padding rows
and padding edges are the program's layout, not the work, and are not
counted: a layout that pads less is a faster kernel here.
"""

from __future__ import annotations

import numpy as np

H100_HBM_BYTES_PER_S = 3.35e12
H100_BF16_FLOPS = 989e12
INDEX_BYTES = 4
WORD_BYTES = 4


def b2_bytes(n_nodes: int, n_edges: int, distinct_sources: int, rows: int) -> int:
    """Bytes one B2 pass needs over a graph of ``n_nodes`` nodes and
    ``n_edges`` edges at ``rows`` checks a batch, with ``distinct_sources``
    distinct source rows (real sources and probe targets together)."""
    w = rows // 32
    return (distinct_sources * w * WORD_BYTES
            + (n_nodes + rows) * w * WORD_BYTES
            + (n_edges + rows) * 2 * INDEX_BYTES)


def b2_bound_s(n_nodes: int, n_edges: int, distinct_sources: int, rows: int) -> float:
    return b2_bytes(n_nodes, n_edges, distinct_sources, rows) / H100_HBM_BYTES_PER_S


def graph_counts(src: np.ndarray, dst: np.ndarray, targets: np.ndarray) -> dict:
    """The sizes ``b2_bytes`` takes, from the generator's own edges and one
    batch's targets: nodes that appear in any edge, edges, and distinct
    source rows."""
    real_src = np.unique(src)
    nodes = np.union1d(real_src, np.unique(dst))
    distinct = len(np.union1d(real_src, np.unique(targets)))
    return {"n_nodes": int(len(nodes)), "n_edges": int(len(src)),
            "distinct_sources": int(distinct)}
