"""Graph encoding layer: tuple store -> vocab-encoded COO arrays and the
interior decomposition the closure engine builds on."""

from .interior import InteriorGraph, build_interior, gather_padded_rows
from .snapshot import GraphSnapshot, SnapshotBuilder, SnapshotManager
from .vocab import NodeVocab, id_key, set_key

__all__ = [
    "NodeVocab",
    "id_key",
    "set_key",
    "GraphSnapshot",
    "SnapshotBuilder",
    "SnapshotManager",
    "InteriorGraph",
    "build_interior",
    "gather_padded_rows",
]
