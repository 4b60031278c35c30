"""The plain reference: a breadth-first search over subject-set nodes.

A check ``object#relation @ subject`` is allowed iff a tuple path of at
most ``depth`` edges leads from the node ``object#relation`` to the
subject's node: the semantics of Keto's check engine with a global
max-depth and no rewrites. The search walks subject-set nodes only, from
the start, and tests the target's in-neighbours: allowed iff some
in-neighbour has distance at most ``depth - 1`` from the start.

It is built from the generator's own id arrays and imports nothing of the
program.
"""

from __future__ import annotations

import numpy as np

_FAR = np.int8(127)


class SetGraph:
    def __init__(self, n_nodes: int, src: np.ndarray, dst: np.ndarray,
                 is_set_node: np.ndarray):
        """``is_set_node``: bool[n_nodes], True for subject-set nodes."""
        self.n = int(n_nodes)
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        self.is_set = np.asarray(is_set_node, dtype=bool)
        keep = self.is_set[dst]
        s, d = src[keep], dst[keep]
        order = np.argsort(s, kind="stable")
        self.out_vals = d[order]
        self.out_ptr = np.zeros(self.n + 1, dtype=np.int64)
        np.cumsum(np.bincount(s, minlength=self.n), out=self.out_ptr[1:])
        order = np.argsort(dst, kind="stable")
        self.in_vals = src[order]
        self.in_ptr = np.zeros(self.n + 1, dtype=np.int64)
        np.cumsum(np.bincount(dst, minlength=self.n), out=self.in_ptr[1:])
        self.dist = np.full(self.n, _FAR, dtype=np.int8)

    def _successors(self, rows: np.ndarray) -> np.ndarray:
        lo = self.out_ptr[rows]
        lens = self.out_ptr[rows + 1] - lo
        total = int(lens.sum())
        base = np.repeat(lo - np.cumsum(lens) + lens, lens)
        return self.out_vals[base + np.arange(total)]

    def check(self, start: int, target: int, depth: int) -> bool:
        preds = self.in_vals[self.in_ptr[target]: self.in_ptr[target + 1]]
        if not len(preds) or depth < 1:
            return False
        dist = self.dist
        frontier = np.array([start], dtype=np.int64)
        dist[frontier] = 0
        touched = [frontier]
        try:
            for level in range(depth):
                if (dist[preds] <= level).any():
                    return True
                if level == depth - 1:
                    return False
                nxt = self._successors(frontier)
                nxt = np.unique(nxt)
                nxt = nxt[dist[nxt] == _FAR]
                if not len(nxt):
                    return False
                dist[nxt] = level + 1
                touched.append(nxt)
                frontier = nxt
            return False
        finally:
            for arr in touched:
                dist[arr] = _FAR
