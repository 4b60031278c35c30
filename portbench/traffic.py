"""The one traffic generator: a traffic file (``traffic/<name>.json``) of
parameters, read against a configuration's graph.

- ``rows``: the check rows, as shares of the rows of a window (or of a
  batch): a share with a ``path`` of edge classes walks real edges (the
  first class from an object of the checked pool and relation, each next
  class from the node reached, ending at a subject of the checked pool);
  a share with no path pairs a uniform object with a uniform subject.
  The counts of each share are fixed; the seed only orders and fills
  them.
- ``loop``: the name of the loop module that sends them
  (``loops/<loop>.py``), with that module's own parameters.

Nothing here imports the program or torch: the client processes use it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional
from urllib.parse import quote

import numpy as np

from .graph import Graph, Layout, rng_for

STREAM_ROWS = 1
STREAM_JUDGE = 4
STREAM_WARM = 5


def share_counts(shares: list, n: int) -> list:
    """Integer counts of ``n`` in the given shares, summing to ``n``
    (largest remainders)."""
    raw = [s * n for s in shares]
    counts = [int(math.floor(r)) for r in raw]
    rest = n - sum(counts)
    order = sorted(range(len(raw)), key=lambda i: counts[i] - raw[i])
    for i in order[:rest]:
        counts[i] += 1
    return counts


@dataclass
class _Walk:
    first_src: np.ndarray  # candidate first edges
    first_dst: np.ndarray
    steps: list  # per next class: (nodes sorted, ptr, vals)


class RowSampler:
    """Draws check rows (start node, target node) for a configuration;
    picklable, so client processes draw their own batches."""

    def __init__(self, graph: Graph, check: dict, rows: list):
        lay = graph.layout
        self.layout = lay
        self.obj_pool = lay.by_name[check["object"]]
        self.rel_index = self.obj_pool.relations.index(check["relation"])
        self.subj_pool = lay.by_name[check["subject"]]
        self.shares = [float(r["share"]) for r in rows]
        self.walks: list[Optional[_Walk]] = []
        for r in rows:
            path = r.get("path")
            self.walks.append(None if not path else self._walk(graph, path))

    def _in_obj(self, nodes: np.ndarray) -> np.ndarray:
        p = self.obj_pool
        local = nodes - p.offset
        return (local >= 0) & (local < p.size) & (local % len(p.relations) == self.rel_index)

    def _in_subj(self, nodes: np.ndarray) -> np.ndarray:
        p = self.subj_pool
        return (nodes >= p.offset) & (nodes < p.offset + p.size)

    def _walk(self, graph: Graph, path: list) -> _Walk:
        s, d = graph.edges_of(path[0])
        keep = self._in_obj(s)
        steps = []
        for name in path[1:]:
            cs, cd = graph.edges_of(name)
            order = np.argsort(cs, kind="stable")
            nodes, counts = np.unique(cs, return_counts=True)
            ptr = np.concatenate([[0], np.cumsum(counts)])
            steps.append((nodes, ptr, cd[order]))
        if steps:
            keep &= np.isin(d, steps[0][0])
        else:
            keep &= self._in_subj(d)
        return _Walk(s[keep], d[keep], steps)

    def _draw_walk(self, w: _Walk, n: int, rng: np.random.Generator):
        out_s = np.empty(0, dtype=np.int64)
        out_t = np.empty(0, dtype=np.int64)
        while len(out_s) < n:
            k = n - len(out_s)
            pick = rng.integers(len(w.first_src), size=k)
            start, node = w.first_src[pick], w.first_dst[pick]
            ok = np.ones(k, dtype=bool)
            for nodes, ptr, vals in w.steps:
                at = np.searchsorted(nodes, node)
                at = np.minimum(at, len(nodes) - 1)
                ok &= nodes[at] == node
                lo, cnt = ptr[at], ptr[at + 1] - ptr[at]
                node = vals[lo + (rng.random(k) * cnt).astype(np.int64)]
            ok &= self._in_subj(node)
            out_s = np.concatenate([out_s, start[ok]])
            out_t = np.concatenate([out_t, node[ok]])
        return out_s, out_t

    def draw(self, rng: np.random.Generator, n: int) -> tuple[np.ndarray, np.ndarray]:
        """``n`` rows: exact counts per share, in an order from ``rng``."""
        starts, targets = [], []
        for count, walk in zip(share_counts(self.shares, n), self.walks):
            if count == 0:
                continue
            if walk is None:
                p, sp = self.obj_pool, self.subj_pool
                obj = rng.integers(p.count, size=count, dtype=np.int64)
                starts.append(p.offset + obj * len(p.relations) + self.rel_index)
                targets.append(sp.offset + rng.integers(sp.size, size=count, dtype=np.int64))
            else:
                s, t = self._draw_walk(walk, count, rng)
                starts.append(s)
                targets.append(t)
        perm = rng.permutation(n)
        return np.concatenate(starts)[perm], np.concatenate(targets)[perm]


# -- request encodings (shared by the clients and the tests) ----------------

def _q(s: str) -> str:
    return quote(s, safe="")


def check_path(layout: Layout, start: int, target: int) -> str:
    """``GET /check`` path of one row."""
    ns, obj, rel = layout.key(start)
    sub = layout.key(target)
    q = f"/check?namespace={_q(ns)}&object={_q(obj)}&relation={_q(rel)}"
    if len(sub) == 1:
        return q + f"&subject_id={_q(sub[0])}"
    return q + (f"&subject_set.namespace={_q(sub[0])}&subject_set.object={_q(sub[1])}"
                f"&subject_set.relation={_q(sub[2])}")


def columnar_body(layout: Layout, starts: np.ndarray, targets: np.ndarray) -> dict:
    """The columnar ``POST /check/batch`` body (subject-id rows)."""
    sk = layout.keys(starts)
    tk = layout.keys(targets)
    if any(len(k) != 1 for k in tk):
        raise ValueError("the columnar body here carries subject ids only")
    return {
        "namespaces": [k[0] for k in sk],
        "objects": [k[1] for k in sk],
        "relations": [k[2] for k in sk],
        "subject_ids": [k[0] for k in tk],
    }
