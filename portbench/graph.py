"""The tuple graph of one configuration, made from the seed in numpy.

A configuration file (``configs/<name>.json``) names pools of node keys and
classes of edges between them. Every node has an integer id in one space
laid out pool after pool; the harness, the traffic and the reference work
on those ids, and only ``keys`` turns them into the (namespace, object,
relation) and (subject id,) keys the program is given.

Edges of a class draw their source uniformly from the source pool and
their destination from the destination pools, each picked with its weight,
then uniformly inside it. Duplicates count once, as the store counts them;
the class marked ``fill`` is drawn again until the graph holds ``tuples``
distinct edges (the pool sizes and the edge mix of ``bench.py``'s
``gen_rbac`` and ``gen_github``, rewritten on ids).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED_STREAM_GRAPH = 0


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """The generator of one stream of a run: any whole seed, negative or
    past 64 bits, maps to its own stream."""
    return np.random.default_rng([seed % (1 << 64), *stream])


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass(frozen=True)
class Pool:
    name: str
    count: int  # objects, or subject ids
    namespace: str  # "" for a pool of subject ids
    prefix: str
    relations: tuple  # () for a pool of subject ids
    offset: int  # the first node id

    @property
    def size(self) -> int:
        return self.count * max(1, len(self.relations))

    @property
    def is_set(self) -> bool:
        return bool(self.relations)

    def key(self, local: int) -> tuple:
        if not self.relations:
            return (f"{self.prefix}{local}",)
        r = len(self.relations)
        return (self.namespace, f"{self.prefix}{local // r}", self.relations[local % r])

    def keys(self, local: np.ndarray) -> list:
        if not self.relations:
            p = self.prefix
            return [(f"{p}{i}",) for i in local.tolist()]
        r, ns, p, rels = len(self.relations), self.namespace, self.prefix, self.relations
        objs, which = np.divmod(local, r)
        return [(ns, f"{p}{o}", rels[j]) for o, j in zip(objs.tolist(), which.tolist())]


class Layout:
    """The node id space of a configuration's pools."""

    def __init__(self, pools_cfg: list):
        self.pools: list[Pool] = []
        off = 0
        for p in pools_cfg:
            rels = tuple(p.get("relations", ()))
            pool = Pool(p["name"], int(p["count"]), p.get("namespace", ""),
                        p["prefix"], rels, off)
            self.pools.append(pool)
            off += pool.size
        self.n_nodes = off
        self.by_name = {p.name: p for p in self.pools}
        self.offsets = np.array([p.offset for p in self.pools], dtype=np.int64)
        self.is_set_pool = np.array([p.is_set for p in self.pools], dtype=bool)

    def pool_index(self, nodes: np.ndarray) -> np.ndarray:
        return np.searchsorted(self.offsets, nodes, side="right") - 1

    def is_set(self, nodes: np.ndarray) -> np.ndarray:
        return self.is_set_pool[self.pool_index(nodes)]

    def node(self, pool: str, obj: int, relation: Optional[str] = None) -> int:
        p = self.by_name[pool]
        if not p.relations:
            return p.offset + obj
        return p.offset + obj * len(p.relations) + p.relations.index(relation)

    def key(self, node: int) -> tuple:
        p = self.pools[int(self.pool_index(np.array([node]))[0])]
        return p.key(int(node) - p.offset)

    def keys(self, nodes: np.ndarray) -> list:
        """The program's node keys of ``nodes``, in order; each distinct
        node's key is built once."""
        nodes = np.asarray(nodes, dtype=np.int64)
        uniq, inv = np.unique(nodes, return_inverse=True)
        out = np.empty(len(uniq), dtype=object)
        pidx = self.pool_index(uniq)
        for i, pool in enumerate(self.pools):
            sel = np.flatnonzero(pidx == i)
            if len(sel):
                out[sel] = pool.keys(uniq[sel] - pool.offset)
        return out[inv].tolist()


@dataclass
class Graph:
    layout: Layout
    src: np.ndarray  # int64 node ids, one per distinct edge
    dst: np.ndarray
    cls: np.ndarray  # int8 index into classes
    classes: list  # edge class names, in the configuration's order

    def edges_of(self, name: str) -> tuple[np.ndarray, np.ndarray]:
        sel = self.cls == self.classes.index(name)
        return self.src[sel], self.dst[sel]


def _draw(layout: Layout, ec: dict, k: int, rng: np.random.Generator):
    sp = layout.by_name[ec["src"]]
    src = sp.offset + rng.integers(sp.size, size=k, dtype=np.int64)
    names = list(ec["dst"])
    pools = [layout.by_name[n] for n in names]
    if len(pools) == 1:
        dst = pools[0].offset + rng.integers(pools[0].size, size=k, dtype=np.int64)
    else:
        w = np.array([float(ec["dst"][n]) for n in names])
        pick = rng.choice(len(pools), size=k, p=w / w.sum())
        sizes = np.array([p.size for p in pools], dtype=np.int64)
        offs = np.array([p.offset for p in pools], dtype=np.int64)
        local = np.minimum((rng.random(k) * sizes[pick]).astype(np.int64), sizes[pick] - 1)
        dst = offs[pick] + local
    return src, dst


def generate(cfg: dict, seed: int) -> Graph:
    """The configuration's graph for ``seed``: the same seed, the same
    edges in the same order."""
    layout = Layout(cfg["pools"])
    rng = rng_for(seed, SEED_STREAM_GRAPH)
    n = int(cfg["tuples"])
    classes = [ec["name"] for ec in cfg["edges"]]
    srcs, dsts, clss = [], [], []
    fill = None
    for ci, ec in enumerate(cfg["edges"]):
        if ec.get("fill"):
            fill = ci
            continue
        k = int(n * float(ec["share"]))
        if "cap" in ec:
            k = min(k, int(ec["cap"]))
        s, d = _draw(layout, ec, k, rng)
        srcs.append(s)
        dsts.append(d)
        clss.append(np.full(k, ci, dtype=np.int8))
    nn = np.int64(layout.n_nodes)

    def dedup(s, d, c):
        _, first = np.unique(s * nn + d, return_index=True)
        first.sort()
        return s[first], d[first], c[first]

    src, dst, cls = dedup(np.concatenate(srcs), np.concatenate(dsts), np.concatenate(clss))
    if fill is None:
        raise ValueError("a configuration needs one edge class with \"fill\": true")
    while len(src) < n:  # the fill class tops up what duplicates took
        k = n - len(src)
        s, d = _draw(layout, cfg["edges"][fill], k, rng)
        src, dst, cls = dedup(
            np.concatenate([src, s]), np.concatenate([dst, d]),
            np.concatenate([cls, np.full(k, fill, dtype=np.int8)]),
        )
    return Graph(layout, src, dst, cls, classes)


def load_config(bench: dict, name: str, root: Path) -> dict:
    entry = next(c for c in bench["configs"] if c["name"] == name)
    return load_json(root / entry["file"])
