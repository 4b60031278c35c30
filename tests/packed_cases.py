"""Inputs of the packed check loop's property cases, shared by the CPU tests
(``test_torch_packed.py``) and the card's (``test_torch_cuda.py``). Made
with numpy from a seed; imports neither JAX nor the JAX package, so the
card's tests can use it."""

import numpy as np
import torch


def random_graph(rng, n_nodes, n_edges):
    """A dst-sorted edge list over n_nodes live nodes with cycles."""
    src = rng.integers(n_nodes, size=n_edges)
    dst = rng.integers(n_nodes, size=n_edges)
    src[:4] = [0, 1, 2, 3]  # a cycle 0 -> 1 -> 2 -> 3 -> 0
    dst[:4] = [1, 2, 3, 0]
    order = np.argsort(dst, kind="stable")
    return src[order].astype(np.int32), dst[order].astype(np.int32)


def check_case(seed, max_steps, kind, bsz=4096):
    """Inputs of one property case: a random graph with cycles, dummy start
    and target rows at depth 0, start == target rows, depths in
    0..max_steps ("mixed") or in 0..max_steps // 2 ("shallow", so the loop
    stops on depth); or ("hit_early") every row one edge from its target
    at depth max_steps, so the loop stops after two passes."""
    rng = np.random.default_rng(seed + 4000)
    n_pad = 128
    live = int(rng.integers(20, n_pad - 1))
    src, dst = random_graph(rng, live, int(rng.integers(live, 4 * live)))
    dummy = n_pad - 1
    if kind == "hit_early":
        e = rng.integers(len(src), size=bsz)
        start, target = src[e].copy(), dst[e].copy()
        depth = np.full(bsz, max_steps, dtype=np.int32)
    else:
        start = rng.integers(live, size=bsz).astype(np.int32)
        target = rng.integers(live, size=bsz).astype(np.int32)
        top = max_steps // 2 if kind == "shallow" else max_steps
        depth = rng.integers(0, top + 1, size=bsz).astype(np.int32)
        target[:32] = start[:32]  # start == target: needs a real cycle
        start[32:48] = dummy
        target[40:56] = dummy
        depth[32:56] = 0
    args = [torch.from_numpy(a.astype(np.int32)) for a in (src, dst, start, target, depth)]
    return args, n_pad
