"""keto_tpu_torch.ops.frontier vs keto_tpu.ops.frontier on the CPU.

The dense and scatter check and distance functions get the same padded COO
graphs, made with numpy from a seed, in both packages. Tolerance: exact —
adjacencies and frontiers are 0/1, answers booleans, distances integers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keto_tpu.ops import frontier as jfrontier
from keto_tpu_torch.ops import frontier as tfrontier

torch.set_num_threads(1)


def padded_graph(rng, live, n_pad, n_edges, e_pad):
    """COO edges over `live` nodes with a cycle and a self-loop, padded
    dummy->dummy to e_pad as a snapshot pads them."""
    src = rng.integers(live, size=n_edges)
    dst = rng.integers(live, size=n_edges)
    src[:4] = [0, 1, 2, 2]  # cycle 0 -> 1 -> 2 -> 0 and a self-loop at 2
    dst[:4] = [1, 2, 0, 2]
    s = np.full(e_pad, n_pad - 1, dtype=np.int32)
    d = np.full(e_pad, n_pad - 1, dtype=np.int32)
    s[:n_edges] = src
    d[:n_edges] = dst
    return s, d


def batch(rng, live, n_pad, b, max_depth):
    start = rng.integers(live, size=b).astype(np.int32)
    target = rng.integers(live, size=b).astype(np.int32)
    target[:4] = start[:4]  # start == target
    start[4] = target[5] = n_pad - 1  # unknown start / unknown target
    depth = rng.integers(0, max_depth + 2, size=b).astype(np.int32)
    return start, target, depth


T = torch.from_numpy
J = jnp.asarray

# (live nodes, padded nodes, edges, padded edges, edge chunk)
GRAPHS = [(50, 64, 120, 1024, 1024), (200, 256, 900, 2048, 1024)]


@pytest.mark.parametrize("live,n_pad,n_edges,e_pad,chunk", GRAPHS)
@pytest.mark.parametrize("max_steps", [1, 3, 6])
def test_check_scatter_and_dense_match_jax(live, n_pad, n_edges, e_pad, chunk, max_steps):
    rng = np.random.default_rng(live + max_steps)
    src, dst = padded_graph(rng, live, n_pad, n_edges, e_pad)
    start, target, depth = batch(rng, live, n_pad, 64, max_steps)
    want = np.asarray(
        jfrontier.batched_check_scatter(
            J(src), J(dst), J(start), J(target), J(depth),
            padded_nodes=n_pad, edge_chunk=chunk, max_steps=max_steps,
        )
    )
    got = tfrontier.batched_check_scatter(
        T(src), T(dst), T(start), T(target), T(depth),
        padded_nodes=n_pad, edge_chunk=chunk, max_steps=max_steps,
    )
    assert np.array_equal(got.numpy(), want)
    adj_j = jfrontier.build_dense_adjacency(J(src), J(dst), n_pad)
    adj_t = tfrontier.build_dense_adjacency(T(src), T(dst), n_pad)
    assert np.array_equal(adj_t.float().numpy(), np.asarray(adj_j, np.float32))
    want_d = np.asarray(
        jfrontier.batched_check_dense(
            adj_j, J(start), J(target), J(depth), max_steps=max_steps
        )
    )
    got_d = tfrontier.batched_check_dense(
        adj_t, T(start), T(target), T(depth), max_steps=max_steps
    )
    assert np.array_equal(got_d.numpy(), want_d)
    assert np.array_equal(want_d, want)


@pytest.mark.parametrize("live,n_pad,n_edges,e_pad,chunk", GRAPHS)
@pytest.mark.parametrize("max_steps", [2, 5])
def test_distances_scatter_and_dense_match_jax(live, n_pad, n_edges, e_pad, chunk, max_steps):
    rng = np.random.default_rng(live * 3 + max_steps)
    src, dst = padded_graph(rng, live, n_pad, n_edges, e_pad)
    start, _, depth = batch(rng, live, n_pad, 16, max_steps)
    want = np.asarray(
        jfrontier.batched_distances_scatter(
            J(src), J(dst), J(start), J(depth),
            padded_nodes=n_pad, edge_chunk=chunk, max_steps=max_steps,
        )
    )
    got = tfrontier.batched_distances_scatter(
        T(src), T(dst), T(start), T(depth),
        padded_nodes=n_pad, edge_chunk=chunk, max_steps=max_steps,
    )
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    adj = tfrontier.build_dense_adjacency(T(src), T(dst), n_pad)
    want_d = np.asarray(
        jfrontier.batched_distances_dense(
            jfrontier.build_dense_adjacency(J(src), J(dst), n_pad),
            J(start), J(depth), max_steps=max_steps,
        )
    )
    got_d = tfrontier.batched_distances_dense(
        adj, T(start), T(depth), max_steps=max_steps
    )
    assert np.array_equal(got_d.numpy(), want_d)
    assert (want != tfrontier.UNREACHED).sum() > len(start)  # not trivial


@pytest.mark.parametrize(
    "padded_edges,batch_size", [(1024, 8), (1 << 20, 64), (1 << 24, 4096), (2048, 1 << 14)]
)
def test_pick_edge_chunk_matches_jax(padded_edges, batch_size):
    assert tfrontier.pick_edge_chunk(padded_edges, batch_size) == (
        jfrontier.pick_edge_chunk(padded_edges, batch_size)
    )


def test_unreached_sentinel_matches_jax():
    assert tfrontier.UNREACHED == jfrontier.UNREACHED
