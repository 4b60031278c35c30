"""keto_tpu_torch's host closure builder (engine/semiring.py) and
interior_blocks against keto_tpu's, on the CPU.

The same random interior graphs, made from a seed with numpy, go through
both packages' ``build_closure_bitset`` (one and four workers, with and
without the block schedule), ``interior_blocks``, the dirty-row rebuild
``update_closure_bitset_ex`` (insert, delete and empty deltas; D and the
dirty rows), ``transpose_closure`` and ``update_transpose``, and through
the port's plain device build ``build_closure_semiring(device="cpu")``.
These are the cases of ``tests/test_semiring.py``, parametrised. Tolerance:
none, D is uint8 and must be equal byte for byte.
"""

import numpy as np
import pytest
import torch

from keto_tpu.engine import semiring as jsemi
from keto_tpu.graph.interior import interior_blocks as j_interior_blocks
from keto_tpu_torch.engine import semiring as tsemi
from keto_tpu_torch.engine.masked_spmv import build_closure_semiring, masked_step_plain
from keto_tpu_torch.graph.interior import interior_blocks as t_interior_blocks
from keto_tpu_torch.ops.closure import pack_adjacency

torch.set_num_threads(1)


def _m_pad(m: int) -> int:
    return ((m + 255) // 256) * 256


def _rand_edges(rng, m: int, n_edges: int):
    src = rng.integers(0, m, n_edges, dtype=np.int32)
    dst = rng.integers(0, m, n_edges, dtype=np.int32)
    return src, dst


class _IG:
    """The two fields interior_blocks reads, for a bare edge list."""

    def __init__(self, m, src, dst):
        self.m, self.ii_src, self.ii_dst = m, src, dst


def _plain_device_build(src, dst, m, m_pad, k_max) -> np.ndarray:
    d = build_closure_semiring(
        pack_adjacency(src, dst, m_pad), m, m_pad=m_pad, k_max=k_max,
        device="cpu", step=masked_step_plain,
    )
    return d.numpy()


def _graph(seed: int, lo: int = 1, hi: int = 60):
    rng = np.random.default_rng(seed)
    m = int(rng.integers(lo, hi))
    src, dst = _rand_edges(rng, m, int(rng.integers(0, 4 * m)))
    return rng, m, _m_pad(m), src, dst


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("with_blocks", [False, True])
def test_build_matches_reference_and_device_build(seed, workers, with_blocks):
    rng, m, m_pad, src, dst = _graph(seed)
    k_max = int(rng.integers(1, 7))
    tblocks = t_interior_blocks(_IG(m, src, dst)) if with_blocks else None
    jblocks = j_interior_blocks(_IG(m, src, dst)) if with_blocks else None
    got = tsemi.build_closure_bitset(
        src, dst, m, m_pad, k_max, workers=workers, blocks=tblocks
    )
    want = jsemi.build_closure_bitset(
        src, dst, m, m_pad, k_max, workers=workers, blocks=jblocks
    )
    assert got.dtype == np.uint8 and got.flags.writeable
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _plain_device_build(src, dst, m, m_pad, k_max))


@pytest.mark.parametrize("k_max", [1, 2, 3, 6])
def test_cycles_and_self_loops(k_max):
    # a 0 -> 1 -> 2 -> 0 cycle and a self loop: distances clamp at k_max,
    # the live diagonal stays 0
    src = np.array([0, 1, 2, 3], dtype=np.int32)
    dst = np.array([1, 2, 0, 3], dtype=np.int32)
    got = tsemi.build_closure_bitset(src, dst, 4, 256, k_max)
    np.testing.assert_array_equal(got, jsemi.build_closure_bitset(src, dst, 4, 256, k_max))
    np.testing.assert_array_equal(got, _plain_device_build(src, dst, 4, 256, k_max))


def test_padding_rows_stay_inf_and_empty_interior():
    src = np.array([0], dtype=np.int32)
    dst = np.array([1], dtype=np.int32)
    d = tsemi.build_closure_bitset(src, dst, 2, 256, 4)
    assert (d[2:] == 255).all() and d[0, 0] == 0 and d[1, 1] == 0 and d[0, 1] == 1
    empty = np.zeros(0, dtype=np.int32)
    np.testing.assert_array_equal(
        tsemi.build_closure_bitset(empty, empty, 0, 256, 4),
        jsemi.build_closure_bitset(empty, empty, 0, 256, 4),
    )


@pytest.mark.parametrize("seed", range(8))
def test_interior_blocks_match_reference(seed):
    _, m, _, src, dst = _graph(seed, lo=2, hi=80)
    got = t_interior_blocks(_IG(m, src, dst))
    want = j_interior_blocks(_IG(m, src, dst))
    assert (got.m, got.n_blocks, got.n_levels) == (want.m, want.n_blocks, want.n_levels)
    for field in ("comp", "level", "build_order"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    np.testing.assert_array_equal(got.block_sizes(), want.block_sizes())


@pytest.mark.parametrize("seed", range(10))
@pytest.mark.parametrize("workers", [1, 4])
def test_insert_and_delete_deltas(seed, workers):
    rng = np.random.default_rng(100 + seed)
    m = int(rng.integers(8, 300))
    m_pad = _m_pad(m)
    src, dst = _rand_edges(rng, m, 3 * m)
    k_max = int(rng.integers(2, 6))
    d_prev = tsemi.build_closure_bitset(src, dst, m, m_pad, k_max)
    keep = rng.random(len(src)) > 0.2  # an arbitrary delta: drop a slice,
    add_src, add_dst = _rand_edges(rng, m, int(rng.integers(1, 10)))  # add edges
    new_src = np.concatenate([src[keep], add_src])
    new_dst = np.concatenate([dst[keep], add_dst])
    d_new, rows = tsemi.update_closure_bitset_ex(
        d_prev, src, dst, new_src, new_dst, m, m_pad, k_max, workers=workers
    )
    j_new, j_rows = jsemi.update_closure_bitset_ex(
        d_prev, src, dst, new_src, new_dst, m, m_pad, k_max, workers=workers
    )
    np.testing.assert_array_equal(rows, j_rows)
    np.testing.assert_array_equal(d_new, j_new)
    np.testing.assert_array_equal(
        d_new, tsemi.build_closure_bitset(new_src, new_dst, m, m_pad, k_max)
    )
    np.testing.assert_array_equal(
        d_new, _plain_device_build(new_src, new_dst, m, m_pad, k_max)
    )
    assert rows.size <= m and d_prev is not d_new
    # the count form agrees
    _, n_dirty = tsemi.update_closure_bitset(
        d_prev, src, dst, new_src, new_dst, m, m_pad, k_max
    )
    assert n_dirty == rows.size


@pytest.mark.parametrize("seed", range(6))
def test_deletion_only_with_block_refinement(seed):
    rng = np.random.default_rng(200 + seed)
    m = int(rng.integers(8, 64))
    m_pad = _m_pad(m)
    src, dst = _rand_edges(rng, m, 3 * m)
    d_prev = tsemi.build_closure_bitset(src, dst, m, m_pad, 4)
    keep = rng.random(len(src)) > 0.3
    d_new, rows = tsemi.update_closure_bitset_ex(
        d_prev, src, dst, src[keep], dst[keep], m, m_pad, 4,
        blocks=t_interior_blocks(_IG(m, src, dst)),
    )
    j_new, j_rows = jsemi.update_closure_bitset_ex(
        d_prev, src, dst, src[keep], dst[keep], m, m_pad, 4,
        blocks=j_interior_blocks(_IG(m, src, dst)),
    )
    np.testing.assert_array_equal(rows, j_rows)
    np.testing.assert_array_equal(d_new, j_new)
    np.testing.assert_array_equal(
        d_new, tsemi.build_closure_bitset(src[keep], dst[keep], m, m_pad, 4)
    )


def test_empty_delta_reuses_the_matrix():
    src = np.array([0, 1], dtype=np.int32)
    dst = np.array([1, 2], dtype=np.int32)
    d = tsemi.build_closure_bitset(src, dst, 3, 256, 4)
    # the same edges in another order, with a duplicate: nothing is dirty
    src2 = np.array([1, 0, 0], dtype=np.int32)
    dst2 = np.array([2, 1, 1], dtype=np.int32)
    d_new, rows = tsemi.update_closure_bitset_ex(d, src, dst, src2, dst2, 3, 256, 4)
    assert rows.size == 0 and d_new is d
    assert tsemi.update_transpose(d.T.copy(), d_new, rows) is not None


def test_edge_delta_keys():
    args = (np.array([0, 1]), np.array([1, 2]), np.array([1, 5]), np.array([2, 6]), 256)
    ins, dele = tsemi.interior_edge_delta(*args)
    j_ins, j_dele = jsemi.interior_edge_delta(*args)
    assert list(ins) == list(j_ins) == [5 * 256 + 6]
    assert list(dele) == list(j_dele) == [0 * 256 + 1]


@pytest.mark.parametrize("seed", range(4))
def test_transposes_match_reference(seed):
    rng = np.random.default_rng(300 + seed)
    m = int(rng.integers(8, 120))
    m_pad = _m_pad(m)
    src, dst = _rand_edges(rng, m, 3 * m)
    d = tsemi.build_closure_bitset(src, dst, m, m_pad, 4)
    d_rev = tsemi.transpose_closure(d)
    assert d_rev.flags.c_contiguous
    np.testing.assert_array_equal(d_rev, jsemi.transpose_closure(d))
    np.testing.assert_array_equal(d_rev, d.T)
    keep = rng.random(len(src)) > 0.25
    d_new, rows = tsemi.update_closure_bitset_ex(
        d, src, dst, src[keep], dst[keep], m, m_pad, 4
    )
    got = tsemi.update_transpose(d_rev, d_new, rows)
    np.testing.assert_array_equal(got, jsemi.update_transpose(d_rev, d_new, rows))
    np.testing.assert_array_equal(got, d_new.T)
    assert rows.size == 0 or got is not d_rev  # the old D^T is left intact
    np.testing.assert_array_equal(d_rev, d.T)
