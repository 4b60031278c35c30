"""keto_tpu_torch.ops.closure vs keto_tpu.ops.closure on the CPU.

Same inputs, made with numpy from a seed, go through the JAX functions and
their PyTorch counterparts. Tolerance: exact everywhere — every output is
uint8 or boolean.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keto_tpu.ops import closure as jclosure
from keto_tpu_torch.ops import closure as tclosure

torch.set_num_threads(1)


def random_interior(rng, m, n_edges):
    """COO interior edges over m nodes, with self-loops and 2-cycles."""
    src = rng.integers(m, size=n_edges)
    dst = rng.integers(m, size=n_edges)
    k = max(1, n_edges // 10)
    # explicit 2-cycles and a self-loop
    src = np.concatenate([src, dst[:k], [0]])
    dst = np.concatenate([dst, src[:k], [0]])
    return src.astype(np.int32), dst.astype(np.int32)


@pytest.mark.parametrize("k_max", [1, 2, 4, 6])
@pytest.mark.parametrize("m,m_pad,n_edges", [(40, 256, 90), (300, 512, 700)])
def test_build_closure_packed_matches_jax(m, m_pad, n_edges, k_max):
    rng = np.random.default_rng(m * 10 + k_max)
    src, dst = random_interior(rng, m, n_edges)
    packed = tclosure.pack_adjacency(src, dst, m_pad)
    assert np.array_equal(packed, jclosure.pack_adjacency(src, dst, m_pad))
    want = np.asarray(
        jclosure.build_closure_packed(
            jnp.asarray(packed), jnp.int32(m), m_pad=m_pad, k_max=k_max
        )
    )
    got = tclosure.build_closure_packed(
        packed, m, m_pad=m_pad, k_max=k_max, device="cpu"
    )
    assert got.dtype == torch.uint8
    got = got.numpy()
    assert np.array_equal(got, want)
    # padding rows stay INF and the padding diagonal is INF, live diagonal 0
    assert (got[m:] == tclosure.INF_DIST).all()
    assert (np.diagonal(got)[:m] == 0).all()


def test_unpack_follows_packbits_order():
    rng = np.random.default_rng(3)
    dense = (rng.random((256, 256)) < 0.1).astype(np.uint8)
    packed = np.packbits(dense, axis=1)
    got = tclosure.unpack_adjacency(packed, 256, "cpu")
    assert np.array_equal(got.float().numpy().astype(np.uint8), dense)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("k_max", [1, 4, 254])
def test_closure_insert_edge_matches_jax(seed, k_max):
    rng = np.random.default_rng(seed)
    m_pad = 256
    d = rng.integers(0, 8, size=(m_pad, m_pad)).astype(np.uint8)
    d[rng.random((m_pad, m_pad)) < 0.5] = tclosure.INF_DIST
    u, v = (int(x) for x in rng.integers(m_pad, size=2))
    if seed == 0:
        # col + 1 + row = 200 + 1 + 100 wraps in uint8 arithmetic
        d[:, u] = 200
        d[v, :] = 100
    want = np.asarray(
        jclosure.closure_insert_edge(
            jnp.asarray(d), jnp.int32(u), jnp.int32(v), jnp.int32(k_max)
        )
    )
    dt = torch.from_numpy(d.copy())
    got = tclosure.closure_insert_edge(dt, u, v, k_max).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(dt.numpy(), d)  # input left as it was


@pytest.mark.parametrize("seed", range(3))
def test_closure_query_matches_jax(seed):
    rng = np.random.default_rng(seed + 10)
    m_pad, b, f_w, l_w = 256, 64, 4, 8
    d = rng.integers(0, 6, size=(m_pad, m_pad)).astype(np.uint8)
    d[rng.random((m_pad, m_pad)) < 0.7] = tclosure.INF_DIST
    d[m_pad - 1] = tclosure.INF_DIST
    f0 = rng.integers(m_pad, size=(b, f_w)).astype(np.int32)
    l = rng.integers(m_pad, size=(b, l_w)).astype(np.int32)
    f0[rng.random((b, f_w)) < 0.3] = m_pad - 1  # PAD
    extra = rng.integers(0, 2, size=b).astype(np.int32)
    depth = rng.integers(0, 8, size=b).astype(np.int32)
    direct = rng.random(b) < 0.2
    want = np.asarray(
        jclosure.closure_query(
            jnp.asarray(d), jnp.asarray(f0), jnp.asarray(l),
            jnp.asarray(extra), jnp.asarray(depth), jnp.asarray(direct),
        )
    )
    got = tclosure.closure_query(
        torch.from_numpy(d), torch.from_numpy(f0), torch.from_numpy(l),
        torch.from_numpy(extra), torch.from_numpy(depth),
        torch.from_numpy(direct),
    ).numpy()
    assert got.dtype == np.bool_
    assert np.array_equal(got, want)
