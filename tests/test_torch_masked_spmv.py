"""keto_tpu_torch.engine.masked_spmv vs keto_tpu.engine.pallas_spmv on the CPU.

The plain step is held against the JAX kernel's own plain reference
(``_masked_step_lax``; no JAX test runs the Pallas body on the CPU), and the
port's ``build_closure_semiring`` against JAX's ``_build_closure_semiring``
with the lax step and against ``build_closure_packed``. Inputs are made with
numpy from a seed. Tolerance: exact — masks are 0/1 and D is uint8.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keto_tpu.engine import pallas_spmv as jspmv
from keto_tpu.ops import closure as jclosure
from keto_tpu_torch.engine import masked_spmv as tspmv
from keto_tpu_torch.ops.closure import pack_adjacency

torch.set_num_threads(1)


def random_masks(rng, g, m, density):
    f = (rng.random((g, m)) < density).astype(np.float32)
    a = (rng.random((m, m)) < density).astype(np.float32)
    r = np.maximum(f, (rng.random((g, m)) < density).astype(np.float32))
    f[0] = 0.0  # an all-zero frontier row
    f[1] = 1.0  # an all-one frontier row
    r[2] = 1.0  # a fully reached row
    a[:, 3] = 0.0  # a column nothing reaches
    return f, a, r


def as_bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("g,m,density", [(128, 256, 0.02), (256, 512, 0.3)])
def test_plain_step_matches_lax(g, m, density):
    rng = np.random.default_rng(g + m)
    f, a, r = random_masks(rng, g, m, density)
    jn, jr = jspmv._masked_step_lax(
        jnp.asarray(f, jnp.bfloat16),
        jnp.asarray(a, jnp.bfloat16),
        jnp.asarray(r, jnp.bfloat16),
    )
    tn, tr = tspmv.masked_step_plain(as_bf16(f), as_bf16(a), as_bf16(r))
    assert tn.dtype == tr.dtype == torch.bfloat16
    assert np.array_equal(tn.float().numpy(), np.asarray(jn, np.float32))
    assert np.array_equal(tr.float().numpy(), np.asarray(jr, np.float32))
    # the wrapper takes the plain version for CPU tensors and counts nothing
    before = tspmv.masked_step.launches
    wn, wr = tspmv.masked_step(as_bf16(f), as_bf16(a), as_bf16(r))
    assert torch.equal(wn, tn) and torch.equal(wr, tr)
    assert tspmv.masked_step.launches == before


def test_wrapper_rejects_bad_operands():
    f = torch.zeros((128, 256), dtype=torch.bfloat16)
    a = torch.zeros((256, 256), dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        tspmv.masked_step(f.float(), a, f)
    with pytest.raises(ValueError):
        tspmv.masked_step(f, a[:128], f)
    with pytest.raises(ValueError):
        tspmv.masked_step(f, a.t(), f)  # not contiguous


@pytest.mark.parametrize("group", [128, 256])
@pytest.mark.parametrize("k_max", [1, 2, 4])
def test_semiring_build_matches_jax_builders(group, k_max):
    rng = np.random.default_rng(group + k_max)
    m, m_pad = 300, 768
    n_edges = 900
    src = rng.integers(m, size=n_edges)
    dst = rng.integers(m, size=n_edges)
    src = np.concatenate([src, dst[:50]])  # 2-cycles
    dst = np.concatenate([dst, src[:50]])
    packed = pack_adjacency(src, dst, m_pad)
    got = tspmv.build_closure_semiring(
        packed, m, m_pad=m_pad, k_max=k_max, group=group, device="cpu"
    ).numpy()
    want_semiring = np.asarray(
        jspmv._build_closure_semiring(
            jnp.asarray(packed), jnp.int32(m), m_pad=m_pad, k_max=k_max,
            group=group, use_pallas=False,
        )
    )
    want_matmul = np.asarray(
        jclosure.build_closure_packed(
            jnp.asarray(packed), jnp.int32(m), m_pad=m_pad, k_max=k_max
        )
    )
    assert np.array_equal(got, want_semiring)
    assert np.array_equal(got, want_matmul)


def test_semiring_build_with_explicit_plain_step():
    rng = np.random.default_rng(5)
    m, m_pad = 100, 256
    packed = pack_adjacency(
        rng.integers(m, size=300), rng.integers(m, size=300), m_pad
    )
    a = tspmv.build_closure_semiring(packed, m, m_pad=m_pad, k_max=4, device="cpu")
    b = tspmv.build_closure_semiring(
        packed, m, m_pad=m_pad, k_max=4, device="cpu",
        step=tspmv.masked_step_plain,
    )
    assert torch.equal(a, b)


# every closure width the engine can produce: multiples of 256 up to
# _m_pad_for(16384) = 17152
M_PADS = range(256, 17152 + 1, 256)


@pytest.mark.parametrize("g", [128, 256])
def test_launch_geometry_covers_every_column_once(g):
    for m in list(M_PADS) + [128, 384]:
        geom = tspmv.launch_geometry(g, m)
        assert geom.grid_x % tspmv.CLUSTER == 0  # whole clusters
        assert geom.grid_y * geom.rows == g  # every frontier row, once
        assert geom.rows == (256 if g % 256 == 0 else 128)
        stripe = tspmv.STRIPE
        cover = np.zeros(m, dtype=np.int64)
        for x in range(geom.grid_x):
            cover[x * stripe : min((x + 1) * stripe, m)] += 1
        assert (cover == 1).all(), m
        # stripes past M only pad the grid to whole clusters
        assert (geom.grid_x - tspmv.CLUSTER) * stripe < m


@pytest.mark.parametrize("g", [128, 256])
def test_launch_geometry_fills_one_wave_at_rbac1m(g):
    geom = tspmv.launch_geometry(g, 11520)
    assert geom.grid_x * geom.grid_y <= 132  # the H100's SMs: one wave
    assert geom.grid_y == 1  # the adjacency is read once per group


@pytest.mark.parametrize("g,m", [(100, 256), (256, 200), (64, 128)])
def test_launch_geometry_rejects_what_the_kernel_does_not_take(g, m):
    with pytest.raises(ValueError):
        tspmv.launch_geometry(g, m)
