"""keto_tpu_torch.ops.packed vs keto_tpu.ops.packed on the CPU.

The JAX side runs its Pallas kernel in interpret mode (``interpret=True``,
as tests/test_packed_engine.py runs it); the port runs its plain version,
directly and through the wrapper, which takes the plain version for CPU
tensors. Inputs are made with numpy from a seed. Tolerance: exact — the
frontiers are bitmaps and the answers booleans.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keto_tpu.ops import packed as jpacked
from keto_tpu_torch.ops import packed as tpacked
from keto_tpu_torch.telemetry.devstats import DEVSTATS
from keto_tpu_torch.telemetry.metrics import MetricsRegistry
from keto_tpu_torch.utils import kernels
from packed_cases import check_case, random_graph

torch.set_num_threads(1)


def sorted_edges(rng, n_pad, n_out, m, hub_edges=0):
    """m dst-sorted edges: random ones with duplicates, `hub_edges` of them
    into one hub row, the dummy row as a source, and padding edges
    (dummy -> n_out - 1) up to m. Some rows get no in-edge."""
    k = (m - hub_edges) * 3 // 4
    src = rng.integers(n_pad, size=k)
    dst = rng.integers(n_pad // 2, size=k)  # rows >= n_pad/2: no in-edge
    src[:8] = src[8:16]  # duplicate edges
    dst[:8] = dst[8:16]
    src[16] = n_pad - 1  # the dummy row as a source
    hub = rng.integers(n_pad // 2)
    src = np.concatenate([src, rng.integers(n_pad, size=hub_edges)])
    dst = np.concatenate([dst, np.full(hub_edges, hub)])
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    pad = m - len(src)
    src = np.concatenate([src, np.full(pad, n_pad - 1)])
    dst = np.concatenate([dst, np.full(pad, n_out - 1)])
    return src.astype(np.int32), dst.astype(np.int32)


def random_frontier(rng, n_pad, w):
    f = rng.integers(-(2**31), 2**31, size=(n_pad, w), dtype=np.int64)
    f[rng.random(n_pad) < 0.3] = 0  # empty rows
    f[1] = -1  # every bit, bit 31 included
    return f.astype(np.int32)


@pytest.mark.parametrize(
    "n_pad,w,m,hub",
    [(256, 128, 2048, 0), (512, 4, 3072, 1500), (128, 8, 1024, 300)],
)
def test_propagate_matches_jax(n_pad, w, m, hub):
    rng = np.random.default_rng(n_pad + w + m)
    n_out = n_pad + 32 * w  # the probe rows of a batch of 32 W requests
    src, dst = sorted_edges(rng, n_pad, n_out, m, hub)
    f = random_frontier(rng, n_pad, w)
    want = np.asarray(
        jpacked.packed_propagate(
            jnp.asarray(f), jnp.asarray(src), jnp.asarray(dst), n_out,
            interpret=True,
        )
    )
    tf, ts, td = (torch.from_numpy(a) for a in (f, src, dst))
    got = tpacked.packed_propagate_plain(tf, ts, td, n_out)
    assert got.dtype == torch.int32 and tuple(got.shape) == (n_out, w)
    assert np.array_equal(got.numpy(), want)
    rp = tpacked.csr_row_ptr(td, n_out)
    assert torch.equal(
        tpacked.packed_propagate_plain(tf, ts, td, n_out, row_ptr=rp), got
    )
    # the wrapper takes the plain version for CPU tensors and counts nothing
    before = tpacked.packed_propagate.launches
    assert torch.equal(tpacked.packed_propagate(tf, ts, td, n_out), got)
    assert tpacked.packed_propagate.launches == before


def test_propagate_with_no_edges_is_zero():
    f = torch.full((64, 4), -1, dtype=torch.int32)
    e = torch.zeros(0, dtype=torch.int32)
    assert not tpacked.packed_propagate(f, e, e, 80).any()


def test_wrapper_rejects_bad_operands():
    f = torch.zeros((64, 4), dtype=torch.int32)
    e = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(TypeError):
        tpacked.packed_propagate(f.to(torch.int64), e, e, 64)
    with pytest.raises(TypeError):
        tpacked.packed_propagate(f, e.to(torch.int64), e, 64)
    with pytest.raises(ValueError):
        tpacked.packed_propagate(f, e, e[:4], 64)
    with pytest.raises(ValueError):
        tpacked.packed_propagate(f, e, e, 64, row_ptr=torch.zeros(10, dtype=torch.int64))


@pytest.mark.parametrize("n_pad,bsz", [(256, 4096), (1024, 8192)])
def test_build_f0_and_probe_hits_match_jax(n_pad, bsz):
    rng = np.random.default_rng(bsz + n_pad)
    w = bsz // 32
    start = rng.integers(n_pad, size=bsz).astype(np.int32)
    start[:64] = 7  # many requests share a row, bit 31 of a word included
    want = np.asarray(jpacked._build_f0(jnp.asarray(start), n_pad, w))
    got = tpacked._build_f0(torch.from_numpy(start), n_pad, w)
    assert np.array_equal(got.numpy(), want)
    probe = random_frontier(rng, bsz, w)
    want_hits = np.asarray(jpacked._probe_hits(jnp.asarray(probe), w))
    got_hits = tpacked._probe_hits(torch.from_numpy(probe), w)
    assert np.array_equal(got_hits.numpy(), want_hits)


@pytest.mark.parametrize("seed,max_steps", [(0, 5), (1, 3), (2, 8)])
def test_batched_check_matches_jax(seed, max_steps):
    rng = np.random.default_rng(seed + 90)
    n_pad, live, bsz = 256, 120, 4096
    src, dst = random_graph(rng, live, 300)
    dummy = n_pad - 1
    start = rng.integers(live, size=bsz).astype(np.int32)
    target = rng.integers(live, size=bsz).astype(np.int32)
    depth = rng.integers(0, max_steps + 1, size=bsz).astype(np.int32)
    target[:16] = start[:16]  # start == target: needs a real cycle
    start[16:24] = dummy  # the engine gives dummy rows depth 0
    target[20:28] = dummy
    depth[16:28] = 0
    want = np.asarray(
        jpacked.packed_batched_check(
            jnp.asarray(src), jnp.asarray(dst), jnp.asarray(start),
            jnp.asarray(target), jnp.asarray(depth),
            padded_nodes=n_pad, max_steps=max_steps, interpret=True,
        )
    )
    args = [torch.from_numpy(a) for a in (src, dst, start, target, depth)]
    got = tpacked.packed_batched_check(
        *args, padded_nodes=n_pad, max_steps=max_steps
    )
    assert np.array_equal(got.numpy(), want)
    assert 0 < want.sum() < bsz
    # with the per-snapshot CSR passed in, as the engine does
    rp = tpacked.csr_row_ptr(args[1], n_pad)
    got_rp = tpacked.packed_batched_check(
        *args, padded_nodes=n_pad, max_steps=max_steps, row_ptr=rp
    )
    assert torch.equal(got_rp, got)


def test_batched_check_rejects_a_ragged_batch():
    e = torch.zeros(0, dtype=torch.int32)
    b = torch.zeros(100, dtype=torch.int32)
    with pytest.raises(ValueError, match="4096"):
        tpacked.packed_batched_check(e, e, b, b, b, padded_nodes=64, max_steps=5)


def test_batched_check_counts_each_pass():
    """The loop runs at most max_steps + 1 passes and stops when every
    request is done."""
    rng = np.random.default_rng(5)
    src, dst = random_graph(rng, 60, 150)
    args = [torch.from_numpy(src), torch.from_numpy(dst)]
    start = torch.from_numpy(rng.integers(60, size=4096).astype(np.int32))
    calls = []

    def counting(*a, **kw):
        calls.append(1)
        return tpacked.packed_propagate_plain(*a, **kw)

    for depth, passes in ((5, 6), (2, 3), (0, 1)):
        calls.clear()
        tpacked.packed_batched_check(
            *args, start, start, torch.full((4096,), depth, dtype=torch.int32),
            padded_nodes=64, max_steps=5, propagate=counting,
        )
        assert len(calls) == passes


def accumulating_check(src, dst, start, target, depth, *, padded_nodes, max_steps):
    """The packed check as the JAX loop runs it, in plain torch: the
    frontier is the accumulated set, replaced by the pass's output at
    iteration 0 and OR-ed with it after. Returns (hit, passes)."""
    bsz = start.shape[0]
    w = bsz // 32
    n_out = padded_nodes + bsz
    pad = (-(src.shape[0] + bsz)) % tpacked._CHUNK
    src_all = torch.cat([src, target, torch.full((pad,), padded_nodes - 1, dtype=torch.int32)])
    dst_all = torch.cat([
        dst, padded_nodes + torch.arange(bsz, dtype=torch.int32),
        torch.full((pad,), n_out - 1, dtype=torch.int32),
    ])
    f = tpacked._build_f0(start, padded_nodes, w)
    hit = torch.zeros(bsz, dtype=torch.bool)
    done = torch.zeros(bsz, dtype=torch.bool)
    i = 0
    while i <= max_steps and not bool(done.all()):
        p_full = tpacked.packed_propagate_plain(f, src_all, dst_all, n_out)
        hit |= tpacked._probe_hits(p_full[padded_nodes:], w) & (i >= 1) & (i <= depth)
        p = p_full[:padded_nodes]
        if i == 0:
            f.copy_(p)
        else:
            f |= p
        done = hit | (i >= depth)
        i += 1
    return hit, i


@pytest.mark.parametrize(
    "seed,max_steps,kind",
    [(s, s % 9, "mixed") for s in range(13)]
    + [(13, 8, "hit_early"), (14, 3, "hit_early"), (15, 8, "shallow"), (16, 6, "shallow")],
)
def test_batched_check_matches_the_accumulating_loop(seed, max_steps, kind):
    """Carrying the last pass's output as the frontier gives the same `hit`
    and the same number of passes as carrying the accumulated set."""
    args, n_pad = check_case(seed, max_steps, kind)
    want, want_passes = accumulating_check(*args, padded_nodes=n_pad, max_steps=max_steps)
    calls = []

    def counting(*a, **kw):
        calls.append(1)
        return tpacked.packed_propagate_plain(*a, **kw)

    got = tpacked.packed_batched_check(
        *args, padded_nodes=n_pad, max_steps=max_steps, propagate=counting
    )
    assert torch.equal(got, want)
    assert len(calls) == want_passes
    if kind == "hit_early":
        assert bool(want.all()) and want_passes == min(2, max_steps + 1)
    elif kind == "shallow":
        assert want_passes == int(args[4].max()) + 1 < max_steps + 1
    if kind != "hit_early" and max_steps >= 1:
        assert 0 < int(want.sum()) < len(want)


def test_batched_check_passes_the_output_on_untouched():
    """Pass k >= 1 reads pass k-1's output as its frontier, unchanged and
    in place: no copy, no in-place OR between passes."""
    args, n_pad = check_case(3, 5, "mixed")
    seen = []  # per pass: f's data_ptr, shape and rows, the output's data_ptr and frontier rows

    def recording(f, *a, **kw):
        out = tpacked.packed_propagate_plain(f, *a, **kw)
        seen.append((f.data_ptr(), tuple(f.shape), f.clone(), out.data_ptr(), out[:n_pad].clone()))
        return out

    tpacked.packed_batched_check(
        *args, padded_nodes=n_pad, max_steps=5, propagate=recording
    )
    assert len(seen) == 6
    for (_, _, _, out_ptr, out_rows), (f_ptr, f_shape, f, _, _) in zip(seen, seen[1:]):
        assert f_ptr == out_ptr and f_shape == (n_pad, 4096 // 32)
        assert torch.equal(f, out_rows)


def test_cpu_tensors_and_a_given_pass_take_the_python_loop(monkeypatch):
    """The native loop is for CUDA tensors with the default pass: CPU
    tensors, and any pass a caller gives, run the Python loop, never load
    the kernel library, and count as ``python`` loops with their passes."""

    def refuse(name):
        raise AssertionError(f"the kernel library {name} was loaded")

    monkeypatch.setattr(kernels, "load", refuse)
    metrics = MetricsRegistry()
    DEVSTATS.bind(metrics, platform="cpu")
    loops, passes = (metrics.get(f"keto_packed_{n}_total") for n in ("loops", "passes"))

    def counts():
        return {(fam, path): f.labels(path=path).value
                for fam, f in (("loops", loops), ("passes", passes))
                for path in ("native", "python")}

    args, n_pad = check_case(7, 5, "shallow")
    before = counts()
    default = tpacked.packed_batched_check(*args, padded_nodes=n_pad, max_steps=5)
    kernel = tpacked.packed_batched_check(
        *args, padded_nodes=n_pad, max_steps=5, propagate=tpacked.packed_propagate
    )
    plain = tpacked.packed_batched_check(
        *args, padded_nodes=n_pad, max_steps=5, propagate=tpacked.packed_propagate_plain
    )
    assert torch.equal(default, kernel) and torch.equal(default, plain)
    n = int(args[4].max()) + 1  # "shallow": the loop stops on depth
    after = counts()
    assert {k: after[k] - before[k] for k in after} == {
        ("loops", "native"): 0, ("loops", "python"): 3,
        ("passes", "native"): 0, ("passes", "python"): 3 * n,
    }
