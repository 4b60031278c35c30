"""keto_tpu_torch on a CUDA card: the masked-SpMV and packed-propagate
kernels against their plain versions, and the closure and packed engines on
the card against the same engines on the CPU.

Marked ``cuda``; each test skips when no card is present (decided inside
the fixture, never at import). Run on a card with
``python -m pytest tests/test_torch_cuda.py -m cuda``. Tolerance: exact —
masks are 0/1, frontiers are bitmaps, D is uint8, answers are booleans.
"""

import numpy as np
import pytest
import torch

from keto_tpu_torch.engine import ClosureCheckEngine, DeviceCheckEngine
from keto_tpu_torch.engine import masked_spmv
from keto_tpu_torch.graph import SnapshotManager
from keto_tpu_torch.ops import packed
from keto_tpu_torch.relationtuple import RelationTuple
from keto_tpu_torch.store import InMemoryTupleStore

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU tests cover the plain versions")
    return torch.device("cuda")


@pytest.mark.parametrize("g,m", [(128, 128), (256, 1024)])
def test_kernel_matches_plain(cuda, g, m):
    gen = torch.Generator(device=cuda).manual_seed(g + m)

    def bern(shape, p):
        return (torch.rand(shape, generator=gen, device=cuda) < p).to(
            torch.bfloat16
        )

    f, a = bern((g, m), 0.05), bern((m, m), 0.05)
    r = torch.maximum(f, bern((g, m), 0.05))
    before = masked_spmv.masked_step.launches
    kn, kr = masked_spmv.masked_step(f, a, r)
    pn, pr = masked_spmv.masked_step_plain(f, a, r)
    torch.cuda.synchronize()
    assert masked_spmv.masked_step.launches == before + 1
    assert torch.equal(kn, pn) and torch.equal(kr, pr)


def test_engine_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(3)
    store = InMemoryTupleStore()
    tuples = {
        f"n:o{rng.integers(20)}#r{rng.integers(3)}@"
        + (
            f"(n:o{rng.integers(20)}#r{rng.integers(3)})"
            if rng.random() < 0.45
            else f"u{rng.integers(12)}"
        ): None
        for _ in range(200)
    }
    store.write_relation_tuples(*(RelationTuple.from_string(s) for s in tuples))
    reqs = [
        RelationTuple.from_string(f"n:o{rng.integers(20)}#r{rng.integers(3)}@u{i % 12}")
        for i in range(128)
    ]
    on_card = ClosureCheckEngine(SnapshotManager(store), device=cuda)
    on_cpu = ClosureCheckEngine(SnapshotManager(store), device="cpu")
    assert on_card.batch_check(reqs) == on_cpu.batch_check(reqs)
    assert np.array_equal(on_card.closure(), on_cpu.closure())


@pytest.mark.parametrize("n_pad,w,m", [(4096, 128, 50_000), (1 << 16, 256, 300_000)])
def test_packed_kernel_matches_plain(cuda, n_pad, w, m):
    """Rows with no in-edge, duplicate edges, a hub row with thousands of
    in-edges, probe and padding edges, and the dummy row."""
    rng = np.random.default_rng(n_pad + w)
    bsz = 32 * w
    n_out = n_pad + bsz
    src = rng.integers(n_pad, size=m)
    dst = rng.integers(n_pad // 2, size=m)
    dst[:5000] = 17  # hub
    src[5000:5100] = src[5100:5200]  # duplicates
    dst[5000:5100] = dst[5100:5200]
    src[-1] = n_pad - 1  # the dummy row as a source
    order = np.argsort(dst, kind="stable")
    pad = (-(m + bsz)) % 1024
    src_all = np.concatenate(
        [src[order], rng.integers(n_pad, size=bsz), np.full(pad, n_pad - 1)]
    ).astype(np.int32)
    dst_all = np.concatenate(
        [dst[order], n_pad + np.arange(bsz), np.full(pad, n_out - 1)]
    ).astype(np.int32)
    gen = torch.Generator(device=cuda).manual_seed(n_pad)
    f = torch.randint(
        -(2**31), 2**31 - 1, (n_pad, w), generator=gen, device=cuda,
        dtype=torch.int32,
    )
    s = torch.from_numpy(src_all).to(cuda)
    d = torch.from_numpy(dst_all).to(cuda)
    before = packed.packed_propagate.launches
    got = packed.packed_propagate(f, s, d, n_out)
    want = packed.packed_propagate_plain(f, s, d, n_out)
    torch.cuda.synchronize()
    assert packed.packed_propagate.launches == before + 1
    assert torch.equal(got, want)
    assert not got[n_pad // 2 : n_pad].any()  # rows with no in-edge


def test_packed_engine_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(4)
    store = InMemoryTupleStore()
    tuples = {
        f"n:o{rng.integers(30)}#r{rng.integers(3)}@"
        + (
            f"(n:o{rng.integers(30)}#r{rng.integers(3)})"
            if rng.random() < 0.45
            else f"u{rng.integers(20)}"
        ): None
        for _ in range(300)
    }
    store.write_relation_tuples(*(RelationTuple.from_string(s) for s in tuples))
    reqs = [
        RelationTuple.from_string(
            f"n:o{rng.integers(32)}#r{rng.integers(3)}@u{rng.integers(22)}"
        )
        for _ in range(500)
    ]
    depths = [int(d) for d in rng.integers(0, 7, size=len(reqs))]
    on_card = DeviceCheckEngine(SnapshotManager(store), mode="packed", device=cuda)
    on_cpu = DeviceCheckEngine(SnapshotManager(store), mode="packed", device="cpu")
    before = packed.packed_propagate.launches
    got = on_card.batch_check(reqs, depths=depths)
    assert packed.packed_propagate.launches > before
    assert got == on_cpu.batch_check(reqs, depths=depths)
    assert 0 < sum(got) < len(got)
