"""keto_tpu_torch on a CUDA card: the masked-SpMV kernel against its plain
version, and the engine on the card against the engine on the CPU.

Marked ``cuda``; each test skips when no card is present (decided inside
the fixture, never at import). Run on a card with
``python -m pytest tests/test_torch_cuda.py -m cuda``. Tolerance: exact —
masks are 0/1, D is uint8, answers are booleans.
"""

import numpy as np
import pytest
import torch

from keto_tpu_torch.engine import ClosureCheckEngine
from keto_tpu_torch.engine import masked_spmv
from keto_tpu_torch.graph import SnapshotManager
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
