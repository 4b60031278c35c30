"""keto_tpu_torch on a CUDA card: the masked-SpMV and packed-propagate
kernels against their plain versions, the packed check's native loop
against its Python loop (the same B2 kernel, pass by pass), with the sync
sites and loop counters of one packed engine batch, the closure and packed
engines on the card against the same engines on the CPU, and the list
path's D^T and row gathers on the card against the CPU build.

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
from keto_tpu_torch.relationtuple.columns import CheckColumns
from keto_tpu_torch.store import InMemoryTupleStore
from keto_tpu_torch.telemetry.attribution import (
    TimeLedger,
    reset_current_ledger,
    set_current_ledger,
)
from keto_tpu_torch.telemetry.devstats import DEVSTATS
from keto_tpu_torch.telemetry.metrics import MetricsRegistry
from packed_cases import check_case

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


def _edge_masks(device, g, m, density, seed):
    """Random 0/1 masks with an all-zero frontier row (0), an all-one row
    (1) against an all-one adjacency column (5), and a fully reached row
    (2)."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def bern(shape):
        return (torch.rand(shape, generator=gen, device=device) < density).to(
            torch.bfloat16
        )

    f, a = bern((g, m)), bern((m, m))
    r = torch.maximum(f, bern((g, m)))
    f[0] = 0
    f[1] = 1
    a[:, 5] = 1
    r[2] = 1
    return f, a, r


def _assert_kernel_matches_plain(f, a, r):
    before = masked_spmv.masked_step.launches
    kn, kr = masked_spmv.masked_step(f, a, r)
    pn, pr = masked_spmv.masked_step_plain(f, a, r)
    torch.cuda.synchronize()
    assert masked_spmv.masked_step.launches == before + 1
    assert torch.equal(kn, pn) and torch.equal(kr, pr)
    assert not kn[0].any()  # an empty frontier row reaches nothing new
    assert not kn[2].any() and bool((kr[2] == 1).all())  # fully reached
    assert kr[1, 5] == 1  # the all-one row meets the all-one column


@pytest.mark.parametrize("m", [128, 256, 384, 2048, 11520])
@pytest.mark.parametrize("g", [128, 256])
def test_kernel_edges_match_plain(cuda, g, m):
    """Ragged 96-column stripes (every M here but 384 and 11520) and CTAs
    that only pad the grid to whole clusters (M = 128, 256, 2048)."""
    geom = masked_spmv.launch_geometry(g, m)
    assert geom.grid_x * masked_spmv.STRIPE >= m
    _assert_kernel_matches_plain(*_edge_masks(cuda, g, m, 0.02, seed=g + m))


def test_kernel_at_the_largest_interior(cuda):
    """M = _m_pad_for(16384) = 17152: the all-one row against the all-one
    column counts to M in the accumulator, still exact in f32."""
    m = 17152
    f, a, r = _edge_masks(cuda, 256, m, 0.001, seed=m)
    assert int((f[1].float() @ a[:, 5].float()).item()) == m
    _assert_kernel_matches_plain(f, a, r)


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


@pytest.mark.parametrize(
    "seed,max_steps,kind,bsz",
    [(s, s % 9, "mixed", 4096) for s in range(9)]
    + [(9, 5, "mixed", 8192), (10, 8, "mixed", 8192), (11, 0, "mixed", 8192)]
    + [(13, 8, "hit_early", 4096), (14, 3, "hit_early", 8192)]
    + [(15, 8, "shallow", 4096), (16, 6, "shallow", 8192)],
)
def test_native_loop_matches_the_python_loop(cuda, seed, max_steps, kind, bsz):
    """The one-call native loop against the Python loop running the same
    B2 kernel: ``hit`` bitwise equal and the same passes, over random
    graphs with cycles, dummy rows at depth 0, start == target, batches
    that all hit early and batches whose depths stop the loop early; with
    the engine's cached CSR and with the CSR derived."""
    args, n_pad = check_case(seed, max_steps, kind, bsz)
    src, dst, start, target, depth = (a.to(cuda) for a in args)
    row_ptr = packed.csr_row_ptr(dst, n_pad) if seed % 2 else None
    calls = []

    def counting(*a, **kw):
        calls.append(1)
        return packed.packed_propagate(*a, **kw)

    common = dict(padded_nodes=n_pad, max_steps=max_steps, row_ptr=row_ptr)
    want = packed.packed_batched_check(src, dst, start, target, depth,
                                       propagate=counting, **common)
    before = packed.packed_propagate.launches
    got = packed.packed_batched_check(src, dst, start, target, depth, **common)
    torch.cuda.synchronize()
    assert got.dtype == torch.bool and got.device.type == "cuda"
    assert torch.equal(got, want)
    assert packed.packed_propagate.launches - before == len(calls)
    if kind == "hit_early":
        assert bool(want.all()) and len(calls) == min(2, max_steps + 1)
    elif kind == "shallow":
        assert len(calls) == int(args[4].max()) + 1 < max_steps + 1
    if kind != "hit_early" and max_steps >= 1:
        assert 0 < int(want.sum()) < len(want)


@pytest.mark.parametrize("reqs,allowed,passes", [
    # a denied row between known nodes is done only at its depth: all 6
    (["n:obj#access@alice", "n:doc#read@alice"], [True, False], 6),
    # alice hits at distance 3; the unknown subject has depth 0
    (["n:obj#access@alice", "n:obj#access@mallory"], [True, False], 4),
    (["n:doc#read@bob", "n:team#member@alice"], [True, True], 2),
])
def test_a_packed_engine_batch_makes_five_syncs_on_the_card(cuda, reqs, allowed, passes):
    """One packed DeviceCheckEngine batch on the card: the three uploads,
    one native loop and the decode, on the ambient ledger and in
    ``keto_device_syncs_total``; one native loop with its passes in
    ``keto_packed_{loops,passes}_total`` and in B2's launch count."""
    store = InMemoryTupleStore()
    store.write_relation_tuples(*(RelationTuple.from_string(s) for s in (
        "n:obj#access@(n:org#member)", "n:org#member@(n:team#member)",
        "n:team#member@alice", "n:doc#read@bob")))
    eng = DeviceCheckEngine(SnapshotManager(store), max_depth=5, mode="packed", device=cuda)
    cols = CheckColumns.from_tuples([RelationTuple.from_string(s) for s in reqs])
    assert eng.batch_check_columns(cols) == allowed  # builds and loads the kernels
    metrics = MetricsRegistry()
    DEVSTATS.bind(metrics, platform="cuda")
    syncs = metrics.get("keto_device_syncs_total")
    loops, passes_fam = (metrics.get(f"keto_packed_{n}_total") for n in ("loops", "passes"))
    sites = ("device.upload", "packed.loop", "device.decode",
             "packed.bits", "packed.done", "packed.row_ptr")

    def counts():
        return ({site: syncs.labels(site=site).value for site in sites},
                {path: (loops.labels(path=path).value, passes_fam.labels(path=path).value)
                 for path in ("native", "python")},
                packed.packed_propagate.launches)

    (sync0, loop0, launch0) = counts()
    led = TimeLedger()
    token = set_current_ledger(led)
    try:
        assert eng.batch_check_columns(cols) == allowed
    finally:
        reset_current_ledger(token)
    (sync1, loop1, launch1) = counts()
    want = {"device.upload": 3, "packed.loop": 1, "device.decode": 1}
    assert {site: n for site, (n, _) in led.waits.items()} == want
    assert {s: sync1[s] - sync0[s] for s in sites} == {
        **want, "packed.bits": 0, "packed.done": 0, "packed.row_ptr": 0}
    assert {p: (loop1[p][0] - loop0[p][0], loop1[p][1] - loop0[p][1]) for p in loop1} == {
        "native": (1, passes), "python": (0, 0)}
    assert launch1 - launch0 == passes


def test_overlay_on_card_matches_cpu(cuda):
    """One write sequence (leaf, interior insert with growth, interior and
    leaf deletes) absorbed by the overlay on a CUDA D and on a CPU D: the
    same answers, no rebuild, and D byte-equal after every step."""
    rng = np.random.default_rng(8)
    base = {
        f"n:o{rng.integers(20)}#r{rng.integers(3)}@"
        + (
            f"(n:o{rng.integers(20)}#r{rng.integers(3)})"
            if rng.random() < 0.45
            else f"u{rng.integers(12)}"
        ): None
        for _ in range(200)
    }
    steps = [
        ("write", "n:o1#r0@newuser"),
        ("write", "n:o2#r1@(n:o3#r2)"),
        ("write", "n:fresh#r@(n:o1#r0)"),
        ("write", "n:o4#r0@(n:fresh#r)"),
        ("delete", "n:o2#r1@(n:o3#r2)"),
        ("delete", "n:o1#r0@newuser"),
    ]
    reqs = [
        RelationTuple.from_string(
            f"n:o{rng.integers(20)}#r{rng.integers(3)}@u{rng.integers(13)}"
        )
        for _ in range(96)
    ] + [RelationTuple.from_string("n:o4#r0@newuser")]
    engines = []
    for dev in (cuda, "cpu"):
        store = InMemoryTupleStore()
        store.write_relation_tuples(*(RelationTuple.from_string(s) for s in base))
        engines.append((store, ClosureCheckEngine(SnapshotManager(store), device=dev)))
    answers = [eng.batch_check(reqs) for _, eng in engines]
    assert answers[0] == answers[1]
    for op, tup in steps:
        for store, _ in engines:
            getattr(store, f"{op}_relation_tuples")(RelationTuple.from_string(tup))
        answers = [eng.batch_check(reqs) for _, eng in engines]
        assert answers[0] == answers[1]
        (_, on_card), (_, on_cpu) = engines
        assert np.array_equal(on_card.closure(), on_cpu.closure())
        assert on_card._overlay.n_events == on_cpu._overlay.n_events > 0
    assert [e.n_full_builds for _, e in engines] == [1, 1]


def test_registry_on_card_serves_cat_videos_over_rest(cuda):
    import json
    import urllib.error
    import urllib.parse
    import urllib.request
    from pathlib import Path

    from keto_tpu_torch.driver import Config, Registry

    reg = Registry(Config(values={
        "namespaces": [{"id": 1, "name": "videos"}],
        "serve": {"read": {"host": "127.0.0.1", "port": 0},
                  "write": {"host": "127.0.0.1", "port": 0}},
    }))
    assert reg.device.type == "cuda"
    read_port, write_port = reg.start_all()
    try:
        examples = Path(__file__).resolve().parent.parent / "contrib/cat-videos-example"
        for path in sorted((examples / "relation-tuples").glob("*.json")):
            doc = json.loads(path.read_text())
            doc.pop("$schema", None)
            req = urllib.request.Request(
                f"http://127.0.0.1:{write_port}/relation-tuples",
                data=json.dumps(doc).encode(), method="PUT",
            )
            with urllib.request.urlopen(req, timeout=60) as resp:
                assert resp.status == 201
        expect = {
            ("/cats", "owner", "cat lady"): 200,
            ("/cats/1.mp4", "owner", "cat lady"): 200,
            ("/cats/1.mp4", "view", "cat lady"): 200,
            ("/cats/1.mp4", "view", "*"): 200,
            ("/cats/2.mp4", "view", "*"): 403,
        }
        for (obj, rel, sub), status in expect.items():
            query = urllib.parse.urlencode({
                "namespace": "videos", "object": obj, "relation": rel,
                "subject_id": sub,
            })
            url = f"http://127.0.0.1:{read_port}/check?{query}"
            try:
                with urllib.request.urlopen(url, timeout=60) as resp:
                    got = resp.status
            except urllib.error.HTTPError as e:
                got = e.code
            assert got == status, (obj, rel, sub)
        assert reg.check_engine()._state.d.is_cuda
    finally:
        reg.stop_all()


def _random_store(rng, n_objects=20, n_users=12, n_edges=200):
    store = InMemoryTupleStore()
    tuples = {
        f"n:o{rng.integers(n_objects)}#r{rng.integers(3)}@"
        + (
            f"(n:o{rng.integers(n_objects)}#r{rng.integers(3)})"
            if rng.random() < 0.45
            else f"u{rng.integers(n_users)}"
        ): None
        for _ in range(n_edges)
    }
    store.write_relation_tuples(*(RelationTuple.from_string(s) for s in tuples))
    return store


def test_reverse_residency_on_card_matches_cpu(cuda):
    from keto_tpu_torch.engine.listing import ListEngine
    from keto_tpu_torch.relationtuple import SubjectID

    store = _random_store(np.random.default_rng(5))
    on_card = ClosureCheckEngine(SnapshotManager(store), device=cuda)
    on_cpu = ClosureCheckEngine(SnapshotManager(store), device="cpu")
    card_view, cpu_view = on_card.reverse_artifacts(), on_cpu.reverse_artifacts()
    assert card_view.d_rev.is_cuda and card_view.d_rev.is_contiguous()
    assert torch.equal(card_view.d_rev.cpu(), cpu_view.d.t())
    assert torch.equal(card_view.d.cpu(), cpu_view.d)
    lists = [ListEngine(on_card), ListEngine(on_cpu)]
    for rel in ("r0", "r1", "r2"):
        for i in range(12):
            pages = [le.list_objects(SubjectID(f"u{i}"), rel, "n") for le in lists]
            assert pages[0].items == pages[1].items
            assert pages[0].source == pages[1].source == "reverse"
        for o in range(20):
            pages = [le.list_subjects("n", f"o{o}", rel) for le in lists]
            assert pages[0].items == pages[1].items


def test_rows_min_on_card_matches_numpy(cuda):
    from keto_tpu_torch.engine.listing import _rows_min

    gen = torch.Generator(device=cuda).manual_seed(9)
    d = torch.randint(0, 256, (1280, 1280), generator=gen, device=cuda,
                      dtype=torch.uint8)
    host = d.cpu().numpy()
    rng = np.random.default_rng(9)
    for k in (1, 3, 64, 1280):
        rows = rng.choice(1280, size=k, replace=False).astype(np.int64)
        got = _rows_min(d, rows)
        assert got.dtype == np.uint8
        assert np.array_equal(got, host[rows].min(axis=0))
        assert np.array_equal(got, _rows_min(d.cpu(), rows))


def test_pipelined_packed_batcher_on_card_matches_cpu(cuda):
    """The pipelined CheckBatcher over the packed engine on the card: the
    answers of the CPU engine, B2 launched, and a repeated id batch answered
    by the encoded cache alone."""
    from concurrent.futures import ThreadPoolExecutor

    from keto_tpu_torch.engine.batcher import CheckBatcher

    rng = np.random.default_rng(8)
    store = _random_store(rng, n_objects=30, n_users=20, n_edges=300)
    reqs = [
        RelationTuple.from_string(
            f"n:o{rng.integers(32)}#r{rng.integers(3)}@u{rng.integers(22)}"
        )
        for _ in range(200)
    ]
    eng = DeviceCheckEngine(SnapshotManager(store), mode="packed", device=cuda)
    want = DeviceCheckEngine(
        SnapshotManager(store), mode="packed", device="cpu"
    ).batch_check(reqs)
    b = CheckBatcher(eng, pipeline_depth=2, encode_workers=2,
                     encoded_cache_size=4096, version_fn=lambda: store.version,
                     window_s=0.002)
    try:
        before = packed.packed_propagate.launches
        with ThreadPoolExecutor(16) as pool:
            got = list(pool.map(b.check, reqs))
        assert got == want and packed.packed_propagate.launches > before
        s, t = eng.snapshots.snapshot().encode_requests(reqs)
        assert b.check_batch_encoded(s, t) == want
        before = packed.packed_propagate.launches
        assert b.check_batch_encoded(s, t) == want
        assert packed.packed_propagate.launches == before
    finally:
        b.close()


def test_columnar_batch_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(9)
    store = _random_store(rng)
    reqs = [
        RelationTuple.from_string(f"n:o{rng.integers(20)}#r{rng.integers(3)}@u{i % 14}")
        for i in range(128)
    ]
    cols = CheckColumns.from_tuples(reqs)
    on_card = ClosureCheckEngine(SnapshotManager(store), device=cuda)
    on_cpu = ClosureCheckEngine(SnapshotManager(store), device="cpu")
    assert on_card.batch_check_columns(cols) == on_cpu.batch_check(reqs)
    packed_card = DeviceCheckEngine(SnapshotManager(store), mode="packed", device=cuda)
    assert packed_card.batch_check_columns(cols) == on_cpu.batch_check(reqs)
