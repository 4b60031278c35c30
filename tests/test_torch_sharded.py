"""keto_tpu_torch's multi-device engines vs keto_tpu's, on the CPU.

The port's ``ShardedCheckEngine`` and ``ShardedClosureEngine`` run on an
8-stripe mesh of one repeated CPU device (``[cpu] * 8``); the reference's
run on ``jax.devices()``, the 8 virtual CPU devices ``tests/conftest.py``
gives JAX. Both get the same random stores, built from one numpy seed, and
the same requests, in every mesh shape (1, 8), (2, 4), (4, 2) and (8, 1):
the allowed bitmaps must equal each other and the host oracle's, and each
stripe's CSR arrays, D, ``shard_bytes()`` and ``overflow_stats`` must be
byte-equal. Covers the cases of ``tests/test_multichip_sharded.py`` and
``tests/test_sharded_utils.py``. Tolerance: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keto_tpu.engine import CheckEngine as JCheck
from keto_tpu.graph import SnapshotManager as JManager
from keto_tpu.parallel import ShardedCheckEngine as JShardedCheck
from keto_tpu.parallel import ShardedClosureEngine as JShardedClosure
from keto_tpu.parallel import closure_sharded as jclosure_sharded
from keto_tpu.parallel import make_mesh as jmake_mesh
from keto_tpu.parallel import sharded as jsharded
from keto_tpu.relationtuple import RelationTuple as JTuple
from keto_tpu.store import InMemoryTupleStore as JStore
from keto_tpu_torch.engine import CheckEngine as TCheck
from keto_tpu_torch.graph.snapshot import SnapshotManager as TManager
from keto_tpu_torch.parallel import Mesh, make_mesh
from keto_tpu_torch.parallel import ShardedCheckEngine as TShardedCheck
from keto_tpu_torch.parallel import ShardedClosureEngine as TShardedClosure
from keto_tpu_torch.parallel import closure_sharded as tclosure_sharded
from keto_tpu_torch.parallel import sharded as tsharded
from keto_tpu_torch.relationtuple import RelationTuple as TTuple
from keto_tpu_torch.store import InMemoryTupleStore as TStore

CPU8 = [torch.device("cpu")] * 8
MESH_SHAPES = [(1, 8), (2, 4), (4, 2), (8, 1)]


def jax_devices():
    devices = jax.devices()
    assert len(devices) >= 8, "tests/conftest.py gives JAX 8 virtual CPU devices"
    return devices[:8]


def meshes(shape):
    """(reference mesh, port mesh) of one shape."""
    data, edge = shape
    return jmake_mesh(jax_devices(), data=data, edge=edge), make_mesh(CPU8, data=data, edge=edge)


def random_tuples(rng, n_objects, n_users, n_edges, n_rel=3) -> list[str]:
    tuples = set()
    for _ in range(n_edges):
        obj = f"o{rng.integers(n_objects)}"
        rel = f"r{rng.integers(n_rel)}"
        if rng.random() < 0.45:
            sub = f"n:o{rng.integers(n_objects)}#r{rng.integers(n_rel)}"
        else:
            sub = f"u{rng.integers(n_users)}"
        tuples.add(f"n:{obj}#{rel}@({sub})")
    return sorted(tuples)


def random_requests(rng, n, n_objects, n_users, set_share=0.3, n_rel=3) -> list[str]:
    out = []
    for _ in range(n):
        obj = f"o{rng.integers(n_objects)}"
        rel = f"r{rng.integers(n_rel)}"
        if rng.random() < set_share:
            sub = f"(n:o{rng.integers(n_objects)}#r{rng.integers(n_rel)})"
        else:
            sub = f"u{rng.integers(n_users)}"
        out.append(f"n:{obj}#{rel}@{sub}")
    return out


class Side:
    """One package's store, snapshot manager and host oracle over the same
    tuple strings (written in one call, in list order, so the vocab ids are
    equal across the packages)."""

    def __init__(self, pkg: str, tuples: list[str]):
        self.pkg = pkg
        self.Tuple = JTuple if pkg == "jax" else TTuple
        self.store = (JStore if pkg == "jax" else TStore)()
        if tuples:
            self.store.write_relation_tuples(*(self.Tuple.from_string(s) for s in tuples))
        self.mgr = (JManager if pkg == "jax" else TManager)(self.store)
        self.oracle = (JCheck if pkg == "jax" else TCheck)(self.store, max_depth=5)

    def tuples(self, strings):
        return [self.Tuple.from_string(s) for s in strings]

    def write(self, *strings):
        self.store.write_relation_tuples(*self.tuples(strings))


def sides(tuples):
    return Side("jax", tuples), Side("torch", tuples)


def equal_answers(engines, sides_, reqs, **kw):
    """Each engine's batch_check of ``reqs``: equal across the packages and
    to the host oracle; returns the port's."""
    (jeng, teng), (j, t) = engines, sides_
    want = j.oracle.batch_check(j.tuples(reqs), **kw)
    assert t.oracle.batch_check(t.tuples(reqs), **kw) == want
    got_j = jeng.batch_check(j.tuples(reqs), **kw)
    got_t = teng.batch_check(t.tuples(reqs), **kw)
    assert got_j == want
    assert got_t == want
    return got_t


# -- the mesh ------------------------------------------------------------------


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_make_mesh_lays_out_the_references_grid(shape):
    jm, tm = meshes(shape)
    assert isinstance(tm, Mesh) and tm.axis_names == jm.axis_names
    assert tm.shape == dict(jm.shape)
    assert len(tm.devices) == shape[0] and tm.distinct() == [torch.device("cpu")]
    assert all(len(row) == shape[1] for row in tm.devices)


@pytest.mark.parametrize("data,edge", [(3, 3), (16, 1), (16, None), (3, None)])
def test_make_mesh_refuses_a_bad_shape_with_the_references_message(data, edge):
    with pytest.raises(ValueError) as want:
        jmake_mesh(jax_devices(), data=data, edge=edge)
    with pytest.raises(ValueError) as got:
        make_mesh(CPU8, data=data, edge=edge)
    assert str(got.value) == str(want.value)


def test_make_mesh_defaults_to_the_cuda_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = make_mesh(data=1)
    assert mesh.devices == [[torch.device("cuda", 0), torch.device("cuda", 1)]]


def test_bucket_batch_is_the_references():
    """tests/test_sharded_utils.py: the bucket terminates for a data axis
    that is not a power of two, and divides over it."""

    class Dummy:
        pass

    for n_data in (1, 2, 3, 5, 6, 7, 8):
        eng = Dummy()
        eng.n_data = n_data
        for n in (1, 7, 8, 9, 100, 4096):
            b = TShardedCheck._bucket_batch(eng, n)
            assert b == JShardedCheck._bucket_batch(eng, n)
            assert b == TShardedClosure._bucket_batch(eng, n)
            assert b >= n and b % n_data == 0
            per = b // n_data
            assert per & (per - 1) == 0


@pytest.mark.parametrize("edge_chunk", [0, 16, 7])
def test_local_propagate_is_the_references(edge_chunk):
    rng = np.random.default_rng(3)
    pn, e = 64, 96
    f = rng.random((8, pn)) < 0.2
    src = rng.integers(0, pn, e).astype(np.int32)
    dst = rng.integers(0, pn, e).astype(np.int32)
    # the reference scans in chunks that divide its stripe
    jchunk = edge_chunk if edge_chunk and e % edge_chunk == 0 else e
    want = np.asarray(jsharded._local_propagate(
        jnp.asarray(f), jnp.asarray(src), jnp.asarray(dst), pn, jchunk))
    got = tsharded._local_propagate(
        torch.from_numpy(f), torch.from_numpy(src).long(), torch.from_numpy(dst).long(),
        pn, edge_chunk).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_stripe_helpers_are_byte_equal(n_shards):
    rng = np.random.default_rng(n_shards)
    pn = 50
    counts = rng.integers(0, 5, pn)
    indptr = np.zeros(pn + 1, dtype=np.int32)
    np.cumsum(counts, out=indptr[1:])
    vals = rng.integers(0, 1000, int(indptr[-1])).astype(np.int32)
    for a, b in zip(tclosure_sharded._stripe_csr(indptr, vals, pn, n_shards),
                    jclosure_sharded._stripe_csr(indptr, vals, pn, n_shards)):
        assert np.array_equal(a, b) and getattr(a, "dtype", None) == getattr(b, "dtype", None)
    vec = rng.integers(-1, 9, pn).astype(np.int32)
    got = tclosure_sharded._stripe_vector(vec, pn, n_shards, -1)
    want = jclosure_sharded._stripe_vector(vec, pn, n_shards, -1)
    assert np.array_equal(got, want) and got.dtype == want.dtype


# -- ShardedCheckEngine (the edge-partitioned lockstep BFS) ---------------------


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_sharded_check_matches_the_reference_and_the_oracle(shape):
    rng = np.random.default_rng(42)
    pair = sides(random_tuples(rng, n_objects=20, n_users=12, n_edges=300))
    jm, tm = meshes(shape)
    engines = (JShardedCheck(pair[0].mgr, mesh=jm, max_depth=5),
               TShardedCheck(pair[1].mgr, mesh=tm, max_depth=5))
    reqs = random_requests(rng, 96, 20, 12)
    got = equal_answers(engines, pair, reqs)
    assert any(got) and not all(got)
    depths = [1 + (i % 5) for i in range(len(reqs))]
    equal_answers(engines, pair, reqs, depths=depths)


def test_sharded_check_depth_budget_and_writes():
    pair = sides(["n:obj#r@(n:s1#m)", "n:s1#m@(n:s2#m)", "n:s2#m@alice"])
    jm, tm = meshes((2, 4))
    engines = (JShardedCheck(pair[0].mgr, mesh=jm, max_depth=8),
               TShardedCheck(pair[1].mgr, mesh=tm, max_depth=8))
    for eng, side in zip(engines, pair):
        req = side.Tuple.from_string("n:obj#r@alice")
        assert not eng.subject_is_allowed(req, max_depth=2)
        assert eng.subject_is_allowed(req, max_depth=3)
        # a write is visible after the re-shard
        side.write("n:s2#m@bob")
        assert eng.subject_is_allowed(side.Tuple.from_string("n:obj#r@bob"))


def test_sharded_check_ids_matches_the_object_api():
    rng = np.random.default_rng(43)
    pair = sides(random_tuples(rng, n_objects=16, n_users=10, n_edges=220))
    jm, tm = meshes((2, 4))
    engines = (JShardedCheck(pair[0].mgr, mesh=jm, max_depth=5),
               TShardedCheck(pair[1].mgr, mesh=tm, max_depth=5))
    reqs = random_requests(rng, 64, 16, 10, set_share=0.0)
    outs = []
    for eng, side in zip(engines, pair):
        snap = side.mgr.snapshot()
        tuples = side.tuples(reqs)
        start = np.array([snap.node_for_set(r.namespace, r.object, r.relation) for r in tuples],
                         dtype=np.int64)
        target = np.array([snap.node_for_subject(r.subject) for r in tuples], dtype=np.int64)
        got = eng.check_ids(start, target).tolist()
        assert got == side.oracle.batch_check(tuples) == eng.batch_check(tuples)
        # ids beyond the snapshot clamp to the dummy: denied, no crash
        big = np.array([snap.padded_nodes + 5], dtype=np.int64)
        assert eng.check_ids(big, big).tolist() == [False]
        assert eng.check_ids(np.empty(0, np.int64), np.empty(0, np.int64)).tolist() == []
        outs.append((start.tolist(), target.tolist(), got))
    assert outs[1] == outs[0]


def test_sharded_check_circular_and_unknowns():
    pair = sides(["n:a#r@(n:b#r)", "n:b#r@(n:a#r)"])
    jm, tm = meshes((1, 8))
    engines = (JShardedCheck(pair[0].mgr, mesh=jm), TShardedCheck(pair[1].mgr, mesh=tm))
    got = equal_answers(engines, pair, ["n:a#r@alice", "n:a#r@(n:a#r)", "zz:zz#zz@nobody",
                                        "n:b#r@(n:a#r)"])
    assert got == [False, True, False, True]


def test_sharded_check_warmup_places_the_stripes_once():
    pair = sides(["n:doc#view@(n:g#m)", "n:g#m@ann"])
    eng = TShardedCheck(pair[1].mgr, mesh=make_mesh(CPU8, data=2, edge=4))
    eng.warmup(100)
    cached = eng._cached
    assert cached is not None and len(cached[2]) == 2 and len(cached[2][0]) == 4
    eng.warmup(1)
    assert eng._cached is cached  # the same snapshot: the same stripes


# -- ShardedClosureEngine (D replicated, CSRs node-striped) ---------------------


def assert_resident_equal(jeng, teng):
    """Each stripe's CSR arrays, the interior index, D and shard_bytes()
    byte-equal across the packages."""
    jr, tr = jeng._resident, teng._resident
    placement = tr[3]
    assert tr[2] == jr[2]  # m_pad
    assert np.array_equal(placement.host["d"].cpu().numpy(), np.asarray(jr[3]))
    for i, name in enumerate(("f0_ip", "f0_v", "l_ip", "l_v", "int", "out_ip", "out_v")):
        want = np.asarray(jr[4 + i])
        got = placement.host[name]
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    assert teng.shard_bytes() == jeng.shard_bytes()


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_sharded_closure_matches_the_reference_and_the_oracle(shape):
    rng = np.random.default_rng(7)
    pair = sides(random_tuples(rng, n_objects=20, n_users=12, n_edges=300))
    jm, tm = meshes(shape)
    engines = (JShardedClosure(pair[0].mgr, mesh=jm, max_depth=5),
               TShardedClosure(pair[1].mgr, mesh=tm, max_depth=5))
    reqs = random_requests(rng, 96, 20, 12)
    for depths in (None, [1 + (i % 5) for i in range(96)]):
        equal_answers(engines, pair, reqs, depths=depths)
    assert_resident_equal(*engines)
    bytes_ = engines[1].shard_bytes()
    assert bytes_["total_per_shard"] > 0
    assert set(bytes_) >= {"d_replicated", "f0_vals", "out_vals"}
    assert engines[1].overflow_stats == engines[0].overflow_stats


def test_sharded_closure_wide_fanout_falls_back_exactly():
    """Rows wider than the static gather widths overflow to the exact host
    fallback, never silently truncated."""
    tuples = []
    for i in range(70):  # 70 set successors > f0_max=32
        tuples += [f"n:doc#view@(n:g{i}#m)", f"n:g{i}#m@(n:h{i}#m)"]
    tuples += [f"n:h{i}#m@alice" for i in range(50)]  # 50 interior in-neighbours
    pair = sides(tuples)
    jm, tm = meshes((1, 8))
    engines = (JShardedClosure(pair[0].mgr, mesh=jm, max_depth=5),
               TShardedClosure(pair[1].mgr, mesh=tm, max_depth=5))
    equal_answers(engines, pair, ["n:doc#view@alice", "n:doc#view@bob",
                                  "n:doc#view@(n:g3#m)", "n:doc#view@(n:h9#m)"])
    assert engines[1].overflow_stats == engines[0].overflow_stats
    assert_resident_equal(*engines)


def _wide_tuples():
    tuples = ["n:doc#view@(n:g0#m)"]
    for i in range(120):  # alice in 120 groups: an L row far past l_max=32
        tuples += [f"n:g{i}#m@alice", f"n:top#r@(n:g{i}#m)"]  # every g interior
    return tuples


WIDE_REQUESTS = ["n:doc#view@alice", "n:top#r@alice", "n:doc#view@mallory"]


def test_sharded_closure_escalated_pass_keeps_wide_rows_on_the_device():
    """A wide fan-out row is answered by the escalated device pass, not the
    host oracle; beyond the escalated widths the oracle answers, counted."""
    pair = sides(_wide_tuples())
    jm, tm = meshes((1, 8))
    engines = (JShardedClosure(pair[0].mgr, mesh=jm, max_depth=5),
               TShardedClosure(pair[1].mgr, mesh=tm, max_depth=5))
    assert equal_answers(engines, pair, WIDE_REQUESTS) == [True, True, False]
    assert engines[1].overflow_stats == engines[0].overflow_stats
    assert engines[1].overflow_stats["escalated"] > 0
    assert engines[1].overflow_stats["host_fallback"] == 0
    narrow = (JShardedClosure(pair[0].mgr, mesh=jm, max_depth=5, f0_max_escalated=64,
                              l_max_escalated=64),
              TShardedClosure(pair[1].mgr, mesh=tm, max_depth=5, f0_max_escalated=64,
                              l_max_escalated=64))
    assert equal_answers(narrow, pair, WIDE_REQUESTS) == [True, True, False]
    assert narrow[1].overflow_stats == narrow[0].overflow_stats
    assert narrow[1].overflow_stats["host_fallback"] > 0


def test_the_port_builds_nothing_for_an_empty_batch():
    pair = sides(["n:doc#view@ann"])
    eng = TShardedClosure(pair[1].mgr, mesh=make_mesh(CPU8, data=1, edge=8))
    assert eng.check_ids(np.empty(0, np.int64), np.empty(0, np.int64)).tolist() == []
    assert eng.batch_check([]) == [] and eng._resident is None
