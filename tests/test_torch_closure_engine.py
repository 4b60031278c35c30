"""keto_tpu_torch's ClosureCheckEngine vs keto_tpu's, on the CPU.

The same tuples, in the same insertion order, go into a store of each
package; the port's engine (``device="cpu"``, plain step) and the JAX
engine in device query mode must give identical ``batch_check`` lists, the
same interior arrays and the same closure matrix D, byte for byte. The host
BFS oracle of each package agrees too. Tolerance: exact — every answer is a
boolean and D is uint8.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from keto_tpu.engine.closure import ClosureCheckEngine as JClosure
from keto_tpu.graph import SnapshotManager as JManager
from keto_tpu.graph.interior import build_interior as j_build_interior
from keto_tpu.relationtuple import RelationTuple as JTuple
from keto_tpu.store import InMemoryTupleStore as JStore
from keto_tpu_torch.engine import CheckEngine as TCheck
from keto_tpu_torch.engine import ClosureCheckEngine as TClosure
from keto_tpu_torch.graph import NodeVocab, SnapshotBuilder
from keto_tpu_torch.graph import SnapshotManager as TManager
from keto_tpu_torch.graph.interior import build_interior as t_build_interior
from keto_tpu_torch.relationtuple import RelationTuple as TTuple
from keto_tpu_torch.relationtuple import SubjectID
from keto_tpu_torch.store import ColumnarTupleStore, InMemoryTupleStore

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


class Pair:
    """One tuple graph held by both packages, with an engine each."""

    def __init__(self, tuples=(), max_depth=5, **kw):
        self.jstore = JStore()
        self.tstore = InMemoryTupleStore()
        self.write(*tuples)
        self.jeng = JClosure(
            JManager(self.jstore), max_depth=max_depth, query_mode="device",
            freshness="strong", **kw,
        )
        self.teng = TClosure(
            TManager(self.tstore), max_depth=max_depth, freshness="strong",
            device="cpu", **kw,
        )
        self.oracle = TCheck(self.tstore, max_depth=max_depth)

    def write(self, *strings):
        if strings:
            self.jstore.write_relation_tuples(*(JTuple.from_string(s) for s in strings))
            self.tstore.write_relation_tuples(*(TTuple.from_string(s) for s in strings))

    def delete(self, *strings):
        self.jstore.delete_relation_tuples(*(JTuple.from_string(s) for s in strings))
        self.tstore.delete_relation_tuples(*(TTuple.from_string(s) for s in strings))

    def check(self, reqs, **kw):
        """The port's answers, after asserting JAX and the oracle agree."""
        got = self.teng.batch_check([TTuple.from_string(s) for s in reqs], **kw)
        want = self.jeng.batch_check([JTuple.from_string(s) for s in reqs], **kw)
        assert got == want
        if "depths" in kw:
            oracle = [
                self.oracle.subject_is_allowed(TTuple.from_string(s), d)
                for s, d in zip(reqs, kw["depths"])
            ]
        else:
            oracle = self.oracle.batch_check(
                [TTuple.from_string(s) for s in reqs], kw.get("max_depth", 0)
            )
        assert got == oracle
        return got

    def assert_same_residency(self):
        d_t = self.teng.closure()
        jstate = self.jeng._state
        if d_t is None:
            assert not hasattr(jstate, "d")
            return
        assert np.array_equal(d_t, np.asarray(jstate.d))
        ti, ji = self.teng._state.ig, jstate.ig
        for name in ("interior_ids", "ii_src", "ii_dst", "set_out_indptr",
                     "set_out_vals", "id_in_indptr", "id_in_vals"):
            assert np.array_equal(getattr(ti, name), getattr(ji, name)), name


def random_tuples(rng, n_objects, n_users, n_edges, n_rel=3):
    """Random tuple strings with a healthy share of subject-set
    indirections (the shape of test_device_engines.random_store), in a
    fixed order so both packages intern the same ids."""
    out = {}
    for _ in range(n_edges):
        obj = f"o{rng.integers(n_objects)}"
        rel = f"r{rng.integers(n_rel)}"
        if rng.random() < 0.45:
            sub = f"n:o{rng.integers(n_objects)}#r{rng.integers(n_rel)}"
        else:
            sub = f"u{rng.integers(n_users)}"
        out[f"n:{obj}#{rel}@({sub})"] = None
    return list(out)


def random_requests(rng, n_objects, n_users, k=64):
    reqs = []
    for _ in range(k):
        obj = f"o{rng.integers(n_objects)}"
        rel = f"r{rng.integers(3)}"
        if rng.random() < 0.3:
            sub = f"n:o{rng.integers(n_objects)}#r{rng.integers(3)}"
        else:
            sub = f"u{rng.integers(n_users + 3)}"  # some unknown subjects
        reqs.append(f"n:{obj}#{rel}@({sub})")
    reqs.append("nope:x#y@nobody")
    return reqs


SCENARIOS = {
    "direct": (
        ["n:obj#access@alice"],
        ["n:obj#access@alice", "n:obj#access@bob"],
    ),
    "two_levels": (
        ["n:obj#access@(n:org#member)", "n:org#member@(n:team#member)",
         "n:team#member@alice"],
        ["n:obj#access@alice", "n:obj#access@(n:team#member)",
         "n:obj#access@mallory"],
    ),
    "wrong_object_or_relation": (
        ["n:obj#access@alice"],
        ["n:other#access@alice", "n:obj#write@alice", "other:obj#access@alice"],
    ),
    "cycle": (
        ["n:a#r@(n:b#r)", "n:b#r@(n:a#r)"],
        ["n:a#r@alice", "n:a#r@(n:a#r)", "n:a#r@(n:b#r)"],
    ),
    "set_target_depth_one": (
        ["n:obj#r@(n:grp#m)", "n:grp#m@u"],
        ["n:obj#r@(n:grp#m)", "n:obj#r@(n:obj#r)"],
    ),
    "unknown_everything": ([], ["no:thing#here@nobody"]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenarios(name):
    tuples, reqs = SCENARIOS[name]
    pair = Pair(tuples)
    for depth in (0, 1, 2, 5):
        pair.check(reqs, max_depth=depth)
    pair.assert_same_residency()


def test_depth_budget_and_clamp():
    pair = Pair(
        ["n:obj#r@(n:s1#m)", "n:s1#m@(n:s2#m)", "n:s2#m@(n:s3#m)",
         "n:s3#m@alice"],
        max_depth=10,
    )
    req = ["n:obj#r@alice"]
    assert pair.check(req, max_depth=3) == [False]
    assert pair.check(req, max_depth=4) == [True]
    assert pair.check(req, max_depth=0) == [True]  # clamps to global
    assert pair.check(req, max_depth=99) == [True]
    assert pair.check(req * 3, depths=[3, 4, 6]) == [False, True, True]


@pytest.mark.parametrize("max_depth", [4, 5, 6])
def test_depth_boundary_chain(max_depth):
    """A chain needing depth 5 is allowed at max-depth 5, one needing 6 not."""
    chain = [f"n:c{i}#m@(n:c{i + 1}#m)" for i in range(5)] + ["n:c5#m@alice"]
    pair = Pair(chain, max_depth=max_depth)
    got = pair.check(["n:c1#m@alice", "n:c0#m@alice"])
    assert got == [max_depth >= 5, max_depth >= 6]


@pytest.mark.parametrize("seed", range(4))
def test_random_graphs(seed):
    rng = np.random.default_rng(seed)
    tuples = random_tuples(rng, n_objects=15, n_users=10, n_edges=140)
    for depth in (1, 3, 6):
        pair = Pair(tuples, max_depth=depth)
        pair.check(random_requests(rng, 15, 10))
        pair.assert_same_residency()


def test_random_graphs_per_request_depths():
    rng = np.random.default_rng(50)
    pair = Pair(random_tuples(rng, 12, 8, 100), max_depth=6)
    reqs = random_requests(rng, 12, 8)
    pair.check(reqs, depths=[int(rng.integers(0, 8)) for _ in reqs])


def test_overflow_rows_fall_back_exactly():
    """Rows above 32 fan-out (and tiny widths) take the oracle fallback."""
    rng = np.random.default_rng(200)
    tuples = random_tuples(rng, 10, 6, 100)
    # a start with 40 set successors and a user in 40 interior sets
    tuples += [f"n:wide#r@(n:g{i}#m)" for i in range(40)]
    tuples += [f"n:g{i}#m@hub" for i in range(40)]
    tuples += [f"n:g{i}#m@(n:o{i % 10}#r0)" for i in range(40)]
    pair = Pair(tuples)
    reqs = random_requests(rng, 10, 6) + ["n:wide#r@hub", "n:o1#r0@hub",
                                          "n:wide#r@u1"]
    pair.check(reqs)
    narrow = Pair(tuples, f0_max=1, l_max=1)
    narrow.check(reqs)


def test_interior_limit_falls_back_whole_batch():
    rng = np.random.default_rng(7)
    pair = Pair(random_tuples(rng, 10, 6, 80), interior_limit=2)
    pair.check(random_requests(rng, 10, 6))
    assert pair.teng.closure() is None
    pair.assert_same_residency()


def test_writes_between_checks():
    rng = np.random.default_rng(21)
    tuples = random_tuples(rng, 12, 8, 90)
    pair = Pair(tuples)
    reqs = random_requests(rng, 12, 8)
    pair.check(reqs)
    # leaf edge, then an interior edge between existing interior nodes:
    # both packages' write overlays absorb them without any rebuild
    interior = pair.teng._state.ig
    keys = [pair.teng._state.snap.vocab.key(int(i)) for i in interior.interior_ids]
    (a_ns, a_obj, a_rel), (b_ns, b_obj, b_rel) = keys[0], keys[1]
    pair.write("n:o1#r1@newuser")
    pair.check(reqs + ["n:o1#r1@newuser"])
    full = pair.teng.n_full_builds
    pair.write(f"{a_ns}:{a_obj}#{a_rel}@({b_ns}:{b_obj}#{b_rel})")
    pair.check(reqs)
    assert pair.teng.n_full_builds == full == pair.jeng.n_full_builds
    assert pair.teng.n_incremental_builds == pair.jeng.n_incremental_builds == 0
    pair.assert_same_residency()
    # random writes and deletes
    for step in range(2):
        new = random_tuples(rng, 12, 8, 6)
        pair.write(*new)
        pair.check(random_requests(rng, 12, 8, k=32))
        pair.delete(new[0], tuples[step])
        pair.check(reqs)


def test_check_ids_matches_batch_check():
    rng = np.random.default_rng(11)
    for limit in (16384, 2):
        pair = Pair(random_tuples(rng, 12, 8, 100), interior_limit=limit)
        reqs = [TTuple.from_string(s) for s in random_requests(rng, 12, 8)]
        snap = pair.teng.snapshots.snapshot()
        start = np.array(
            [snap.node_for_set(r.namespace, r.object, r.relation) for r in reqs]
        )
        target = np.array([snap.node_for_subject(r.subject) for r in reqs])
        is_id = np.array([isinstance(r.subject, SubjectID) for r in reqs])
        got = pair.teng.check_ids(start, target, is_id)
        assert got.tolist() == pair.teng.batch_check(reqs)
        assert got.tolist() == pair.oracle.batch_check(reqs)


def test_state_loads_from_the_jax_package():
    """A JAX snapshot's vocab keys and COO arrays, and its D, load into the
    port and give the same node ids and the same answers."""
    rng = np.random.default_rng(31)
    pair = Pair(random_tuples(rng, 14, 9, 120))
    reqs = random_requests(rng, 14, 9)
    pair.check(reqs)
    jsnap = pair.jeng._state.snap
    vocab = NodeVocab.from_keys(jsnap.vocab._key_of)
    tsnap = SnapshotBuilder(vocab=vocab).build_from_ids(
        jsnap.src[: jsnap.num_edges], jsnap.dst[: jsnap.num_edges], jsnap.version
    )
    assert np.array_equal(tsnap.src, jsnap.src)
    assert tsnap.padded_nodes == jsnap.padded_nodes
    ti, ji = t_build_interior(tsnap), j_build_interior(jsnap)
    assert np.array_equal(ti.edge_table, ji.edge_table)
    assert np.array_equal(ti.interior_ids, ji.interior_ids)
    # the port's own store interned the same ids in the same order
    assert pair.teng._state.snap.vocab.keys() == jsnap.vocab._key_of
    loaded = TClosure.from_closure(
        TManager(pair.tstore), np.asarray(pair.jeng._state.d), device="cpu"
    )
    assert loaded.batch_check([TTuple.from_string(s) for s in reqs]) == (
        pair.teng.batch_check([TTuple.from_string(s) for s in reqs])
    )
    assert loaded.n_full_builds == 0
    with pytest.raises(ValueError):
        TClosure.from_closure(
            TManager(pair.tstore), np.zeros((3, 3), np.uint8), device="cpu"
        )


def test_columnar_store_matches_memory_store():
    rng = np.random.default_rng(41)
    tuples = random_tuples(rng, 12, 8, 100)
    pair = Pair(tuples)
    col = ColumnarTupleStore()
    parsed = [TTuple.from_string(s) for s in tuples]
    col.bulk_load_edges(
        [(t.namespace, t.object, t.relation) for t in parsed],
        [(t.subject.id,) if isinstance(t.subject, SubjectID)
         else (t.subject.namespace, t.subject.object, t.subject.relation)
         for t in parsed],
    )
    eng = TClosure(TManager(col), device="cpu")
    reqs = [TTuple.from_string(s) for s in random_requests(rng, 12, 8)]
    assert eng.batch_check(reqs) == pair.teng.batch_check(reqs)
    assert eng.batch_check(reqs) == TCheck(col).batch_check(reqs)
    col.write_relation_tuples(TTuple.from_string("n:o2#r0@late"))
    assert eng.batch_check([TTuple.from_string("n:o2#r0@late")]) == [True]


def test_cat_videos_example():
    store = InMemoryTupleStore()
    for path in sorted((REPO / "contrib/cat-videos-example/relation-tuples").glob("*.json")):
        doc = json.loads(path.read_text())
        doc.pop("$schema", None)
        store.write_relation_tuples(TTuple.from_dict(doc))
    eng = TClosure(TManager(store), device="cpu")
    expect = {
        "videos:/cats#owner@cat lady": True,
        "videos:/cats/1.mp4#owner@cat lady": True,
        "videos:/cats/1.mp4#view@cat lady": True,
        "videos:/cats/1.mp4#view@*": True,
        "videos:/cats/2.mp4#view@*": False,
    }
    reqs = [TTuple.from_string(s) for s in expect]
    assert eng.batch_check(reqs) == list(expect.values())


def test_bounded_freshness_is_a_later_slice():
    """Bounded freshness, once a later slice, is accepted now; `auto` above
    strong_freshness_edges serves instead of raising, and an unknown policy
    still raises."""
    TClosure(TManager(InMemoryTupleStore()), freshness="bounded", device="cpu")
    with pytest.raises(ValueError, match="unknown freshness"):
        TClosure(TManager(InMemoryTupleStore()), freshness="eventual", device="cpu")
    pair = Pair(["n:a#r@(n:b#r)", "n:b#r@x"], strong_freshness_edges=1)
    pair.teng.freshness = pair.jeng.freshness = "auto"
    pair.check(["n:a#r@x"])  # first build
    pair.write("n:a#r@y")
    assert pair.check(["n:a#r@y"]) == [True]  # absorbed by the overlay
    assert pair.teng.served_version() == pair.tstore.version


@pytest.mark.parametrize("store_cls", [InMemoryTupleStore, ColumnarTupleStore])
def test_store_contract(store_cls):
    from keto_tpu_torch.namespace import MemoryNamespaceManager
    from keto_tpu_torch.relationtuple import RelationQuery
    from keto_tpu_torch.utils.errors import (
        ErrMalformedPageToken,
        ErrNamespaceNotFound,
    )
    from keto_tpu_torch.utils.pagination import PaginationOptions

    store = store_cls(namespace_manager=MemoryNamespaceManager("n"))
    with pytest.raises(ErrNamespaceNotFound):
        store.write_relation_tuples(TTuple.from_string("other:o#r@u"))
    tuples = [TTuple.from_string(f"n:big#r@u{i}") for i in range(250)]
    store.write_relation_tuples(*tuples)
    store.write_relation_tuples(tuples[0])  # duplicate: idempotent
    assert len(store) == 250
    query = RelationQuery(namespace="n", object="big", relation="r")
    seen, token = [], ""
    while True:
        page, token = store.get_relation_tuples(query, PaginationOptions(token=token))
        seen += page
        if not token:
            break
    assert seen == tuples
    with pytest.raises(ErrMalformedPageToken):
        store.get_relation_tuples(query, PaginationOptions(token="%%%"))
    # the oracle pages through all 250 subjects
    assert TCheck(store).subject_is_allowed(TTuple.from_string("n:big#r@u249"))
