"""keto_tpu_torch's write overlay vs keto_tpu's, on the CPU.

The scenarios of ``tests/test_overlay.py``, each run as the same store
operations against one store of each package, with a closure engine per
package (the JAX engine in device query mode, so its overlay patches a
device-resident ``D`` as the port's does). After every step the two
engines must agree on the answers (and with the host oracle), on
``served_version`` and ``answering_version``, on the build counts, on the
overlay's state (``broken``, ``broken_reason``, version and event counts)
and on ``D`` byte for byte. Tolerance: exact — answers are booleans and D
is uint8. The store delta feeds of both packages are compared too.
"""

import time

import numpy as np
import pytest
import torch

from keto_tpu.engine.closure import ClosureCheckEngine as JClosure
from keto_tpu.graph import SnapshotManager as JManager
from keto_tpu.relationtuple import RelationTuple as JTuple
from keto_tpu.store import ColumnarTupleStore as JColumnar
from keto_tpu.store import InMemoryTupleStore as JStore
from keto_tpu_torch.engine import CheckEngine as TCheck
from keto_tpu_torch.engine import ClosureCheckEngine as TClosure
from keto_tpu_torch.graph import SnapshotManager as TManager
from keto_tpu_torch.relationtuple import RelationTuple as TTuple
from keto_tpu_torch.store import ColumnarTupleStore as TColumnar
from keto_tpu_torch.store import InMemoryTupleStore as TStore

from test_torch_closure_engine import random_requests, random_tuples

torch.set_num_threads(1)

OVERLAY_STATE = (
    "broken", "broken_reason", "version", "n_events", "n_interior_edges",
    "n_interior_deletes",
)


def settle(eng, store, timeout_s=30.0):
    """Let a bounded engine's background rebuild land (a no-op when the
    overlay absorbs the writes or the policy is strong), then wait for its
    rebuild thread to leave, so the next write cannot start a second
    rebuild in one package and not the other."""
    eng.wait_for_version(store.version, timeout_s=timeout_s)
    deadline = time.monotonic() + timeout_s
    while eng._rebuilding:
        assert time.monotonic() < deadline, "rebuild thread never finished"
        time.sleep(0.005)


class Pair:
    """One store per package, the same operations on both, an engine each."""

    def __init__(self, tuples=(), freshness="bounded", max_depth=5, store="memory"):
        self.jstore = JStore() if store == "memory" else JColumnar()
        self.tstore = TStore() if store == "memory" else TColumnar()
        self.write(*tuples)
        self.jeng = JClosure(
            JManager(self.jstore), max_depth=max_depth, query_mode="device",
            freshness=freshness, rebuild_debounce_s=0.0,
        )
        self.teng = TClosure(
            TManager(self.tstore), max_depth=max_depth, freshness=freshness,
            rebuild_debounce_s=0.0, device="cpu",
        )

    def write(self, *strings):
        if strings:
            self.jstore.write_relation_tuples(*(JTuple.from_string(s) for s in strings))
            self.tstore.write_relation_tuples(*(TTuple.from_string(s) for s in strings))

    def delete(self, *strings):
        self.jstore.delete_relation_tuples(*(JTuple.from_string(s) for s in strings))
        self.tstore.delete_relation_tuples(*(TTuple.from_string(s) for s in strings))

    def transact(self, insert, delete):
        self.jstore.transact_relation_tuples(
            [JTuple.from_string(s) for s in insert],
            [JTuple.from_string(s) for s in delete],
        )
        self.tstore.transact_relation_tuples(
            [TTuple.from_string(s) for s in insert],
            [TTuple.from_string(s) for s in delete],
        )

    def apply(self, step):
        op, *args = step
        getattr(self, op)(*args)

    def builds(self, eng):
        return eng.n_full_builds, eng.n_incremental_builds

    def check(self, reqs, depths=(0,)):
        """Settle both engines, then require the same answers from both and
        from the oracle, and the same versions, build counts, overlay state
        and D. Returns the port's answers at the first depth."""
        settle(self.jeng, self.jstore)
        settle(self.teng, self.tstore)
        oracle = TCheck(self.tstore, max_depth=self.teng.global_max_depth)
        first = None
        for d in depths:
            got = self.teng.batch_check([TTuple.from_string(s) for s in reqs], d)
            want = self.jeng.batch_check([JTuple.from_string(s) for s in reqs], d)
            assert got == want
            assert got == oracle.batch_check([TTuple.from_string(s) for s in reqs], d)
            first = got if first is None else first
        assert self.teng.served_version() == self.jeng.served_version()
        assert self.teng.answering_version() == self.jeng.answering_version()
        assert self.builds(self.teng) == self.builds(self.jeng)
        tov, jov = self.teng._overlay, self.jeng._overlay
        assert (tov is None) == (jov is None)
        if tov is not None:
            for name in OVERLAY_STATE:
                assert getattr(tov, name) == getattr(jov, name), name
        self.assert_same_d()
        return first

    def assert_same_d(self):
        tstate, jstate = self.teng._state, self.jeng._state
        if hasattr(jstate, "d"):
            assert np.array_equal(tstate.d.cpu().numpy(), np.asarray(jstate.d))
        else:
            assert not hasattr(tstate, "d")


# name -> (base tuples, steps, requests, depths, no_rebuild). Each step is
# ("write", *tuples), ("delete", *tuples) or ("transact", inserts, deletes).
SCENARIOS = {
    "delete_then_reinsert": (
        ["n:doc#view@(n:g#m)", "n:g#m@alice"],
        [("delete", "n:g#m@alice"), ("write", "n:g#m@alice")],
        ["n:doc#view@alice", "n:g#m@alice"], (0,), True,
    ),
    "new_user_and_object_after_snapshot": (
        ["n:doc#view@(n:g#m)"],
        [("write", "n:g#m@zoe"), ("write", "n:newdoc#view@zoe")],
        ["n:doc#view@zoe", "n:newdoc#view@zoe"], (0,), True,
    ),
    "direct_delete_with_surviving_path": (
        ["n:doc#view@alice", "n:doc#view@(n:g#m)", "n:g#m@alice"],
        [("delete", "n:doc#view@alice"), ("delete", "n:g#m@alice")],
        ["n:doc#view@alice"], (0, 1, 2), True,
    ),
    "interior_insert": (
        ["n:doc#view@(n:g1#m)", "n:g2#m@alice", "n:g2#m@(n:g3#m)", "n:g3#m@bob"],
        [("write", "n:g1#m@(n:g2#m)")],
        ["n:doc#view@alice", "n:doc#view@bob"], (0, 3, 4), True,
    ),
    "growth_into_padding": (
        ["n:g0#m@(n:g1#m)", "n:g1#m@u0"],
        [("write", "n:g1#m@(n:h1#x)"), ("write", "n:h1#x@(n:h2#x)"),
         ("write", "n:h2#x@carol")],
        ["n:g0#m@carol", "n:g0#m@(n:h2#x)", "n:h1#x@carol"], (0,), True,
    ),
    "interior_delete": (
        ["n:doc#view@(n:g1#m)", "n:g1#m@(n:g2#m)", "n:g2#m@alice"],
        [("delete", "n:g1#m@(n:g2#m)")],
        ["n:doc#view@alice"], (0,), True,
    ),
    "interior_delete_keeps_longer_path": (
        ["n:doc#view@(n:g1#m)", "n:g1#m@(n:g3#m)", "n:g1#m@(n:g2#m)",
         "n:g2#m@(n:g3#m)", "n:g3#m@alice"],
        [("delete", "n:g1#m@(n:g3#m)")],
        ["n:doc#view@alice"], (0, 3, 4), True,
    ),
    "interior_delete_of_overlay_insert": (
        ["n:doc#view@(n:g1#m)", "n:g1#m@x", "n:g2#m@alice", "n:top#m@(n:g2#m)"],
        [("write", "n:g1#m@(n:g2#m)"), ("delete", "n:g1#m@(n:g2#m)"),
         ("write", "n:g1#m@(n:g2#m)")],
        ["n:doc#view@alice"], (0,), True,
    ),
    "chain_from_empty_store": (
        [],
        [("write", "videos:/cats#owner@(cat lady)"),
         ("write", "videos:/cats/1.mp4#owner@(videos:/cats#owner)"),
         ("write", "videos:/cats/1.mp4#view@(videos:/cats/1.mp4#owner)")],
        ["videos:/cats#owner@(cat lady)", "videos:/cats/1.mp4#owner@(cat lady)",
         "videos:/cats/1.mp4#view@(cat lady)", "videos:/cats/1.mp4#view@(dog guy)"],
        (0,), True,
    ),
    "transact_insert_and_delete_same_set_tuple": (
        ["n:g#m@alice"],
        [("transact", ["n:doc#view@(n:g#m)"], ["n:doc#view@(n:g#m)"])],
        ["n:doc#view@alice", "n:g#m@alice"], (0,), False,
    ),
    "promotion_skips_deleted_base_edges": (
        ["n:g#m@alice"],
        [("delete", "n:g#m@alice"), ("write", "n:doc#view@(n:g#m)")],
        ["n:doc#view@alice", "n:g#m@alice"], (0,), True,
    ),
}


@pytest.mark.parametrize("freshness", ["bounded", "strong"])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenarios(name, freshness):
    tuples, steps, reqs, depths, no_rebuild = SCENARIOS[name]
    pair = Pair(tuples, freshness=freshness)
    pair.check(reqs, depths)
    builds0 = pair.builds(pair.teng)
    for step in steps:
        pair.apply(step)
        pair.check(reqs, depths)
        assert pair.teng.served_version() == pair.tstore.version
    if no_rebuild:
        assert pair.builds(pair.teng) == builds0 == (1, 0)


def test_scenario_answers_match_the_reference_expectations():
    """The answers test_overlay.py spells out, through the port."""
    pair = Pair(SCENARIOS["interior_insert"][0])
    pair.write("n:g1#m@(n:g2#m)")
    assert pair.check(["n:doc#view@alice"]) == [True]
    assert pair.check(["n:doc#view@bob"], (4,)) == [True]
    assert pair.check(["n:doc#view@bob"], (3,)) == [False]
    pair = Pair(SCENARIOS["interior_delete_keeps_longer_path"][0])
    pair.delete("n:g1#m@(n:g3#m)")
    assert pair.check(["n:doc#view@alice"], (3, 4)) == [False]
    assert pair.check(["n:doc#view@alice"], (4,)) == [True]


@pytest.mark.parametrize("seed", range(4))
def test_random_leaf_mutations(seed):
    rng = np.random.default_rng(seed)
    tuples = random_tuples(rng, n_objects=12, n_users=9, n_edges=110)
    pair = Pair(tuples)
    reqs = random_requests(rng, 12, 9, k=96)
    pair.check(reqs)
    for step in range(6):
        live = [str(t) for t in pair.tstore.all_tuples()]
        victims = [live[i] for i in rng.integers(len(live), size=3)]
        victims = [v for v in victims if "#" not in v.split("@", 1)[1]]
        if victims:
            pair.delete(*victims)
        pair.write(
            f"n:o{rng.integers(12)}#r{rng.integers(3)}@u{rng.integers(9)}",
            f"n:o{rng.integers(12)}#r{rng.integers(3)}@newuser{step}",
        )
        pair.check(reqs, depths=(0, 2))
        assert pair.teng.served_version() == pair.tstore.version
    assert pair.builds(pair.teng) == (1, 0)


@pytest.mark.parametrize(
    "budget,value,ops,reason",
    [
        ("max_delete_rows", 0, [("delete", "n:g1#m@(n:g2#m)")],
         "interior delete too wide"),
        ("max_events", 4, [("write", f"n:g2#m@x{i}") for i in range(6)],
         "event budget"),
        ("max_interior_edges", 1,
         [("write", "n:g2#m@(n:g1#m)"), ("write", "n:g1#m@(n:g1#m)")],
         "interior edge budget"),
    ],
)
@pytest.mark.parametrize("freshness", ["bounded", "strong"])
def test_budget_breaks_then_rebuild(budget, value, ops, reason, freshness):
    """A delta past a budget breaks the overlay with the same reason in
    both packages; the rebuild path then answers exactly."""
    pair = Pair(
        ["n:doc#view@(n:g1#m)", "n:g1#m@(n:g2#m)", "n:g2#m@alice"],
        freshness=freshness,
    )
    reqs = ["n:doc#view@alice", "n:g1#m@alice", "n:doc#view@x5"]
    pair.check(reqs)
    for eng in (pair.teng, pair.jeng):
        setattr(eng._overlay, budget, value)
    t_ov, j_ov = pair.teng._overlay, pair.jeng._overlay
    for op in ops:
        pair.apply(op)
    # drained without serving: both overlays break on the same delta
    pair.teng.served_version()
    pair.jeng.served_version()
    assert t_ov.broken and t_ov.broken_reason == reason
    assert (t_ov.broken_reason, t_ov.version) == (j_ov.broken_reason, j_ov.version)
    pair.check(reqs)  # the rebuild lands, exact at the live version
    assert pair.teng.served_version() == pair.tstore.version
    assert sum(pair.builds(pair.teng)) == 2


def test_wait_for_version_satisfied_by_overlay():
    pair = Pair(["n:doc#view@(n:g#m)"])
    pair.check(["n:doc#view@alice"])
    pair.write("n:g#m@alice")
    pair.teng.wait_for_version(pair.tstore.version, timeout_s=0.5)
    assert pair.teng._rebuilding is False
    assert pair.check(["n:doc#view@alice"]) == [True]


@pytest.mark.parametrize("freshness", ["bounded", "strong"])
def test_mixed_random_mutations(freshness):
    rng = np.random.default_rng(42)
    tuples = random_tuples(rng, n_objects=10, n_users=8, n_edges=90)
    pair = Pair(tuples, freshness=freshness)
    reqs = random_requests(rng, 10, 8, k=80)
    pair.check(reqs)
    for step in range(8):
        roll = rng.random()
        if roll < 0.4:
            live = [str(t) for t in pair.tstore.all_tuples()]
            pair.delete(*(live[i] for i in rng.integers(len(live), size=2)))
        elif roll < 0.8:
            pair.write(*random_tuples(rng, 10, 8, 3))
        else:
            pair.write(f"n:o{rng.integers(10)}#r0@(n:o{rng.integers(10)}#r1)")
        pair.check(reqs)
        assert pair.teng.served_version() == pair.tstore.version


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_interior_churn(seed):
    """Interleaved interior inserts and deletes: exact after every step,
    with zero rebuilds, in both packages."""
    rng = np.random.default_rng(seed)
    n_groups = 12
    base = []
    for g in range(n_groups):
        base.append(f"n:g{g}#m@u{g % 5}")
        base.append(f"n:doc{g % 4}#view@(n:g{g}#m)")
    for _ in range(8):
        a, b = rng.integers(n_groups, size=2)
        base.append(f"n:g{a}#m@(n:g{b}#m)")
    pair = Pair(list(dict.fromkeys(base)))
    reqs = [f"n:doc{d}#view@u{u}" for d in range(4) for u in range(5)] + [
        f"n:g{a}#m@u{u}" for a in range(0, n_groups, 3) for u in range(5)
    ]
    pair.check(reqs, depths=(0, 2, 3))
    for step in range(60):
        a, b = (int(x) for x in rng.integers(n_groups, size=2))
        edge = f"n:g{a}#m@(n:g{b}#m)"
        if rng.random() < 0.5:
            pair.write(edge)
        else:
            pair.delete(edge)
        if step % 5 == 0:
            pair.check(reqs, depths=(0, 3))
    pair.check(reqs, depths=(0, 2, 3, 5))
    assert pair.builds(pair.teng) == (1, 0)
    assert pair.teng.served_version() == pair.tstore.version


class Recorder:
    def __init__(self):
        self.deltas = []

    def __call__(self, version, inserted, deleted):
        self.deltas.append((
            version,
            None if inserted is None else [str(t) for t in inserted],
            None if deleted is None else [str(t) for t in deleted],
        ))


@pytest.mark.parametrize("kind", ["memory", "columnar"])
def test_store_delta_feeds_match(kind):
    """Every mutation delivers the same (version, inserted, deleted) in
    both packages, and a bulk load delivers (version, None, None)."""
    from keto_tpu.relationtuple import RelationQuery as JQuery
    from keto_tpu_torch.relationtuple import RelationQuery as TQuery

    pair = Pair(freshness="strong", store=kind)
    rec_j, rec_t = Recorder(), Recorder()
    pair.jstore.subscribe_deltas(rec_j)
    pair.tstore.subscribe_deltas(rec_t)
    pair.write("n:a#r@u1", "n:a#r@(n:b#r)", "n:a#r@u1")
    pair.write("n:a#r@u1")  # duplicate: a version-only delta
    pair.delete("n:a#r@u1", "n:a#r@nobody")
    pair.transact(["n:c#r@u2", "n:c#r@u3"], ["n:a#r@(n:b#r)"])
    pair.jstore.delete_all_relation_tuples(JQuery(namespace="n", object="c"))
    pair.tstore.delete_all_relation_tuples(TQuery(namespace="n", object="c"))
    if kind == "columnar":
        keys = ([("n", "d", "r")], [("u9",)])
        pair.jstore.bulk_load_edges(*keys)
        pair.tstore.bulk_load_edges(*keys)
    assert rec_t.deltas == rec_j.deltas
    assert len(rec_t.deltas) == (6 if kind == "columnar" else 5)


def test_bulk_load_breaks_the_overlay_then_rebuilds():
    """A bulk load carries no per-tuple delta: both overlays break on it
    the same way, and the engines rebuild to the live version."""
    pair = Pair(["n:doc#view@(n:g#m)", "n:g#m@alice"], store="columnar")
    reqs = ["n:doc#view@alice", "n:doc#view@bob"]
    assert pair.check(reqs) == [True, False]
    t_ov, j_ov = pair.teng._overlay, pair.jeng._overlay
    keys = ([("n", "g", "m")], [("bob",)])
    pair.jstore.bulk_load_edges(*keys)
    pair.tstore.bulk_load_edges(*keys)
    assert pair.teng.answering_version() == pair.jeng.answering_version()
    assert t_ov.broken and t_ov.broken_reason == j_ov.broken_reason
    assert pair.check(reqs) == [True, True]
    assert pair.builds(pair.teng) in ((2, 0), (1, 1))


def test_promotion_reads_the_derived_csr_and_the_coo_scan_alike():
    """A set node gaining its first in-edge is promoted to interior, and
    the overlay reads its base successors: from ``snap.out_neighbors`` once
    an Expand has derived the snapshot's CSR, by a masked scan of the COO
    arrays before that (never forcing the sort inside the drain). Both
    engines end with the same D and the oracle's answers, with no
    rebuild."""
    from keto_tpu_torch.engine.device import SnapshotExpandEngine
    from keto_tpu_torch.relationtuple import SubjectSet

    tuples = ["n:top#r@(n:mid#m)", "n:mid#m@(n:leaf#m)", "n:leaf#m@alice",
              "n:s#m@bob", "n:s#m@(n:leaf#m)", "n:s#m@(n:mid#m)", "n:s#m@carol"]
    reqs = ["n:top#r@bob", "n:top#r@carol", "n:top#r@alice", "n:top#r@(n:s#m)",
            "n:s#m@alice", "n:top#r@dave"]
    engines, calls = [], []
    for expand_first in (True, False):
        store = TStore()
        store.write_relation_tuples(*(TTuple.from_string(s) for s in tuples))
        mgr = TManager(store)
        eng = TClosure(mgr, freshness="strong", device="cpu")
        eng.batch_check([TTuple.from_string(reqs[0])])
        snap = eng._state.snap
        if expand_first:
            SnapshotExpandEngine(mgr).build_tree(SubjectSet("n", "top", "r"))
        assert (snap._csr is not None) is expand_first
        seen = []
        base = snap.out_neighbors
        snap.out_neighbors = lambda nid, _base=base, _seen=seen: (
            _seen.append(nid), _base(nid))[1]
        store.write_relation_tuples(TTuple.from_string("n:top#r@(n:s#m)"))
        got = eng.batch_check([TTuple.from_string(r) for r in reqs])
        assert got == TCheck(store).batch_check([TTuple.from_string(r) for r in reqs])
        assert got[:2] == [True, True]
        assert eng.n_full_builds == 1 and not eng._overlay.broken
        engines.append(eng)
        calls.append(seen)
    s_id = engines[0]._state.snap.vocab.lookup(("n", "s", "m"))
    assert calls[0] and set(calls[0]) == {s_id}  # the CSR, once derived
    assert calls[1] == []  # the COO scan before that
    assert torch.equal(engines[0]._state.d, engines[1]._state.d)
