"""keto_tpu_torch's host query mode against keto_tpu's, on the CPU.

The same RBAC-shaped tuples, made from a numpy seed and written in the
same order into a columnar store of each package, are served by
``ClosureCheckEngine(query_mode="host")`` in both (the port with
``device="cpu"``). After the first build, a leaf and an interior insert
through the write overlay, the per-edge host relax that folds them into D
with the D^T carry, a role -> role delete absorbed by the overlay and
folded by the dirty-row rebuild (``_semiring_incremental``), the answers,
``n_full_builds``/``n_incremental_builds``, the host ``D`` and the host
``D^T`` must be equal in both packages, and D must equal a fresh host build
of the live snapshot. List pages, ``device_view()`` answers, an engine
that may not build (``allow_device_builds=False``, the exact fallback) and
the ``matmul`` builder in host mode are held against keto_tpu too.
Tolerance: none, answers are booleans and D is uint8.
"""

import numpy as np
import pytest
import torch

from keto_tpu.engine.closure import ClosureCheckEngine as JClosure
from keto_tpu.engine.listing import ListEngine as JListEngine
from keto_tpu.graph import SnapshotManager as JManager
from keto_tpu.relationtuple import RelationTuple as JTuple
from keto_tpu.relationtuple import SubjectID as JID
from keto_tpu.store.columnar import ColumnarTupleStore as JColumnar
from keto_tpu_torch.engine import CheckEngine, ClosureCheckEngine
from keto_tpu_torch.engine.listing import ListEngine
from keto_tpu_torch.engine.semiring import build_closure_bitset
from keto_tpu_torch.graph import SnapshotManager
from keto_tpu_torch.graph.interior import build_interior
from keto_tpu_torch.relationtuple import RelationTuple, SubjectID
from keto_tpu_torch.store import ColumnarTupleStore

torch.set_num_threads(1)

DEPTH = 5


def rbac_tuples(rng, n_users=40, n_groups=10, n_roles=6, n_res=30):
    """users in groups, groups in roles, a role hierarchy and grants of
    resources to roles or groups, as tuple strings in a fixed order."""
    out = {}
    for _ in range(80):
        out[f"rbac:g{rng.integers(n_groups)}#member@u{rng.integers(n_users)}"] = None
    for _ in range(14):
        out[f"rbac:role{rng.integers(n_roles)}#member@(rbac:g{rng.integers(n_groups)}#member)"] = None
    for _ in range(6):
        a, b = rng.integers(n_roles, size=2)
        if a != b:
            out[f"rbac:role{a}#member@(rbac:role{b}#member)"] = None
    for _ in range(60):
        to = f"role{rng.integers(n_roles)}" if rng.random() < 0.5 else f"g{rng.integers(n_groups)}"
        out[f"rbac:res{rng.integers(n_res)}#view@(rbac:{to}#member)"] = None
    return list(out)


class HostPair:
    """One tuple graph in both packages, a host-mode closure engine and a
    list engine each."""

    def __init__(self, tuples, **kw):
        self.jstore = JColumnar()
        self.tstore = ColumnarTupleStore()
        self.write(*tuples)
        self.jeng = JClosure(
            JManager(self.jstore), max_depth=DEPTH, query_mode="host",
            freshness="strong", rebuild_debounce_s=0.0, **kw,
        )
        self.teng = ClosureCheckEngine(
            SnapshotManager(self.tstore), max_depth=DEPTH, query_mode="host",
            freshness="strong", rebuild_debounce_s=0.0, device="cpu", **kw,
        )
        self.jlist = JListEngine(self.jeng)
        self.tlist = ListEngine(self.teng)
        self.oracle = CheckEngine(self.tstore, max_depth=DEPTH)

    def write(self, *strings):
        self.jstore.write_relation_tuples(*(JTuple.from_string(s) for s in strings))
        self.tstore.write_relation_tuples(*(RelationTuple.from_string(s) for s in strings))

    def delete(self, *strings):
        self.jstore.delete_relation_tuples(*(JTuple.from_string(s) for s in strings))
        self.tstore.delete_relation_tuples(*(RelationTuple.from_string(s) for s in strings))

    def check(self, requests):
        got = self.teng.batch_check([RelationTuple.from_string(s) for s in requests])
        want = self.jeng.batch_check([JTuple.from_string(s) for s in requests])
        assert got == want
        assert got == self.oracle.batch_check(
            [RelationTuple.from_string(s) for s in requests]
        )
        return got

    def assert_residency_equal(self):
        tstate, jstate = self.teng._state, self.jeng._state
        assert tstate.d is None and jstate.d is None  # nothing on a device
        assert isinstance(tstate.d_host, np.ndarray) and tstate.d_host.flags.writeable
        np.testing.assert_array_equal(tstate.d_host, jstate.d_host)
        assert (tstate.d_rev is None) == (jstate.d_rev is None)
        if tstate.d_rev is not None:
            assert isinstance(tstate.d_rev, np.ndarray)
            np.testing.assert_array_equal(tstate.d_rev, jstate.d_rev)
            np.testing.assert_array_equal(tstate.d_rev, tstate.d_host.T)
        assert (self.teng.n_full_builds, self.teng.n_incremental_builds) == (
            self.jeng.n_full_builds, self.jeng.n_incremental_builds,
        )

    def lists(self, users, resources):
        for u in users:
            got = self.tlist.list_objects(SubjectID(u), "view", "rbac", max_depth=DEPTH)
            want = self.jlist.list_objects(JID(u), "view", "rbac", max_depth=DEPTH)
            assert (got.items, got.version, got.source) == (
                want.items, want.version, want.source
            )
        for r in resources:
            got = self.tlist.list_subjects("rbac", r, "view", max_depth=DEPTH)
            want = self.jlist.list_subjects("rbac", r, "view", max_depth=DEPTH)
            assert (got.items, got.version, got.source) == (
                want.items, want.version, want.source
            )

    def fresh_host_build(self) -> np.ndarray:
        """D of a full host build of the live snapshot."""
        ig = build_interior(self.teng.snapshots.snapshot())
        m_pad = self.teng._state.m_pad
        return build_closure_bitset(ig.ii_src, ig.ii_dst, ig.m, m_pad, DEPTH - 1)


def sample(rng, k=160, n_users=44, n_res=32):
    return [f"rbac:res{rng.integers(n_res)}#view@u{rng.integers(n_users)}" for _ in range(k)]


def role_edges(pair):
    return [
        t for t in (str(x) for x in pair.tstore.all_tuples())
        if t.startswith("rbac:role") and "@rbac:role" in t
    ]


@pytest.mark.parametrize("seed", range(3))
def test_writes_rebuilds_and_lists_match_keto_tpu(seed):
    rng = np.random.default_rng(700 + seed)
    pair = HostPair(rbac_tuples(rng))
    reqs = sample(rng)
    users = [f"u{i}" for i in range(0, 40, 7)]
    resources = [f"res{i}" for i in range(0, 30, 6)]
    assert pair.teng.host_queries() and pair.jeng.host_queries()
    pair.check(reqs)
    assert pair.teng.n_full_builds == 1
    assert set(pair.teng.last_build_phases) >= {"interior", "blocks", "kernel", "total"}
    pair.assert_residency_equal()
    pair.lists(users, resources)  # builds the host D^T
    pair.assert_residency_equal()

    # a leaf and an interior insert, absorbed by the overlay: D patched in
    # place and the patch mirrored onto D^T, no rebuild
    pair.write("rbac:g0#member@u-new", "rbac:role0#member@(rbac:role5#member)")
    pair.check(reqs + ["rbac:res1#view@u-new"])
    assert pair.teng._overlay.n_events == 2
    pair.assert_residency_equal()
    # the next list folds the overlay into D: an append of at most 8
    # interior edges takes the per-edge host relax, D^T carried
    pair.lists(users, resources)
    assert pair.teng.n_incremental_builds == 1 and pair.teng.n_full_builds == 1
    pair.assert_residency_equal()
    np.testing.assert_array_equal(pair.teng._state.d_host, pair.fresh_host_build())

    # a role -> role delete: the overlay re-closes D, then the list's
    # rebuild takes the dirty-row path with the D^T carry
    pair.delete(role_edges(pair)[0])
    pair.check(reqs)
    pair.assert_residency_equal()
    pair.lists(users, resources)
    assert pair.teng.n_incremental_builds == 2 and pair.teng.n_full_builds == 1
    assert pair.teng.last_dirty_rows >= 1
    assert "reverse_incremental" in pair.teng.last_build_phases
    pair.assert_residency_equal()
    np.testing.assert_array_equal(pair.teng._state.d_host, pair.fresh_host_build())
    pair.check(reqs)


def test_a_delete_burst_without_a_list_folds_through_compaction():
    rng = np.random.default_rng(720)
    pair = HostPair(rbac_tuples(rng))
    reqs = sample(rng)
    pair.check(reqs)
    for t in role_edges(pair)[:2]:
        pair.delete(t)
    pair.check(reqs)
    pair.teng._build_sync()
    pair.jeng._build_sync()
    pair.assert_residency_equal()
    np.testing.assert_array_equal(pair.teng._state.d_host, pair.fresh_host_build())
    pair.check(reqs)


def test_device_view_answers_equal():
    rng = np.random.default_rng(730)
    pair = HostPair(rbac_tuples(rng))
    reqs = sample(rng)
    want = pair.check(reqs)
    tview = pair.teng.device_view()
    jview = pair.jeng.device_view()
    assert not tview.host_queries() and tview._state.d_host is None
    assert torch.equal(tview._state.d, torch.from_numpy(pair.teng._state.d_host))
    treqs = [RelationTuple.from_string(s) for s in reqs]
    assert tview.batch_check(treqs) == want
    assert jview.batch_check([JTuple.from_string(s) for s in reqs]) == want
    np.testing.assert_array_equal(tview._state.d.numpy(), np.asarray(jview._state.d))
    # the port's view holds a copy of D: the overlay's in-place host patch
    # does not reach it (keto_tpu's jnp.asarray may alias the host array on
    # the CPU backend, so its view is not compared after the write)
    before = pair.teng._state.d_host.copy()
    pair.write("rbac:role1#member@(rbac:role4#member)")
    pair.check(reqs)
    assert pair.teng._overlay.n_events == 1
    np.testing.assert_array_equal(tview._state.d.numpy(), before)


def test_an_engine_that_may_not_build_answers_from_the_live_store():
    rng = np.random.default_rng(740)
    tuples = rbac_tuples(rng)
    pair = HostPair(tuples)
    pair.teng.allow_device_builds = False
    pair.jeng.allow_device_builds = False
    reqs = sample(rng)
    pair.check(reqs)
    assert pair.teng.closure() is None and pair.teng.n_full_builds == 0
    pair.write("rbac:g1#member@u-late")
    assert pair.check(["rbac:res0#view@u-late"] + reqs)[1:] == pair.oracle.batch_check(
        [RelationTuple.from_string(s) for s in reqs]
    )


def test_the_matmul_builder_in_host_mode_gives_the_same_d():
    rng = np.random.default_rng(750)
    tuples = rbac_tuples(rng)
    semi = HostPair(tuples)
    mat = HostPair(tuples, builder="matmul")
    reqs = sample(rng)
    assert semi.check(reqs) == mat.check(reqs)
    assert "matmul" in mat.teng.last_build_phases
    np.testing.assert_array_equal(mat.teng._state.d_host, semi.teng._state.d_host)
    mat.assert_residency_equal()
    # a delete in matmul mode takes no dirty-row rebuild: a full build
    mat.delete(role_edges(mat)[0])
    mat.check(reqs)
    mat.teng._build_sync()
    mat.jeng._build_sync()
    assert mat.teng.n_full_builds == 2 and mat.teng.n_incremental_builds == 0
    mat.assert_residency_equal()


def test_placement_and_knob_validation():
    store = ColumnarTupleStore()
    store.write_relation_tuples(RelationTuple.from_string("n:a#r@u"))
    mgr = SnapshotManager(store)
    # on a CPU torch device "auto" resolves to the device path
    assert not ClosureCheckEngine(mgr, device="cpu").host_queries()
    assert ClosureCheckEngine(mgr, device="cpu", query_mode="host").host_queries()
    for kw in ({"query_mode": "nope"}, {"builder": "nope"}):
        with pytest.raises(ValueError):
            ClosureCheckEngine(mgr, device="cpu", **kw)


def test_a_check_racing_a_writes_delivery_waits_for_the_overlay():
    # the store makes a write's version visible under its lock and delivers
    # the delta after releasing it; a check in that window used to rebuild,
    # and a replica that may not build fell to the live store for good
    import threading

    rng = np.random.default_rng(760)
    store = ColumnarTupleStore()
    store.write_relation_tuples(*(RelationTuple.from_string(s) for s in rbac_tuples(rng)))
    entered, gate = threading.Event(), threading.Event()

    def slow_listener(version, inserted, deleted):  # delivered before the engine
        entered.set()
        gate.wait(10)

    store.subscribe_deltas(slow_listener)
    eng = ClosureCheckEngine(
        SnapshotManager(store), max_depth=DEPTH, query_mode="host",
        freshness="strong", device="cpu",
    )
    oracle = CheckEngine(store, max_depth=DEPTH)
    reqs = [RelationTuple.from_string(s) for s in sample(rng)]
    eng.batch_check(reqs)
    state = eng._state
    eng.allow_device_builds = False  # as in a forked replica
    write = RelationTuple.from_string("rbac:g0#member@u-raced")
    writer = threading.Thread(target=store.write_relation_tuples, args=(write,))
    writer.start()
    assert entered.wait(10)
    assert store.version == eng._overlay.version + 1  # visible, not delivered
    releaser = threading.Timer(0.2, gate.set)
    releaser.start()
    probe = RelationTuple.from_string("rbac:res1#view@u-raced")
    got = eng.batch_check(reqs + [probe])
    writer.join(timeout=10)
    releaser.join(timeout=10)
    assert not writer.is_alive()
    assert got == oracle.batch_check(reqs + [probe])
    assert eng._state is state and eng.n_full_builds == 1
    assert eng._overlay.version == store.version and not eng._overlay.broken


def test_a_write_landing_during_a_build_is_rebuilt_not_waited_for():
    # a write committed between _build_sync's snapshot and its overlay swap
    # is handed to the outgoing overlay; the next strong check must rebuild,
    # not wait for a delta that has already been handed over
    import threading

    rng = np.random.default_rng(761)
    store = ColumnarTupleStore()
    store.write_relation_tuples(*(RelationTuple.from_string(s) for s in rbac_tuples(rng)))
    eng = ClosureCheckEngine(
        SnapshotManager(store), max_depth=DEPTH, query_mode="host",
        freshness="strong", device="cpu",
    )
    oracle = CheckEngine(store, max_depth=DEPTH)
    reqs = [RelationTuple.from_string(s) for s in sample(rng)]
    eng.batch_check(reqs)
    store.write_relation_tuples(RelationTuple.from_string("rbac:g1#member@u-first"))
    build_state = eng._build_state
    late = RelationTuple.from_string("rbac:g0#member@u-late")

    def build_then_write(snap, prev=None):
        state = build_state(snap, prev=prev)
        store.write_relation_tuples(late)  # delivered to the outgoing overlay
        return state

    eng._build_state = build_then_write
    eng._build_sync()
    eng._build_state = build_state
    assert store.version == eng._state.version + 1
    builds = eng.n_full_builds + eng.n_incremental_builds
    probe = reqs + [RelationTuple.from_string("rbac:res1#view@u-late")]
    got = []
    checker = threading.Thread(target=lambda: got.append(eng.batch_check(probe)), daemon=True)
    checker.start()
    checker.join(timeout=30)
    assert not checker.is_alive(), "the check spun instead of rebuilding"
    assert got[0] == oracle.batch_check(probe)
    assert eng._state.version == store.version
    assert eng.n_full_builds + eng.n_incremental_builds == builds + 1
