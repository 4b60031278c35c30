"""keto_tpu_torch's DeviceCheckEngine vs keto_tpu's, on the CPU, in the
dense, scatter and packed modes.

The same tuples, in the same insertion order, go into a store of each
package, so both intern the same node ids. The port's engine
(``device="cpu"``: plain versions) and the JAX engine (its packed kernel in
Pallas interpret mode) must give identical answers, and both must equal
the host BFS oracle. Covers the scenarios of tests/test_packed_engine.py
and tests/test_device_engines.py::TestDeviceCheckScenarios. Tolerance:
exact — answers are booleans and distances integers.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from keto_tpu.engine.device import DeviceCheckEngine as JDevice
from keto_tpu.graph import SnapshotManager as JManager
from keto_tpu.relationtuple import RelationTuple as JTuple
from keto_tpu.relationtuple import SubjectSet as JSet
from keto_tpu.store import InMemoryTupleStore as JStore
from keto_tpu_torch.engine import CheckEngine as TCheck
from keto_tpu_torch.engine import DeviceCheckEngine as TDevice
from keto_tpu_torch.graph import SnapshotManager as TManager
from keto_tpu_torch.relationtuple import RelationTuple as TTuple
from keto_tpu_torch.relationtuple import SubjectSet as TSet
from keto_tpu_torch.store import InMemoryTupleStore

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
MODES = ["dense", "scatter", "packed"]


class Pair:
    """One tuple graph held by both packages, with a device engine each."""

    def __init__(self, mode, tuples=(), max_depth=5):
        self.jstore = JStore()
        self.tstore = InMemoryTupleStore()
        self.write(*tuples)
        self.jmgr = JManager(self.jstore)
        self.tmgr = TManager(self.tstore)
        self.jeng = JDevice(self.jmgr, max_depth=max_depth, mode=mode)
        self.teng = TDevice(self.tmgr, max_depth=max_depth, mode=mode, device="cpu")
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

    def check_depths(self, reqs, depths):
        """Every request at every depth, in one batch."""
        got = self.check(
            [r for _ in depths for r in reqs],
            depths=[d for d in depths for _ in reqs],
        )
        return [got[i * len(reqs) : (i + 1) * len(reqs)] for i in range(len(depths))]


SCENARIOS = {
    "direct": (
        ["n:obj#access@alice"],
        ["n:obj#access@alice", "n:obj#access@bob"],
    ),
    "two_levels": (
        ["n:obj#access@(n:org#member)", "n:org#member@(n:team#member)",
         "n:team#member@alice", "n:doc#read@bob"],
        ["n:obj#access@alice", "n:obj#access@(n:team#member)",
         "n:obj#access@mallory", "n:doc#read@bob", "n:obj#access@bob",
         "n:doc#read@alice"],
    ),
    "wrong_object_or_relation": (
        ["n:obj#access@alice"],
        ["n:other#access@alice", "n:obj#write@alice", "other:obj#access@alice"],
    ),
    "cycle": (
        ["n:a#r@(n:b#r)", "n:b#r@(n:a#r)"],
        ["n:a#r@alice", "n:a#r@(n:a#r)", "n:a#r@(n:b#r)"],
    ),
    "start_equals_target": (
        ["n:obj#r@alice", "n:obj#r@(n:grp#m)", "n:grp#m@u"],
        ["n:obj#r@(n:obj#r)", "n:obj#r@(n:grp#m)", "n:grp#m@(n:grp#m)"],
    ),
    "unknown_nodes": (
        ["n:obj#r@alice"],
        ["no:thing#here@nobody", "n:obj#r@nobody", "no:thing#here@alice",
         "n:obj#r@(no:such#set)"],
    ),
    "unknown_everything": ([], ["no:thing#here@nobody"]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
@pytest.mark.parametrize("mode", MODES)
def test_scenarios(mode, name):
    tuples, reqs = SCENARIOS[name]
    pair = Pair(mode, tuples)
    pair.check_depths(reqs, [0, 1, 2, 5])


@pytest.mark.parametrize("mode", MODES)
def test_depth_budget_and_clamp(mode):
    pair = Pair(
        mode,
        ["n:obj#r@(n:s1#m)", "n:s1#m@(n:s2#m)", "n:s2#m@(n:s3#m)",
         "n:s3#m@alice"],
        max_depth=10,
    )
    got = pair.check_depths(["n:obj#r@alice"], [3, 4, 0, 99, -1])
    assert got == [[False], [True], [True], [True], [True]]
    assert pair.check(["n:obj#r@alice"], max_depth=3) == [False]


@pytest.mark.parametrize("mode", MODES)
def test_global_max_depth_precedence(mode):
    pair = Pair(
        mode,
        ["n:obj#r@(n:s1#m)", "n:s1#m@(n:s2#m)", "n:s2#m@alice"],
        max_depth=2,
    )
    # global cap 2 < required 3: denied even when the request asks for more
    assert pair.check(["n:obj#r@alice"], max_depth=50) == [False]


@pytest.mark.parametrize("mode", MODES)
def test_exact_depth_boundary(mode):
    """A path of length d is allowed at depth d and denied at d-1 — for the
    packed mode this is the probe-lag compensation boundary."""
    pair = Pair(mode, ["n:a#r@(n:b#r)", "n:b#r@u"], max_depth=2)
    assert pair.check_depths(["n:a#r@u"], [2, 1]) == [[True], [False]]


@pytest.mark.parametrize("mode", MODES)
def test_depth_boundary_chain(mode):
    """A chain needing depth 5 is allowed at max-depth 5, one needing 6 not."""
    chain = [f"n:c{i}#m@(n:c{i + 1}#m)" for i in range(5)] + ["n:c5#m@alice"]
    pair = Pair(mode, chain, max_depth=5)
    assert pair.check(["n:c1#m@alice", "n:c0#m@alice"]) == [True, False]


@pytest.mark.parametrize("mode", MODES)
def test_batch_mixed_depths(mode):
    pair = Pair(mode, ["n:obj#r@(n:s1#m)", "n:s1#m@alice", "n:obj#r@bob"])
    reqs = ["n:obj#r@alice", "n:obj#r@bob", "n:obj#r@eve"] * 2
    got = pair.check(reqs, depths=[1, 1, 5, 2, 1, 5])
    assert got == [False, True, False, True, True, False]


@pytest.mark.parametrize("mode", MODES)
def test_write_visibility(mode):
    pair = Pair(mode)
    req = ["n:obj#r@alice"]
    assert pair.check(req) == [False]
    pair.write(*req)
    assert pair.check(req) == [True]
    pair.delete(*req)
    assert pair.check(req) == [False]


def random_tuples(rng, n_objects, n_users, n_edges, n_rel=3):
    """Random tuple strings with a healthy share of subject-set
    indirections, in a fixed order so both packages intern the same ids."""
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


def random_requests(rng, n_objects, n_users, k=48):
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


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("mode", MODES)
def test_random_graphs(mode, seed):
    rng = np.random.default_rng(seed + 400)
    tuples = random_tuples(rng, n_objects=14, n_users=9, n_edges=110)
    reqs = random_requests(rng, 14, 9)
    for max_depth in (1, 3, 6):
        pair = Pair(mode, tuples, max_depth=max_depth)
        got = pair.check(reqs)
        assert 0 < sum(got) < len(got)


@pytest.mark.parametrize("mode", MODES)
def test_random_graphs_per_request_depths(mode):
    rng = np.random.default_rng(77)
    pair = Pair(mode, random_tuples(rng, 10, 6, 70), max_depth=8)
    reqs = random_requests(rng, 10, 6, k=32)
    pair.check(reqs, depths=[int(rng.integers(-1, 10)) for _ in reqs])


@pytest.mark.parametrize("mode", MODES)
def test_distances_match_jax(mode):
    """BFS levels; the packed mode answers them on its scatter companion."""
    rng = np.random.default_rng(11)
    pair = Pair(
        mode,
        ["n:obj#r@(n:s1#m)", "n:s1#m@(n:s2#m)", "n:s2#m@alice"]
        + random_tuples(rng, 10, 6, 60),
        max_depth=5,
    )
    sets = [("n", "obj", "r"), ("n", "o3", "r1"), ("no", "such", "set")]
    for depth in (0, 2):
        got = pair.teng.distances([TSet(*s) for s in sets], max_depth=depth)
        want = np.asarray(
            pair.jeng.distances([JSet(*s) for s in sets], max_depth=depth)
        )
        assert got.dtype == np.int32 and np.array_equal(got, want)
    snap = pair.tmgr.snapshot()
    levels = pair.teng.distances([TSet("n", "obj", "r")])[0]
    assert levels[snap.node_for_set("n", "obj", "r")] == 0
    assert levels[snap.node_for_set("n", "s1", "m")] == 1
    assert levels[snap.node_for_set("n", "s2", "m")] == 2
    assert levels[snap.vocab.lookup(("alice",))] == 3


@pytest.mark.parametrize("mode", MODES)
def test_check_ids_match_jax(mode):
    rng = np.random.default_rng(21)
    pair = Pair(mode, random_tuples(rng, 12, 8, 90))
    snap = pair.tmgr.snapshot()
    n = snap.num_nodes
    start = rng.integers(-2, n + 3, size=40)  # some ids out of range
    target = rng.integers(-2, n + 3, size=40)
    start[:5] = snap.padded_nodes + 7  # beyond the snapshot's width
    depths = rng.integers(0, 7, size=40)
    got = pair.teng.check_ids(start, target, depths=depths)
    want = pair.jeng.check_ids(start, target, depths=depths)
    assert got.dtype == bool and np.array_equal(got, np.asarray(want))
    assert pair.teng.check_ids([], []).shape == (0,)


@pytest.mark.parametrize("mode", MODES)
def test_pipeline_stages(mode):
    """encode -> launch -> decode answers the batch, pads it to the mode's
    bucket, and returns the staging buffers to the free-list."""
    rng = np.random.default_rng(31)
    pair = Pair(mode, random_tuples(rng, 10, 6, 70))
    reqs = random_requests(rng, 10, 6, k=20)
    full = pair.check(reqs)
    enc = pair.teng.encode_batch([TTuple.from_string(s) for s in reqs])
    assert enc.n == len(reqs) and enc.b == (4096 if mode == "packed" else 32)
    if mode == "packed":  # padding rows and unknown endpoints get depth 0
        dummy = enc.dg.dummy
        unknown = (enc.start == dummy) | (enc.target == dummy)
        assert unknown[enc.n :].all() and not enc.depth[unknown].any()
    dg = enc.dg
    got = pair.teng.decode_launched(pair.teng.launch_encoded(enc))
    assert got == full
    assert enc.start is None and len(dg._staging[enc.b]) == 1
    enc.release()  # idempotent
    assert len(dg._staging[enc.b]) == 1


@pytest.mark.parametrize("mode", MODES)
def test_residency_is_reused_and_reset(mode):
    pair = Pair(mode, ["n:obj#r@alice"])
    pair.check(["n:obj#r@alice"])
    dg = pair.teng._cached
    pair.write("n:obj#r@alice")  # duplicate write: a version-only change
    assert pair.check(["n:obj#r@alice"]) == [True]
    assert pair.teng._cached is dg
    pair.teng.reset_residency()
    assert pair.teng._cached is None
    pair.teng.warmup(batch=20)
    assert pair.check(["n:obj#r@alice"]) == [True]


def test_auto_mode_picks_dense_then_scatter():
    store = InMemoryTupleStore()
    store.write_relation_tuples(TTuple.from_string("n:obj#r@alice"))
    mgr = TManager(store)
    eng = TDevice(mgr, device="cpu")
    assert eng.batch_check([TTuple.from_string("n:obj#r@alice")]) == [True]
    assert eng._cached.mode == "dense"
    eng = TDevice(mgr, dense_threshold=512, device="cpu")
    assert eng.batch_check([TTuple.from_string("n:obj#r@alice")]) == [True]
    assert eng._cached.mode == "scatter"
    with pytest.raises(ValueError, match="mode"):
        TDevice(mgr, mode="bitset", device="cpu")


@pytest.mark.parametrize("mode", MODES)
def test_cat_videos_example(mode):
    store = InMemoryTupleStore()
    for path in sorted((REPO / "contrib/cat-videos-example/relation-tuples").glob("*.json")):
        doc = json.loads(path.read_text())
        doc.pop("$schema", None)
        store.write_relation_tuples(TTuple.from_dict(doc))
    eng = TDevice(TManager(store), mode=mode, device="cpu")
    expect = {
        "videos:/cats#owner@cat lady": True,
        "videos:/cats/1.mp4#owner@cat lady": True,
        "videos:/cats/1.mp4#view@cat lady": True,
        "videos:/cats/1.mp4#view@*": True,
        "videos:/cats/2.mp4#view@*": False,
    }
    got = eng.batch_check([TTuple.from_string(s) for s in expect])
    assert got == list(expect.values())
    assert eng.subject_is_allowed(TTuple.from_string("videos:/cats#owner@cat lady"))
