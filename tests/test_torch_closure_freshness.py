"""Write-path freshness of keto_tpu_torch's closure engine against keto_tpu's,
on the CPU: the scenarios of ``tests/test_closure_freshness.py``.

Each scenario runs the same store operations on one store of each package,
with a closure engine each (the JAX one in device query mode), and requires
the same answers, versions and build counts. Bounded freshness is shown
without wall-clock thresholds: a rebuild gate holds the background rebuild
while checks keep answering from the previous closure (no check waits on
it), and convergence is awaited on the engine's state condition with a
timeout. Tolerance: exact.
"""

import threading
import time

import numpy as np
import pytest
import torch

from keto_tpu.engine.closure import ClosureCheckEngine as JClosure
from keto_tpu.graph import SnapshotManager as JManager
from keto_tpu.relationtuple import RelationTuple as JTuple
from keto_tpu_torch.engine import CheckEngine as TCheck
from keto_tpu_torch.engine import ClosureCheckEngine as TClosure
from keto_tpu_torch.graph import SnapshotManager as TManager
from keto_tpu_torch.graph.interior import build_interior
from keto_tpu_torch.relationtuple import RelationTuple as TTuple
from keto_tpu_torch.utils.errors import ErrUnavailable

from test_torch_closure_engine import random_tuples
from test_torch_overlay import Pair, settle

torch.set_num_threads(1)


def wait_until(pred, timeout_s=30.0):
    deadline = time.monotonic() + timeout_s
    while not pred():
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(0.005)


class Gate:
    """A rebuild gate that holds background rebuilds until released."""

    def __init__(self):
        self.open = threading.Event()
        self.calls = 0

    def __call__(self):
        self.calls += 1
        assert self.open.wait(timeout=60), "gate never released"


def gated_pair(tuples, freshness="bounded", **kw):
    """A columnar Pair whose engines' rebuilds wait on one gate each."""
    pair = Pair(tuples, freshness=freshness, store="columnar", **kw)
    pair.tgate, pair.jgate = Gate(), Gate()
    pair.teng._rebuild_gate = pair.tgate
    pair.jeng._rebuild_gate = pair.jgate
    return pair


def bulk(pair, *strings):
    """The same bulk load into both columnar stores: a version step with no
    per-tuple delta, which no overlay can absorb."""
    parsed = [TTuple.from_string(s) for s in strings]
    src = [(t.namespace, t.object, t.relation) for t in parsed]
    dst = [
        (t.subject.id,) if not hasattr(t.subject, "relation")
        else (t.subject.namespace, t.subject.object, t.subject.relation)
        for t in parsed
    ]
    pair.jstore.bulk_load_edges(src, dst)
    pair.tstore.bulk_load_edges(src, dst)


def both(pair, strings, max_depth=0):
    """Answers of both engines, required equal (no settling: stale serving
    is the point here)."""
    got = pair.teng.batch_check([TTuple.from_string(s) for s in strings], max_depth)
    want = pair.jeng.batch_check([JTuple.from_string(s) for s in strings], max_depth)
    assert got == want
    return got


class TestIncrementalClosure:
    def test_appended_interior_edge_updates_in_place(self):
        pair = Pair(
            ["n:a#r@(n:b#r)", "n:b#r@(n:c#r)", "n:c#r@u1"],
            freshness="auto", max_depth=8,
        )
        assert pair.check(["n:a#r@u1"]) == [True]
        assert pair.builds(pair.teng) == (1, 0)
        # c#r -> b#r: both endpoints already interior; the overlay patches D
        pair.write("n:c#r@(n:b#r)")
        assert pair.check(["n:c#r@u1"]) == [True]
        assert pair.builds(pair.teng) == (1, 0)
        # the cycle b -> c -> b resolves both ways
        assert pair.check(["n:b#r@(n:b#r)", "n:c#r@(n:c#r)"]) == [True, True]

    def test_new_interior_node_grows_without_rebuild(self):
        pair = Pair(["n:a#r@(n:b#r)", "n:b#r@u1"], freshness="auto", max_depth=8)
        pair.check(["n:a#r@u1"])
        # a#r gains an in-edge: it grows into D's reserved padding
        pair.write("n:x#q@(n:a#r)")
        assert pair.check(["n:x#q@u1"]) == [True]
        assert pair.builds(pair.teng) == (1, 0)
        assert pair.teng.served_version() == pair.tstore.version

    @pytest.mark.parametrize("seed", range(3))
    def test_incremental_stream_matches_oracle(self, seed):
        """Appended set->set edges between existing interior nodes keep D
        byte-equal across the packages and the answers exact."""
        rng = np.random.default_rng(seed + 300)
        pair = Pair(random_tuples(rng, 12, 8, 120), freshness="auto", max_depth=6)
        snap = pair.teng.snapshots.snapshot()
        ig = build_interior(snap)
        keys = [snap.vocab.key(int(i)) for i in ig.interior_ids]
        assert len(keys) >= 3
        pair.check(["n:o0#r0@u0"])
        for _ in range(5):
            a = keys[rng.integers(len(keys))]
            b = keys[rng.integers(len(keys))]
            pair.write(f"{a[0]}:{a[1]}#{a[2]}@({b[0]}:{b[1]}#{b[2]})")
            reqs = [
                f"n:o{rng.integers(12)}#r{rng.integers(3)}@u{rng.integers(8)}"
                for _ in range(32)
            ]
            pair.check(reqs)
        assert pair.builds(pair.teng) == (1, 0)

    def test_rebuild_after_a_break_is_incremental_when_appended(self):
        """A bulk append of interior edges over an unchanged interior node
        set takes the incremental build in both packages, from the D the
        overlay had already patched."""
        pair = Pair(
            ["n:a#r@(n:b#r)", "n:b#r@(n:c#r)", "n:c#r@u1", "n:d#r@(n:a#r)"],
            freshness="strong", store="columnar",
        )
        pair.check(["n:d#r@u1"])
        pair.write("n:c#r@(n:a#r)")  # absorbed by the overlay
        bulk(pair, "n:b#r@(n:a#r)")  # breaks it: the next check rebuilds
        assert pair.check(["n:d#r@u1", "n:c#r@(n:b#r)"], (0, 2)) == [True, True]
        assert pair.builds(pair.teng) == (1, 1)


class TestBoundedFreshness:
    def test_serves_stale_then_converges(self):
        pair = gated_pair(["n:obj#r@alice"])
        assert both(pair, ["n:obj#r@alice", "n:obj#r@bob"]) == [True, False]
        v0 = pair.teng.served_version()
        pair.write("n:obj#r@carol")  # a leaf write: the overlay absorbs it
        assert both(pair, ["n:obj#r@carol"]) == [True]
        assert pair.teng.served_version() == pair.tstore.version
        bulk(pair, "n:obj#r@bob")  # no overlay can absorb this
        # the check after the bulk load does not wait for the held rebuild:
        # it answers from the previous closure, at the previous version
        assert both(pair, ["n:obj#r@bob", "n:obj#r@carol"]) == [False, True]
        # a broken overlay names its base snapshot's version
        assert pair.teng.served_version() == v0 == pair.jeng.served_version()
        assert pair.teng.answering_version() == v0 == pair.jeng.answering_version()
        with pytest.raises(ErrUnavailable):
            pair.teng.wait_for_version(pair.tstore.version, timeout_s=0.05)
        pair.tgate.open.set()
        pair.jgate.open.set()
        assert pair.check(["n:obj#r@bob"]) == [True]  # settles both first
        assert pair.teng.served_version() == pair.tstore.version > v0 + 1
        assert pair.builds(pair.teng) == (1, 1)  # an append: incremental

    def test_no_stall_under_write_storm(self):
        """Checks keep answering while writes stream in; none builds on the
        calling thread. Leaf writes are absorbed by the overlay; bulk loads
        wait for the (held) background rebuild instead of stalling checks."""
        base = [f"n:o{i}#r@(n:g{i % 7}#m)" for i in range(50)]
        base += [f"n:g{i}#m@alice" for i in range(7)]
        pair = gated_pair(base)
        pair.teng.warmup()
        pair.jeng.warmup()
        for i in range(30):
            pair.write(f"n:extra{i}#r@bob")
            assert both(pair, ["n:o1#r@alice", f"n:extra{i}#r@bob"]) == [True, True]
        assert pair.builds(pair.teng) == (1, 0)
        assert pair.teng.served_version() == pair.tstore.version
        for i in range(10):
            bulk(pair, f"n:bulk{i}#r@bob")
            assert both(pair, ["n:o1#r@alice", "n:bulk0#r@bob"]) == [True, False]
        assert pair.builds(pair.teng) == (1, 0)  # every rebuild is held
        wait_until(lambda: pair.tgate.calls == 1)
        assert pair.tgate.calls == 1  # one rebuild thread, kicked once
        pair.tgate.open.set()
        pair.jgate.open.set()
        assert pair.check(["n:o1#r@alice", "n:bulk9#r@bob"]) == [True, True]

    def test_strong_freshness_is_read_your_writes(self):
        pair = Pair([], freshness="strong")
        assert pair.check(["n:obj#r@alice"]) == [False]
        pair.write("n:obj#r@alice")
        assert pair.check(["n:obj#r@alice"]) == [True]
        assert pair.teng.served_version() == pair.tstore.version

    def test_auto_is_strong_at_small_scale(self):
        pair = Pair([], freshness="auto")
        pair.write("n:obj#r@alice")
        assert pair.check(["n:obj#r@alice"]) == [True]
        pair = gated_pair(["n:obj#r@alice"], freshness="auto")
        both(pair, ["n:obj#r@alice"])
        bulk(pair, "n:obj#r@bob")
        # below strong_freshness_edges a break rebuilds synchronously
        assert both(pair, ["n:obj#r@bob"]) == [True]
        assert pair.tgate.calls == 0

    def test_auto_above_the_threshold_no_longer_raises(self):
        """Past strong_freshness_edges, auto serves the previous closure
        while the background rebuild runs (it used to raise ValueError)."""
        pair = gated_pair(["n:obj#r@alice", "n:obj#r@(n:g#m)"], freshness="auto")
        for eng in (pair.teng, pair.jeng):
            eng.strong_freshness_edges = 2
        both(pair, ["n:obj#r@alice"])
        bulk(pair, "n:g#m@bob")
        assert both(pair, ["n:obj#r@bob"]) == [False]  # stale, not a raise
        assert pair.teng.served_version() < pair.tstore.version
        pair.tgate.open.set()
        pair.jgate.open.set()
        assert pair.check(["n:obj#r@bob"]) == [True]

    def test_snaptoken_wait_on_a_strong_engine_returns_at_once(self):
        pair = Pair(["n:obj#r@alice"], freshness="strong", store="columnar")
        pair.check(["n:obj#r@alice"])
        bulk(pair, "n:obj#r@bob")
        pair.teng.wait_for_version(pair.tstore.version, timeout_s=0.0)
        assert pair.teng._rebuilding is False
        assert pair.check(["n:obj#r@bob"]) == [True]


def test_oracle_agrees_after_settling():
    """settle() leaves no rebuild thread behind, and the engine then agrees
    with the host oracle at the live version."""
    pair = gated_pair(["n:a#r@(n:b#r)", "n:b#r@u"])
    pair.check(["n:a#r@u"])
    bulk(pair, "n:b#r@v")
    pair.tgate.open.set()
    pair.jgate.open.set()
    settle(pair.teng, pair.tstore)
    assert not pair.teng._rebuilding
    req = TTuple.from_string("n:a#r@v")
    assert pair.teng.batch_check([req]) == TCheck(pair.tstore).batch_check([req])
