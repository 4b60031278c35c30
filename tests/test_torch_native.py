"""keto_tpu_torch's native host tier against keto_tpu's, and against the
port's own numpy twins, on the CPU.

The port builds its copy of ``_hotpath.c`` with gcc into
``keto_tpu_torch/_build/`` at first use; keto_tpu builds its own. The same
seeded inputs go through both packages' five wrappers (``object_hashes``,
``request_hashes``, ``probe_index`` through ``lookup_hashes``,
``closure_check`` through a host-query-mode ``ClosureCheckEngine``,
``gather_min_u8``) and through the port with ``native.lib`` monkeypatched
to None, which takes the numpy branches. The cases of
``tests/test_native_kernels.py`` are ported: hashes equal Python's,
unhashable keys raise, ``lookup_bulk`` native against numpy, the tuple-hash
selftest on the port's slotted dataclasses, ``request_hashes`` flags,
``lookup_hashes`` against ``lookup_bulk`` and its collision fallback,
``closure_check`` against numpy and the host oracle (fan-out wider than
the numpy caps, mixed depths with direct edges), ``gather_min_u8`` against
numpy. Then one host-query-mode engine of each package through overlay
writes, with the tier on and with it off in both. Tolerance: none; ids
must be equal and answers exact.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from keto_tpu import native as jnative
from keto_tpu.engine.closure import ClosureCheckEngine as JClosure
from keto_tpu.graph import SnapshotManager as JManager
from keto_tpu.graph.vocab import NodeVocab as JVocab
from keto_tpu.relationtuple import RelationTuple as JTuple
from keto_tpu.relationtuple import SubjectID as JID
from keto_tpu.store import InMemoryTupleStore as JStore
from keto_tpu_torch import native
from keto_tpu_torch.engine import CheckEngine, ClosureCheckEngine
from keto_tpu_torch.graph import SnapshotManager
from keto_tpu_torch.graph.vocab import NodeVocab
from keto_tpu_torch.relationtuple import RelationTuple, SubjectID, SubjectSet
from keto_tpu_torch.store import InMemoryTupleStore

REPO = Path(__file__).resolve().parent.parent
torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _tiers_built():
    """Both tiers must load here (gcc is present): a test that silently ran
    the numpy twins twice would prove nothing."""
    assert native.lib is not None, native.build_error
    assert jnative.lib is not None
    assert native.tuple_hash_ok and jnative.tuple_hash_ok


def t(s: str) -> RelationTuple:
    return RelationTuple.from_string(s)


def random_tuples(rng, n_objects, n_users, n_edges, n_rel=3) -> list[str]:
    """A random tuple graph with a healthy share of subject-set
    indirections (tests/test_device_engines.py random_store), as strings in
    a fixed order."""
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


def random_requests(rng, n_objects, n_users, k) -> list[str]:
    reqs = []
    for _ in range(k):
        obj = f"o{rng.integers(n_objects)}"
        rel = f"r{rng.integers(3)}"
        if rng.random() < 0.3:
            sub = f"n:o{rng.integers(n_objects)}#r{rng.integers(3)}"
        else:
            sub = f"u{rng.integers(n_users)}"
        reqs.append(f"n:{obj}#{rel}@({sub})")
    return reqs


# -- the build ------------------------------------------------------------------


def test_built_from_the_package_source_into_the_build_dir():
    assert native.so_path.parent == REPO / "keto_tpu_torch" / "_build"
    assert native.so_path.name.startswith("_hotpath_") and native.so_path.exists()
    assert native.build_error == "" and native.available()
    assert native.lib.__file__ == str(native.so_path)


def test_disabled_tier_says_why_and_the_callers_take_numpy():
    code = (
        "import logging; logging.basicConfig(level=logging.INFO)\n"
        "from keto_tpu_torch import native\n"
        "from keto_tpu_torch.graph.vocab import NodeVocab\n"
        "v = NodeVocab(); v.intern_bulk([('a',), ('b',)])\n"
        "assert v.lookup_bulk([('b',), ('c',)]).tolist() == [1, -1]\n"
        "assert native.lib is None and not native.tuple_hash_ok\n"
        "assert native.object_hashes.calls == 0\n"
        "print('ERR', native.build_error)\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120, env={**os.environ, "KETO_NATIVE": "0"},
    )
    assert r.returncode == 0, r.stderr
    assert "ERR disabled by KETO_NATIVE" in r.stdout
    said = [ln for ln in r.stderr.splitlines() if "native host tier unavailable" in ln]
    assert len(said) == 1, r.stderr


# -- hashes -----------------------------------------------------------------------


class TestObjectHashes:
    def test_matches_python_hash_and_keto_tpu(self):
        keys = [("ns", f"o{i}", "rel") for i in range(100)] + [
            (f"u{i}",) for i in range(100)
        ]
        h = native.object_hashes(keys)
        assert h.tolist() == [hash(k) for k in keys]
        np.testing.assert_array_equal(h, jnative.object_hashes(keys))

    def test_unhashable_raises(self):
        with pytest.raises(TypeError):
            native.object_hashes([["list", "unhashable"]])


class TestRequestHashes:
    def test_tuple_hash_selftest_on_this_interpreter(self):
        assert native.tuple_hash_ok
        for tup in [("a", "b", "c"), ("x",), ("", "", ""), ("u" * 99,)]:
            assert native.lib.tuple_hash_check(tup) == hash(tup)

    def test_hashes_and_flags_off_the_ports_slotted_dataclasses(self):
        strings = ["n:o1#r@alice", "n:o2#r@(m:g#member)", ":#@()"]
        reqs = [t(s) for s in strings]
        # the slot-offset fast path reads the dataclasses' members by name
        for cls in (RelationTuple, SubjectID, SubjectSet):
            assert cls.__slots__, cls
        hs, ht, is_id = native.request_hashes(reqs, SubjectID)
        for i, r in enumerate(reqs):
            assert hs[i] == hash((r.namespace, r.object, r.relation))
            s = r.subject
            want = (
                hash((s.id,))
                if isinstance(s, SubjectID)
                else hash((s.namespace, s.object, s.relation))
            )
            assert ht[i] == want
            assert is_id[i] == isinstance(s, SubjectID)
        jhs, jht, jis_id = jnative.request_hashes(
            [JTuple.from_string(s) for s in strings], JID
        )
        np.testing.assert_array_equal(hs, jhs)
        np.testing.assert_array_equal(ht, jht)
        np.testing.assert_array_equal(is_id, jis_id)

    def test_an_object_of_another_shape_takes_the_getattr_path(self):
        class Loose:  # no slots: the C loop's GetAttr fallback
            def __init__(self, r):
                self.namespace, self.object, self.relation = r.namespace, r.object, r.relation
                self.subject = r.subject

        reqs = [t("n:o1#r@alice"), t("n:o2#r@(m:g#member)")]
        fast = native.request_hashes(reqs, SubjectID)
        slow = native.request_hashes([Loose(r) for r in reqs], SubjectID)
        for a, b in zip(fast, slow):
            np.testing.assert_array_equal(a, b)


# -- the vocab index ------------------------------------------------------------


class TestProbeParity:
    @pytest.mark.parametrize("seed", range(3))
    def test_lookup_bulk_native_vs_numpy_vs_keto_tpu(self, seed, monkeypatch):
        rng = np.random.default_rng(seed)
        keys = [("n", f"o{i}", f"r{i % 3}") for i in range(2000)] + [
            (f"u{i}",) for i in range(2000)
        ]
        vocab, jvocab = NodeVocab(), JVocab()
        vocab.intern_bulk(keys)
        jvocab.intern_bulk(keys)
        probe = [keys[i] for i in rng.integers(len(keys), size=500)]
        probe += [("n", "missing", "x"), ("nouser",)] * 10
        before = (native.object_hashes.calls, native.probe_index.calls)
        got_native = vocab.lookup_bulk(probe)
        assert (native.object_hashes.calls, native.probe_index.calls) == (
            before[0] + 1, before[1] + 1
        )
        np.testing.assert_array_equal(got_native, jvocab.lookup_bulk(probe))
        monkeypatch.setattr(native, "lib", None)
        got_numpy = vocab.lookup_bulk(probe)
        np.testing.assert_array_equal(got_native, got_numpy)
        exact = [v if (v := vocab.lookup(k)) is not None else -1 for k in probe]
        assert got_native.tolist() == exact

    def test_lookup_hashes_matches_lookup_bulk(self, monkeypatch):
        vocab = NodeVocab()
        keys = [("n", f"o{i}", "r") for i in range(500)] + [
            (f"u{i}",) for i in range(500)
        ]
        vocab.intern_bulk(keys)
        probe = keys[::3] + [("n", "nope", "r"), ("ghost",)]
        h = np.fromiter((hash(k) for k in probe), np.int64, count=len(probe))
        got = vocab.lookup_hashes(h, lambda i: probe[i])
        np.testing.assert_array_equal(got, vocab.lookup_bulk(probe))
        monkeypatch.setattr(native, "lib", None)
        np.testing.assert_array_equal(vocab.lookup_hashes(h, lambda i: probe[i]), got)

    @pytest.mark.parametrize("tier", ["native", "numpy"])
    def test_lookup_hashes_collision_fallback(self, tier, monkeypatch):
        """Keys routed to the exact dict when their hash collides inside the
        vocab still resolve through key_fn, on both branches."""
        if tier == "numpy":
            monkeypatch.setattr(native, "lib", None)
        vocab = NodeVocab()
        keys = [("n", f"o{i}", "r") for i in range(64)]
        vocab.intern_bulk(keys)
        vocab._extend_hash_index()
        mask, slots, slot_ids, collisions, upto = vocab._h_table
        victim = keys[7]
        collisions.add(hash(victim))
        vocab._h_table = (mask, slots, slot_ids, collisions, upto)
        h = np.array([hash(victim)], np.int64)
        assert vocab.lookup_hashes(h, lambda i: victim)[0] == vocab.lookup(victim)
        # a different key with that same hash value resolves to unknown
        assert vocab.lookup_hashes(h, lambda i: ("not", "a", "key"))[0] == -1

    def test_snapshot_encode_requests_native_vs_numpy_vs_keto_tpu(self, monkeypatch):
        """The packed and frontier engines' encode (GraphSnapshot.encode_requests)."""
        rng = np.random.default_rng(5)
        tuples = random_tuples(rng, 30, 20, 200)
        reqs = random_requests(rng, 32, 22, 300)  # unknown keys included
        tstore, jstore = InMemoryTupleStore(), JStore()
        tstore.write_relation_tuples(*(t(s) for s in tuples))
        jstore.write_relation_tuples(*(JTuple.from_string(s) for s in tuples))
        snap, jsnap = SnapshotManager(tstore).snapshot(), JManager(jstore).snapshot()
        calls = native.request_hashes.calls
        s, tt = snap.encode_requests([t(x) for x in reqs])
        assert native.request_hashes.calls == calls + 1
        js, jt = jsnap.encode_requests([JTuple.from_string(x) for x in reqs])
        np.testing.assert_array_equal(s, js)
        np.testing.assert_array_equal(tt, jt)
        monkeypatch.setattr(native, "lib", None)
        s2, t2 = snap.encode_requests([t(x) for x in reqs])
        np.testing.assert_array_equal(s, s2)
        np.testing.assert_array_equal(tt, t2)


# -- closure_check --------------------------------------------------------------


def host_engine(store, depth):
    return ClosureCheckEngine(
        SnapshotManager(store), max_depth=depth, query_mode="host", device="cpu"
    )


class TestClosureCheckParity:
    @pytest.mark.parametrize("seed", range(4))
    def test_native_vs_numpy_vs_oracle_vs_keto_tpu(self, seed, monkeypatch):
        rng = np.random.default_rng(seed)
        tuples = random_tuples(rng, 15, 10, 150)
        strings = random_requests(rng, 15, 10, 128)
        store, jstore = InMemoryTupleStore(), JStore()
        store.write_relation_tuples(*(t(s) for s in tuples))
        jstore.write_relation_tuples(*(JTuple.from_string(s) for s in tuples))
        reqs = [t(s) for s in strings]
        jreqs = [JTuple.from_string(s) for s in strings]
        for depth in (1, 2, 3, 5):
            expect = CheckEngine(store, max_depth=depth).batch_check(reqs)
            calls = native.closure_check.calls
            got_native = host_engine(store, depth).batch_check(reqs)
            assert native.closure_check.calls == calls + 1
            jeng = JClosure(JManager(jstore), max_depth=depth, query_mode="host")
            assert jeng.batch_check(jreqs) == expect
            monkeypatch.setattr(native, "lib", None)
            got_numpy = host_engine(store, depth).batch_check(reqs)
            monkeypatch.undo()
            assert got_native == expect
            assert got_numpy == expect

    def test_wide_fanout_exceeding_numpy_caps(self):
        """Rows wider than f0_max/l_max: numpy sends them to the oracle, C
        walks the true degrees; both match the oracle."""
        store = InMemoryTupleStore()
        tuples = []
        for i in range(70):  # a start with 70 set successors (> f0_max 32)
            tuples.append(t(f"n:doc#view@(n:g{i}#m)"))
            tuples.append(t(f"n:g{i}#m@(n:h{i}#m)"))
        for i in range(50):  # a target with 50 interior in-neighbours (> l_max 32)
            tuples.append(t(f"n:h{i}#m@alice"))
        store.write_relation_tuples(*tuples)
        oracle = CheckEngine(store, max_depth=5)
        eng = host_engine(store, 5)
        reqs = [
            t("n:doc#view@alice"),
            t("n:doc#view@bob"),
            t("n:doc#view@(n:g3#m)"),
            t("n:doc#view@(n:h9#m)"),
        ]
        calls = native.closure_check.calls
        assert eng.batch_check(reqs) == oracle.batch_check(reqs)
        assert eng.batch_check(reqs, depths=[1, 2, 3, 4]) == oracle.batch_check(
            reqs, depths=[1, 2, 3, 4]
        )
        assert native.closure_check.calls == calls + 2

    def test_mixed_depths_and_direct_edges(self):
        store = InMemoryTupleStore()
        store.write_relation_tuples(
            t("n:a#r@alice"),
            t("n:a#r@(n:b#r)"),
            t("n:b#r@(n:c#r)"),
            t("n:c#r@bob"),
        )
        oracle = CheckEngine(store, max_depth=8)
        eng = host_engine(store, 8)
        reqs = [
            t("n:a#r@alice"),  # direct, depth 1
            t("n:a#r@bob"),  # 3 hops
            t("n:a#r@(n:c#r)"),  # set target, 2 hops
            t("n:a#r@(n:a#r)"),  # self
            t("n:zzz#r@alice"),  # unknown start
        ]
        for depths in (None, [1, 1, 1, 1, 1], [1, 3, 2, 1, 5], [2, 2, 2, 2, 2]):
            assert eng.batch_check(reqs, depths=depths) == oracle.batch_check(
                reqs, depths=depths
            )

    def test_check_ids_takes_the_fused_kernel(self, monkeypatch):
        """The id-native entry (the encoded tier's) in host query mode."""
        rng = np.random.default_rng(9)
        store = InMemoryTupleStore()
        store.write_relation_tuples(*(t(s) for s in random_tuples(rng, 20, 12, 160)))
        eng = host_engine(store, 5)
        snap = eng.snapshots.snapshot()
        n = 200
        start = rng.integers(snap.padded_nodes, size=n)
        target = rng.integers(snap.padded_nodes, size=n)
        live = len(snap.vocab)
        is_id = np.array([
            int(x) < live and len(snap.vocab.key(int(x))) == 1 for x in target
        ])
        calls = native.closure_check.calls
        got = eng.check_ids(start, target, is_id)
        assert native.closure_check.calls == calls + 1
        monkeypatch.setattr(native, "lib", None)
        np.testing.assert_array_equal(got, eng.check_ids(start, target, is_id))


def test_gather_min_u8_matches_numpy_and_keto_tpu():
    rng = np.random.default_rng(0)
    d = rng.integers(0, 256, size=(64, 64), dtype=np.uint8)
    rows = rng.integers(0, 64, size=(40, 5)).astype(np.int32)
    cols = rng.integers(0, 64, size=(40, 3)).astype(np.int32)
    got = native.gather_min_u8(d, rows, cols)
    want = d[rows[:, :, None], cols[:, None, :]].min(axis=(1, 2))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jnative.gather_min_u8(d, rows, cols))


def test_wrappers_refuse_wrong_dtypes():
    d = np.zeros((4, 4), dtype=np.int32)
    with pytest.raises(ValueError, match="uint8"):
        native.gather_min_u8(d, np.zeros((1, 1)), np.zeros((1, 1)))
    with pytest.raises(ValueError, match="dtypes"):
        native.probe_index(np.zeros(4, np.int32), np.zeros(4, np.int32), 3,
                           np.zeros(1, np.int64))


# -- one host-query-mode engine of each package through overlay writes ----------


@pytest.mark.parametrize("tier", ["native", "numpy"])
def test_host_engines_of_both_packages_through_overlay_writes(tier, monkeypatch):
    if tier == "numpy":
        monkeypatch.setattr(native, "lib", None)
        monkeypatch.setattr(jnative, "lib", None)
    rng = np.random.default_rng(31)
    tuples = random_tuples(rng, 20, 12, 180)
    tstore, jstore = InMemoryTupleStore(), JStore()
    tstore.write_relation_tuples(*(t(s) for s in tuples))
    jstore.write_relation_tuples(*(JTuple.from_string(s) for s in tuples))
    teng = ClosureCheckEngine(
        SnapshotManager(tstore), max_depth=5, query_mode="host",
        freshness="strong", rebuild_debounce_s=0.0, device="cpu",
    )
    jeng = JClosure(
        JManager(jstore), max_depth=5, query_mode="host", freshness="strong",
        rebuild_debounce_s=0.0,
    )
    oracle = CheckEngine(tstore, max_depth=5)
    strings = random_requests(rng, 22, 14, 200)
    calls = native.closure_check.calls

    def check(extra=()):
        reqs = strings + list(extra)
        got = teng.batch_check([t(s) for s in reqs])
        assert got == jeng.batch_check([JTuple.from_string(s) for s in reqs])
        assert got == oracle.batch_check([t(s) for s in reqs])
        return got

    check()
    writes = [
        ("write", ["n:o1#r0@u-new"]),  # a leaf insert
        ("write", ["n:o2#r1@(n:o3#r2)", "n:o3#r2@(n:o4#r0)"]),  # interior inserts
        ("delete", ["n:o1#r0@u-new"]),
        ("delete", ["n:o2#r1@(n:o3#r2)"]),
    ]
    for op, batch in writes:
        getattr(tstore, f"{op}_relation_tuples")(*(t(s) for s in batch))
        getattr(jstore, f"{op}_relation_tuples")(*(JTuple.from_string(s) for s in batch))
        got = check(["n:o1#r0@u-new", "n:o2#r1@u3"])
    assert teng._overlay is not None and teng._overlay.n_events >= 4
    assert teng.n_full_builds == jeng.n_full_builds
    took_c = native.closure_check.calls - calls
    assert took_c == (5 if tier == "native" else 0), took_c
    assert len(got) == len(strings) + 2
