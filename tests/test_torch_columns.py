"""keto_tpu_torch's columnar check batches vs keto_tpu's, on the CPU.

``CheckColumns`` decodes the same REST bodies in both packages, with the
same normalized columns and, for malformed bodies, the same
ErrMalformedInput message. ``encode_requests_columnar`` gives the same ids
as keto_tpu's and as the tuple path. ``batch_check_columns`` answers equal
keto_tpu's closure engine in device query mode, the port's own
``batch_check`` and the host oracle, on random graphs, per-request depth
budgets, overflow rows, and the oversized-interior (``_TooBig``) fallback;
the frontier engine's columnar path agrees too. Tolerance: exact.
"""

import numpy as np
import pytest
import torch

from keto_tpu.engine.closure import ClosureCheckEngine as JClosure
from keto_tpu.graph import SnapshotManager as JManager
from keto_tpu.relationtuple import RelationTuple as JTuple
from keto_tpu.relationtuple.columns import CheckColumns as JColumns
from keto_tpu.store import InMemoryTupleStore as JStore
from keto_tpu.utils.errors import ErrMalformedInput as JMalformed
from keto_tpu_torch.engine import CheckEngine as TCheck
from keto_tpu_torch.engine import ClosureCheckEngine as TClosure
from keto_tpu_torch.engine import DeviceCheckEngine as TDevice
from keto_tpu_torch.graph import SnapshotManager as TManager
from keto_tpu_torch.relationtuple import RelationTuple as TTuple
from keto_tpu_torch.relationtuple.columns import CheckColumns as TColumns
from keto_tpu_torch.relationtuple.columns import proto_has_columns
from keto_tpu_torch.store import InMemoryTupleStore as TStore
from keto_tpu_torch.utils.errors import ErrMalformedInput as TMalformed

from test_torch_closure_engine import random_requests, random_tuples

torch.set_num_threads(1)

COLUMNS = (
    "namespaces", "objects", "relations", "subject_ids",
    "subject_set_namespaces", "subject_set_objects", "subject_set_relations",
)

BODIES = {
    "ids": {"namespaces": ["n", "n"], "objects": ["a", "b"],
            "relations": ["r", "r"], "subject_ids": ["u1", "u2"]},
    "sets": {"namespaces": ["n"], "objects": ["a"], "relations": ["r"],
             "subject_set_namespaces": ["n"], "subject_set_objects": ["g"],
             "subject_set_relations": ["m"]},
    "mixed": {"namespaces": ["n", "n"], "objects": ["a", "b"],
              "relations": ["r", "s"], "subject_ids": ["u1", ""],
              "subject_set_namespaces": ["", "n"],
              "subject_set_objects": ["", "g"],
              "subject_set_relations": ["", "m"]},
    "empty": {"namespaces": []},
    "length_mismatch": {"namespaces": ["n", "n"], "objects": ["a"],
                        "relations": ["r", "r"], "subject_ids": ["u", "v"]},
    "subject_length_mismatch": {"namespaces": ["n"], "objects": ["a"],
                                "relations": ["r"], "subject_ids": ["u", "v"]},
    "both_subjects": {"namespaces": ["n"], "objects": ["a"], "relations": ["r"],
                      "subject_ids": ["u"], "subject_set_namespaces": ["n"]},
    "no_subject": {"namespaces": ["n"], "objects": ["a"], "relations": ["r"]},
    "blank_row": {"namespaces": ["n", "n"], "objects": ["a", "b"],
                  "relations": ["r", "r"], "subject_ids": ["u", ""]},
    "string_column": {"namespaces": "n", "objects": ["a"], "relations": ["r"]},
    "number_in_column": {"namespaces": ["n"], "objects": [3], "relations": ["r"],
                         "subject_ids": ["u"]},
    "not_a_list": {"namespaces": ["n"], "objects": 5, "relations": ["r"],
                   "subject_ids": ["u"]},
}


def decode(cls, exc, body):
    try:
        cols = cls.from_rest_body(body)
    except exc as e:
        return ("error", e.message, e.status_code)
    return tuple(tuple(getattr(cols, c)) for c in COLUMNS)


@pytest.mark.parametrize("name", sorted(BODIES))
def test_rest_body_decodes_like_the_reference(name):
    want = decode(JColumns, JMalformed, BODIES[name])
    got = decode(TColumns, TMalformed, BODIES[name])
    assert got == want


def test_views_select_and_materialize_match_the_reference():
    body = BODIES["mixed"]
    j, t = JColumns.from_rest_body(body), TColumns.from_rest_body(body)
    assert t.start_keys() == j.start_keys()
    assert t.target_keys() == j.target_keys()
    assert t.row_keys(3) == j.row_keys(3)
    assert [str(x) for x in t.materialize()] == [str(x) for x in j.materialize()]
    sub_t, sub_j = t.select([1]), j.select([1])
    assert [getattr(sub_t, c) for c in COLUMNS] == [getattr(sub_j, c) for c in COLUMNS]
    tuples = [TTuple.from_string(s) for s in ("n:a#r@u", "n:b#s@(n:g#m)")]
    back = TColumns.from_tuples(tuples)
    assert back.materialize() == tuples
    assert len(back) == 2

    class Proto:
        namespaces = ["n"]

    assert proto_has_columns(Proto())
    Proto.namespaces = []
    assert not proto_has_columns(Proto())


def columns_of(strings, cls):
    return cls.from_tuples([
        (JTuple if cls is JColumns else TTuple).from_string(s) for s in strings
    ])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encode_requests_columnar_ids_match(seed):
    rng = np.random.default_rng(seed)
    tuples = random_tuples(rng, 12, 8, 90)
    reqs = random_requests(rng, 12, 8)
    jstore, tstore = JStore(), TStore()
    jstore.write_relation_tuples(*(JTuple.from_string(s) for s in tuples))
    tstore.write_relation_tuples(*(TTuple.from_string(s) for s in tuples))
    jsnap, tsnap = JManager(jstore).snapshot(), TManager(tstore).snapshot()
    js, jt = jsnap.encode_requests_columnar(columns_of(reqs, JColumns))
    ts, tt = tsnap.encode_requests_columnar(columns_of(reqs, TColumns))
    assert np.array_equal(ts, js) and np.array_equal(tt, jt)
    ps, pt = tsnap.encode_requests([TTuple.from_string(s) for s in reqs])
    assert np.array_equal(ts, ps) and np.array_equal(tt, pt)
    # the staging-buffer contract: rows [0, n) written in place
    out_s = np.full(len(reqs) + 5, -7, dtype=np.int32)
    out_t = np.full(len(reqs) + 5, -7, dtype=np.int32)
    rs, rt = tsnap.encode_requests_columnar(
        columns_of(reqs, TColumns), out_start=out_s, out_target=out_t
    )
    assert rs is out_s and rt is out_t
    assert np.array_equal(out_s[: len(reqs)], ts) and (out_s[len(reqs):] == -7).all()
    assert (ts[-1] == tsnap.dummy_node) and (tt[-1] == tsnap.dummy_node)


class Engines:
    def __init__(self, tuples, max_depth=5, **kw):
        self.jstore, self.tstore = JStore(), TStore()
        self.jstore.write_relation_tuples(*(JTuple.from_string(s) for s in tuples))
        self.tstore.write_relation_tuples(*(TTuple.from_string(s) for s in tuples))
        self.jeng = JClosure(JManager(self.jstore), max_depth=max_depth,
                             query_mode="device", freshness="strong", **kw)
        self.teng = TClosure(TManager(self.tstore), max_depth=max_depth,
                             freshness="strong", device="cpu", **kw)
        self.oracle = TCheck(self.tstore, max_depth=max_depth)

    def check(self, reqs, depths=None):
        got = self.teng.batch_check_columns(columns_of(reqs, TColumns), depths=depths)
        want = self.jeng.batch_check_columns(columns_of(reqs, JColumns), depths=depths)
        assert got == want
        tuples = [TTuple.from_string(s) for s in reqs]
        assert got == self.teng.batch_check(tuples, depths=depths)
        if depths is None:
            assert got == self.oracle.batch_check(tuples)
        return got


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_batch_check_columns_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    pair = Engines(random_tuples(rng, 12, 8, 100))
    got = pair.check(random_requests(rng, 12, 8))
    assert any(got) and not all(got)
    reqs = random_requests(rng, 12, 8)
    pair.check(reqs, depths=[int(rng.integers(0, 8)) for _ in reqs])
    assert pair.teng.batch_check_columns(TColumns([], [], [])) == []


def test_batch_check_columns_overflow_rows():
    """Rows above the padded fan-out take the exact fallback, which gets
    each overflow row as a tuple built from its columns."""
    rng = np.random.default_rng(200)
    tuples = random_tuples(rng, 10, 6, 100)
    tuples += [f"n:wide#r@(n:g{i}#m)" for i in range(40)]
    tuples += [f"n:g{i}#m@hub" for i in range(40)]
    tuples += [f"n:g{i}#m@(n:o{i % 10}#r0)" for i in range(40)]
    reqs = random_requests(rng, 10, 6) + ["n:wide#r@hub", "n:o1#r0@hub", "n:wide#r@u1"]
    Engines(tuples).check(reqs)
    Engines(tuples, f0_max=1, l_max=1).check(reqs)


def test_batch_check_columns_too_big_falls_back():
    rng = np.random.default_rng(7)
    pair = Engines(random_tuples(rng, 10, 6, 80), interior_limit=2)
    pair.check(random_requests(rng, 10, 6))
    assert pair.teng.closure() is None


@pytest.mark.parametrize("mode", ["packed", "dense", "scatter"])
def test_device_engine_columns_match_its_tuple_path(mode):
    rng = np.random.default_rng(11)
    store = TStore()
    store.write_relation_tuples(
        *(TTuple.from_string(s) for s in random_tuples(rng, 10, 6, 70))
    )
    eng = TDevice(TManager(store), mode=mode, device="cpu")
    reqs = random_requests(rng, 10, 6, k=40)
    depths = [int(rng.integers(0, 7)) for _ in reqs]
    tuples = [TTuple.from_string(s) for s in reqs]
    cols = columns_of(reqs, TColumns)
    assert eng.batch_check_columns(cols, depths=depths) == eng.batch_check(
        tuples, depths=depths
    )
    enc = eng.encode_columns(cols)
    try:
        assert enc.requests == tuples  # materialized lazily from the columns
        assert enc.version == store.version
    finally:
        enc.release()
