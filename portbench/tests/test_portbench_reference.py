"""The reference against the port's host CheckEngine (a breadth-first
search over the store) on a small generated graph; the reference itself
imports nothing of the port."""

import numpy as np
import pytest

from portbench.graph import generate, rng_for
from portbench.reference import SetGraph
from portbench.tests.conftest import small_config
from portbench.traffic import RowSampler


def _tuple(lay, s, t):
    from keto_tpu_torch.relationtuple import RelationTuple, SubjectID, SubjectSet

    ns, obj, rel = lay.key(int(s))
    sub = lay.key(int(t))
    subject = SubjectID(id=sub[0]) if len(sub) == 1 else SubjectSet(*sub)
    return RelationTuple(namespace=ns, object=obj, relation=rel, subject=subject)


@pytest.mark.parametrize("name,scale", [("rbac1m", 0.003), ("github10m", 0.0003)])
def test_reference_equals_port_check_engine(name, scale):
    from keto_tpu_torch.engine import CheckEngine
    from keto_tpu_torch.store import ColumnarTupleStore

    cfg = small_config(name, scale)
    g = generate(cfg, 1234)
    lay = g.layout
    store = ColumnarTupleStore()
    store.bulk_load_edges(lay.keys(g.src), lay.keys(g.dst))
    ref = SetGraph(lay.n_nodes, g.src, g.dst, lay.is_set(np.arange(lay.n_nodes)))
    rows = [{"share": 0.5, "path": ["grant", "membership"]}, {"share": 0.5}]
    starts, targets = RowSampler(g, cfg["check"], rows).draw(rng_for(3, 1), 150)
    # subject-set rows too: the grant edges' own tuples and other set pairs
    sel = g.layout.is_set(g.dst)
    starts = np.concatenate([starts, g.src[sel][:50], g.src[sel][50:100]])
    targets = np.concatenate([targets, g.dst[sel][:50], g.dst[sel][100:150]])
    allowed = 0
    for depth in (1, 2, 3, 5):
        eng = CheckEngine(store, max_depth=depth)
        for s, t in zip(starts, targets):
            want = eng.subject_is_allowed(_tuple(lay, s, t))
            assert ref.check(int(s), int(t), depth) == want, (lay.key(int(s)), lay.key(int(t)), depth)
            allowed += want
    assert allowed > 20


def test_direct_edges_decide_membership():
    cfg = small_config("rbac1m", 0.003)
    g = generate(cfg, 9)
    lay = g.layout
    ref = SetGraph(lay.n_nodes, g.src, g.dst, lay.is_set(np.arange(lay.n_nodes)))
    s, d = g.edges_of("membership")
    grp, user = int(s[0]), int(d[0])
    # a group's members are its direct members alone: the edge decides it
    assert ref.check(grp, user, 1) and ref.check(grp, user, 5)
    assert not ref.check(grp, user, 0)
    others = set(d[s == grp].tolist())
    new_user = next(lay.node("users", i) for i in range(1000) if lay.node("users", i) not in others)
    assert not ref.check(grp, new_user, 5)
