"""The traffic generator and the loop kinds: rows fixed by the seed with
exact counts per share, and each request's rows drawn again by the judge
as the client sent them."""

import json

import numpy as np
import pytest

from portbench.graph import generate, rng_for
from portbench.loops import closed_batch, closed_check, load
from portbench.reference import SetGraph
from portbench.tests.conftest import load as load_file
from portbench.tests.conftest import small_config
from portbench.traffic import STREAM_ROWS, RowSampler, check_path, columnar_body, share_counts


def test_share_counts_exact():
    assert share_counts([0.25, 0.0625, 0.6875], 4096) == [1024, 256, 2816]
    assert sum(share_counts([1 / 3, 1 / 3, 1 / 3], 100)) == 100


def test_rows_exact_shares_and_chains():
    cfg = small_config("github10m", 0.001)
    g = generate(cfg, 77)
    tr = load_file("traffic/batch_collab.json")
    sampler = RowSampler(g, cfg["check"], tr["rows"])
    s1, t1 = sampler.draw(rng_for(5, 1, 0, 0), 4096)
    s2, t2 = sampler.draw(rng_for(5, 1, 0, 0), 4096)
    assert np.array_equal(s1, s2) and np.array_equal(t1, t2)
    lay = g.layout
    assert all(lay.key(int(s))[2] == "pull" for s in s1[:200])
    assert all(len(lay.key(int(t))) == 1 for t in t1[:200])
    # the direct-collaborator rows are grant edges to users: 256 of them
    gs, gd = g.edges_of("grant")
    edges = set(zip(gs.tolist(), gd.tolist()))
    direct = sum((int(s), int(t)) in edges for s, t in zip(s1, t1))
    assert direct >= 256


@pytest.fixture(scope="module")
def rbac():
    cfg = small_config("rbac1m", 0.003)
    g = generate(cfg, 3)
    tr = load_file("traffic/check.json")
    return g.layout, RowSampler(g, cfg["check"], tr["rows"]), tr, g


@pytest.mark.parametrize("seed", [1, 2**33 + 5, -17])
def test_single_check_chunks_hold_exact_shares(rbac, seed):
    lay, sampler, tr, g = rbac
    rows = [closed_check.request_rows(sampler, seed, tr, STREAM_ROWS, 3, i)
            for i in range(closed_check.CHUNK_ROWS)]
    s = np.concatenate([r[0] for r in rows])
    t = np.concatenate([r[1] for r in rows])
    s2, t2 = sampler.draw(rng_for(seed, STREAM_ROWS, 3, 0), closed_check.CHUNK_ROWS)
    assert np.array_equal(s, s2) and np.array_equal(t, t2)
    # a quarter of every chunk walks a real grant -> member chain: allowed
    # in two edges
    ref = SetGraph(lay.n_nodes, g.src, g.dst, lay.is_set(np.arange(lay.n_nodes)))
    assert sum(ref.check(int(a), int(b), 2) for a, b in zip(s, t)) >= closed_check.CHUNK_ROWS // 4


def test_the_judge_draws_what_each_client_sent(rbac):
    """``request_rows`` gives the rows of the request a client built."""
    lay, sampler, tr, _ = rbac
    plan = {"sampler": sampler, "seed": 11, "layout": lay, "traffic": tr}
    prep = closed_check._prepare(plan, STREAM_ROWS)
    for i in (0, 1, 255, 256, 700):
        s, t = closed_check.request_rows(sampler, 11, tr, STREAM_ROWS, 2, i)
        assert prep(2, i) == ("GET", check_path(lay, int(s[0]), int(t[0])), None, 1)
    btr = {**tr, "batch_rows": 64}
    plan["traffic"] = btr
    method, path, body, rows = closed_batch._prepare(plan, STREAM_ROWS)(1, 5)
    s, t = closed_batch.request_rows(sampler, 11, btr, STREAM_ROWS, 1, 5)
    assert (method, path, rows) == ("POST", "/check/batch", 64)
    assert json.loads(body) == columnar_body(lay, s, t)


def test_loops_are_found_by_name_and_split_their_clients():
    for name, tr in (("closed_check", load_file("traffic/check.json")),
                     ("closed_batch", load_file("traffic/batch_collab.json"))):
        mod = load(name)
        plans = mod.client_plans(tr)
        n = tr.get("connections", tr.get("clients"))
        assert len(plans) == tr["procs"]
        assert sorted(c for p in plans for c in p["clients"]) == list(range(n))
