"""The generator: the configurations' pool sizes and edge mixes, and the
same graph for the same seed."""

import numpy as np
import pytest

from portbench.graph import Layout, generate
from portbench.tests.conftest import load, small_config


def test_rbac1m_pools_are_gen_rbac_sizes():
    cfg = load("configs/rbac1m.json")
    n = cfg["tuples"]
    sizes = {p["name"]: p["count"] for p in cfg["pools"]}
    n_groups = min(max(n // 100, 20), 20_000)
    assert sizes == {"users": max(n // 10, 100), "groups": n_groups,
                     "roles": min(max(n_groups // 10, 5), 2_000),
                     "resources": max(n // 3, 50)}
    assert cfg["reduced"] == []


def test_github10m_pools_are_gen_github_sizes():
    cfg = load("configs/github10m.json")
    n = cfg["tuples"]
    sizes = {p["name"]: p["count"] for p in cfg["pools"]}
    assert sizes == {"users": max(n // 8, 100), "teams": min(max(n // 400, 20), 25_000),
                     "repos": max(n // 3, 50)}
    repos = next(p for p in cfg["pools"] if p["name"] == "repos")
    assert repos["relations"] == ["pull", "triage", "push", "maintain", "admin"]  # GitHub's five


@pytest.mark.parametrize("name,scale", [("rbac1m", 0.01), ("github10m", 0.001)])
def test_edge_mix_and_count(name, scale):
    cfg = small_config(name, scale)
    g = generate(cfg, 2**40 + 7)
    n = cfg["tuples"]
    assert len(g.src) == n
    keys = g.src * g.layout.n_nodes + g.dst
    assert len(np.unique(keys)) == n
    for i, ec in enumerate(cfg["edges"]):
        got = int((g.cls == i).sum())
        if ec.get("fill"):
            continue
        k = min(int(n * ec["share"]), ec.get("cap", 1 << 62))
        pairs = g.layout.by_name[ec["src"]].size * sum(
            g.layout.by_name[p].size for p in ec["dst"])
        want = pairs * (1 - (1 - 1 / pairs) ** k)  # distinct among k draws
        assert want - 4 * want ** 0.5 - 1 <= got <= k, (ec["name"], got, want)
        sp = g.layout.by_name[ec["src"]]
        s = g.src[g.cls == i]
        assert ((s >= sp.offset) & (s < sp.offset + sp.size)).all()


def test_dst_weights():
    cfg = small_config("github10m", 0.002)
    g = generate(cfg, 11)
    s, d = g.edges_of("grant")
    teams = g.layout.by_name["teams"]
    share = ((d >= teams.offset) & (d < teams.offset + teams.size)).mean()
    assert 0.78 < share < 0.82


def test_same_seed_same_graph_other_seed_other_graph():
    cfg = small_config("rbac1m", 0.005)
    a, b, c = generate(cfg, -3), generate(cfg, -3), generate(cfg, 5)
    assert np.array_equal(a.src, b.src) and np.array_equal(a.dst, b.dst)
    assert not np.array_equal(a.src, c.src)


def test_keys():
    lay = Layout(load("configs/github10m.json")["pools"])
    repos = lay.by_name["repos"]
    node = lay.node("repos", 12, "push")
    assert lay.key(node) == ("gh", "repo12", "push")
    assert lay.keys(np.array([node, lay.node("users", 7), node])) == [
        ("gh", "repo12", "push"), ("u7",), ("gh", "repo12", "push")]
    assert repos.size == 5 * repos.count
