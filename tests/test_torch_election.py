"""keto_tpu_torch's lease election against keto_tpu's, on the CPU.

The cases of ``tests/test_election.py`` run for both packages under one
``FakeClock`` script, each package over its own temporary directory, with
the reference's assertions: the lease store's CAS, renewals, releases and
lineage; the fencing across clock skew (the double-leader window); the
election manager's campaigns, fencing, retargets, failed promotions
(``replica.promote_fail``) and premature candidacies
(``election.split_heartbeat``), candidacy ranking and status. Each scenario
returns its trace (terms, lineage records, transitions, status documents),
and the two packages' traces must be equal. Then the packages share one
directory: a lease one package writes is fenced by a term the other takes.
Tolerance: exact (the clocks are scripted).
"""

from __future__ import annotations

import json
import os
from types import SimpleNamespace

import pytest

import keto_tpu.cluster.election as jelection
import keto_tpu.faults as jfaults
import keto_tpu_torch.cluster.election as telection
import keto_tpu_torch.faults as tfaults

PKGS = {
    "torch": SimpleNamespace(election=telection, FAULTS=tfaults.FAULTS),
    "jax": SimpleNamespace(election=jelection, FAULTS=jfaults.FAULTS),
}


class FakeClock:
    def __init__(self, t: float = 1_000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@pytest.fixture(autouse=True)
def _reset_faults():
    for p in PKGS.values():
        p.FAULTS.reset()
    yield
    for p in PKGS.values():
        p.FAULTS.reset()


def manager(pkg, store, instance_id, clock, **kw):
    kw.setdefault("lease_ttl_s", 3.0)
    kw.setdefault("heartbeat_interval_s", 0.01)
    return pkg.election.ElectionManager(store, instance_id=instance_id, clock=clock, **kw)


def both(tmp_path, scenario):
    """``scenario(pkg, directory)`` for each package, each over a directory
    of its own; the two traces must be equal."""
    out = []
    for name in ("torch", "jax"):
        d = tmp_path / name
        d.mkdir()
        out.append(json.loads(json.dumps(scenario(PKGS[name], str(d)), default=str)))
    assert out[0] == out[1]
    return out[0]


def _lineage(store) -> list:
    return [{k: r[k] for k in ("term", "leader_id", "prev_term", "prev_leader_id", "at")}
            for r in store.lineage()]


# -- the lease store --------------------------------------------------------------


def test_vacant_acquire_mints_term_one(tmp_path):
    def scenario(pkg, d):
        clock = FakeClock()
        store = pkg.election.LeaseStore(d, clock=clock)
        lease = store.acquire("a", 3.0, write_url="http://a:1")
        assert lease["term"] == 1 and lease["leader_id"] == "a"
        assert store.fence_check("a", 1)
        lineage = store.lineage()
        assert [r["term"] for r in lineage] == [1] and lineage[0]["prev_leader_id"] is None
        return lease, _lineage(store)

    both(tmp_path, scenario)


def test_live_lease_blocks_other_candidates(tmp_path):
    def scenario(pkg, d):
        clock = FakeClock()
        store = pkg.election.LeaseStore(d, clock=clock)
        assert store.acquire("a", 3.0) is not None
        assert store.acquire("b", 3.0) is None
        clock.advance(3.5)  # ...until it expires
        lease = store.acquire("b", 3.0)
        assert lease is not None and lease["term"] == 2
        return lease, _lineage(store)

    both(tmp_path, scenario)


def test_renew_extends_and_fences(tmp_path):
    def scenario(pkg, d):
        clock = FakeClock()
        store = pkg.election.LeaseStore(d, clock=clock)
        store.acquire("a", 3.0)
        clock.advance(2.0)
        renewed = store.renew("a", 1, 3.0)
        assert renewed["expires_at"] == pytest.approx(clock() + 3.0)
        clock.advance(3.5)
        store.acquire("b", 3.0)
        # a newer term on disk fences the old leader's renewal
        assert store.renew("a", 1, 3.0) is None
        return renewed, store.read()

    both(tmp_path, scenario)


def test_release_expires_immediately(tmp_path):
    def scenario(pkg, d):
        clock = FakeClock()
        store = pkg.election.LeaseStore(d, clock=clock)
        store.acquire("a", 300.0)
        assert store.release("a", 1)
        assert not store.fence_check("a", 1)
        lease = store.acquire("b", 3.0)  # no wait for the 300 s TTL
        assert lease["term"] == 2
        assert not store.release("a", 1)  # a stale term is a no-op
        return lease, _lineage(store)

    both(tmp_path, scenario)


def test_corrupt_lease_reads_as_vacant(tmp_path):
    def scenario(pkg, d):
        clock = FakeClock()
        store = pkg.election.LeaseStore(d, clock=clock)
        store.acquire("a", 3.0)
        with open(os.path.join(d, pkg.election.LEASE_FILE), "w") as f:
            f.write("{half a lease")
        assert store.read() is None
        # vacancy only delays an election: the next acquire wins
        lease = store.acquire("b", 3.0)
        assert lease["term"] == 1
        return lease, _lineage(store)

    both(tmp_path, scenario)


def test_lineage_is_strictly_increasing(tmp_path):
    def scenario(pkg, d):
        clock = FakeClock()
        store = pkg.election.LeaseStore(d, clock=clock)
        for i, who in enumerate(["a", "b", "a", "c"]):
            clock.advance(10.0)
            assert store.acquire(who, 3.0)["term"] == i + 1
        assert [r["term"] for r in store.lineage()] == [1, 2, 3, 4]
        assert [r["prev_term"] for r in store.lineage()] == [0, 1, 2, 3]
        return _lineage(store)

    both(tmp_path, scenario)


# -- fencing across clock skew ----------------------------------------------------


def test_stale_ex_leader_is_fenced_despite_skew(tmp_path):
    def scenario(pkg, d):
        # A's clock runs 20 s behind B's: by A's reckoning its lease lives on
        clock_a, clock_b = FakeClock(1_000.0), FakeClock(1_020.0)
        store_a = pkg.election.LeaseStore(d, clock=clock_a)
        store_b = pkg.election.LeaseStore(d, clock=clock_b)
        lease = store_a.acquire("a", 10.0)
        takeover = store_b.acquire("b", 10.0)
        assert takeover["term"] == 2
        # terms are compared before expiry: A is rejected
        assert clock_a() < lease["expires_at"]
        assert not store_a.fence_check("a", 1) and store_b.fence_check("b", 2)
        return lease, takeover

    both(tmp_path, scenario)


def test_exactly_one_writer_throughout_the_window(tmp_path):
    def scenario(pkg, d):
        clock_a, clock_b = FakeClock(1_000.0), FakeClock(1_020.0)
        store_a = pkg.election.LeaseStore(d, clock=clock_a)
        store_b = pkg.election.LeaseStore(d, clock=clock_b)
        store_a.acquire("a", 10.0)
        trace = [(store_a.fence_check("a", 1), store_b.fence_check("b", 1))]
        store_b.acquire("b", 10.0)
        trace.append((store_a.fence_check("a", 1), store_b.fence_check("b", 2)))
        assert trace == [(True, False), (False, True)]
        return trace

    both(tmp_path, scenario)


def test_manager_write_gate_rejects_late_writes(tmp_path):
    def scenario(pkg, d):
        clock_a, clock_b = FakeClock(1_000.0), FakeClock(1_020.0)
        store_a = pkg.election.LeaseStore(d, clock=clock_a)
        store_b = pkg.election.LeaseStore(d, clock=clock_b)
        em = manager(pkg, store_a, "a", clock_a, write_url="http://a:1")
        assert em.ensure_leadership() and em.is_writable()
        store_b.acquire("b", 10.0, write_url="http://b:1")
        assert not em.is_writable()  # no cached verdict
        hint = em.leader_hint()
        assert hint == {"leader_id": "b", "term": 2, "read_url": "",
                        "write_url": "http://b:1"}
        return hint, em.status()

    both(tmp_path, scenario)


# -- the election manager ---------------------------------------------------------


def test_campaign_wins_vacant_lease_and_promotes(tmp_path):
    def scenario(pkg, d):
        clock = FakeClock()
        store = pkg.election.LeaseStore(d, clock=clock)
        promoted = []
        em = manager(pkg, store, "b", clock,
                     promote_fn=lambda: promoted.append(True) or {"applied": 0})
        em.run_once()
        assert em.role == "leader" and em.term == 1 and promoted == [True]
        assert em.is_writable() and em.leader_hint() is None
        return em.status(), _lineage(store)

    both(tmp_path, scenario)


def test_fenced_leader_steps_down_and_retargets(tmp_path):
    def scenario(pkg, d):
        clock = FakeClock()
        store = pkg.election.LeaseStore(d, clock=clock)
        retargets = []
        em = manager(pkg, store, "a", clock, write_url="http://a:1",
                     retarget_fn=retargets.append)
        assert em.ensure_leadership()
        clock.advance(10.0)
        store.acquire("b", 3.0, write_url="http://b:1")
        em.run_once()
        assert em.role == "follower" and em.term == 0
        assert "fenced by b" in em.last_transition["reason"]
        assert [r["write_url"] for r in retargets] == ["http://b:1"]
        return em.status(), retargets

    both(tmp_path, scenario)


def test_failed_promotion_releases_and_reelects(tmp_path):
    def scenario(pkg, d):
        clock = FakeClock()
        store = pkg.election.LeaseStore(d, clock=clock)
        promoted = []
        em = manager(pkg, store, "b", clock, promote_fn=lambda: promoted.append(True) or {})
        pkg.FAULTS.arm("replica.promote_fail")
        em.run_once()
        # released, not left to bake out its TTL
        assert em.role == "follower"
        assert "promotion failed" in em.last_transition["reason"]
        assert not store.fence_check("b", 1) and promoted == []
        first = em.status()
        em.run_once()  # the next tick re-elects with a new term
        assert em.role == "leader" and em.term == 2 and promoted == [True]
        assert [r["term"] for r in store.lineage()] == [1, 2]
        return first, em.status(), _lineage(store), pkg.FAULTS.fired("replica.promote_fail")

    both(tmp_path, scenario)


def test_split_heartbeat_cannot_mint_a_second_term(tmp_path):
    def scenario(pkg, d):
        clock = FakeClock()
        store = pkg.election.LeaseStore(d, clock=clock)
        assert store.acquire("a", 30.0) is not None
        em = manager(pkg, store, "b", clock)
        pkg.FAULTS.arm("election.split_heartbeat")
        em.run_once()  # a false suspicion: a premature campaign
        assert em.role == "follower" and em.observed_term == 1
        assert [r["term"] for r in store.lineage()] == [1]
        em.run_once()  # the fault drained: a normal tick follows
        assert em.role == "follower"
        return em.status(), _lineage(store), pkg.FAULTS.fired("election.split_heartbeat")

    both(tmp_path, scenario)


def test_candidacy_rank_orders_by_priority_then_position(tmp_path):
    def scenario(pkg, d):
        clock = FakeClock()
        store = pkg.election.LeaseStore(d, clock=clock)
        em = manager(pkg, store, "b", clock, position_fn=lambda: 50)
        em.observe_peers({"members": [
            {"instance_id": "L", "role": "leader", "alive": True, "version": 999},
            {"instance_id": "c", "alive": True, "version": 80, "election": {"priority": 0}},
            {"instance_id": "d", "alive": False, "version": 500,
             "election": {"priority": 5}},
            {"instance_id": "e", "alive": True, "version": 10, "election": {"priority": 0}},
        ]})
        ranks = [em.candidacy_rank()]
        em.priority = 1  # priority trumps position
        ranks.append(em.candidacy_rank())
        assert ranks == [1, 0]
        return ranks

    both(tmp_path, scenario)


def test_rank_ties_break_on_instance_id(tmp_path):
    def scenario(pkg, d):
        clock = FakeClock()
        store = pkg.election.LeaseStore(d, clock=clock)
        em = manager(pkg, store, "b", clock, position_fn=lambda: 50)
        em.observe_peers({"members": [
            {"instance_id": "a", "alive": True, "version": 50, "election": {"priority": 0}},
            {"instance_id": "c", "alive": True, "version": 50, "election": {"priority": 0}},
        ]})
        assert em.candidacy_rank() == 1
        return em.candidacy_rank()

    both(tmp_path, scenario)


def test_clean_stop_releases_for_fast_failover(tmp_path):
    def scenario(pkg, d):
        clock = FakeClock()
        store = pkg.election.LeaseStore(d, clock=clock)
        em = manager(pkg, store, "a", clock)
        assert em.ensure_leadership()
        em.stop(release=True)
        lease = store.acquire("b", 3.0)  # no wait for the TTL
        assert lease["term"] == 2
        return lease

    both(tmp_path, scenario)


def test_status_surfaces_term_and_lease(tmp_path):
    def scenario(pkg, d):
        clock = FakeClock()
        store = pkg.election.LeaseStore(d, clock=clock)
        em = manager(pkg, store, "a", clock)
        assert em.ensure_leadership()
        doc = em.status()
        assert doc["role"] == "leader" and doc["term"] == 1 and doc["observed_term"] == 1
        assert doc["leader_id"] == "a" and doc["transitions"] == 1
        assert doc["lease_expires_in_s"] == pytest.approx(3.0)
        assert doc["last_transition"]["reason"] == "bootstrap"
        return doc

    both(tmp_path, scenario)


def test_election_metrics_families(tmp_path):
    """keto_election_{term,is_leader,transitions_total} after one script."""
    import keto_tpu.telemetry.metrics as jmetrics
    import keto_tpu_torch.telemetry.metrics as tmetrics

    metrics_of = {"torch": tmetrics, "jax": jmetrics}

    def scenario(pkg, d):
        name = "torch" if pkg is PKGS["torch"] else "jax"
        clock = FakeClock()
        m = metrics_of[name].MetricsRegistry()
        store = pkg.election.LeaseStore(d, clock=clock)
        em = manager(pkg, store, "a", clock, metrics=m)
        em.ensure_leadership()
        clock.advance(10.0)
        store.acquire("b", 3.0)
        em.run_once()
        return [line for line in m.expose().splitlines() if "keto_election_" in line]

    lines = both(tmp_path, scenario)
    assert "keto_election_term 2.0" in lines and "keto_election_is_leader 0.0" in lines


# -- both packages over one directory ---------------------------------------------


@pytest.mark.parametrize("first,second", [("torch", "jax"), ("jax", "torch")])
def test_packages_share_one_lease_directory(tmp_path, first, second):
    """A lease one package writes is read, respected and then fenced by the
    other: the files are one format, so a mixed fleet keeps one lineage."""
    clock = FakeClock()
    a = PKGS[first].election.LeaseStore(str(tmp_path), clock=clock)
    b = PKGS[second].election.LeaseStore(str(tmp_path), clock=clock)
    em = manager(PKGS[first], a, "a", clock, write_url="http://a:1")
    assert em.ensure_leadership() and em.is_writable()
    assert b.acquire("b", 3.0) is None  # a live lease blocks the other package
    clock.advance(3.5)
    assert b.acquire("b", 3.0, write_url="http://b:1")["term"] == 2
    assert not em.is_writable()
    assert em.leader_hint()["write_url"] == "http://b:1"
    assert [r["term"] for r in a.lineage()] == [r["term"] for r in b.lineage()] == [1, 2]
