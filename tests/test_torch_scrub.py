"""keto_tpu_torch's integrity scrubber vs keto_tpu's, on the CPU (the port of
tests/test_scrub.py): ``ClosureCheckEngine.scrub_residency`` and
``reset_residency``, and ``engine/scrub.py ScrubDaemon``'s device-row and
oracle-replay kinds, its repair ladder, guards, budget and history.

Both packages get the same tuple graph, in the same insertion order (so the
same interior indices), and the same seeds: a ``np.random.default_rng(seed)``
handed to ``scrub_residency`` picks the same poisoned cell and the same
sample in both, and both must report the same bad row. Tolerances: exact —
bad rows, closure bytes, answers and counts.
"""

import numpy as np
import pytest

from keto_tpu.engine import CheckEngine as JCheck
from keto_tpu.engine.closure import ClosureCheckEngine as JClosure
from keto_tpu.engine.scrub import ScrubDaemon as JDaemon
from keto_tpu.faults import FAULTS as JFAULTS
from keto_tpu.graph import SnapshotManager as JManager
from keto_tpu.relationtuple import RelationTuple as JTuple
from keto_tpu.store import InMemoryTupleStore as JStore
from keto_tpu_torch.driver import Config, Registry
from keto_tpu_torch.engine import CheckEngine as TCheck
from keto_tpu_torch.engine.cache import CheckResultCache
from keto_tpu_torch.engine.closure import ClosureCheckEngine as TClosure
from keto_tpu_torch.engine.scrub import (
    ACTION_CACHE_FLUSH,
    ACTION_RESET_RESIDENCY,
    KIND_DEVICE,
    KIND_REPLAY,
    ScrubDaemon,
)
from keto_tpu_torch.faults import FAULTS as TFAULTS
from keto_tpu_torch.graph import SnapshotManager as TManager
from keto_tpu_torch.relationtuple import RelationTuple as TTuple
from keto_tpu_torch.store import InMemoryTupleStore as TStore


@pytest.fixture(autouse=True)
def _clean_faults():
    JFAULTS.reset()
    TFAULTS.reset()
    yield
    JFAULTS.reset()
    TFAULTS.reset()


def _graph(groups=3, users=4):
    tuples = []
    for g in range(groups):
        tuples.append(f"n:doc{g}#view@(n:group{g}#member)")
        tuples += [f"n:group{g}#member@user{g}_{u}" for u in range(users)]
    tuples.append("n:group0#member@(n:group1#member)")
    tuples.append("n:group1#member@(n:group2#member)")
    return tuples


def _requests(groups=3, users=4):
    return [f"n:doc{g}#view@user{h}_{u}" for g in range(groups)
            for h in range(groups) for u in range(users)]


class Rig:
    """One package's store, closure engine and host oracle."""

    def __init__(self, pkg, query_mode="device", tuples=None):
        self.pkg = pkg
        tuples = _graph() if tuples is None else tuples
        if pkg == "jax":
            self.Tuple, self.faults = JTuple, JFAULTS
            self.store = JStore()
            self.store.write_relation_tuples(*(JTuple.from_string(s) for s in tuples))
            self.eng = JClosure(JManager(self.store), max_depth=5, query_mode=query_mode)
            self.oracle = JCheck(self.store, max_depth=5)
        else:
            self.Tuple, self.faults = TTuple, TFAULTS
            self.store = TStore()
            self.store.write_relation_tuples(*(TTuple.from_string(s) for s in tuples))
            self.eng = TClosure(TManager(self.store), max_depth=5,
                                query_mode=query_mode, device="cpu")
            self.oracle = TCheck(self.store, max_depth=5)
        self.reqs = [self.Tuple.from_string(s) for s in _requests()]

    def write(self, s):
        self.store.write_relation_tuples(self.Tuple.from_string(s))

    def daemon(self, **kw):
        kw.setdefault("interval_s", 999.0)
        kw.setdefault("sample_rows", 4096)
        kw.setdefault("seed", 3)
        if self.pkg == "jax":
            # the reference's store-backed kinds (WAL, checkpoint) read it;
            # the port has none of them yet
            cls, kw = JDaemon, {"store_fn": lambda: self.store, **kw}
        else:
            cls = ScrubDaemon
        return cls(engine_fn=lambda: self.eng, oracle_fn=lambda: self.oracle,
                   version_fn=lambda: self.store.version, **kw)

    def closure(self):
        d = self.eng._state.d_host if self.eng._state.d_host is not None else self.eng._state.d
        return np.array(d)


def _rigs(query_mode="device"):
    return [Rig("jax"), Rig("torch", query_mode)]


# -- scrub_residency ---------------------------------------------------------------


@pytest.mark.parametrize("query_mode", ["device", "host"])
@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("sample_rows", [4096, 3])
def test_bitflip_reports_the_same_bad_row_in_both_packages(query_mode, seed, sample_rows):
    reports = []
    for rig in _rigs(query_mode):
        rig.eng.batch_check(rig.reqs)
        rig.faults.arm("scrub.device_bitflip")
        reports.append(rig.eng.scrub_residency(sample_rows, np.random.default_rng(seed)))
    j, t = reports
    assert (t["sampled"], t["version"], t["bad_rows"], t["bad_rev_rows"]) == (
        j["sampled"], j["version"], j["bad_rows"], j["bad_rev_rows"]
    )
    assert t["resident"] == ("host" if query_mode == "host" else "device")
    if sample_rows == 4096:
        assert len(t["bad_rows"]) == 1  # every row sampled: detection is certain


def test_a_clean_residency_scrubs_clean_and_the_d_transpose_too():
    for rig in _rigs():
        rig.eng.batch_check(rig.reqs)
        rig.eng.reverse_artifacts()  # builds D^T, which the scrub cross-checks
        rep = rig.eng.scrub_residency(4096, np.random.default_rng(0))
        assert rep["bad_rows"] == [] and rep["bad_rev_rows"] == []
        assert rep["sampled"] == rig.eng._state.ig.m


def test_scrub_skips_while_the_residency_is_stale_or_patched():
    for rig in _rigs():
        assert rig.eng.scrub_residency(16, np.random.default_rng(0)) is None  # unbuilt
        rig.eng.batch_check(rig.reqs)
        rig.write("n:group1#member@late_joiner")
        # the store moved past the residency (the overlay absorbs the write
        # on the next check, and then holds an event)
        assert rig.eng.scrub_residency(16, np.random.default_rng(0)) is None
        rig.eng.batch_check(rig.reqs)
        assert rig.eng.scrub_residency(16, np.random.default_rng(0)) is None


def test_reset_residency_rebuilds_byte_identical():
    rig = Rig("torch")
    rig.eng.batch_check(rig.reqs)
    before = rig.closure()
    rig.write("n:group2#member@late")
    rig.eng.batch_check(rig.reqs)  # absorbed by the overlay
    assert rig.eng.scrub_residency(16, np.random.default_rng(0)) is None
    builds = rig.eng.n_full_builds
    rig.eng.reset_residency()
    assert rig.eng.n_full_builds == builds + 1
    assert rig.eng.scrub_residency(16, np.random.default_rng(0)) is not None
    fresh = TClosure(TManager(rig.store), max_depth=5, query_mode="device", device="cpu")
    fresh.batch_check(rig.reqs)
    assert np.array_equal(rig.closure(), np.array(fresh._state.d))
    assert before.shape == rig.closure().shape


# -- the daemon -------------------------------------------------------------------


def _summary(daemon, ev):
    return (ev["action"], ev.get("clean"), dict(daemon.mismatches), dict(daemon.repairs),
            daemon.cycles)


def test_bitflip_detected_and_repaired_byte_identical():
    outs = []
    for rig in _rigs():
        baseline = rig.oracle.batch_check(rig.reqs)
        assert rig.eng.batch_check(rig.reqs) == baseline
        built = rig.closure()
        daemon = rig.daemon()
        rig.faults.arm("scrub.device_bitflip")
        ev = daemon.step()
        outs.append(_summary(daemon, ev))
        assert not ev["clean"]
        assert daemon.repairs[ACTION_RESET_RESIDENCY] == 1
        assert np.array_equal(rig.closure(), built)  # the repair restored D
        assert rig.eng.batch_check(rig.reqs) == baseline
        assert daemon.step()["clean"]
        hist = daemon.history()
        assert hist and hist[0]["action"] == "cycle"
        assert KIND_DEVICE in {f.get("kind") for f in hist[0]["findings"]}
    assert outs[0] == outs[1]


def test_clean_cycles_and_disabled_daemon():
    for rig in _rigs():
        rig.eng.batch_check(rig.reqs)
        daemon = rig.daemon()
        ev = daemon.step()
        assert ev["clean"] and daemon.repairs == {} and daemon.history() == []
        assert daemon.last_clean_version == rig.store.version
        rig.write("n:group0#member@newcomer")
        daemon.step()
        assert daemon.last_clean_version == rig.store.version
        assert rig.daemon(enabled_fn=lambda: False).step()["action"] == "disabled"


def test_poisoned_replay_caught_caches_flushed_stale_entries_skipped():
    outs = []
    for rig in _rigs():
        flushed = []
        daemon = rig.daemon(cache_flush_fn=lambda: flushed.append(1))
        truth = rig.oracle.batch_check(rig.reqs)
        served = list(truth)
        served[0] = not served[0]
        daemon.observe_batch(rig.reqs, served)
        ev = daemon.step()
        assert not ev["clean"] and daemon.mismatches[KIND_REPLAY] == 1
        assert daemon.repairs[ACTION_CACHE_FLUSH] == 1 and flushed
        assert daemon.step()["clean"]  # the reservoir went with the repair
        daemon.observe_batch(rig.reqs, served)
        rig.write("n:group2#member@drive_by")  # answers at v are not v+1's
        ev2 = daemon.step()
        outs.append((_summary(daemon, ev), ev2["clean"]))
        daemon.observe_batch(rig.reqs, rig.oracle.batch_check(rig.reqs))
        assert daemon.step()["clean"]
    assert outs[0] == outs[1]


def test_reservoir_is_bounded():
    rig = Rig("torch")
    daemon = rig.daemon(reservoir=8)
    truth = rig.oracle.batch_check(rig.reqs)
    for _ in range(20):
        daemon.observe_batch(rig.reqs, truth)
    assert len(daemon._reservoir) == 8 and daemon.snapshot()["reservoir_observed"] == 20 * len(truth)


def test_guard_freeze_blocks_repairs_then_thaws():
    outs = []
    for rig in _rigs():
        rig.eng.batch_check(rig.reqs)
        frozen = [True]
        daemon = rig.daemon(guards=(lambda: "hbm_pressure" if frozen[0] else None,))
        rig.faults.arm("scrub.device_bitflip")
        ev = daemon.step()
        assert ev == {"ts": ev["ts"], "action": "frozen", "reason": "hbm_pressure"}
        daemon.step()
        assert len(daemon.history()) == 1 and daemon.repairs == {}
        frozen[0] = False
        daemon.step()
        outs.append((dict(daemon.repairs), daemon.cycles))
    assert outs[0] == outs[1] == ({ACTION_RESET_RESIDENCY: 1, ACTION_CACHE_FLUSH: 1}, 1)


def test_repair_budget_defers_the_second_repair():
    for rig in _rigs():
        rig.eng.batch_check(rig.reqs)
        daemon = rig.daemon(max_repairs_per_cycle=1)
        rig.faults.arm("scrub.device_bitflip")
        ev = daemon.step()
        assert daemon.repairs == {ACTION_RESET_RESIDENCY: 1}
        deferred = [f for f in ev["findings"] if f.get("reason") == "repair_budget"]
        assert deferred and deferred[0]["action"] == ACTION_CACHE_FLUSH


def test_the_snapshot_keys_match_the_reference():
    """Every key of the reference's snapshot, the WAL kind's included."""
    rigs = _rigs()
    snaps = [rig.daemon().snapshot() for rig in rigs]
    assert set(snaps[1]) == set(snaps[0])


def test_cache_clear_drops_entries_and_the_version_stamp():
    cache = CheckResultCache(capacity=16)
    cache.get(7, "k")
    cache.put(7, "k", True)
    assert cache.get(7, "k") is True
    cache.clear()
    assert cache.get(7, "k") is None


# -- through the registry -------------------------------------------------------------


def test_registry_scrubber_repairs_through_the_supervisor():
    """The registry's wiring: the scrubber's repair is the supervisor's
    reset_residency (a timeline event), the batcher taps the reservoir, and
    the daemon thread runs only once started."""
    reg = Registry(Config(values={
        "namespaces": [{"id": 1, "name": "n"}],
        "engine": {"query_mode": "device", "cache_size": 0},
        "scrub": {"enabled": True, "interval_s": 999, "sample_rows": 4096},
    }), device="cpu")
    reg.store().write_relation_tuples(*(TTuple.from_string(s) for s in _graph()))
    reqs = [TTuple.from_string(s) for s in _requests()]
    checker = reg.checker()
    try:
        want = TCheck(reg.store(), max_depth=5).batch_check(reqs)
        assert checker.check_batch(reqs) == want
        daemon = reg.scrubber()
        assert checker.scrub_observer == daemon.observe_batch
        assert daemon.snapshot()["running"] is False
        assert checker.check_batch(reqs) == want  # tapped
        assert daemon.snapshot()["reservoir_size"] == len(reqs)
        TFAULTS.arm("scrub.device_bitflip")
        ev = daemon.step()
        assert not ev["clean"]
        events = [e["event"] for e in reg.device_supervisor().status()["timeline"]]
        assert events == ["scrub_reset_residency"]
        assert checker.check_batch(reqs) == want
        assert daemon.step()["clean"]
    finally:
        checker.close()
