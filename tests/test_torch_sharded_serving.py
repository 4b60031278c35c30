"""keto_tpu_torch's sharded serving tier vs keto_tpu's, on the CPU.

The port's ``ShardedServingEngine`` on an 8-stripe ``[cpu] * 8`` mesh, the
reference's on JAX's 8 virtual CPU devices, fed the same stores and
requests (``tests/test_sharded_serving.py``'s cases): the parity fuzz over
every mesh shape, the path through ``CheckBatcher`` and the breaker,
overflow escalating to the host oracle, the incremental re-shard after a
write, mesh-shape errors, the breaker answering through the oracle on
``shard.launch_fail``, and HBM admission's per-shard model. Compared:
allowed bitmaps, each stripe's CSR arrays and D (byte-equal),
``overflow_stats``, ``shard_bytes()``, the re-shard counts, and the values
of ``keto_shard_*`` after the same batches. Then the registry: both
packages' ``Registry`` with ``engine.mode: sharded`` and with
``engine.sharding.enabled`` on 8 stripes, the escalation-budget knob, and
the one-device fall-through with the reference's log line. Tolerance:
exact.
"""

import logging
import time

import numpy as np
import pytest
import torch

from keto_tpu.driver import Config as JConfig
from keto_tpu.driver import Registry as JRegistry
from keto_tpu.engine import CheckEngine as JCheck
from keto_tpu.engine import hbm as jhbm
from keto_tpu.engine.batcher import CheckBatcher as JBatcher
from keto_tpu.engine.fallback import DeviceFallbackEngine as JBreaker
from keto_tpu.faults import FAULTS as JFAULTS
from keto_tpu.parallel.serving import ShardedServingEngine as JServing
from keto_tpu.telemetry import MetricsRegistry as JMetrics
from keto_tpu_torch.driver import Config as TConfig
from keto_tpu_torch.driver import Registry as TRegistry
from keto_tpu_torch.engine import CheckEngine as TCheck
from keto_tpu_torch.engine import hbm as thbm
from keto_tpu_torch.engine.batcher import CheckBatcher as TBatcher
from keto_tpu_torch.engine.fallback import DeviceFallbackEngine as TBreaker
from keto_tpu_torch.faults import FAULTS as TFAULTS
from keto_tpu_torch.parallel import make_mesh
from keto_tpu_torch.parallel.serving import ShardedServingEngine as TServing
from keto_tpu_torch.relationtuple import RelationTuple as TTuple
from keto_tpu_torch.telemetry import MetricsRegistry as TMetrics
from tests.test_torch_sharded import (
    CPU8,
    MESH_SHAPES,
    WIDE_REQUESTS,
    _wide_tuples,
    equal_answers,
    jax_devices,
    meshes,
    sides,
)


@pytest.fixture(autouse=True)
def _clean_faults():
    JFAULTS.reset()
    TFAULTS.reset()
    yield
    JFAULTS.reset()
    TFAULTS.reset()


# multi-byte vocab: the tier encodes and decodes ids against the snapshot
# vocab, and such keys must survive the round trip
_UNI_OBJS = ["документ", "予約-α", "ficha-ñ", "plain"]
_UNI_USERS = ["алиса", "ユーザー1", "böb", "mallory"]


def fuzz_tuples(rng, n_edges=300) -> list[str]:
    tuples = set()
    for _ in range(n_edges):
        obj = f"o{rng.integers(20)}"
        rel = f"r{rng.integers(3)}"
        if rng.random() < 0.45:
            sub = f"n:o{rng.integers(20)}#r{rng.integers(3)}"
        else:
            sub = f"u{rng.integers(12)}"
        tuples.add(f"n:{obj}#{rel}@({sub})")
    # a unicode spine, with a cycle through the multi-byte nodes
    for i, (o, u) in enumerate(zip(_UNI_OBJS, _UNI_USERS)):
        tuples.add(f"n:{o}#view@({u})")
        tuples.add(f"n:o{i}#r0@(n:{o}#view)")
    tuples.add(f"n:{_UNI_OBJS[0]}#view@(n:{_UNI_OBJS[1]}#view)")
    tuples.add(f"n:{_UNI_OBJS[1]}#view@(n:{_UNI_OBJS[0]}#view)")
    return sorted(tuples)


def fuzz_requests(rng, n=96) -> list[str]:
    reqs = []
    for _ in range(n):
        roll = rng.random()
        if roll < 0.15:
            obj, rel = _UNI_OBJS[rng.integers(len(_UNI_OBJS))], "view"
            sub = _UNI_USERS[rng.integers(len(_UNI_USERS))]
        else:
            obj, rel = f"o{rng.integers(20)}", f"r{rng.integers(3)}"
            sub = (f"(n:o{rng.integers(20)}#r{rng.integers(3)})" if roll < 0.4
                   else f"u{rng.integers(12)}")
        reqs.append(f"n:{obj}#{rel}@{sub}")
    return reqs


def engines(pair, shape, jmetrics=None, tmetrics=None, **kw):
    jm, tm = meshes(shape)
    return (JServing(pair[0].mgr, mesh=jm, max_depth=5, metrics=jmetrics, **kw),
            TServing(pair[1].mgr, mesh=tm, max_depth=5, metrics=tmetrics, **kw))


def assert_host_equal(jeng, teng):
    """The host artifacts of the last re-shard byte-equal: D and each
    stripe's CSR arrays and interior index."""
    jh, th = jeng._host, teng._host
    assert th["m_pad"] == jh["m_pad"] and th["n_dirty"] == jh["n_dirty"]
    assert th["shards"] == jh["shards"]
    assert th["d"].dtype == jh["d"].dtype and np.array_equal(th["d"], jh["d"])
    for name in ("f0", "l", "out"):
        for got, want in zip(th[name], jh[name]):
            assert got.dtype == want.dtype and np.array_equal(got, want), name
    assert np.array_equal(th["int"], jh["int"])
    assert teng.shard_bytes() == jeng.shard_bytes()
    assert teng.overflow_stats == jeng.overflow_stats


def shard_families(metrics) -> list[str]:
    return sorted(line for line in metrics.expose().splitlines()
                  if line.startswith("keto_shard_"))


def encode(snap, tuples):
    start = np.array([snap.node_for_set(r.namespace, r.object, r.relation) for r in tuples],
                     dtype=np.int64)
    target = np.array([snap.node_for_subject(r.subject) for r in tuples], dtype=np.int64)
    return start, target


def batcher(pkg, engine, store):
    Breaker, Check, Batcher = ((JBreaker, JCheck, JBatcher) if pkg == "jax"
                               else (TBreaker, TCheck, TBatcher))
    breaker = Breaker(engine, fallback_factory=lambda: Check(store, max_depth=5),
                      failure_threshold=3, cooldown_s=0.1)
    return Batcher(breaker, max_batch=256, window_s=0.0)


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_serving_parity_fuzz(shape):
    """batch_check over a fuzzed store with a unicode vocab and cycles, in
    every mesh shape and with a depth vector: the allowed bitmaps, the host
    artifacts, shard_bytes(), overflow_stats and the shard families equal."""
    rng = np.random.default_rng(11)
    pair = sides(fuzz_tuples(rng))
    jmet, tmet = JMetrics(), TMetrics()
    engs = engines(pair, shape, jmet, tmet)
    reqs = fuzz_requests(rng)
    for depths in (None, [1 + (i % 5) for i in range(len(reqs))]):
        equal_answers(engs, pair, reqs, depths=depths)
    assert_host_equal(*engs)
    assert shard_families(tmet) == shard_families(jmet)
    assert any(line.startswith("keto_shard_residency_bytes") for line in shard_families(tmet))


def test_serving_through_the_check_batcher_encoded():
    """The production route: CheckBatcher.check_batch_encoded over the
    breaker-wrapped serving engine, and the string path on the same seam."""
    rng = np.random.default_rng(12)
    pair = sides(fuzz_tuples(rng))
    engs = engines(pair, (2, 4))
    reqs = fuzz_requests(rng, n=64)
    outs = []
    for pkg, eng, side in zip(("jax", "torch"), engs, pair):
        b = batcher(pkg, eng, side.store)
        try:
            tuples = side.tuples(reqs)
            want = side.oracle.batch_check(tuples)
            start, target = encode(side.mgr.snapshot(), tuples)
            assert b.check_batch_encoded(start, target) == want
            assert b.check_batch(tuples) == want
            outs.append(want)
        finally:
            b.close()
    assert outs[1] == outs[0]
    assert engs[1].overflow_stats == engs[0].overflow_stats


def test_serving_overflow_escalates_to_the_host_oracle():
    """Rows past even the escalated widths reach the host oracle and stay
    exact; the escalation counters, the budget breaches and the families
    move alike in both packages."""
    pair = sides(_wide_tuples())
    jmet, tmet = JMetrics(), TMetrics()
    wide = engines(pair, (1, 8), jmet, tmet)
    assert equal_answers(wide, pair, WIDE_REQUESTS) == [True, True, False]
    assert wide[1].overflow_stats == wide[0].overflow_stats
    assert wide[1].overflow_stats["escalated"] > 0
    assert wide[1].overflow_stats["host_fallback"] == 0
    jmet2, tmet2 = JMetrics(), TMetrics()
    narrow = engines(pair, (1, 8), jmet2, tmet2, f0_max_escalated=64, l_max_escalated=64,
                     escalation_budget=0.01)
    assert equal_answers(narrow, pair, WIDE_REQUESTS) == [True, True, False]
    assert narrow[1].overflow_stats == narrow[0].overflow_stats
    assert narrow[1].overflow_stats["host_fallback"] > 0
    assert narrow[1].n_budget_breaches == narrow[0].n_budget_breaches > 0
    for jm, tm in ((jmet, tmet), (jmet2, tmet2)):
        assert shard_families(tm) == shard_families(jm)
    assert any('path="host_oracle"' in line for line in shard_families(tmet2))


def test_a_write_reshards_incrementally_and_reuses_the_residency():
    """An append-only write re-shards incrementally (dirty rows and the
    affected stripes only), not from scratch, and stays exact; the port
    keeps the tensors of every untouched stripe."""
    rng = np.random.default_rng(13)
    pair = sides(fuzz_tuples(rng))
    jmet, tmet = JMetrics(), TMetrics()
    engs = engines(pair, (2, 4), jmet, tmet)
    reqs = fuzz_requests(rng, n=48)
    equal_answers(engs, pair, reqs)
    assert [e.n_full_reshards for e in engs] == [1, 1]
    assert [e.n_incremental_reshards for e in engs] == [0, 0]
    before = engs[1]._resident[3]
    # an append-only delta touching interior rows (set -> set edges)
    for side in pair:
        side.write("n:o1#r0@(n:o2#r1)", "n:o2#r1@(n:o3#r2)", "n:o3#r2@zoe")
    equal_answers(engs, pair, reqs + ["n:o1#r0@zoe"])
    for eng in engs:
        assert (eng.n_full_reshards, eng.n_incremental_reshards) == (1, 1)
    assert engs[1].last_reshard == engs[0].last_reshard
    assert engs[1].last_reshard["kind"] == "incremental"
    assert engs[1].last_reshard["dirty_rows"] >= 1
    assert_host_equal(*engs)
    assert shard_families(tmet) == shard_families(jmet)
    after = engs[1]._resident[3]
    touched = set(engs[1].last_reshard["shards"])
    assert after.tensors["int"] is before.tensors["int"]  # the same interior set
    for name in ("f0_ip", "out_ip"):
        for (k, dev), tensor in after.tensors[name].items():
            if after.host[name] is before.host[name]:
                assert tensor is before.tensors[name][(k, dev)]
    assert touched


def test_mesh_shape_validation_errors():
    for kw in ({"data": 3, "edge": 3}, {"data": 16, "edge": 1}):
        from keto_tpu.parallel import make_mesh as jmake_mesh

        with pytest.raises(ValueError) as want:
            jmake_mesh(jax_devices(), **kw)
        with pytest.raises(ValueError) as got:
            make_mesh(CPU8, **kw)
        assert str(got.value) == str(want.value)


def test_the_breaker_answers_through_the_oracle_on_a_launch_fault():
    """shard.launch_fail: the breaker catches the injected launch failure and
    the host oracle answers exactly; disarmed, the mesh path serves again."""
    rng = np.random.default_rng(14)
    pair = sides(fuzz_tuples(rng))
    engs = engines(pair, (1, 8))
    reqs = fuzz_requests(rng, n=32)
    for pkg, eng, side, faults in zip(("jax", "torch"), engs, pair, (JFAULTS, TFAULTS)):
        b = batcher(pkg, eng, side.store)
        try:
            tuples = side.tuples(reqs)
            start, target = encode(side.mgr.snapshot(), tuples)
            want = side.oracle.batch_check(tuples)
            faults.arm("shard.launch_fail", times=1)
            assert b.check_batch_encoded(start, target) == want
            assert faults.fired("shard.launch_fail") == 1
            assert b.check_batch_encoded(start, target) == want
        finally:
            b.close()


def test_a_slow_shard_stalls_the_launch():
    pair = sides(["n:doc#view@(n:g#m)", "n:g#m@ann"])
    eng = engines(pair, (1, 8))[1]
    enc = eng.encode_ids(np.array([0]), np.array([0]))
    TFAULTS.arm_slow("shard.launch_slow", sleep_ms=200)
    t0 = time.monotonic()
    eng.decode_launched(eng.launch_encoded(enc))
    assert time.monotonic() - t0 >= 0.2
    assert TFAULTS.fired("shard.launch_slow") == 1


# -- HBM admission's per-shard model --------------------------------------------


class _FakeDevstats:
    """n devices as the reference's admission samples them."""

    def __init__(self, limit, peak=0, n=2):
        self.limit = limit
        self.peak = peak
        self.n = n

    def sample_devices(self):
        return [{"memory_stats": {"bytes_in_use": 0, "bytes_limit": self.limit,
                                  "peak_bytes_in_use": self.peak}}
                for _ in range(self.n)]


def _both(**kw):
    out = []
    for mod in (jhbm, thbm):
        stats = _FakeDevstats(**{k: v for k, v in kw.items() if k in ("limit", "peak", "n")})
        rest = {k: v for k, v in kw.items() if k not in ("limit", "peak", "n")}
        out.append((mod.HbmAdmission(devstats=stats, **rest), stats))
    return out


def test_the_clamp_respects_the_fullest_shard():
    outs = []
    for hbm, _ in _both(limit=1_000_000, budget_frac=1.0, bytes_per_row=100):
        trace = [hbm.clamp_rows(8192)]
        # 920k pinned on the fullest shard: 80k of headroom / 100 B = 800 rows
        hbm.set_shard_residency({0: 500_000.0, 1: 920_000.0})
        trace += [hbm.clamp_rows(8192), hbm.snapshot()["resident_floor_bytes"]]
        hbm.set_shard_residency({0: 500_000.0, 1: 500_000.0})  # rebalanced
        trace += [hbm.clamp_rows(8192), hbm.snapshot()["shard_residency"]]
        hbm.set_shard_residency({0: 2_000_000.0})  # over budget
        trace.append(hbm.clamp_rows(8192))
        outs.append(trace)
    assert outs[1] == outs[0]
    assert outs[1][:4] == [8192, 800, 920_000.0, 5000] and outs[1][-1] >= 1


def test_the_shard_peak_model_learns():
    outs = []
    for hbm, stats in _both(limit=1_000_000, peak=0, n=2, bytes_per_row=100):
        tok = hbm.reserve(128, 1)
        stats.peak = 48_000
        hbm.release(tok)
        snap = hbm.snapshot()
        outs.append([hbm.modeled_shard_bytes(128, 1, 0), hbm.modeled_shard_bytes(128, 1, 1),
                     hbm.modeled_shard_bytes(128, 2, 0), snap["modeled_shard_shapes"]])
    assert outs[1] == outs[0]
    assert outs[1][0] == pytest.approx(48_000) and outs[1][1] == pytest.approx(48_000)
    assert outs[1][2] is None and outs[1][3] >= 1


def test_the_serving_tier_pushes_its_residency_into_admission():
    pair = sides(["n:doc#view@(n:g#m)", "n:g#m@ann", "n:g#m@(n:h#m)", "n:h#m@bob"])
    hbms = [mod.HbmAdmission(devstats=_FakeDevstats(limit=1 << 30, n=8)) for mod in (jhbm, thbm)]
    engs = engines(pair, (1, 8), hbm=None)
    for eng, hbm in zip(engs, hbms):
        eng.hbm = hbm
    equal_answers(engs, pair, ["n:doc#view@bob", "n:doc#view@carl"])
    snaps = [h.snapshot() for h in hbms]
    assert snaps[1]["shard_residency"] == snaps[0]["shard_residency"]
    assert len(snaps[1]["shard_residency"]) == 8
    assert snaps[1]["resident_floor_bytes"] == max(snaps[1]["shard_residency"].values())
    assert engs[1].shard_bytes()["per_shard_logical"] == list(
        snaps[1]["shard_residency"].values())


# -- the registry -----------------------------------------------------------------


def _values(engine):
    return {"namespaces": [{"id": 1, "name": "n"}], "engine": engine,
            "autotune": {"enabled": False}}


SEED = ["n:doc#view@(n:g#m)", "n:g#m@ann", "n:g#m@(n:h#m)", "n:h#m@bob"]
PROBES = ["n:doc#view@ann", "n:doc#view@bob", "n:doc#view@carl", "n:g#m@(n:h#m)"]


@pytest.mark.parametrize("engine,kind", [
    ({"mode": "sharded", "mesh": {"data": 2}}, "ShardedCheckEngine"),
    ({"sharding": {"enabled": True, "data": 2, "escalation_budget": 0.1}},
     "ShardedServingEngine"),
])
def test_both_registries_build_the_sharded_engine_on_8_stripes(engine, kind):
    jreg = JRegistry(JConfig(values={**_values(engine), "log": {"level": "error"}}, env={}))
    treg = TRegistry(TConfig(values=_values(engine)), device="cpu", mesh_devices=CPU8)
    try:
        regs = (jreg, treg)
        engines_ = [reg.check_engine() for reg in regs]
        assert [type(e).__name__ for e in engines_] == [kind, kind]
        assert engines_[1].mesh.shape == dict(engines_[0].mesh.shape) == {"data": 2, "edge": 4}
        from keto_tpu.relationtuple import RelationTuple as JTuple

        for reg, Tuple in zip(regs, (JTuple, TTuple)):
            reg.store().write_relation_tuples(*(Tuple.from_string(s) for s in SEED))
        answers = [reg.checker().check_batch([Tuple.from_string(s) for s in PROBES])
                   for reg, Tuple in zip(regs, (JTuple, TTuple))]
        assert answers[1] == answers[0] == [True, True, False, True]
        knobs = [{k.name: k.describe() for k in reg.autotuner().knobs} for reg in regs]
        assert knobs[1] == knobs[0]
        if kind == "ShardedServingEngine":
            assert knobs[1]["escalation_budget"]["value"] == 0.1
            treg._apply_hot_knob("engine.sharding.escalation_budget", 0.25)
            assert engines_[1].escalation_budget == 0.25
            assert treg.config.get("engine.sharding.escalation_budget") == 0.25
            assert treg.hbm_admission() is engines_[1].hbm
        else:
            assert "escalation_budget" not in knobs[1]
    finally:
        jreg._batcher.close()
        treg.checker().close()


def test_one_device_falls_through_to_single_chip_with_the_references_line(
        caplog, capsys, monkeypatch):
    import jax

    values = _values({"sharding": {"enabled": True}})
    # the reference on a one-device JAX: its mesh is jax.devices()
    monkeypatch.setattr(jax, "devices", lambda *a: jax.local_devices()[:1])
    with caplog.at_level(logging.INFO):
        jreg = JRegistry(JConfig(values={**values, "log": {"level": "info"}}, env={}))
        jengine = jreg.check_engine()
        treg = TRegistry(TConfig(values=values), device="cpu")
        tengine = treg.check_engine()
    assert type(tengine).__name__ == type(jengine).__name__ == "ClosureCheckEngine"
    # the reference's structured logger writes its own stderr line
    ref = [line.split(": ", 1)[1] for line in capsys.readouterr().err.splitlines()
           if "keto_tpu.server: engine.sharding" in line]
    port = [r.getMessage() + "".join(f" {k}={v}" for k, v in r.fields.items())
            for r in caplog.records
            if r.name == "keto_tpu_torch.server" and "engine.sharding" in r.getMessage()]
    assert port == ref == [
        "engine.sharding enabled but mesh has one device; serving single-chip devices=1"]
    # a host-mode config never reaches the sharded tier
    host = TRegistry(TConfig(values=_values({"mode": "host", "sharding": {"enabled": True}})),
                     device="cpu", mesh_devices=CPU8)
    assert type(host.check_engine()).__name__ == "CheckEngine"


def test_the_registry_mesh_defaults():
    reg = TRegistry(TConfig(values=_values({})), device="cpu")
    assert reg.mesh_devices() == [torch.device("cpu")]
    reg = TRegistry(TConfig(values=_values({})), device="cpu", mesh_devices=["cpu", "cpu"])
    assert reg.mesh_devices() == ["cpu", "cpu"]
