"""keto_tpu_torch's fault registry and the self-healing paths it drives vs
keto_tpu's, on the CPU (the port of tests/test_faults.py).

- the registry's semantics (arm/fire counts, slowness, ``KETO_FAULTS``,
  fork snapshots), one script through both packages' ``FaultRegistry``;
- the check batcher's stage deaths and the ``reconfigure_stall`` drill, the
  same engine stand-ins behind both packages' ``CheckBatcher``;
- the device breaker's trip, half-open probe and backoff under one clock;
- the registry-wired path (``device.compile_error``, ``device.batch_nan``)
  and readiness, and ``registry.checker()``'s shape under the defaults;
- ``list.gather_fail`` against keto_tpu and the oracle;
- the replica pool's ``delta.drop`` and respawn snapshot, on socketpairs
  (no fork in a pytest worker).

Tolerances: exact — answers, counts and error types.
"""

import pickle
import socket
import threading
import time

import numpy as np
import pytest

from keto_tpu.engine import batcher as jbatcher
from keto_tpu.engine import fallback as jfb
from keto_tpu.faults import FAULTS as JFAULTS
from keto_tpu.faults import FaultInjected as JInjected
from keto_tpu.faults import FaultRegistry as JRegistry
from keto_tpu.relationtuple import RelationTuple as JTuple
from keto_tpu.relationtuple import SubjectID as JID
from keto_tpu_torch.driver import Config, Registry
from keto_tpu_torch.engine import batcher as tbatcher
from keto_tpu_torch.engine import fallback as tfb
from keto_tpu_torch.faults import FAULTS as TFAULTS
from keto_tpu_torch.faults import FaultInjected
from keto_tpu_torch.faults import FaultRegistry as TRegistry
from keto_tpu_torch.relationtuple import RelationTuple as TTuple
from keto_tpu_torch.relationtuple import SubjectID as TID

from tests.test_torch_device_engine import random_tuples
from tests.test_torch_listing import Pair as ListPair

PKGS = {
    "jax": (jbatcher, jfb, JFAULTS, JTuple, JID),
    "torch": (tbatcher, tfb, TFAULTS, TTuple, TID),
}


@pytest.fixture(autouse=True)
def _clean_faults():
    JFAULTS.reset()
    TFAULTS.reset()
    yield
    JFAULTS.reset()
    TFAULTS.reset()


def _tup(pkg, i=0):
    _, _, _, Tuple, ID = PKGS[pkg]
    return Tuple(namespace="n", object=f"o{i}", relation="view", subject=ID(id="alice"))


# -- the registry ----------------------------------------------------------------


def _registry_script(Registry, Injected):
    out = []
    r = Registry()
    r.arm("x.y", times=2)
    for _ in range(3):
        try:
            r.fire("x.y")
            out.append("quiet")
        except Injected:
            out.append("fired")
    out += [r.armed("x.y"), r.fired("x.y")]
    r.arm("a")
    out += [r.should_fire("a"), r.should_fire("a")]
    env = Registry(env={"KETO_FAULTS": "a.b, c.d:3 ,,s.t:sleep=5:2,u.v:stuck"})
    out += [env.armed("a.b"), env.armed("c.d"), env.slow_armed("s.t"),
            env.slow_armed("u.v"), env.snapshot()]
    t0 = time.monotonic()
    delays = [env.maybe_sleep("s.t"), env.maybe_sleep("s.t"), env.maybe_sleep("s.t")]
    out += [delays, time.monotonic() - t0 >= 0.01]
    threading.Timer(0.05, env.disarm, args=("u.v",)).start()
    t0 = time.monotonic()
    out.append(env.maybe_sleep("u.v") > 0 and time.monotonic() - t0 < 5)
    snap = env.snapshot()
    r2 = Registry()
    r2.arm("stale.fault")
    r2.load(snap)
    out += [r2.armed("c.d"), r2.armed("stale.fault"), r2.snapshot() == snap]
    for bad in (lambda: r.arm("a", times=0), lambda: r.arm_slow("a")):
        try:
            bad()
            out.append("accepted")
        except ValueError:
            out.append("ValueError")
    return out


def test_registry_semantics_match_the_reference():
    from keto_tpu.faults import FaultInjected as JInjected

    assert _registry_script(TRegistry, FaultInjected) == _registry_script(
        JRegistry, JInjected
    )


def test_the_site_table_names_every_reference_site():
    """A KETO_FAULTS string written for the reference names the same sites
    here: each reference site is in the port's table, and the sites of
    unported modules name their roadmap item."""
    import re

    import keto_tpu.faults as jf
    import keto_tpu_torch.faults as tf

    sites = set(re.findall(r"``([a-z_]+\.[a-z_]+)``", jf.__doc__))
    assert sites and sites <= set(re.findall(r"``([a-z_]+\.[a-z_]+)``", tf.__doc__))
    for site in ("wal.bitrot", "checkpoint.crash_mid_write", "shard.launch_fail",
                 "election.lease_stall", "replica.skip_delta"):
        assert site in tf.__doc__


# -- batcher drills ---------------------------------------------------------------


class _FakeEncoded:
    version = 0

    def __init__(self, requests):
        self.requests = list(requests)
        self.released = False

    def keys(self):
        return [(r.object, 0, 0) for r in self.requests]

    def compact(self, keep):
        self.requests = [self.requests[i] for i in keep]

    def release(self):
        self.released = True


class _SplitEngine:
    def pipeline_supported(self):
        return True

    def encode_batch(self, requests, max_depth=0, depths=None):
        self.last_enc = _FakeEncoded(requests)
        return self.last_enc

    def launch_encoded(self, enc):
        return enc

    def decode_launched(self, launched):
        return [True] * len(launched.requests)

    def batch_check(self, requests, max_depth=0, depths=None):
        return [True] * len(requests)


def _wait(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_dispatcher_death_restarts_the_serial_loop(pkg):
    batcher_mod, _, faults, _, _ = PKGS[pkg]
    b = batcher_mod.CheckBatcher(_SplitEngine(), window_s=0)
    try:
        faults.arm("batcher.dispatcher_die")
        assert b.check(_tup(pkg)) is True  # answered, then the loop dies
        assert _wait(lambda: faults.fired("batcher.dispatcher_die") == 1)
        assert b.check(_tup(pkg, 1)) is True  # the watchdog's replacement
    finally:
        b.close()


@pytest.mark.parametrize("pkg", ["jax", "torch"])
@pytest.mark.parametrize(
    "site", ["batcher.encode_die", "batcher.decode_die", "batcher.dispatcher_die"]
)
def test_stage_death_fails_the_held_batch_typed_and_restarts(pkg, site):
    batcher_mod, _, faults, _, _ = PKGS[pkg]
    eng = _SplitEngine()
    b = batcher_mod.CheckBatcher(eng, window_s=0, pipeline_depth=2, encode_workers=2)
    try:
        assert b.pipelined
        faults.arm(site)
        with pytest.raises(batcher_mod.DispatcherCrashed) as ei:
            b.check(_tup(pkg), timeout=10)
        assert ei.value.grpc_code == "INTERNAL"
        assert faults.fired(site) == 1
        if site != "batcher.encode_die":  # the encode dies before encoding
            assert eng.last_enc.released  # the crash returned the buffers
        assert b.check(_tup(pkg, 1), timeout=10) is True
        assert b.pipeline_stats()["batches_in_pipeline"] == 0
    finally:
        b.close()


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_stalled_reconfigure_keeps_concurrent_traffic(pkg):
    batcher_mod, _, faults, _, _ = PKGS[pkg]
    b = batcher_mod.CheckBatcher(_SplitEngine(), window_s=0, pipeline_depth=2,
                                 encode_workers=1)
    try:
        assert b.check(_tup(pkg)) is True
        faults.arm_slow("batcher.reconfigure_stall", sleep_ms=150)
        results, errs = [], []

        def call(i):
            try:
                results.append(b.check(_tup(pkg, i), timeout=10))
            except Exception as e:  # pragma: no cover - the failure path
                errs.append(e)

        threads = [threading.Thread(target=call, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        assert b.reconfigure(pipeline_depth=3, encode_workers=2)
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)
        assert faults.fired("batcher.reconfigure_stall") == 1
        assert errs == [] and results == [True] * 8
        assert (b.pipeline_depth, b.encode_workers, b.pipelined) == (3, 2, True)
        assert b.reconfigure(pipeline_depth=3) is False  # a no-op
        assert b.reconfigure(pipeline_depth=0)  # down to the serial loop
        assert not b.pipelined and b.check(_tup(pkg, 99), timeout=10) is True
        assert b.reconfigure(pipeline_depth=2)
        assert b.pipelined and b.check(_tup(pkg, 98), timeout=10) is True
    finally:
        b.close()


def test_reconfigure_under_load_loses_no_future():
    """64 closed-loop submitters while the pipeline goes 2 -> 0 -> 2: every
    check is answered."""
    b = tbatcher.CheckBatcher(_SplitEngine(), window_s=0, pipeline_depth=2,
                              encode_workers=2)
    stop = threading.Event()
    answered, errs = [0], []

    def submit(i):
        while not stop.is_set():
            try:
                assert b.check(_tup("torch", i), timeout=10) is True
                answered[0] += 1
            except Exception as e:
                errs.append(e)
                return

    threads = [threading.Thread(target=submit, args=(i,)) for i in range(64)]
    try:
        for t in threads:
            t.start()
        for depth in (0, 2, 0, 2):
            time.sleep(0.05)
            assert b.reconfigure(pipeline_depth=depth)
        time.sleep(0.05)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
        b.close()
    assert not any(t.is_alive() for t in threads)
    assert errs == [] and answered[0] > 64


def test_hbm_admission_splits_and_charges_the_pipeline():
    """The batcher asks the admission per chunk and charges each launched
    batch from launch to decode."""
    class _Admission:
        def __init__(self):
            self.reserved, self.released = [], []

        def clamp_rows(self, rows):
            return 16

        def reserve(self, bucket, version):
            self.reserved.append(bucket)
            return len(self.reserved)

        def release(self, token):
            self.released.append(token)

    class _Sized(_SplitEngine):
        def encode_batch(self, requests, max_depth=0, depths=None):
            enc = super().encode_batch(requests, max_depth, depths)
            enc.b = len(requests)
            return enc

    hbm = _Admission()
    b = tbatcher.CheckBatcher(_Sized(), window_s=0, pipeline_depth=2, hbm=hbm)
    try:
        assert b.check_batch([_tup("torch", i) for i in range(40)]) == [True] * 40
        assert b.check(_tup("torch"), timeout=10) is True
        assert hbm.reserved == [1] and sorted(hbm.released) == [1]
    finally:
        b.close()


# -- the device breaker -------------------------------------------------------------


class _FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


class _FlakyPrimary:
    """Fails as the ``device.compile_error`` site does (an injected fault,
    which both breakers answer from the oracle), or raises ``real``."""

    def __init__(self, injected=FaultInjected, real=None):
        self.fail = self.nan = self.calls = 0
        self.injected, self.real = injected, real

    def batch_check(self, requests, max_depth=0, depths=None):
        self.calls += 1
        if self.real is not None:
            raise self.real
        if self.fail > 0:
            self.fail -= 1
            raise self.injected("device.compile_error")
        if self.nan > 0:
            self.nan -= 1
            return [float("nan")] * len(requests)
        return [True] * len(requests)


class _Oracle:
    def batch_check(self, requests, max_depth=0):
        return [False] * len(requests)

    def subject_is_allowed(self, requested, max_depth=0):
        return False


class _Health:
    def __init__(self):
        self.serving = True

    def set_serving(self, serving):
        self.serving = serving


def _breaker_script(pkg):
    """One failure script through a breaker; the trace of answers, circuit
    state and readiness."""
    _, fb, _, _, _ = PKGS[pkg]
    primary = _FlakyPrimary(JInjected if pkg == "jax" else FaultInjected)
    health, clock = _Health(), _FakeClock()
    eng = fb.DeviceFallbackEngine(
        primary, fallback_factory=_Oracle, failure_threshold=3, cooldown_s=1.0,
        health=health, clock=clock, jitter_frac=0.0,
    )
    trace = []

    def step():
        trace.append((eng.batch_check([_tup(pkg)]), eng.circuit_open(),
                      health.serving, primary.calls))

    primary.fail = 4
    for _ in range(4):
        step()  # three strikes trip it; the fourth is not even tried
    clock.t += 1.5
    step()  # the probe fails: re-opened with a doubled cooldown
    clock.t += 1.5
    step()  # still inside the doubled window
    clock.t += 1.0
    step()  # the probe succeeds: closed, readiness back
    primary.nan = 1
    eng.failure_threshold = 1
    step()  # garbage output is a failure
    return trace


def test_breaker_trip_probe_and_backoff_match_the_reference():
    assert _breaker_script("torch") == _breaker_script("jax")
    trace = _breaker_script("torch")
    assert [t[1] for t in trace] == [False, False, True, True, True, True, False, True]
    assert [t[2] for t in trace] == [True, True, False, False, False, False, True, False]


@pytest.mark.parametrize("code", [2, 7, 209, 700, 719])
def test_a_real_device_error_fails_its_batch_typed_and_takes_readiness_down(code):
    """A kernel wrapper's real CUDA error is never answered on the CPU: the
    batch raises DeviceKernelError (503), readiness drops at once, no shape
    is quarantined and the oracle is never built; the next good batch
    restores readiness."""
    from keto_tpu_torch.utils.kernels import launch_error

    primary, health = _FlakyPrimary(), _Health()
    built = []
    eng = tfb.DeviceFallbackEngine(
        primary, fallback_factory=lambda: built.append(1) or _Oracle(),
        failure_threshold=3, cooldown_s=1.0, health=health,
    )
    primary.real = launch_error("packed_propagate", code)
    with pytest.raises(tfb.DeviceKernelError) as err:
        eng.batch_check([_tup("torch")])
    assert err.value.status_code == 503
    assert err.value.kind == tfb.classify_device_error(primary.real)
    assert not health.serving and not built and eng.quarantine_snapshot() == []
    snap = eng.breaker_snapshot()
    assert snap["real_failures"] == 1 and snap["fallback_batches"] == 0
    assert snap["open"] is (err.value.kind == "device_lost") is snap["open_real"]
    if snap["open"]:
        # a circuit a real error opened refuses typed, never on the CPU
        with pytest.raises(tfb.DeviceKernelError, match="circuit_open"):
            eng.batch_check([_tup("torch")])
        eng.force_probe()
    primary.real = None
    assert eng.batch_check([_tup("torch")]) == [True]
    assert health.serving and not eng.circuit_open() and not built


def test_a_real_launch_error_fails_the_pipelined_batch_typed():
    """Through the pipelined batcher over the device engine: a launch that
    raises a real CUDA error fails exactly its batch's futures typed; the
    quarantine stays empty and no batch reaches the oracle."""
    from keto_tpu_torch.utils.kernels import launch_error

    reg = _device_registry(pipeline_depth=2)
    reg.store().transact_relation_tuples([_tup("torch")], [])
    checker = reg.checker()
    breaker = reg._engine_breaker
    reg.mark_serving()
    engine = reg.check_engine()
    real_launch = engine.launch_encoded

    def refused(enc):
        raise launch_error("packed_propagate", 209)

    try:
        assert checker.pipelined and checker.check(_tup("torch")) is True
        engine.launch_encoded = refused
        with pytest.raises(tfb.DeviceKernelError, match="compile_fail"):
            checker.check(_tup("torch"), timeout=10)
        assert not reg.is_serving()
        engine.launch_encoded = real_launch
        assert checker.check(_tup("torch"), timeout=10) is True
        assert reg.is_serving()
        snap = reg._device_status()["breaker"]
        assert snap["fallback_batches"] == 0 and snap["quarantine_size"] == 0
        assert breaker._fallback is None
    finally:
        checker.close()


def _device_registry(**engine):
    return Registry(Config(values={
        "namespaces": [{"id": 1, "name": "n"}],
        "engine": {"mode": "device", "cache_size": 0, "encoded_cache_size": 0,
                   "fallback_threshold": 2, "fallback_cooldown_ms": 50, **engine},
    }), device="cpu")


def test_injected_device_faults_reach_the_oracle_through_the_registry():
    reg = _device_registry()
    reg.store().transact_relation_tuples([_tup("torch")], [])
    checker = reg.checker()
    breaker = reg._engine_breaker
    reg.mark_serving()
    try:
        assert checker.check(_tup("torch")) is True
        TFAULTS.arm("device.compile_error", times=2)
        assert checker.check(_tup("torch")) is True
        assert checker.check(_tup("torch")) is True  # second strike: trips
        assert breaker.circuit_open() and not reg.is_serving()
        TFAULTS.arm("device.batch_nan")
        time.sleep(0.1)
        assert checker.check(_tup("torch")) is True  # a failed probe
        assert TFAULTS.fired("device.batch_nan") == 1 and breaker.circuit_open()
        time.sleep(0.25)
        assert checker.check(_tup("torch")) is True  # the probe closes it
        assert not breaker.circuit_open() and reg.is_serving()
        snap = reg._device_status()["breaker"]
        assert snap["failures"] == 3 and snap["fallback_batches"] == 3
    finally:
        checker.close()


@pytest.mark.parametrize("mode", ["closure", "packed"])
def test_checker_under_defaults_is_the_reference_shape(mode):
    """registry.checker() under the default config: a CheckBatcher over a
    DeviceFallbackEngine over the raw engine, with HbmAdmission, the
    supervisor on the breaker's hook — as keto_tpu's registry builds it."""
    from keto_tpu.driver import Config as JConfig
    from keto_tpu.driver import Registry as JReg
    from keto_tpu.engine.hbm import HbmAdmission as JHbm
    from keto_tpu_torch.engine.hbm import HbmAdmission

    values = {"namespaces": [{"id": 1, "name": "n"}], "engine": {"mode": mode}}
    reg = Registry(Config(values=values), device="cpu")
    jreg = JReg(JConfig(values={**values, "log": {"level": "error"}}, env={}))
    checker, jchecker = reg.checker(), jreg.checker()
    try:
        for c, Breaker, Hbm in ((checker, tfb.DeviceFallbackEngine, HbmAdmission),
                                (jchecker, jfb.DeviceFallbackEngine, JHbm)):
            assert type(c).__name__ == "CheckBatcher"
            assert isinstance(c.engine, Breaker)
            assert isinstance(c.hbm, Hbm)
        assert checker.engine.primary is reg.check_engine()
        sup = reg.device_supervisor()
        assert sup._breaker is checker.engine
        assert checker.engine._on_device_lost == sup.notify_device_lost
        assert (sup.home_platform, sup.probe_mode) == ("cpu", "child")
        assert checker.pipelined == (mode == "packed") == jchecker.pipelined
    finally:
        checker.close()
        jchecker.close()


def test_fallback_off_and_host_mode_build_no_plane():
    reg = _device_registry(fallback=False, memory={"admission": False},
                           failover={"enabled": False})
    checker = reg.checker()
    try:
        assert not isinstance(checker.engine, tfb.DeviceFallbackEngine)
        assert checker.hbm is None and reg.device_supervisor() is None
    finally:
        checker.close()
    host = Registry(Config(values={"engine": {"mode": "host"}}), device="cpu")
    assert host.hbm_admission() is None and host.device_supervisor() is None


# -- list.gather_fail ---------------------------------------------------------------


def test_list_gather_fail_answers_like_the_reference_and_the_oracle():
    rng = np.random.default_rng(1000)
    pair = ListPair(random_tuples(rng, n_objects=10, n_users=6, n_edges=90),
                    breaker_threshold=2, breaker_cooldown_s=60.0)
    users = [f"u{i}" for i in range(4)]
    for site in (JFAULTS, TFAULTS):
        site.arm("list.gather_fail", times=2)
    pages = [pair.objects(u, "r0", "n") for u in users]  # held to keto_tpu
    assert [p.source for p in pages] == ["oracle"] * 4
    for u, p in zip(users, pages):
        assert p.items == pair.oracle_objects(TID(u), "r0", "n")
    assert TFAULTS.fired("list.gather_fail") == JFAULTS.fired("list.gather_fail") == 2
    assert pair.tlist.breaker_open() and pair.jlist.breaker_open()
    assert pair.subjects("n", "o1", "r0").items == pair.oracle_subjects("n", "o1", "r0")


# -- the replica pool's sites, on socketpairs -----------------------------------------


def _frames(sock):
    from keto_tpu_torch.driver.replicas import _recv_frame

    sock.settimeout(0.2)
    out = []
    try:
        while True:
            frame = _recv_frame(sock)
            if frame is None:
                break
            out.append(pickle.loads(frame))
    except OSError:
        pass
    return out


def test_delta_drop_skips_one_frame_for_one_replica():
    from keto_tpu_torch.driver.replicas import ReplicaPool, _Link

    pool = ReplicaPool(registry=None, n_replicas=3)
    pairs = [socket.socketpair() for _ in range(2)]
    pool._children = [_Link(100 + i, p) for i, (p, _) in enumerate(pairs)]
    try:
        TFAULTS.arm("delta.drop")
        pool._broadcast(7, [], [])
        pool._broadcast(8, [], [])
        got = [[m[1] for m in _frames(c)] for _, c in pairs]
        assert got == [[8], [7, 8]]  # the first replica has a gap to resync
        assert TFAULTS.fired("delta.drop") == 1
        assert [v for v, _ in pool._delta_log] == [7, 8]  # the replay log has both
    finally:
        for a, b in pairs:
            a.close()
            b.close()


def test_a_respawn_carries_the_current_fault_snapshot():
    from keto_tpu_torch.driver.replicas import ReplicaPool, _Link, _recv_frame

    pool = ReplicaPool(registry=None, n_replicas=2)
    zp, zc = socket.socketpair()
    pool._zygote = _Link(99, zp)
    try:
        TFAULTS.arm("replica.crash")
        TFAULTS.disarm("replica.crash")
        TFAULTS.arm_slow("replica.slow", sleep_ms=5, times=2)
        pool._respawn()
        zc.settimeout(2)
        cmd = pickle.loads(_recv_frame(zc))
        assert cmd[0] == "spawn"
        assert cmd[2] == TFAULTS.snapshot()
        assert "replica.crash" not in cmd[2]
    finally:
        for link in pool._children:
            link.sock.close()
        zp.close()
        zc.close()
