"""keto_tpu_torch's device-fault plane vs keto_tpu's, on the CPU
(the port of tests/test_device_faults.py): ``engine/fallback.py``,
``engine/hbm.py`` and the registry's ``DeviceSupervisor``.

Both packages get the same inputs: the same error messages, the same
seeded tuple graphs and request pools (the port's engines on
``device="cpu"``, plain versions; the JAX packed kernel in Pallas
interpret mode), the same injected rng and clock, the same fake device
statistics. Tolerances: exact — answers and bisected results are booleans,
windows and budgets come from the same arithmetic on the same floats.
"""

import random
import threading
import time

import pytest

from keto_tpu.engine import CheckEngine as JCheck
from keto_tpu.engine.device import DeviceCheckEngine as JDevice
from keto_tpu.engine import fallback as jfb
from keto_tpu.engine import hbm as jhbm
from keto_tpu.faults import FAULTS as JFAULTS
from keto_tpu.faults import FaultInjected as JInjected
from keto_tpu.graph import SnapshotManager as JManager
from keto_tpu.relationtuple import RelationTuple as JTuple
from keto_tpu.store import InMemoryTupleStore as JStore
from keto_tpu_torch.driver import Config, Registry
from keto_tpu_torch.driver.registry import DeviceSupervisor
from keto_tpu_torch.engine import CheckEngine as TCheck
from keto_tpu_torch.engine import DeviceCheckEngine as TDevice
from keto_tpu_torch.engine import fallback as tfb
from keto_tpu_torch.engine import hbm as thbm
from keto_tpu_torch.engine.batcher import CheckBatcher
from keto_tpu_torch.faults import FAULTS as TFAULTS
from keto_tpu_torch.faults import FaultInjected as TInjected
from keto_tpu_torch.graph import SnapshotManager as TManager
from keto_tpu_torch.relationtuple import RelationTuple as TTuple
from keto_tpu_torch.store import InMemoryTupleStore as TStore
from keto_tpu_torch.utils.kernels import CUDA_ERROR_TEXT, launch_error


@pytest.fixture(autouse=True)
def _clean_faults():
    JFAULTS.reset()
    TFAULTS.reset()
    yield
    JFAULTS.reset()
    TFAULTS.reset()


# unicode vocab: node ids must survive encode -> split -> re-encode even
# when the key strings are multi-byte
_OBJS = ["документ", "予約-α", "ficha-ñ", "plain"]
_USERS = ["алиса", "ユーザー1", "böb", "mallory"]
_GRAPH = [f"n:{o}#view@(n:группа{i % 2}#member)" for i, o in enumerate(_OBJS)] + [
    "n:группа0#member@алиса",
    "n:группа1#member@ユーザー1",
    "n:plain#view@böb",
]


def _pool(rng, k):
    return [
        f"n:{_OBJS[rng.randrange(len(_OBJS))]}#view@{_USERS[rng.randrange(len(_USERS))]}"
        for _ in range(k)
    ]


class Side:
    """One package's breaker over its device engine and its host oracle."""

    def __init__(self, pkg, mode, **kw):
        self.pkg = pkg
        if pkg == "jax":
            self.Tuple, self.faults = JTuple, JFAULTS
            store = JStore()
            store.write_relation_tuples(*(JTuple.from_string(s) for s in _GRAPH))
            self.engine = JDevice(JManager(store), max_depth=5, mode=mode)
            oracle, fb = JCheck(store, max_depth=5), jfb
        else:
            self.Tuple, self.faults = TTuple, TFAULTS
            store = TStore()
            store.write_relation_tuples(*(TTuple.from_string(s) for s in _GRAPH))
            self.engine = TDevice(TManager(store), max_depth=5, mode=mode, device="cpu")
            oracle, fb = TCheck(store, max_depth=5), tfb
        self.oracle = oracle
        self.breaker = fb.DeviceFallbackEngine(
            self.engine, fallback_factory=lambda: oracle,
            failure_threshold=3, cooldown_s=0.1, **kw,
        )

    def reqs(self, strings):
        return [self.Tuple.from_string(s) for s in strings]

    def roundtrip(self, strings):
        enc = self.breaker.encode_batch(self.reqs(strings))
        return [bool(v) for v in self.breaker.decode_launched(self.breaker.launch_encoded(enc))]

    def want(self, strings):
        return [self.oracle.subject_is_allowed(r) for r in self.reqs(strings)]


# -- classification ------------------------------------------------------------

_REFERENCE_MESSAGES = [
    ("RESOURCE_EXHAUSTED: out of memory allocating 2GB", "oom"),
    ("XLA error: failed to allocate buffer", "oom"),
    ("DEVICE_LOST: tpu rebooted underneath us", "device_lost"),
    ("backend reported device lost", "device_lost"),
    ("Mosaic compilation failure: unsupported op", "compile_fail"),
    ("something unrecognized went wrong", "transient"),
]


@pytest.mark.parametrize("msg,kind", _REFERENCE_MESSAGES)
def test_message_taxonomy_matches_the_reference(msg, kind):
    err = RuntimeError(msg)
    assert jfb.classify_device_error(err) == kind
    assert tfb.classify_device_error(err) == kind


@pytest.mark.parametrize("site", ["device.oom", "device.lost", "device.compile_fail",
                                  "device.compile_error"])
def test_injected_fault_sites_classify_alike(site):
    assert tfb.classify_device_error(TInjected(site)) == (
        jfb.classify_device_error(JInjected(site))
    )


@pytest.mark.parametrize(
    "msg,kind",
    [
        ("CUDA out of memory. Tried to allocate 20.00 GiB", "oom"),
        ("CUDA error: an illegal memory access was encountered", "device_lost"),
        ("CUDA error: unspecified launch failure", "device_lost"),
        ("CUDA error: device-side assert triggered", "device_lost"),
        ("CUDA error: an illegal instruction was encountered", "device_lost"),
        ("CUDA error: uncorrectable ECC error encountered", "device_lost"),
        ("CUDA error: no CUDA-capable device is detected", "device_lost"),
        ("CUDA driver version is insufficient for CUDA runtime version", "device_lost"),
        ("CUDA error: too many resources requested for launch", "compile_fail"),
        ("CUDA error: invalid configuration argument", "compile_fail"),
        ("CUDA error: no kernel image is available for execution on the device",
         "compile_fail"),
    ],
)
def test_cuda_message_taxonomy(msg, kind):
    """The CUDA runtime's words, classified by the port alone."""
    assert tfb.classify_device_error(RuntimeError(msg)) == kind


def test_out_of_memory_type_is_oom_whatever_its_text():
    assert tfb.classify_device_error(torch_oom("allocator said no")) == "oom"


def torch_oom(msg):
    import torch

    return torch.cuda.OutOfMemoryError(msg)


@pytest.mark.parametrize("code", sorted(CUDA_ERROR_TEXT))
def test_a_failed_launch_raises_words_the_breaker_types(code):
    """A kernel wrapper's nonzero cudaError_t carries the runtime's text,
    so a sticky error in B1 or B2 opens the breaker at once."""
    kind = tfb.classify_device_error(launch_error("packed_propagate", code))
    want = {2: "oom", 7: "compile_fail", 9: "compile_fail", 209: "compile_fail"}
    assert kind == want.get(code, "device_lost")


# -- OOM bisection ---------------------------------------------------------------


@pytest.mark.parametrize("mode,sizes", [("scatter", [2, 3, 5, 17, 33, 64, 120]),
                                        ("packed", [5, 33])])
def test_oom_bisection_parity_fuzz(mode, sizes):
    """Fuzzed batch sizes and armed-OOM counts: every bisection tree
    answers exactly like the unsplit host oracle in both packages, with
    the circuit closed and the host oracle never built."""
    sides = [Side("jax", mode), Side("torch", mode)]
    rng = random.Random(11)
    for trial, size in enumerate(sizes):
        strings = _pool(rng, size)
        times = max(1, min(1 + trial % 3, size.bit_length() - 1))
        got = []
        for side in sides:
            side.faults.arm("device.oom", times=times)
            got.append(side.roundtrip(strings))
            assert not side.faults.armed("device.oom")
        assert got[0] == got[1] == sides[1].want(strings), f"size={size}"
    for side in sides:
        assert not side.breaker.circuit_open()
        assert side.breaker._fallback is None  # zero oracle escalations
    assert sides[1].breaker.n_bisections > 0


def test_single_row_and_persistent_oom_reach_the_oracle():
    for pkg in ("jax", "torch"):
        side = Side(pkg, "scatter")
        side.faults.arm("device.oom")
        assert side.roundtrip(["n:plain#view@böb"]) == [True]
        strings = _pool(random.Random(3), 32)
        side.faults.arm("device.oom", times=10_000)
        assert side.roundtrip(strings) == side.want(strings)
        side.faults.reset()


def test_bisection_behind_the_encoded_cache():
    """Encoded-cache hits compact the batch before launch; the bisection of
    the compacted miss rows merges back into the exact full answer."""
    from keto_tpu_torch.relationtuple.columns import CheckColumns

    side = Side("torch", "scatter")
    batcher = CheckBatcher(side.breaker, max_batch=256, encoded_cache_size=1024,
                           version_fn=lambda: 0)
    try:
        rng = random.Random(5)
        warm = side.reqs(_pool(rng, 24))

        def cols(rs):
            return CheckColumns(
                ["n"] * len(rs), [r.object for r in rs], ["view"] * len(rs),
                subject_ids=[r.subject.id for r in rs],
            ).validate()

        batcher.check_batch_columnar(cols(warm), 5)
        mixed = warm[:12] + side.reqs(_pool(rng, 36))
        TFAULTS.arm("device.oom", times=2)
        got = batcher.check_batch_columnar(cols(mixed), 5)
        assert got == [side.oracle.subject_is_allowed(r) for r in mixed]
        assert not side.breaker.circuit_open()
    finally:
        batcher.close()


# -- compile quarantine ----------------------------------------------------------


def test_quarantine_absorbs_one_shape_in_both_packages():
    rng = random.Random(9)
    strings = _pool(rng, 20)
    for pkg in ("jax", "torch"):
        side = Side(pkg, "scatter")
        want = side.want(strings)
        side.faults.arm("device.compile_fail")
        assert side.roundtrip(strings) == want
        assert not side.breaker.circuit_open()
        q = side.breaker.quarantine_snapshot()
        assert len(q) == 1 and q[0]["bucket"] == 32
        assert side.roundtrip(strings) == want  # the shape stays quarantined
        assert side.roundtrip(strings[:4]) == want[:4]  # another bucket launches
        assert not side.breaker.circuit_open()


# -- breaker windows ---------------------------------------------------------------


def _ticking(pkg, **kw):
    fake = [0.0]
    return fake, Side(pkg, "scatter", clock=lambda: fake[0], **kw).breaker


def test_jittered_windows_match_under_one_rng_and_clock():
    opens = {}
    for pkg in ("jax", "torch"):
        _, breaker = _ticking(pkg, rng=random.Random(42), jitter_frac=0.25)
        breaker.failure_threshold = 1
        breaker._record_failure(RuntimeError("boom"))
        windows = [breaker._open_until]
        for _ in range(5):  # failed probes: doubled, jittered, capped
            breaker._record_failure(RuntimeError("boom"))
            windows.append(breaker._open_until)
        opens[pkg] = windows
    assert opens["torch"] == opens["jax"]
    assert 0.1 <= opens["torch"][0] < 0.1 * 1.25


def test_cooldown_doubles_and_caps():
    _, breaker = _ticking("torch", rng=random.Random(1), jitter_frac=0.0)
    breaker.failure_threshold = 1
    breaker._record_failure(RuntimeError("boom"))
    assert breaker._cooldown_s == pytest.approx(0.1)
    for _ in range(16):
        breaker._record_failure(RuntimeError("boom"))
    assert breaker._cooldown_s == tfb._COOLDOWN_CAP_S == jfb._COOLDOWN_CAP_S


def test_device_lost_forces_open_notifies_and_force_probe():
    lost = []
    side = Side("torch", "scatter", on_device_lost=lost.append)
    with pytest.raises(tfb.DeviceKernelError):  # a real error fails typed
        side.breaker._note_failure(RuntimeError("CUDA error: an illegal memory access was encountered"))
    assert side.breaker.circuit_open() and len(lost) == 1
    side.breaker.force_probe()
    assert side.breaker._use_primary()


# -- the device supervisor ----------------------------------------------------------


def _wait_idle(sup, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        st = sup.status()
        if st["failovers"] >= 1 and not st["recovering"]:
            return st
        time.sleep(0.02)
    raise AssertionError(f"supervisor still recovering: {sup.status()}")


def _registry(**engine):
    return Registry(Config(values={
        "namespaces": [{"id": 1, "name": "n"}],
        "engine": {"max_batch": 128, "cache_size": 0, "encoded_cache_size": 0,
                   "fallback_cooldown_ms": 100,
                   "failover": {"probe_mode": "inproc", "probe_interval_s": 0.05},
                   **engine},
    }), device="cpu")


def test_device_lost_recovery_drill_through_the_registry():
    """device.lost: the lost batch is answered by the oracle, the supervisor
    re-probes, re-inits and forces the probe; the next batch closes the
    breaker on the device engine again, and /debug/device shows it all."""
    from keto_tpu_torch.relationtuple.columns import CheckColumns

    reg = _registry(mode="device")
    objs = [f"ok{i}" for i in range(16)]
    reg.store().write_relation_tuples(*(TTuple.from_string(f"n:{o}#view@alice") for o in objs))
    checker = reg.checker()
    sup, breaker = reg.device_supervisor(), reg._engine_breaker
    try:
        rows = objs + ["ghost0", "ghost1"]
        want = [True] * len(objs) + [False, False]
        cols = CheckColumns(["n"] * len(rows), rows, ["view"] * len(rows),
                            subject_ids=["alice"] * len(rows)).validate()
        TFAULTS.arm("device.lost")
        assert checker.check_batch_columnar(cols, 5) == want
        st = _wait_idle(sup)
        events = [e["event"] for e in st["timeline"]]
        assert events[0] == "device_lost" and "recovered" in events
        assert checker.check_batch_columnar(cols, 5) == want
        assert not breaker.circuit_open()
        status = reg._device_status()
        assert status["backend"] == "cpu" and status["supervisor"]["failovers"] == 1
        assert status["breaker"]["fallback_batches"] == 1
    finally:
        checker.close()
        sup.stop()


def test_probe_hang_counts_as_one_failed_attempt():
    class _Eng:
        def reset_residency(self):
            pass

        def warmup(self, n):
            pass

    sup = DeviceSupervisor(_Eng(), probe_mode="inproc", probe_interval_s=0.01,
                           max_backoff_s=0.05, home_platform="cpu")
    TFAULTS.arm("backend.probe_hang")
    sup.notify_device_lost(RuntimeError("device lost"))
    st = _wait_idle(sup)
    probes = [e for e in st["timeline"] if e["event"] == "probe"]
    assert [e["ok"] for e in probes] == [False, True]
    sup.stop()


def _lose_the_card_once(eng):
    """The closure engine's next batch raises as a sticky CUDA error would
    (the closure path has no device.* fault site of its own); the breaker
    reaches the engine through its array seam."""
    real = eng.batch_check_array

    def batch_check_array(*a, **kw):
        eng.batch_check_array = real
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    eng.batch_check_array = batch_check_array


def _wait_event(sup, event, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if any(e["event"] == event for e in sup.status()["timeline"]):
            return
        time.sleep(0.02)
    raise AssertionError(f"no {event} in {sup.status()}")


def _card_home(reg):
    """The supervisor of a CPU registry, labelled as a card's: the CPU
    tensors stand in for the card, the injected probes for its driver."""
    sup = reg.device_supervisor()
    sup.home_platform = sup.backend = "cuda"
    return sup


def test_cpu_failover_and_homecoming_keep_the_answers():
    """The failover mapping: a real lost-card error fails its batch typed
    (never re-answered on the CPU) and takes readiness down; a failed home
    probe moves the closure engine to host query mode (numpy build, no
    device work), and a later good probe brings it home. Readiness stays
    down until the card answers again; every answer equals the oracle.
    Probes are injected: no child process."""
    from keto_tpu_torch.engine.closure import ClosureCheckEngine

    reg = _registry(mode="closure", query_mode="device")
    tuples = [f"n:doc{i}#view@(n:g{i % 3}#member)" for i in range(12)]
    tuples += [f"n:g{j}#member@(n:g{j + 1}#member)" for j in range(2)]
    tuples += ["n:g2#member@carol", "n:g0#member@alice"]
    reg.store().write_relation_tuples(*(TTuple.from_string(s) for s in tuples))
    checker, sup = reg.checker(), _card_home(reg)
    eng = reg.check_engine()
    assert isinstance(eng, ClosureCheckEngine)
    probes = iter([(False, "gone"), (False, "gone"), (True, "1 devices")])
    sup._probe_backend = lambda platform: next(probes)
    reqs = [TTuple.from_string(f"n:doc{i}#view@{u}") for i in range(12)
            for u in ("alice", "carol", "mallory")]
    oracle = TCheck(reg.store(), max_depth=5)
    want = [oracle.subject_is_allowed(r) for r in reqs]
    reg.mark_serving()
    try:
        assert checker.check_batch(reqs) == want
        assert not eng.host_queries() and reg.is_serving()
        _lose_the_card_once(eng)
        with pytest.raises(tfb.DeviceKernelError) as lost:
            checker.check_batch(reqs)
        assert lost.value.kind == "device_lost" and lost.value.status_code == 503
        assert not reg.is_serving()
        st = _wait_idle(sup)
        events = [e["event"] for e in st["timeline"]]
        assert events == ["device_lost", "probe", "failover", "probe", "probe", "recovered"], events
        assert st["backend"] == "cuda"
        assert not eng.host_queries()  # the placement it had
        assert not reg.is_serving()  # until a batch closes the breaker
        assert checker.check_batch(reqs) == want
        assert not reg._engine_breaker.circuit_open() and reg.is_serving()
        snap = reg._device_status()["breaker"]
        assert snap["fallback_batches"] == 0 and snap["real_failures"] == 1
        assert reg._engine_breaker._fallback is None  # the oracle never built
    finally:
        checker.close()
        sup.stop()


def test_cpu_failover_serves_from_the_host_residency():
    """Between the failover and the homecoming the engine answers from a
    host D, exactly, and the breaker closes on it; readiness stays down
    while the backend is not the card."""
    reg = _registry(mode="closure", query_mode="device")
    reg.store().write_relation_tuples(*(TTuple.from_string(s) for s in (
        "n:d#view@(n:g#member)", "n:g#member@(n:h#member)", "n:h#member@ann")))
    checker, sup = reg.checker(), _card_home(reg)
    eng = reg.check_engine()
    gate = threading.Event()
    answers = iter([(False, "gone")])

    def probe(platform):
        try:
            return next(answers)
        except StopIteration:
            gate.wait(10)  # hold the card "gone" until the test has looked
            return True, "1 devices"

    sup._probe_backend = probe
    req = [TTuple.from_string("n:d#view@ann"), TTuple.from_string("n:d#view@bob")]
    reg.mark_serving()
    try:
        assert checker.check_batch(req) == [True, False]
        _lose_the_card_once(eng)
        with pytest.raises(tfb.DeviceKernelError):
            checker.check_batch(req)
        _wait_event(sup, "failover")
        assert sup.status()["backend"] == "cpu"
        assert eng.host_queries() and eng._state.d_host is not None
        assert checker.check_batch(req) == [True, False]  # the probe closes it
        assert not reg._engine_breaker.circuit_open()
        assert not reg.is_serving()  # a host residency is not the card
        gate.set()
        _wait_idle(sup)
        assert not eng.host_queries() and eng._state.d is not None
        assert checker.check_batch(req) == [True, False]
        assert reg.is_serving()
    finally:
        gate.set()
        checker.close()
        sup.stop()


def test_sticky_error_keeps_retrying_reinit():
    """A fresh child sees the card but this process's context is poisoned:
    the probe succeeds, the re-init fails, and the loop retries with the
    failures in the timeline."""
    class _Poisoned:
        def __init__(self):
            self.tries = 0

        def reset_residency(self):
            self.tries += 1
            if self.tries < 3:
                raise RuntimeError("CUDA error: an illegal memory access was encountered")

        def warmup(self, n):
            pass

    eng = _Poisoned()
    sup = DeviceSupervisor(eng, probe_interval_s=0.01, max_backoff_s=0.02)
    sup._probe_backend = lambda platform: (True, "1 devices")
    sup.notify_device_lost(RuntimeError("device lost"))
    st = _wait_idle(sup)
    events = [e["event"] for e in st["timeline"]]
    assert events.count("reinit_failed") == 2 and events[-1] == "recovered"
    sup.stop()


# -- HBM admission ---------------------------------------------------------------


class _FakeDevstats:
    """One card's allocator as both packages' admissions read it: the
    reference samples ``peak`` at reserve and release, the port opens a
    per-batch peak window (``window_enter`` resets ``peak`` to the bytes in
    use while no batch is in flight and returns the batch's entry counts,
    ``window_exit`` charges it as ``telemetry/devstats.py`` does)."""

    def __init__(self, limit=1_000_000, peak=0, in_use=0):
        self.limit = limit
        self.peak = peak
        self.in_use = in_use
        self.allocated = in_use
        self.freed = 0
        self.depth = 0
        self.hwm = peak

    def sample_devices(self):
        if self.limit is None:
            return []
        return [{"platform": "cuda", "memory_stats": {
            "bytes_in_use": 0, "bytes_limit": self.limit,
            "peak_bytes_in_use": self.peak,
        }}]

    def peak_bytes(self):
        return None if self.limit is None else max(self.hwm, self.peak)

    def window_enter(self):
        if self.limit is None:
            return None
        if self.depth == 0:
            self.hwm = max(self.hwm, self.peak)
            self.peak = self.in_use
        self.depth += 1
        return (self.in_use, self.allocated, self.freed)

    def window_exit(self, entry):
        if self.limit is None:
            return None
        self.depth -= 1
        in_use0, allocated0, freed0 = entry
        return min(self.peak - in_use0 + self.freed - freed0,
                   self.allocated - allocated0)

    def alloc(self, nbytes):
        self.in_use += nbytes
        self.allocated += nbytes
        self.peak = max(self.peak, self.in_use)

    def free(self, nbytes):
        self.in_use -= nbytes
        self.freed += nbytes


def _both_hbm(**kw):
    stats = [_FakeDevstats(**{k: v for k, v in kw.items() if k in ("limit", "peak")})
             for _ in range(2)]
    rest = {k: v for k, v in kw.items() if k not in ("limit", "peak")}
    return (
        (jhbm.HbmAdmission(devstats=stats[0], **rest), stats[0]),
        (thbm.HbmAdmission(devstats=stats[1], **rest), stats[1]),
    )


_SNAP_KEYS = ("budget_bytes", "budget_frac", "inflight_bytes", "inflight_batches",
              "headroom_bytes", "bytes_per_row", "modeled_shapes")


def test_hbm_admission_matches_under_one_fake_devstats():
    """The same script of reserves, releases and peak moves: the same
    budget, clamps, model and snapshot in both packages."""
    outs = []
    for hbm, stats in _both_hbm(limit=1_000_000, budget_frac=0.5, bytes_per_row=100):
        trace = [hbm.budget_bytes(), hbm.clamp_rows(4096)]
        t1 = hbm.reserve(4096, 1)
        trace += [hbm.clamp_rows(4096), hbm.clamp_rows(8)]
        t2 = hbm.reserve(128, 1)
        stats.alloc(64_000)
        hbm.release(t2)
        trace += [hbm.modeled_bytes(128, 1), hbm.clamp_rows(4096)]
        hbm.release(t1)
        hbm.release(t1)  # double release is a no-op
        hbm.set_reverse_residency(200_000)
        trace += [hbm.clamp_rows(4096), hbm.wait_for_headroom(timeout_s=0.0)]
        hbm.set_budget_frac(0.25)
        trace.append(hbm.budget_bytes())
        snap = hbm.snapshot()
        trace.append({k: snap[k] for k in _SNAP_KEYS})
        outs.append(trace)
    assert outs[0] == outs[1]


def test_no_device_stats_means_admission_off():
    for hbm, _ in _both_hbm(limit=None):
        assert hbm.budget_bytes() is None
        assert hbm.clamp_rows(4096) == 4096
        assert hbm.reserve(128, 1) == 0
        hbm.release(0)
        assert hbm.wait_for_headroom(timeout_s=0.0)


def test_rebuild_gate_blocks_until_headroom():
    hbm = thbm.HbmAdmission(budget_frac=1.0, bytes_per_row=1000,
                            devstats=_FakeDevstats(limit=100_000))
    tok = hbm.reserve(100, 1)
    assert not hbm.wait_for_headroom(frac=0.5, timeout_s=0.05)
    threading.Timer(0.05, hbm.release, args=(tok,)).start()
    assert hbm.wait_for_headroom(frac=0.5, timeout_s=5.0)


def test_a_cpu_process_samples_no_device():
    """devstats on a process without CUDA: no entries, so admission is off
    (a forked replica reads the same: CUDA not initialised here)."""
    from keto_tpu_torch.telemetry.devstats import DEVSTATS

    assert DEVSTATS.sample_devices() == []
    assert thbm.HbmAdmission().budget_bytes() is None


# -- the two repairs: a bounded oracle, a per-batch HBM peak ------------------------


class _GarbageEngine:
    """A primary whose every answer is invalid, as ``device.batch_nan``
    makes the card's: every batch goes to the breaker's oracle."""

    def batch_check(self, requests, max_depth=0, depths=None):
        return [float("nan")] * len(requests)


class _SlowStore:
    """A store whose every page costs ``page_s`` more: the registry's
    oracle (``CheckEngine`` over the store) made slow, as a full-column
    scan per query makes it at ten million tuples."""

    page_s = 0.005

    def __init__(self, store):
        self.store = store
        self.calls = 0

    def get_relation_tuples(self, query, pagination=None):
        self.calls += 1
        time.sleep(self.page_s)
        return self.store.get_relation_tuples(query, pagination)


def _bounded_rig(seed=3):
    from tests.test_torch_device_engine import random_requests, random_tuples

    rng = random.Random(seed)
    import numpy as np

    nrng = np.random.default_rng(seed)
    lines = random_tuples(nrng, 30, 12, 120)
    reqs = random_requests(nrng, 30, 12, k=64)
    rng.shuffle(reqs)
    tstore, jstore = TStore(), JStore()
    tstore.write_relation_tuples(*[TTuple.from_string(x) for x in lines])
    jstore.write_relation_tuples(*[JTuple.from_string(x) for x in lines])
    want = JCheck(jstore).batch_check([JTuple.from_string(r) for r in reqs])
    oracle = TCheck(_SlowStore(tstore))
    breaker = tfb.DeviceFallbackEngine(
        _GarbageEngine(), fallback_factory=lambda: oracle, failure_threshold=3,
        cooldown_s=1.0,
    )
    return breaker, [TTuple.from_string(r) for r in reqs], want


def test_a_slow_oracle_returns_by_the_deadline_plus_one_row():
    """A 64-row batch whose every answer the oracle must give (5 ms a store
    page, ~20 pages a row), under a 0.3 s deadline through the batcher:
    the batch fails typed by 0.3 s + one page (the oracle reads the clock
    before each page), so well inside one row's time, and every row it
    answered is the reference's answer."""
    from keto_tpu_torch.utils.errors import DeadlineExceeded

    breaker, reqs, want = _bounded_rig()
    batcher = CheckBatcher(breaker, window_s=0, pipeline_depth=0)
    budget = 0.3
    try:
        t0 = time.monotonic()
        with pytest.raises(DeadlineExceeded) as err:
            batcher.check_batch(reqs, deadline=t0 + budget)
        wall = time.monotonic() - t0
    finally:
        batcher.close()
    answers = err.value.answers
    answered = [i for i, v in enumerate(answers) if v is not None]
    assert wall <= budget + _SlowStore.page_s + 0.15, wall
    assert 0 < len(answered) < len(reqs)
    assert answered == list(range(len(answered)))  # in order, then cut
    assert [answers[i] for i in answered] == [want[i] for i in answered]
    assert breaker.n_deadline_skips == len(reqs) - len(answered)
    # with time enough, the same batch is answered whole, exactly
    batcher = CheckBatcher(breaker, window_s=0, pipeline_depth=0)
    try:
        assert batcher.check_batch(reqs, deadline=time.monotonic() + 60) == want
    finally:
        batcher.close()


def test_a_row_is_cut_inside_its_search():
    """One row whose search needs many pages at 0.1 s a page, under a 0.05 s
    deadline: the oracle gives up at its next page, so the row comes back
    None after about one page, not after the whole search; with time
    enough the same search answers as the reference."""
    breaker, reqs, want = _bounded_rig(seed=5)
    oracle = breaker.fallback_engine()
    pages = {}
    oracle.manager.page_s = 0.0
    for r in reqs:  # the row whose search asks for the most pages
        before = oracle.manager.calls
        oracle.subject_is_allowed(r)
        pages[r] = oracle.manager.calls - before
    row = max(reqs, key=pages.get)
    assert pages[row] >= 4
    oracle.manager.page_s = 0.1
    t0 = time.monotonic()
    got = breaker._fallback_check([row], 0, None, [t0 + 0.05])
    wall = time.monotonic() - t0
    assert got == [None] and wall < 0.35, wall
    oracle.manager.page_s = 0.0
    assert oracle.check_until(row, 0, time.monotonic() + 60) is want[reqs.index(row)]


def test_the_oracle_checks_every_rows_own_deadline():
    """Per-row deadlines (the pipeline's shape): a passed deadline skips its
    row, a None deadline never does, and the rows answered are exact."""
    breaker, reqs, want = _bounded_rig(seed=4)
    now = time.monotonic()
    deadlines = [None if i % 3 == 0 else (now - 1 if i % 3 == 1 else now + 60)
                 for i in range(len(reqs))]
    got = breaker._fallback_check(reqs, 0, None, deadlines)
    for i, v in enumerate(got):
        assert v is None if i % 3 == 1 else v == want[i]


def test_a_batch_teaches_admission_under_a_larger_earlier_peak():
    """An earlier 10 GB peak, then a batch that allocates 2 GB over 1 GB in
    use: the reference's process-peak delta is 0 and learns nothing; the
    port's per-batch window learns 2 GB for the shape. Its reported high
    water mark never falls below the earlier peak."""
    gb = 1 << 30
    learned = {}
    for hbm, stats in _both_hbm(limit=80 * gb, bytes_per_row=4096):
        stats.alloc(10 * gb)
        stats.free(9 * gb)  # 1 GB stays resident; the mark stays at 10 GB
        token = hbm.reserve(4096, 7)
        stats.alloc(2 * gb)
        stats.free(2 * gb)
        hbm.release(token)
        learned[hbm.__module__] = (hbm.modeled_bytes(4096, 7), hbm.snapshot()["modeled_shapes"])
        assert stats.peak_bytes() == 10 * gb
    assert learned[jhbm.__name__] == (4096 * 4096, 0)  # the reference: nothing
    assert learned[thbm.__name__] == (2 * gb, 1)


def test_devstats_windows_keep_the_high_water_mark(monkeypatch):
    """The collector's per-batch window over a fake CUDA allocator: the
    window resets the allocator's peak only while no batch is in flight,
    overlapping batches share it, each is charged at least its own rise
    (also when bytes in use before the window are freed while it is open),
    and the reported mark never falls."""
    import torch

    from keto_tpu_torch.telemetry import devstats

    gb = 1 << 30
    alloc = {"in_use": 0, "peak": 0, "allocated": 0, "freed": 0, "resets": 0}

    def reset():
        alloc["peak"] = alloc["in_use"]
        alloc["resets"] += 1

    def grow(n):
        alloc["in_use"] += n
        alloc["allocated" if n > 0 else "freed"] += abs(n)
        alloc["peak"] = max(alloc["peak"], alloc["in_use"])

    def nested():
        return {"allocated_bytes": {"all": {
            "current": alloc["in_use"], "allocated": alloc["allocated"],
            "freed": alloc["freed"],
        }}}

    monkeypatch.setattr(devstats, "cuda_ready", lambda: True)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: alloc["peak"])
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a: alloc["in_use"])
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda *a: alloc["in_use"])
    monkeypatch.setattr(torch.cuda, "memory_stats_as_nested_dict", lambda *a: nested())
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda *a: reset())
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "fake")
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda *a: (70 * gb, 80 * gb))
    col = devstats.DeviceStatsCollector()
    hbm = thbm.HbmAdmission(devstats=col, bytes_per_row=4096)
    marks = []

    def mark():
        marks.append(col.peak_bytes())
        assert col.sample_devices()[0]["memory_stats"]["peak_bytes_in_use"] == marks[-1]

    grow(12 * gb)
    grow(-11 * gb)
    mark()
    a = hbm.reserve(4096, 1)  # opens the window: one reset
    grow(3 * gb)
    b = hbm.reserve(1024, 1)  # inside the open window: no reset
    grow(1 * gb)
    mark()
    grow(-4 * gb)
    hbm.release(b)
    hbm.release(a)
    mark()
    assert alloc["resets"] == 1
    # each overlapping batch is charged its own rise: a 3 GB plus b's 1 GB
    # (a neighbour's bytes: an overestimate), b its own 1 GB
    assert hbm.modeled_bytes(4096, 1) == 4 * gb and hbm.modeled_bytes(1024, 1) == 1 * gb
    c = hbm.reserve(4096, 2)  # a new window
    grow(2 * gb)
    grow(-2 * gb)
    hbm.release(c)
    mark()
    assert alloc["resets"] == 2 and hbm.modeled_bytes(4096, 2) == 2 * gb
    # a window that never closes: 10 GB in use when it opens, d's 1 GB
    # peak, then e enters and 8 GB in use before the window are freed (a
    # residency swap) while e allocates 5 GB. The window's peak (11 GB)
    # is over e's entry, yet e is charged its whole 5 GB.
    grow(9 * gb)
    d = hbm.reserve(4096, 3)
    grow(1 * gb)
    e = hbm.reserve(2048, 3)
    grow(-8 * gb)
    grow(5 * gb)
    hbm.release(e)
    grow(-1 * gb)
    hbm.release(d)
    mark()
    assert hbm.modeled_bytes(2048, 3) == 5 * gb
    assert hbm.modeled_bytes(4096, 3) == 6 * gb  # its 1 GB and e's 5 GB
    assert alloc["resets"] == 3
    assert marks == [12 * gb] * 5 and hbm.snapshot()["modeled_shapes"] == 5