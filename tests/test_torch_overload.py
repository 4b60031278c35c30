"""keto_tpu_torch's overload-control plane vs keto_tpu's, on the CPU.

Both packages' ``OverloadController`` take the same injected clock and
random source, and the same script of ``admit`` and ``observe`` calls
(calm traffic, storms of every criticality class, idle gaps, the kill
switch): every decision, every rung, the LIFO and cull flags and the final
snapshot and history must be identical. The cases of
``tests/test_overload.py`` that apply to the port follow (criticality
parsing, the AIMD limiter and CoDel, the brownout ladder, the SRE throttle,
the controller facade, the batcher's cull and LIFO), then one batcher test
per shape over real engines (the serial shape over ClosureCheckEngine, the
pipelined shape over DeviceCheckEngine in packed mode): ``sheddable`` is
shed before ``default``, ``critical`` only by ``max_queue``, and the CoDel
cull spares ``critical``. Last, the REST plane against keto_tpu's with the
ladder pinned: the ``X-Request-Criticality`` header and the 429's
``Retry-After``. Tolerance: exact.
"""

import json
import random
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from keto_tpu.engine import overload as jov
from keto_tpu_torch.engine import overload as tov
from keto_tpu_torch.engine.batcher import BatcherOverloaded, CheckBatcher
from keto_tpu_torch.engine.overload import (
    CRITICAL,
    DEFAULT,
    SHEDDABLE,
    STATE_BOUNDED_STALE,
    STATE_HEDGE_SUPPRESS,
    STATE_NORMAL,
    STATE_SHED_DEFAULT,
    STATE_SHED_SHEDDABLE,
    AdaptiveLimiter,
    AdaptiveThrottle,
    BrownoutController,
    OverloadController,
    parse_criticality,
)
from keto_tpu_torch.relationtuple import RelationTuple
from keto_tpu_torch.utils.errors import ErrResourceExhausted

import test_torch_rest
from test_torch_closure_engine import random_requests, random_tuples


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt
        return self.t


def _tup(i=0):
    return RelationTuple.from_string(f"n:o{i}#view@u")


# -- parity: one script through both packages ----------------------------------


def _script(seed: int) -> list:
    """Phases of traffic: calm, a storm, recovery, an idle gap, the kill
    switch off and on, a second storm; each tick observes one batch and
    admits a few requests of mixed criticality."""
    rng = np.random.default_rng(seed)
    ops = []
    phases = [("calm", 40), ("storm", 80), ("calm", 60), ("idle", 1),
              ("off", 20), ("storm", 40), ("calm", 120)]
    for name, ticks in phases:
        if name == "idle":
            ops.append(("advance", float(rng.uniform(2.0, 6.0))))
            continue
        if name == "off":
            ops.append(("enable", False))
        for _ in range(ticks):
            ops.append(("advance", float(rng.uniform(0.005, 0.06))))
            storm = name == "storm"
            delay = float(rng.uniform(0.1, 2.0) if storm else rng.uniform(0.0, 0.02))
            ops.append(("observe", delay, float(rng.uniform(0.0, 0.05))))
            for _ in range(int(rng.integers(1, 6))):
                qlen = int(rng.integers(0, 6000 if storm else 50))
                crit = (CRITICAL, DEFAULT, SHEDDABLE, "bogus")[int(rng.integers(4))]
                ops.append(("admit", qlen, crit))
        if name == "off":
            ops.append(("enable", True))
    return ops


def _run(mod, ops, seed, default_parts: bool):
    clk = _Clock()
    rng = random.Random(seed)
    enabled = [True]
    if default_parts:
        ctl = mod.OverloadController(
            max_queue=4096, enabled_fn=lambda: enabled[0], clock=clk, rand=rng.random
        )
    else:
        ctl = mod.OverloadController(
            max_queue=1_000_000,
            limiter=mod.AdaptiveLimiter(initial=100, target_delay_s=0.05,
                                        interval_s=0.05, clock=clk),
            brownout=mod.BrownoutController(hysteresis_s=0.5, min_dwell_s=0.02,
                                            clock=clk, history=32),
            throttle=mod.AdaptiveThrottle(window_s=5.0, clock=clk),
            enabled_fn=lambda: enabled[0],
            clock=clk,
            rand=rng.random,
        )
    trace = []
    for op in ops:
        if op[0] == "advance":
            clk.advance(op[1])
        elif op[0] == "enable":
            enabled[0] = op[1]
        elif op[0] == "observe":
            ctl.observe(op[1], op[2])
        else:
            trace.append(ctl.admit(op[1], op[2]))
        trace.append((ctl.state(), ctl.lifo(), ctl.cull_age_s(), ctl.stale_ok(),
                      ctl.hedge_suppressed(), round(ctl.limiter.limit, 9)))
    return trace, ctl.snapshot(), ctl.history()


@pytest.mark.parametrize("default_parts", [False, True], ids=["tuned", "defaults"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_same_script_same_decisions(seed, default_parts):
    ops = _script(seed)
    want = _run(jov, ops, seed, default_parts)
    got = _run(tov, ops, seed, default_parts)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    sheds = got[1]["sheds_by_class"]
    assert sheds[CRITICAL] == 0
    if not default_parts:
        # the storms reached the shedding rungs; the calm tail stepped down
        assert sheds[SHEDDABLE] > 0 and got[1]["brownout"]["transitions_down"] > 0


def test_the_port_names_the_reference_ladder():
    assert tov.STATE_NAMES == jov.STATE_NAMES
    assert tov.CRITICALITIES == jov.CRITICALITIES


# -- criticality parsing ---------------------------------------------------------


def test_criticality_parsing():
    assert parse_criticality("critical") == CRITICAL
    assert parse_criticality(" Sheddable ") == SHEDDABLE
    assert parse_criticality("DEFAULT") == DEFAULT
    # a typo must not change the answer, only the shed priority
    assert parse_criticality("importantest") == DEFAULT
    assert parse_criticality("") == DEFAULT
    assert parse_criticality(None) == DEFAULT
    assert parse_criticality(None, default=SHEDDABLE) == SHEDDABLE
    assert parse_criticality("nope", default=SHEDDABLE) == SHEDDABLE
    assert parse_criticality("critical", default=SHEDDABLE) == CRITICAL


# -- AIMD limiter and CoDel --------------------------------------------------------


def test_additive_increase_under_healthy_latency():
    clk = _Clock()
    lim = AdaptiveLimiter(initial=100, target_delay_s=0.1, interval_s=0.1, clock=clk)
    for _ in range(10):
        clk.advance(0.2)
        lim.observe(0.005, 0.005)
    assert lim.limit == pytest.approx(100 + 10 * lim.additive)
    assert lim.decreases == 0 and not lim.overloaded


def test_multiplicative_decrease_on_inflation():
    clk = _Clock()
    lim = AdaptiveLimiter(initial=100, target_delay_s=0.1, interval_s=0.1,
                          tolerance=2.0, clock=clk)
    for _ in range(5):  # learn a ~5 ms baseline
        clk.advance(0.2)
        lim.observe(0.005)
    base_limit = lim.limit
    for _ in range(5):  # 50 ms >> 2x the baseline, still under the target
        clk.advance(0.2)
        lim.observe(0.05)
    assert lim.limit < base_limit and lim.decreases >= 1


def test_convergence_floor_is_min_limit():
    clk = _Clock()
    lim = AdaptiveLimiter(initial=64, min_limit=8, target_delay_s=0.01,
                          interval_s=0.1, clock=clk)
    for _ in range(200):
        clk.advance(0.2)
        lim.observe(1.0)
    assert lim.limit == 8.0


def test_codel_sustain_flips_lifo_and_cull():
    clk = _Clock()
    lim = AdaptiveLimiter(initial=100, target_delay_s=0.1, interval_s=0.1, clock=clk)
    lim.observe(0.2)  # one sample above the target is a burst
    assert not lim.overloaded and lim.cull_age_s() is None
    clk.advance(0.15)
    lim.observe(0.2)
    assert lim.overloaded and lim.lifo()
    assert lim.cull_age_s() == pytest.approx(0.1)
    lim.observe(0.01)  # below the target: the episode ends
    assert not lim.overloaded and lim.cull_age_s() is None


def test_baseline_frozen_while_overloaded():
    clk = _Clock()
    lim = AdaptiveLimiter(initial=100, target_delay_s=0.05, interval_s=0.1, clock=clk)
    lim.observe(0.005)
    clk.advance(0.2)
    lim.observe(0.2)
    clk.advance(0.2)
    lim.observe(0.2)
    assert lim.overloaded
    frozen = lim._baseline
    clk.advance(0.2)
    lim.observe(5.0)
    assert lim._baseline == pytest.approx(frozen)


# -- the brownout ladder -----------------------------------------------------------


def _ladder(clk, **kw):
    kw.setdefault("up_thresholds", (1.0, 1.5, 2.0, 3.0))
    kw.setdefault("hysteresis_s", 1.0)
    kw.setdefault("min_dwell_s", 0.05)
    return BrownoutController(clock=clk, **kw)


def test_ladder_escalates_one_rung_per_dwell():
    clk = _Clock()
    b = _ladder(clk)
    seen = [b.update(99.0, clk.t)]
    for _ in range(6):
        clk.advance(0.06)
        seen.append(b.update(99.0, clk.t))
    assert seen[:5] == [1, 2, 3, 4, 4] and b.transitions_up == 4


def test_shed_order_and_critical_exemption():
    b = _ladder(_Clock())
    b.state = STATE_SHED_SHEDDABLE
    assert b.should_shed(SHEDDABLE) and not b.should_shed(DEFAULT)
    assert not b.should_shed(CRITICAL)
    b.state = STATE_SHED_DEFAULT
    assert b.should_shed(SHEDDABLE) and b.should_shed(DEFAULT)
    assert not b.should_shed(CRITICAL)


def test_degradations_by_rung():
    b = _ladder(_Clock())
    assert not b.hedge_suppressed() and not b.stale_ok()
    b.state = STATE_HEDGE_SUPPRESS
    assert b.hedge_suppressed() and not b.stale_ok()
    b.state = STATE_BOUNDED_STALE
    assert b.hedge_suppressed() and b.stale_ok()


def test_hysteresis_prevents_flapping():
    clk = _Clock()
    b = _ladder(clk)
    b.update(1.2, clk.t)
    assert b.state == 1
    for _ in range(20):
        clk.advance(0.4)
        b.update(0.1, clk.t)
        clk.advance(0.4)
        b.update(0.9, clk.t)
    assert b.state == 1 and b.transitions_down == 0
    clk.advance(0.4)
    b.update(0.1, clk.t)
    clk.advance(1.1)
    b.update(0.1, clk.t)
    assert b.state == 0 and b.transitions_down == 1


def test_step_down_one_rung_per_quiet_window():
    clk = _Clock()
    b = _ladder(clk, min_dwell_s=0.0)
    for _ in range(4):
        clk.advance(0.01)
        b.update(99.0, clk.t)
    assert b.state == 4
    states = []
    for _ in range(6):
        clk.advance(1.05)
        states.append(b.update(0.0, clk.t))
    assert states == [4, 3, 2, 1, 0, 0]


def test_idle_decay_via_current():
    clk = _Clock()
    b = _ladder(clk)
    b.update(1.2, clk.t)
    assert b.state == 1
    clk.advance(5.0)
    assert b.current(clk.t) == 0


def test_transitions_reach_the_flight_hook_and_history():
    class Flight:
        def __init__(self):
            self.records = []

        def record(self, **event):
            self.records.append(event)

    clk = _Clock()
    flight = Flight()
    b = _ladder(clk, flight=flight)
    b.update(1.2, clk.t)
    clk.advance(2.0)
    b.update(0.0, clk.t)
    clk.advance(1.1)
    b.update(0.0, clk.t)
    hist = b.history()
    assert [h["direction"] for h in hist] == ["down", "up"]
    assert hist[1]["from"] == "normal" and hist[1]["to"] == "hedge_suppress"
    assert [r["kind"] for r in flight.records] == ["overload", "overload"]


def test_threshold_validation():
    with pytest.raises(ValueError):
        BrownoutController(up_thresholds=(1.0, 1.5))
    with pytest.raises(ValueError):
        BrownoutController(up_thresholds=(1.0, 1.5, 1.5, 3.0))


# -- the SRE throttle --------------------------------------------------------------


def test_throttle_zero_rejects_while_accepts_keep_up():
    th = AdaptiveThrottle(window_s=10.0, k=2.0, clock=_Clock())
    for _ in range(100):
        th.on_request()
        th.on_accept()
    assert th.reject_probability() == 0.0


def test_throttle_formula_exact():
    th = AdaptiveThrottle(window_s=10.0, k=2.0, clock=_Clock())
    for _ in range(100):
        th.on_request()
    for _ in range(10):
        th.on_accept()
    assert th.reject_probability() == pytest.approx(80 / 101)


def test_throttle_window_slides_old_buckets_out():
    clk = _Clock()
    th = AdaptiveThrottle(window_s=5.0, k=2.0, bucket_s=1.0, clock=clk)
    for _ in range(50):
        th.on_request()
    assert th.reject_probability() > 0.9
    clk.advance(10.0)
    assert th.totals() == (0, 0) and th.reject_probability() == 0.0


# -- the controller facade -----------------------------------------------------------


def _controller(clk, enabled_fn=None, rand=lambda: 0.5, max_queue=1_000_000):
    return OverloadController(
        max_queue=max_queue,
        limiter=AdaptiveLimiter(initial=100, target_delay_s=0.05, interval_s=0.05,
                                clock=clk),
        brownout=BrownoutController(hysteresis_s=0.5, min_dwell_s=0.02, clock=clk),
        throttle=AdaptiveThrottle(window_s=5.0, clock=clk),
        enabled_fn=enabled_fn,
        clock=clk,
        rand=rand,
    )


def _storm(ctl, clk, ticks=60, delay=1.0):
    shed = {CRITICAL: 0, DEFAULT: 0, SHEDDABLE: 0}
    for _ in range(ticks):
        clk.advance(0.03)
        ctl.observe(delay)
        for crit in (CRITICAL, DEFAULT, SHEDDABLE):
            if ctl.admit(5000, crit) is not None:
                shed[crit] += 1
    return shed


def test_storm_sheds_ordered_never_critical():
    clk = _Clock()
    ctl = _controller(clk)
    shed = _storm(ctl, clk)
    assert ctl.state() == STATE_SHED_DEFAULT
    assert shed[CRITICAL] == 0 and shed[SHEDDABLE] > shed[DEFAULT] > 0
    snap = ctl.snapshot()
    assert snap["sheds_by_class"][CRITICAL] == 0 and snap["state_name"] == "shed_default"


def test_recovery_steps_down_within_hysteresis_windows():
    clk = _Clock()
    ctl = _controller(clk)
    _storm(ctl, clk)
    assert ctl.state() >= STATE_SHED_SHEDDABLE
    for _ in range(200):
        clk.advance(0.03)
        ctl.observe(0.001)
        ctl.admit(0, DEFAULT)
    assert ctl.state() == STATE_NORMAL and ctl.admit(0, SHEDDABLE) is None


def test_disabled_means_admit_everything():
    clk = _Clock()
    enabled = [False]
    ctl = _controller(clk, enabled_fn=lambda: enabled[0])
    assert _storm(ctl, clk) == {CRITICAL: 0, DEFAULT: 0, SHEDDABLE: 0}
    assert ctl.state() == STATE_NORMAL and ctl.snapshot()["enabled"] is False
    enabled[0] = True  # the kill switch is live
    assert _storm(ctl, clk)[SHEDDABLE] > 0


# -- the batcher's queue discipline (stub engine, stub controller) ---------------------


class _GateEngine:
    """batch_check blocks until released; records dispatch order."""

    def __init__(self):
        self.release = threading.Event()
        self.batches: list = []

    def batch_check(self, requests, depths=None):
        assert self.release.wait(30), "gate never released"
        self.batches.append([r.object for r in requests])
        return [True] * len(requests)


class _StubOverload:
    """Admits everything; culls and serves LIFO on demand."""

    def __init__(self, cull=None, use_lifo=False):
        self.cull = cull
        self.use_lifo = use_lifo
        self.culled = 0
        self.seen: list = []

    def admit(self, queue_len, criticality=DEFAULT):
        self.seen.append(criticality)
        return None

    def observe(self, queue_delay_s, service_s=0.0):
        pass

    def lifo(self):
        return self.use_lifo

    def cull_age_s(self):
        return self.cull

    def note_idle(self, idle_s):
        pass

    def note_culled(self, n):
        self.culled += n

    def stale_ok(self):
        return False

    def snapshot(self):
        return {}


def _spin(batcher, i, crit, results, **kw):
    def run():
        try:
            results[i] = batcher.check(_tup(i), timeout=30, criticality=crit, **kw)
        except BaseException as e:
            results[i] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def wait_until(pred, timeout_s=30.0):
    deadline = time.monotonic() + timeout_s
    while not pred():
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(0.002)


def test_codel_cull_exempts_critical():
    ov = _StubOverload(cull=0.01)
    eng = _GateEngine()
    b = CheckBatcher(eng, max_batch=8, window_s=0.0, overload=ov)
    results: dict = {}
    try:
        warm = _spin(b, 0, DEFAULT, results)
        wait_until(lambda: b._inflight)
        t1 = _spin(b, 1, CRITICAL, results)
        t2 = _spin(b, 2, SHEDDABLE, results)
        wait_until(lambda: len(b._queue) == 2)
        time.sleep(0.05)  # both queued well past the 10 ms cull age
        eng.release.set()
        for t in (warm, t1, t2):
            t.join(timeout=30)
        assert isinstance(results[2], ErrResourceExhausted)
        assert "culled" in str(results[2])
        assert results[1] is True and ov.culled == 1
    finally:
        eng.release.set()
        b.close()


def test_a_quiet_spell_clears_the_storm_verdict():
    """After a storm the limiter's sustained-delay verdict stays set until a
    dispatch observes a delay under target; a queue that then stays empty
    for a whole interval must clear it, or the next lone check is culled by
    the storm's verdict on its first scheduling delay past the target (here
    the batcher's 20 ms accumulation window against a 5 ms target). A gap
    shorter than the interval keeps the verdict. The reference has no such
    exit; this is the port's repair."""
    ctl = OverloadController(
        max_queue=1000,
        limiter=AdaptiveLimiter(initial=100, target_delay_s=0.005, interval_s=0.05),
        brownout=BrownoutController(hysteresis_s=0.05, min_dwell_s=0.0),
        throttle=AdaptiveThrottle(window_s=5.0),
    )
    ctl.limiter.overloaded = True  # the verdict a storm's last batch left
    ctl.note_idle(0.01)
    assert ctl.cull_age_s() == 0.005  # a gap inside a storm keeps it
    eng = _GateEngine()
    eng.release.set()
    b = CheckBatcher(eng, max_batch=8, window_s=0.02, overload=ctl)
    try:
        time.sleep(0.1)  # the quiet spell: the dispatcher waits, queue empty
        assert b.check(_tup(), timeout=10) is True
        assert ctl.culled == 0 and not ctl.limiter.overloaded
    finally:
        b.close()


def test_adaptive_lifo_serves_newest_first():
    ov = _StubOverload(use_lifo=True)
    eng = _GateEngine()
    b = CheckBatcher(eng, max_batch=1, window_s=0.0, overload=ov)
    results: dict = {}
    try:
        warm = _spin(b, 0, DEFAULT, results)
        wait_until(lambda: b._inflight)
        threads = []
        for i in (1, 2, 3):
            threads.append(_spin(b, i, DEFAULT, results))
            wait_until(lambda n=i: len(b._queue) == n)
        eng.release.set()
        for t in [warm] + threads:
            t.join(timeout=30)
        assert eng.batches[1:] == [["o3"], ["o2"], ["o1"]]
    finally:
        eng.release.set()
        b.close()


def test_criticality_threaded_into_admission():
    ov = _StubOverload()
    eng = _GateEngine()
    eng.release.set()
    b = CheckBatcher(eng, max_batch=8, window_s=0.0, overload=ov)
    try:
        b.check(_tup(), timeout=10, criticality=SHEDDABLE)
        b.check_batch([_tup()], timeout=10, criticality=CRITICAL)
        b.check(_tup(), timeout=10)
    finally:
        b.close()
    assert ov.seen == [SHEDDABLE, CRITICAL, DEFAULT]


def test_stale_ok_rung_skips_the_freshness_wait():
    class Engine(_GateEngine):
        waits = 0

        def wait_for_version(self, min_version, timeout_s=0.0):
            Engine.waits += 1

    clk = _Clock()
    ctl = _controller(clk)
    eng = Engine()
    eng.release.set()
    b = CheckBatcher(eng, max_batch=8, window_s=0.0, overload=ctl)
    try:
        assert b.check(_tup(), timeout=10, min_version=3)
        assert Engine.waits == 1 and ctl.stale_served == 0
        ctl.brownout.state = STATE_BOUNDED_STALE
        ctl.brownout._last_update = clk.t  # the frozen clock: no decay
        assert b.check(_tup(), timeout=10, min_version=3)
        assert b.check_batch([_tup()], timeout=10, min_version=3) == [True]
        assert Engine.waits == 1 and ctl.stale_served == 2
        assert b.pipeline_stats()["overload"]["stale_served"] == 2
    finally:
        b.close()


# -- one batcher test per shape, over real engines ------------------------------------


class _Gated:
    """A real engine behind a gate: the serial shape holds in batch_check,
    the pipelined shape in encode_batch."""

    def __init__(self, inner):
        self.inner = inner
        self.gate = threading.Event()
        self.gate.set()

    def __getattr__(self, name):
        attr = getattr(self.inner, name)
        if name in ("batch_check", "encode_batch"):
            def held(*a, **kw):
                assert self.gate.wait(30), "gate never opened"
                return attr(*a, **kw)
            return held
        return attr


def _engine(shape):
    from keto_tpu_torch.engine import ClosureCheckEngine, DeviceCheckEngine
    from keto_tpu_torch.graph import SnapshotManager
    from keto_tpu_torch.store import InMemoryTupleStore

    rng = np.random.default_rng(11)
    store = InMemoryTupleStore()
    store.write_relation_tuples(
        *(RelationTuple.from_string(s) for s in random_tuples(rng, 10, 6, 60))
    )
    requests = [RelationTuple.from_string(s) for s in random_requests(rng, 10, 6, k=24)]
    if shape == "serial-closure":
        eng = ClosureCheckEngine(SnapshotManager(store), device="cpu")
        return eng, requests, {"pipeline_depth": 0}
    eng = DeviceCheckEngine(SnapshotManager(store), mode="packed", device="cpu")
    return eng, requests, {"pipeline_depth": 2, "encode_workers": 2}


def _climb(ctl, clk, rung):
    """Drive the ladder to ``rung`` and freeze it there: the injected clock
    stops, so the dwell holds every further step up, and the real batches'
    observations cannot step it down."""
    while ctl.brownout.state < rung:
        clk.advance(0.06)
        ctl.observe(1.0)
    assert ctl.state() == rung


@pytest.mark.parametrize("shape", ["serial-closure", "pipelined-packed"])
def test_ladder_sheds_by_class_and_only_max_queue_refuses_critical(shape):
    inner, requests, kw = _engine(shape)
    want = [bool(v) for v in inner.batch_check(requests)]
    eng = _Gated(inner)
    clk = _Clock()
    # the throttle's random draw never rejects: the ladder alone decides
    ctl = _controller(clk, rand=lambda: 0.999, max_queue=4)
    b = CheckBatcher(eng, max_batch=1, window_s=0.0, max_queue=4, overload=ctl, **kw)
    assert b.pipelined == (shape == "pipelined-packed")
    try:
        r = requests[0]
        assert b.check(r, timeout=30, criticality=SHEDDABLE) == want[0]
        _climb(ctl, clk, STATE_SHED_SHEDDABLE)
        with pytest.raises(BatcherOverloaded, match="brownout, criticality=sheddable"):
            b.check(r, timeout=30, criticality=SHEDDABLE)
        with pytest.raises(BatcherOverloaded, match="brownout"):
            b.check_batch(requests, criticality=SHEDDABLE)
        got = [b.check(q, timeout=30, criticality=DEFAULT) for q in requests]
        assert got == want
        assert b.check_batch(requests, criticality=DEFAULT) == want
        _climb(ctl, clk, STATE_SHED_DEFAULT)
        for crit in (SHEDDABLE, DEFAULT):
            with pytest.raises(BatcherOverloaded, match=f"criticality={crit}"):
                b.check(r, timeout=30, criticality=crit)
        got = [b.check(q, timeout=30, criticality=CRITICAL) for q in requests]
        assert got == want
        assert b.check_batch(requests, criticality=CRITICAL) == want
        sheds = ctl.snapshot()["sheds_by_class"]
        assert sheds[CRITICAL] == 0 and sheds[SHEDDABLE] == 3 and sheds[DEFAULT] == 1
        # only the max_queue backstop refuses critical: hold the engine and
        # fill the queue behind the held batches
        eng.gate.clear()
        results: dict = {}
        threads = []
        for i, q in enumerate(requests[:12]):
            threads.append(_spin_req(b, i, q, CRITICAL, results))
            if len(b._queue) == 4:
                break
        wait_until(lambda: len(b._queue) == 4)
        with pytest.raises(BatcherOverloaded, match="The check queue is full"):
            b.check(r, timeout=30, criticality=CRITICAL)
        eng.gate.set()
        for t in threads:
            t.join(timeout=30)
        assert [results[i] for i in range(len(threads))] == want[: len(threads)]
        assert ctl.snapshot()["sheds_by_class"][CRITICAL] == 0
    finally:
        eng.gate.set()
        b.close()


def _spin_req(batcher, i, request, crit, results):
    def run():
        try:
            results[i] = batcher.check(request, timeout=30, criticality=crit)
        except BaseException as e:
            results[i] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    time.sleep(0.02)  # in order: the held stages take the first ones
    return t


@pytest.mark.parametrize("shape", ["serial-closure", "pipelined-packed"])
def test_codel_cull_spares_critical_over_real_engines(shape):
    inner, requests, kw = _engine(shape)
    want = [bool(v) for v in inner.batch_check(requests)]
    eng = _Gated(inner)
    ov = _StubOverload(cull=0.01)
    b = CheckBatcher(eng, max_batch=1, window_s=0.0, overload=ov, **kw)
    holders = 1 if shape == "serial-closure" else 2  # batches the held stages take
    results: dict = {}
    try:
        eng.gate.clear()
        threads = [_spin_req(b, i, requests[i], DEFAULT, results) for i in range(holders)]
        classes = [CRITICAL, SHEDDABLE, DEFAULT, CRITICAL]
        for j, crit in enumerate(classes):
            i = holders + j
            threads.append(_spin_req(b, i, requests[i], crit, results))
        wait_until(lambda: len(b._queue) == len(classes))
        time.sleep(0.05)  # every queued entry is past the 10 ms cull age
        eng.gate.set()
        for t in threads:
            t.join(timeout=30)
        for j, crit in enumerate(classes):
            i = holders + j
            if crit == CRITICAL:
                assert results[i] == want[i]
            else:
                assert isinstance(results[i], BatcherOverloaded)
                assert "culled" in str(results[i])
        assert ov.culled == 2
    finally:
        eng.gate.set()
        b.close()


# -- the REST plane, against keto_tpu's ----------------------------------------------


OVERLOAD_VALUES = {
    **test_torch_rest.VALUES,
    "engine": {"max_batch": 64, "query_mode": "device", "cache_size": 0},
    "overload": {"enabled": True, "target_delay_ms": 5000.0},
}


@pytest.fixture(scope="module")
def servers():
    mp = pytest.MonkeyPatch()
    mp.setattr(test_torch_rest, "VALUES", OVERLOAD_VALUES)
    jax_server, torch_server = test_torch_rest.JaxServer(), test_torch_rest.TorchServer()
    mp.undo()
    yield jax_server, torch_server
    torch_server.stop()
    jax_server.stop()


def _get(port, path, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read()), resp.headers.get("Retry-After")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers.get("Retry-After")


def _pin(ctl, state):
    ctl.brownout.state = state
    ctl.brownout._last_update = time.monotonic() + 3600  # no idle decay
    ctl.brownout._below_since = None  # and no quiet window carried over


def test_rest_criticality_header_and_retry_after(servers):
    jax_server, torch_server = servers
    controllers = [jax_server.registry._overload, torch_server.registry.overload()]
    assert all(c is not None for c in controllers)
    assert torch_server.registry.checker().overload is controllers[1]
    path = "/check?namespace=n&object=doc&relation=view&subject_id=alice"

    def both(headers=None):
        want = _get(jax_server.read_port, path, headers)
        got = _get(torch_server.read_port, path, headers)
        assert got == want, f"port {got} != jax {want}"
        return got

    for state, shed in ((STATE_NORMAL, ()), (STATE_SHED_SHEDDABLE, (SHEDDABLE,)),
                        (STATE_SHED_DEFAULT, (SHEDDABLE, DEFAULT, "bogus", None))):
        for ctl in controllers:
            _pin(ctl, state)
        for crit in (CRITICAL, DEFAULT, SHEDDABLE, "bogus", None):
            headers = {} if crit is None else {"X-Request-Criticality": crit}
            status, doc, retry = both(headers)
            if crit in shed:
                assert status == 429 and retry == "1", (state, crit, doc)
                assert "overloaded" in doc["error"]["message"]
            else:
                assert status == 403 and doc == {"allowed": False}, (state, crit)
    for ctl in controllers:
        _pin(ctl, STATE_NORMAL)
    sheds = controllers[1].snapshot()["sheds_by_class"]
    assert sheds[CRITICAL] == 0 and sheds == controllers[0].snapshot()["sheds_by_class"]
    # the class reaches the batcher: header, case-folded, unknown -> default
    checker = torch_server.registry.checker()
    seen = []
    orig = checker.check

    def spy(request, *a, **kw):
        seen.append(kw.get("criticality"))
        return orig(request, *a, **kw)

    checker.check = spy
    try:
        for crit in ("sheddable", "CRITICAL", "bogus", None):
            _get(torch_server.read_port, path,
                 {} if crit is None else {"X-Request-Criticality": crit})
    finally:
        del checker.check
    assert seen == [SHEDDABLE, CRITICAL, DEFAULT, DEFAULT]


def test_registry_default_criticality_reaches_rest_and_grpc():
    from keto_tpu_torch.api import rest
    from keto_tpu_torch.driver import Config, Registry

    reg = Registry(Config(values={"overload": {"default_criticality": "sheddable"}}),
                   device="cpu")
    assert reg.default_criticality() == SHEDDABLE
    assert reg.overload() is None  # overload.enabled defaults to false
    req = rest.Request.parse("GET", "/check", {}, b"")
    assert rest.criticality_from_headers(req, reg.default_criticality()) == SHEDDABLE
    req = rest.Request.parse("GET", "/check", {"X-Request-Criticality": "critical"}, b"")
    assert rest.criticality_from_headers(req, reg.default_criticality()) == CRITICAL


def test_grpc_metadata_criticality():
    from keto_tpu_torch.api.services import (
        CRITICALITY_METADATA_KEY,
        _criticality_from_metadata,
    )

    class Ctx:
        def __init__(self, md):
            self._md = md

        def invocation_metadata(self):
            return self._md

    assert _criticality_from_metadata(Ctx(((CRITICALITY_METADATA_KEY, "sheddable"),))) == (
        SHEDDABLE
    )
    assert _criticality_from_metadata(Ctx(())) == DEFAULT
    assert _criticality_from_metadata(Ctx(()), default=SHEDDABLE) == SHEDDABLE
    assert _criticality_from_metadata(Ctx(((CRITICALITY_METADATA_KEY, "bogus"),))) == (
        DEFAULT
    )


def test_rest_retry_after_rounds_up_never_zero():
    from keto_tpu_torch.api.rest import json_error

    err = ErrResourceExhausted("overloaded")
    err.retry_after_s = 0.2
    assert json_error(err).headers["Retry-After"] == "1"
    err.retry_after_s = 1.5
    assert json_error(err).headers["Retry-After"] == "2"
    err.retry_after_s = None
    assert json_error(err).headers["Retry-After"] == "1"
