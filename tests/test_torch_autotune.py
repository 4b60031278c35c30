"""keto_tpu_torch's online autotuner vs keto_tpu's, on the CPU.

Every scripted case of ``tests/test_autotune.py`` runs through both
packages' ``AutoTuner`` with the same scripted attribution ledger, knob
targets, SLO, guards and clock: the step events (knob, direction, old and
new values), the applied values, ``snapshot()``, ``history()``, the flight
records and the metrics exposition must be equal, and the reference's
invariants must hold for the port. ``tools/autotune_gate.py``'s scripted
bottleneck runs against the port's classes, unchanged. The registry cases
build both packages' knob tables from one config, wire the tuner through a
live port server (``/debug/autotune``, ``/metrics``, ``/debug/flight``, the
advertised hedge delay read back by the SDK's ``HedgePolicy``), and start
it from a hot reload. Tolerance: exact.
"""

import asyncio
import importlib.util
import json
import threading
import time
import urllib.request
from pathlib import Path

import pytest

import keto_tpu.engine.autotune as jautotune
import keto_tpu_torch.engine.autotune as tautotune
from keto_tpu.driver import Config as JConfig
from keto_tpu.driver import Registry as JRegistry
from keto_tpu.driver import config as jconfig
from keto_tpu.telemetry import MetricsRegistry as JMetrics
from keto_tpu.telemetry.flight import FlightRecorder as JFlight
from keto_tpu.utils.errors import ErrMalformedInput as JMalformed
from keto_tpu_torch.client.hedge import HedgePolicy
from keto_tpu_torch.driver import Config as TConfig
from keto_tpu_torch.driver import Registry as TRegistry
from keto_tpu_torch.driver import config as tconfig
from keto_tpu_torch.telemetry import MetricsRegistry as TMetrics
from keto_tpu_torch.telemetry.flight import FlightRecorder as TFlight
from keto_tpu_torch.utils.errors import ErrMalformedInput as TMalformed

REPO = Path(__file__).resolve().parent.parent


class Pkg:
    def __init__(self, name, mod, metrics, flight):
        self.name = name
        self.AutoTuner = mod.AutoTuner
        self.Knob = mod.Knob
        self.Metrics = metrics
        self.Flight = flight


PKGS = (
    Pkg("jax", jautotune, JMetrics, JFlight),
    Pkg("torch", tautotune, TMetrics, TFlight),
)


def both(case):
    """``case(pkg)`` under each package; the results must be equal. Returns
    the port's."""
    got = {pkg.name: case(pkg) for pkg in PKGS}
    assert got["torch"] == got["jax"]
    return got["torch"]


class _Clock:
    """One tick of fake time per reading: history timestamps compare equal."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


class _ScriptedLedger:
    """Cumulative attribution snapshots under test control: each
    ``advance`` is one control window's worth of traffic."""

    def __init__(self):
        self._requests = 0
        self._wall = 0.0
        self._stages: dict = {}

    def advance(self, requests: int, wall_s: float, stages: dict) -> None:
        self._requests += int(requests)
        self._wall += float(wall_s)
        for s, v in stages.items():
            self._stages[s] = self._stages.get(s, 0.0) + float(v)

    def snapshot(self) -> dict:
        return {
            "requests": self._requests,
            "entries": self._requests,
            "wall_s": round(self._wall, 6),
            "attributed_s": round(sum(self._stages.values()), 6),
            "unattributed_s": 0.0,
            "coverage": 1.0,
            "stages": {
                s: {"seconds": round(v, 6), "share_of_wall": 0.0}
                for s, v in self._stages.items()
            },
        }


class _Holder:
    """A knob target recording every applied value."""

    def __init__(self, value):
        self.value = value
        self.applied: list = []

    def read(self):
        return self.value

    def apply(self, v):
        self.applied.append(v)
        self.value = v


class _FakeSLO:
    def __init__(self):
        self.burn = 0.0
        self.fast_window_s = 300.0
        self.alert_burn_rate = 14.4

    def burn_rate(self, window_s):
        return self.burn


def _knob(pkg, holder, name="encode_workers", stage="queue", lo=1, hi=8, step=1, **kw):
    return pkg.Knob(name, stage=stage, lo=lo, hi=hi, step=step,
                    read=holder.read, apply=holder.apply, **kw)


def _tuner(pkg, knobs, ledger, **kw):
    kw.setdefault("min_requests", 10)
    kw.setdefault("backoff_ticks", 3)
    kw.setdefault("clock", _Clock())
    return pkg.AutoTuner(knobs, attribution=ledger, **kw)


def _state(t, *holders) -> dict:
    """Everything a scripted case can observe of a tuner."""
    return {
        "snapshot": t.snapshot(),
        "history": t.history(),
        "moves": t.moves_total,
        "reverts": t.reverts_total,
        "ticks": t.ticks,
        "applied": [list(h.applied) for h in holders],
        "values": [h.value for h in holders],
    }


# -- hill climbing -------------------------------------------------------------


def test_converges_to_bound_within_n_steps():
    def case(pkg):
        ledger, holder = _ScriptedLedger(), _Holder(2)
        t = _tuner(pkg, [_knob(pkg, holder)], ledger)
        # queue-bound traffic whose throughput rewards every raise: the
        # climber must reach the upper bound and then hold steady
        events = []
        for _ in range(20):
            ledger.advance(100 + 50 * holder.value, 1.0, {"queue": 0.6})
            events.append(t.step())
        events.append(t.step())
        return {**_state(t, holder), "events": events}

    out = both(case)
    assert out["values"] == [8]
    assert all(1 <= v <= 8 for v in out["applied"][0])
    assert out["moves"] == 6 and out["reverts"] == 0  # 2 -> 8 in unit steps
    assert out["events"][-1]["action"] in ("steady", "idle")
    assert [(e["knob"], e["direction"], e["new"]) for e in out["events"]
            if e["action"] == "move"] == [("encode_workers", 1, v) for v in range(3, 9)]


def test_moves_the_bottleneck_stages_knob_only():
    def case(pkg):
        ledger, q, k = _ScriptedLedger(), _Holder(2), _Holder(0.5)
        t = _tuner(pkg, [
            _knob(pkg, q, name="encode_workers", stage="queue"),
            _knob(pkg, k, name="hbm_budget_frac", stage="kernel",
                  lo=0.1, hi=0.95, step=0.05, integer=False),
        ], ledger)
        t.step()  # warmup
        ledger.advance(100, 1.0, {"kernel": 0.7, "queue": 0.1})
        event = t.step()
        return {**_state(t, q, k), "event": event}

    out = both(case)
    assert out["event"]["action"] == "move" and out["event"]["knob"] == "hbm_budget_frac"
    assert out["applied"][1] and not out["applied"][0]


def test_lower_is_better_direction():
    def case(pkg):
        ledger, page = _ScriptedLedger(), _Holder(2048)
        t = _tuner(pkg, [_knob(pkg, page, name="expand_page_size", stage="serialize",
                               lo=256, hi=8192, step=256, higher_helps=False)], ledger)
        t.step()
        ledger.advance(100, 1.0, {"serialize": 0.8})
        event = t.step()
        return {**_state(t, page), "event": event}

    out = both(case)
    assert out["event"]["action"] == "move" and out["event"]["direction"] == -1
    assert out["values"] == [1792]


def test_disabled_knob_and_unowned_stage_never_move():
    def case(pkg):
        ledger, holder = _ScriptedLedger(), _Holder(2)
        t = _tuner(pkg, [_knob(pkg, holder, enabled=False)], ledger)
        t.step()
        ledger.advance(100, 1.0, {"queue": 0.9, "unattributed": 2.0})
        event = t.step()
        return {**_state(t, holder), "event": event}

    out = both(case)
    assert out["event"]["action"] == "steady" and out["applied"] == [[]]


# -- reverts -------------------------------------------------------------------


def test_revert_on_regression_with_backoff():
    def case(pkg):
        ledger, holder = _ScriptedLedger(), _Holder(2)
        flight = pkg.Flight(capacity=64, clock=lambda: 0.0)
        t = _tuner(pkg, [_knob(pkg, holder)], ledger, flight=flight, revert_threshold=0.05)
        events = [t.step()]  # warmup
        ledger.advance(100, 1.0, {"queue": 0.6})
        events.append(t.step())  # 2 -> 3, baseline 100/s
        ledger.advance(50, 1.0, {"queue": 0.6})  # throughput halves
        events.append(t.step())
        after_revert = holder.value
        # the reverted (knob, direction) sits out backoff_ticks ticks
        for _ in range(4):
            ledger.advance(100, 1.0, {"queue": 0.6})
            events.append(t.step())
        return {**_state(t, holder), "events": events, "after_revert": after_revert,
                "flight": flight.records()}

    out = both(case)
    actions = [e["action"] for e in out["events"]]
    assert actions == ["warmup", "move", "revert", "steady", "steady", "steady", "move"]
    assert out["events"][2]["reason"] == "regression" and out["after_revert"] == 2
    assert out["reverts"] == 1
    # the revert flight record carries both breakdowns
    revert = [r for r in out["flight"] if r.get("action") == "revert"][0]
    assert revert["kind"] == "autotune"
    assert "queue" in revert["before"] and "queue" in revert["after"]


def test_commit_on_improvement_keeps_value():
    def case(pkg):
        ledger, holder = _ScriptedLedger(), _Holder(2)
        t = _tuner(pkg, [_knob(pkg, holder)], ledger)
        t.step()
        ledger.advance(100, 1.0, {"queue": 0.6})
        t.step()  # move 2 -> 3
        ledger.advance(150, 1.0, {"queue": 0.6})  # improved
        event = t.step()  # commit, then the next move
        return {**_state(t, holder), "event": event}

    out = both(case)
    assert out["values"] == [4] and out["reverts"] == 0
    assert out["event"]["action"] == "move"
    assert [h["action"] for h in out["history"]] == ["move", "commit", "move"]


def test_bounds_never_exceeded_under_adversarial_traffic():
    def case(pkg):
        ledger, holder = _ScriptedLedger(), _Holder(4)
        t = _tuner(pkg, [_knob(pkg, holder)], ledger, revert_threshold=0.05)
        # throughput that punishes every second window: moves and reverts
        # interleave, and no applied value may ever leave [lo, hi]
        for i in range(40):
            ledger.advance(200 if i % 2 else 40, 1.0, {"queue": 0.6})
            t.step()
        return _state(t, holder)

    out = both(case)
    assert all(1 <= v <= 8 for v in out["applied"][0])
    assert 1 <= out["values"][0] <= 8 and out["reverts"] > 0


def test_apply_failure_disqualifies_the_knob():
    class _Refusing(_Holder):
        def apply(self, v):
            raise RuntimeError("component closed")

    def case(pkg):
        ledger, bad, good = _ScriptedLedger(), _Refusing(2), _Holder(0.5)
        t = _tuner(pkg, [
            _knob(pkg, bad, name="encode_workers", stage="queue"),
            _knob(pkg, good, name="hbm_budget_frac", stage="queue",
                  lo=0.1, hi=0.95, step=0.05, integer=False),
        ], ledger)
        t.step()
        ledger.advance(100, 1.0, {"queue": 0.6})
        event = t.step()
        return {**_state(t, bad, good), "event": event}

    out = both(case)
    # the refusing knob is skipped; its stage-mate gets the move
    assert out["event"]["action"] == "move" and out["event"]["knob"] == "hbm_budget_frac"
    assert out["values"][0] == 2 and out["applied"][1]
    assert out["history"][1]["action"] == "apply_failed"


# -- freezes -------------------------------------------------------------------


def test_slo_burn_freezes_moves():
    def case(pkg):
        ledger, holder, slo = _ScriptedLedger(), _Holder(2), _FakeSLO()
        t = _tuner(pkg, [_knob(pkg, holder)], ledger, slo=slo)
        t.step()
        slo.burn = 20.0  # past alert_burn_rate (the freeze inherits it)
        ledger.advance(100, 1.0, {"queue": 0.6})
        frozen = t.step()
        frozen_state = _state(t, holder)
        slo.burn = 0.0
        ledger.advance(100, 1.0, {"queue": 0.6})
        return {"frozen": frozen, "frozen_state": frozen_state, "thawed": t.step()}

    out = both(case)
    assert out["frozen"]["action"] == "frozen" and out["frozen"]["reason"] == "slo_burn"
    assert out["frozen_state"]["applied"] == [[]] and out["frozen_state"]["moves"] == 0
    assert out["thawed"]["action"] == "move"


def test_freeze_reverts_the_pending_move():
    def case(pkg):
        ledger, holder, slo = _ScriptedLedger(), _Holder(2), _FakeSLO()
        t = _tuner(pkg, [_knob(pkg, holder)], ledger, slo=slo)
        t.step()
        ledger.advance(100, 1.0, {"queue": 0.6})
        t.step()  # move 2 -> 3, now pending
        slo.burn = 20.0
        ledger.advance(200, 1.0, {"queue": 0.6})  # even improving traffic
        event = t.step()
        return {**_state(t, holder), "event": event}

    out = both(case)
    assert out["event"]["action"] == "revert" and out["event"]["reason"] == "slo_burn"
    assert out["values"] == [2]


def test_guard_freezes_with_its_reason():
    def case(pkg):
        ledger, holder, open_ = _ScriptedLedger(), _Holder(2), {"v": False}
        t = _tuner(pkg, [_knob(pkg, holder)], ledger,
                   guards=(lambda: "breaker_open" if open_["v"] else None,))
        t.step()
        open_["v"] = True
        ledger.advance(100, 1.0, {"queue": 0.6})
        event = t.step()
        return {**_state(t, holder), "event": event}

    out = both(case)
    assert out["event"]["action"] == "frozen" and out["event"]["reason"] == "breaker_open"
    assert out["snapshot"]["frozen"] == "breaker_open"


def test_kill_switch_short_circuits_and_resets():
    def case(pkg):
        ledger, holder, enabled = _ScriptedLedger(), _Holder(2), {"v": True}
        t = _tuner(pkg, [_knob(pkg, holder)], ledger, enabled_fn=lambda: enabled["v"])
        t.step()
        ledger.advance(100, 1.0, {"queue": 0.6})
        t.step()  # move pending
        enabled["v"] = False
        ledger.advance(10, 1.0, {"queue": 0.6})
        off = t.step()
        off_snapshot = t.snapshot()
        # re-enabling starts from a fresh window: the first tick is warmup,
        # the stale pending move is never judged against a stale baseline
        enabled["v"] = True
        return {"off": off, "off_snapshot": off_snapshot, "on": t.step()}

    out = both(case)
    assert out["off"]["action"] == "disabled"
    assert out["off_snapshot"]["enabled"] is False
    assert out["on"]["action"] == "warmup"


def test_idle_window_makes_no_move():
    def case(pkg):
        ledger, holder = _ScriptedLedger(), _Holder(2)
        t = _tuner(pkg, [_knob(pkg, holder)], ledger, min_requests=32)
        t.step()
        ledger.advance(5, 1.0, {"queue": 0.6})
        event = t.step()
        return {**_state(t, holder), "event": event}

    out = both(case)
    assert out["event"]["action"] == "idle" and out["applied"] == [[]]


# -- visibility ----------------------------------------------------------------


def test_metrics_history_snapshot_and_flight_are_the_references():
    def case(pkg):
        ledger, holder = _ScriptedLedger(), _Holder(2)
        m = pkg.Metrics()
        flight = pkg.Flight(capacity=64, clock=lambda: 0.0)
        t = _tuner(pkg, [_knob(pkg, holder)], ledger, metrics=m, flight=flight)
        t.step()
        ledger.advance(100, 1.0, {"queue": 0.6})
        t.step()  # move
        ledger.advance(40, 1.0, {"queue": 0.6})
        t.step()  # revert
        return {**_state(t, holder), "text": m.expose(), "flight": flight.records()}

    out = both(case)
    assert 'keto_autotune_moves_total{direction="up",knob="encode_workers"} 1' in out["text"]
    assert "keto_autotune_reverts_total 1" in out["text"]
    assert "keto_autotune_frozen 0" in out["text"]
    # the per-knob gauge samples the live value (after the revert)
    assert 'keto_autotune_knob_value{knob="encode_workers"} 2' in out["text"]
    assert [h["action"] for h in out["history"][:2]] == ["revert", "move"]  # newest first
    assert out["snapshot"]["moves_total"] == 1 and out["snapshot"]["reverts_total"] == 1
    assert out["snapshot"]["knobs"]["encode_workers"]["value"] == 2
    assert {r.get("kind") for r in out["flight"]} == {"autotune"}


def test_daemon_start_stop():
    ledger, holder = _ScriptedLedger(), _Holder(2)
    t = _tuner(PKGS[1], [_knob(PKGS[1], holder)], ledger, interval_s=0.01)
    t.start()
    t.start()  # idempotent
    deadline = time.time() + 5
    while t.ticks < 3 and time.time() < deadline:
        time.sleep(0.01)
    t.stop()
    assert t.ticks >= 3
    assert t.snapshot()["running"] is False


def test_knob_clamp_and_validation():
    def case(pkg):
        h = _Holder(2)
        k = _knob(pkg, h, lo=1, hi=8, step=1)
        errors = []
        for kw in ({"lo": 8, "hi": 1}, {"step": 0}):
            try:
                _knob(pkg, h, **kw)
            except ValueError as e:
                errors.append(str(e))
        return {"clamp": [k.clamp(0), k.clamp(99), k.clamp(3.6)],
                "fclamp": _knob(pkg, h, lo=0.1, hi=0.95, step=0.05, integer=False).clamp(1.2),
                "describe": k.describe(), "errors": errors}

    out = both(case)
    assert out["clamp"] == [1, 8, 4] and out["fclamp"] == 0.95
    assert len(out["errors"]) == 2


# -- tools/autotune_gate.py's scripted bottleneck ------------------------------


def _gate_module():
    spec = importlib.util.spec_from_file_location(
        "_autotune_gate", REPO / "tools" / "autotune_gate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_autotune_gate_holds_for_the_port(monkeypatch, capsys):
    """The gate's own main(), unchanged, with the port's AutoTuner, Knob and
    MetricsRegistry in place of the reference's: it exits 1 on any broken
    invariant (climb, overshoot, revert and hold at depth 5; workers ridden
    to their bound 6; every applied value in bounds; a guard flip freezes
    and thaws; the four families exposed)."""
    gate = _gate_module()
    monkeypatch.setattr(gate, "AutoTuner", tautotune.AutoTuner)
    monkeypatch.setattr(gate, "Knob", tautotune.Knob)
    monkeypatch.setattr(gate, "MetricsRegistry", TMetrics)
    assert gate.main() == 0
    assert "autotune gate: OK" in capsys.readouterr().out


def test_autotune_gate_drive_is_the_references():
    """The gate's 60-tick drive through both packages: the same moves,
    reverts, applied values, history and snapshot."""
    gate = _gate_module()

    def case(pkg):
        world = gate.World()

        def setter(name, attr):
            def apply(v):
                world.applied.append((name, v))
                setattr(world, attr, int(v))
            return apply

        tuner = pkg.AutoTuner(
            [pkg.Knob("pipeline_depth", stage="launch", lo=1, hi=8, step=1,
                      read=lambda: world.depth, apply=setter("pipeline_depth", "depth")),
             pkg.Knob("encode_workers", stage="queue", lo=1, hi=6, step=1,
                      read=lambda: world.workers, apply=setter("encode_workers", "workers"))],
            attribution=world, metrics=pkg.Metrics(), min_requests=10,
            revert_threshold=0.05, backoff_ticks=2, clock=_Clock(),
        )
        for _ in range(60):
            world.advance_window()
            tuner.step()
        return {"depth": world.depth, "workers": world.workers,
                "applied": world.applied, "history": tuner.history(),
                "snapshot": tuner.snapshot()}

    out = both(case)
    assert (out["depth"], out["workers"]) == (5, 6)
    # pipeline_depth climbs, overshoots once, reverts, and holds
    depth_moves = [(e["action"], e["new"]) for e in reversed(out["history"])
                   if e.get("knob") == "pipeline_depth" and e["action"] in ("move", "revert")]
    assert depth_moves[:5] == [("move", 3), ("move", 4), ("move", 5), ("move", 6),
                               ("revert", 5)]
    # encode_workers rides to its bound; no value ever leaves its bounds
    bounds = {"pipeline_depth": (1, 8), "encode_workers": (1, 6)}
    assert max(v for name, v in out["applied"] if name == "encode_workers") == 6
    assert all(bounds[name][0] <= v <= bounds[name][1] for name, v in out["applied"])


# -- config and the registry ---------------------------------------------------


@pytest.mark.parametrize("key,value", [
    ("engine.pipeline_depth", -1),
    ("engine.encode_workers", 0),
    ("engine.memory.hbm_budget_frac", 1.5),
    ("serve.read.max_freshness_wait_s", -2),
    ("engine.batch_window_us", 100),
    ("dsn", "sqlite://elsewhere"),
])
def test_set_hot_refuses_as_the_reference_refuses(key, value):
    j, t = JConfig(values={"dsn": "memory"}, env={}), TConfig(values={"dsn": "memory"})
    with pytest.raises(JMalformed) as want:
        j.set_hot(key, value)
    with pytest.raises(TMalformed) as got:
        t.set_hot(key, value)
    assert got.value.message == want.value.message


def test_every_registered_knob_has_a_schema_entry():
    assert tconfig.HOT_KNOB_KEYS == jconfig.HOT_KNOB_KEYS
    for key in tconfig.HOT_KNOB_KEYS:
        value = 1 if key in tconfig.HOT_ENGINE_KEYS else 1.0
        jconfig.validate_knob(key, value)
        tconfig.validate_knob(key, value)
        assert tconfig.knob_schema(key) == jconfig.knob_schema(key), key


def test_autotune_defaults_are_the_references():
    tune = {k: v for k, v in jconfig.DEFAULTS.items() if k.startswith("autotune.")}
    assert tune and {k: tconfig.DEFAULTS[k] for k in tune} == tune


AUTOTUNE_VALUES = {
    "namespaces": [{"id": 1, "name": "n"}],
    "autotune": {
        "enabled": True,
        "knobs": {
            "pipeline_depth": {"enabled": False},
            "encode_workers": {"max": 4, "step": 2},
        },
    },
}


def test_per_knob_config_builds_the_references_knob_table():
    jreg = JRegistry(JConfig(values={**AUTOTUNE_VALUES, "log": {"level": "error"}}, env={}))
    treg = TRegistry(TConfig(values=AUTOTUNE_VALUES), device="cpu")
    try:
        jt, tt = jreg.autotuner(), treg.autotuner()
        jknobs = {k.name: k.describe() for k in jt.knobs}
        tknobs = {k.name: k.describe() for k in tt.knobs}
        assert tknobs == jknobs
        assert tknobs["pipeline_depth"]["enabled"] is False
        assert (tknobs["encode_workers"]["hi"], tknobs["encode_workers"]["step"]) == (4, 2)
        assert "hedge_delay_ms" in tknobs  # the reply-stage knob is always present
        assert tt.interval_s == jt.interval_s and tt.min_requests == jt.min_requests
        assert treg.autotuner() is tt  # built once
    finally:
        jreg._batcher.close()
        treg.checker().close()


# -- a live port server --------------------------------------------------------


def _server_values(**autotune):
    return {
        "namespaces": [{"id": 1, "name": "n"}],
        "serve": {"read": {"port": 0, "host": "127.0.0.1"},
                  "write": {"port": 0, "host": "127.0.0.1"}},
        # an interval far beyond the test: the thread exists, the test
        # steps the tuner itself
        "autotune": {"enabled": True, "interval_s": 600.0, "min_requests": 10, **autotune},
    }


class _JaxServer:
    def __init__(self, values):
        self.registry = JRegistry(JConfig(values={**values, "log": {"level": "error"}}, env={}))
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        fut = asyncio.run_coroutine_threadsafe(self.registry.start_all(), self.loop)
        self.read_port, _ = fut.result(timeout=180)

    def stop(self):
        asyncio.run_coroutine_threadsafe(self.registry.stop_all(), self.loop).result(timeout=30)
        asyncio.run_coroutine_threadsafe(
            self.loop.shutdown_default_executor(), self.loop).result(timeout=30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=10)


class _TorchServer:
    def __init__(self, values):
        self.registry = TRegistry(TConfig(values=values), device="cpu")
        self.read_port, _ = self.registry.start_all()

    def stop(self):
        self.registry.stop_all()


@pytest.fixture(scope="module")
def servers():
    out = (_JaxServer(_server_values()), _TorchServer(_server_values()))
    yield out
    for s in out:
        s.stop()


def _get(server, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{server.read_port}{path}",
                                timeout=60) as resp:
        return resp.read().decode()


def _scripted_move(registry, stage):
    """Swap a scripted ledger and a fake clock into the live tuner, then make
    one move on ``stage``'s knob: deterministic, and it lands on the real
    batcher, config, metrics and flight recorder."""
    tuner = registry._autotuner
    ledger = _ScriptedLedger()
    tuner._attribution = ledger
    tuner._clock = _Clock()
    tuner._last = None
    tuner.step()  # warmup
    ledger.advance(100, 1.0, {stage: 0.6})
    return tuner.step()


def test_a_move_shows_in_flight_debug_and_metrics(servers):
    """One knob move through each package's live server: the real batcher
    resized and the config agreeing with it, and the move visible in
    /debug/flight (kind autotune), /debug/autotune and /metrics, equal
    across the packages."""
    jsrv, tsrv = servers
    tuners = [s.registry._autotuner for s in servers]
    assert all(t is not None and t.snapshot()["running"] for t in tuners)
    before = tsrv.registry.checker().encode_workers
    events = [_scripted_move(s.registry, "queue") for s in servers]
    assert events[1] == events[0]
    assert events[1]["action"] == "move" and events[1]["knob"] == "encode_workers"
    assert tsrv.registry.checker().encode_workers == before + 1
    assert tsrv.registry.config.get("engine.encode_workers") == before + 1
    docs = [json.loads(_get(s, "/debug/autotune")) for s in servers]
    for doc in docs:
        doc.pop("running")  # both True; the key order of the rest is compared
    assert docs[1] == docs[0]
    doc = docs[1]
    assert doc["enabled"] is True and doc["moves_total"] >= 1
    assert doc["knobs"]["encode_workers"]["value"] == before + 1
    assert doc["history"][0]["action"] == "move"
    assert doc["hedge_suppressed"] is False
    recs = json.loads(_get(tsrv, "/debug/flight?n=200"))["records"]
    auto = [r for r in recs if r.get("kind") == "autotune"]
    assert auto and auto[0]["knob"] == "encode_workers" and "queue" in auto[0]["before"]
    text = _get(tsrv, "/metrics")
    moves = [line for line in text.splitlines()
             if line.startswith("keto_autotune_moves_total{")]
    assert moves == [line for line in _get(jsrv, "/metrics").splitlines()
                     if line.startswith("keto_autotune_moves_total{")]
    assert 'keto_autotune_knob_value{knob="encode_workers"}' in text


def test_the_sdk_adopts_the_advertised_hedge_delay(servers):
    """The reply-stage knob end to end: a move of hedge_delay_ms on the port's
    server, read from /debug/autotune and fed to the SDK's HedgePolicy."""
    tsrv = servers[1]
    event = _scripted_move(tsrv.registry, "reply")
    assert event["knob"] == "hedge_delay_ms" and event["new"] == 990
    doc = json.loads(_get(tsrv, "/debug/autotune"))
    advertised_ms = doc["knobs"]["hedge_delay_ms"]["value"]
    assert advertised_ms == 990
    policy = HedgePolicy()
    policy.advertise(advertised_ms / 1e3)
    assert policy.current_delay_s() == pytest.approx(0.99)


def test_overload_suppresses_the_advertised_hedge():
    from keto_tpu_torch.engine.overload import STATE_HEDGE_SUPPRESS, STATE_NORMAL

    srv = _TorchServer({**_server_values(), "overload": {"enabled": True}})
    try:
        assert json.loads(_get(srv, "/debug/autotune"))["hedge_suppressed"] is False
        ctl = srv.registry._overload
        ctl.brownout.state = STATE_HEDGE_SUPPRESS
        ctl.brownout._last_update = time.monotonic() + 3600  # pinned: no decay
        try:
            doc = json.loads(_get(srv, "/debug/autotune"))
            assert doc["hedge_suppressed"] is True
            assert doc["knobs"]["hedge_delay_ms"]["value"] is None
        finally:
            ctl.brownout.state = STATE_NORMAL
            ctl.brownout._last_update = None
    finally:
        srv.stop()


def test_debug_autotune_without_a_tuner_is_the_references():
    values = {**_server_values(), "autotune": {"enabled": False}}
    out = (_JaxServer(values), _TorchServer(values))
    try:
        docs = [json.loads(_get(s, "/debug/autotune")) for s in out]
        assert docs[1] == docs[0] == {"enabled": False, "running": False, "knobs": {},
                                      "hedge_suppressed": False}
        assert out[1].registry._autotuner is None  # the route never builds one
    finally:
        for s in out:
            s.stop()


def test_a_reload_that_turns_autotune_on_starts_it(tmp_path):
    path = tmp_path / "keto.json"
    values = {**_server_values(), "autotune": {"enabled": False, "interval_s": 0.05}}
    path.write_text(json.dumps(values))
    reg = TRegistry(TConfig(config_file=str(path), env={}), device="cpu")
    reg.start_all()
    try:
        assert reg._autotuner is None
        values["autotune"]["enabled"] = True
        path.write_text(json.dumps(values))
        deadline = time.monotonic() + 20
        while reg._autotuner is None and time.monotonic() < deadline:
            time.sleep(0.05)
        tuner = reg._autotuner
        assert tuner is not None and tuner.snapshot()["running"] is True
        while tuner.ticks < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert tuner.ticks >= 2
    finally:
        reg.stop_all()
    assert reg._autotuner is None and tuner.snapshot()["running"] is False


# -- the batcher's quiesce seam the pipeline_depth/encode_workers knobs ride ---


class _SplitEngine:
    """A split-phase engine: every request is allowed."""

    def pipeline_supported(self):
        return True

    def encode_batch(self, requests, max_depth=0, depths=None):
        return _Enc(requests)

    def launch_encoded(self, enc):
        return enc

    def decode_launched(self, launched):
        return [True] * len(launched.requests)

    def batch_check(self, requests, max_depth=0, depths=None):
        return [True] * len(requests)


class _Enc:
    version = 0

    def __init__(self, requests):
        self.requests = list(requests)

    def keys(self):
        return [(r.object, 0, 0) for r in self.requests]

    def compact(self, keep):
        self.requests = [self.requests[i] for i in keep]

    def release(self):
        pass


def _batcher_api(name):
    if name == "jax":
        from keto_tpu.engine.batcher import BatcherClosed, CheckBatcher
        from keto_tpu.relationtuple import RelationTuple
    else:
        from keto_tpu_torch.engine.batcher import BatcherClosed, CheckBatcher
        from keto_tpu_torch.relationtuple import RelationTuple
    return CheckBatcher, BatcherClosed, lambda i: RelationTuple.from_string(f"n:o{i}#view@alice")


@pytest.mark.parametrize("script", ["resize", "noop", "serial_to_pipelined", "closed"])
def test_batcher_reconfigure_is_the_references(script):
    def run(name):
        CheckBatcher, BatcherClosed, tup = _batcher_api(name)
        kw = {"resize": {"pipeline_depth": 2, "encode_workers": 1},
              "noop": {"pipeline_depth": 2, "encode_workers": 2},
              "serial_to_pipelined": {"pipeline_depth": 0},
              "closed": {"pipeline_depth": 1}}[script]
        b = CheckBatcher(_SplitEngine(), window_s=0, **kw)
        out = [b.pipelined]
        try:
            if script == "closed":
                b.close()
                try:
                    b.reconfigure(pipeline_depth=2)
                except BatcherClosed:
                    out.append("closed")
                return out
            out.append(b.check(tup(0)))
            if script == "resize":
                out.append(b.reconfigure(pipeline_depth=4, encode_workers=3))
                stats = b.pipeline_stats()
                out += [b.pipeline_depth, b.encode_workers, stats["pipeline_depth"],
                        stats["encode_workers"]]
            elif script == "noop":
                out += [b.reconfigure(pipeline_depth=2, encode_workers=2), b.reconfigure()]
            else:
                out += [b.reconfigure(pipeline_depth=2, encode_workers=2), b.pipelined]
            out.append(b.check(tup(1)))
        finally:
            b.close()
        return out

    got, want = run("torch"), run("jax")
    assert got == want
    expected = {"resize": [True, True, True, 4, 3, 4, 3, True],
                "noop": [True, True, False, False, True],
                "serial_to_pipelined": [False, True, True, True, True],
                "closed": [True, "closed"]}[script]
    assert got == expected
