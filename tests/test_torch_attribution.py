"""keto_tpu_torch's attribution plane against keto_tpu's, on the CPU.

The 20 cases of ``tests/test_attribution.py`` for each package: the
traceparent helpers, the ``TimeLedger`` and ``AttributionLedger``
(conservation, stage order, the ambient ledger), a client's traceparent
reaching the server's spans, flight records and exemplars over REST and
gRPC (a hedged duplicate sharing the trace and tagged), ``/debug/attribution``
conserving wall time under slowness faults, the attribution counter on
``/metrics``, the sampling profiler (folds, overhead, the bounded fold
table, ``/debug/pprof``) and ``tools/flame.py`` reading its folded stacks.
The server cases run against a port server and a keto_tpu server from the
same config, each driven by its own package's client. Then the port's own
seams beside the reference's: the wire ring's stage dict (the parent's
ledger shipped back and merged into the worker's, the transit as
``queue``) and the scrubber's SLO freeze (``scrub.freeze_burn_rate``, 0
meaning ``telemetry.slo.alert_burn_rate``). Tolerance: exact, except the
reference's own ``pytest.approx`` on float seconds.
"""

import asyncio
import importlib.util
import os
import pickle
import re
import threading
import time
from types import SimpleNamespace

import pytest

import keto_tpu.telemetry.attribution as jattr
import keto_tpu.telemetry.tracing as jtracing
import keto_tpu_torch.telemetry.attribution as tattr
import keto_tpu_torch.telemetry.tracing as ttracing
from keto_tpu.driver import Config as JConfig
from keto_tpu.driver import Registry as JRegistry
from keto_tpu_torch.driver import Config as TConfig
from keto_tpu_torch.driver import Registry as TRegistry

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PURE = {
    "torch": SimpleNamespace(attr=tattr, tracing=ttracing),
    "jax": SimpleNamespace(attr=jattr, tracing=jtracing),
}


@pytest.fixture(params=sorted(PURE))
def p(request):
    return PURE[request.param]


# the port's additions to the reference's attribution snapshot, and nothing
# else: the device waits its check path times (telemetry/devstats.py)
PORT_ONLY = ("device_waits",)


def _port_only(attr) -> set:
    return set(PORT_ONLY) if attr is tattr else set()


VALUES = {
    "namespaces": [{"id": 1, "name": "videos"}],
    "serve": {"read": {"port": 0, "host": "127.0.0.1"},
              "write": {"port": 0, "host": "127.0.0.1"}},
    "log": {"level": "error"},
    # slow_ms 0: every check is flight-recorded, so the tests join client
    # trace ids against /debug/flight
    "telemetry": {"flight": {"slow_ms": 0}},
}


class JaxServer:
    def __init__(self):
        self.registry = JRegistry(JConfig(values=VALUES, env={}))
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        fut = asyncio.run_coroutine_threadsafe(self.registry.start_all(), self.loop)
        self.read_port, _ = fut.result(timeout=180)
        from keto_tpu import client, faults

        self.client, self.faults = client, faults.FAULTS

    def stop(self):
        asyncio.run_coroutine_threadsafe(self.registry.stop_all(), self.loop).result(30)
        asyncio.run_coroutine_threadsafe(
            self.loop.shutdown_default_executor(), self.loop).result(timeout=30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=10)


class TorchServer:
    def __init__(self):
        self.registry = TRegistry(TConfig(values=VALUES), device="cpu")
        self.read_port, _ = self.registry.start_all()
        from keto_tpu_torch import client, faults

        self.client, self.faults = client, faults.FAULTS

    def stop(self):
        self.registry.stop_all()


@pytest.fixture(scope="module", params=["torch", "jax"])
def server(request):
    s = TorchServer() if request.param == "torch" else JaxServer()
    yield s
    s.stop()


def _get(server, path, **params):
    import json
    import urllib.parse
    import urllib.request

    url = f"http://127.0.0.1:{server.read_port}{path}"
    if params:
        url += "?" + urllib.parse.urlencode(params)
    with urllib.request.urlopen(url, timeout=30) as r:
        body = r.read().decode()
    return SimpleNamespace(text=body, json=lambda: json.loads(body), status_code=200)


def _trace_id_of(traceparent: str) -> str:
    return traceparent.split("-")[1]


def _flight_trace_ids(server) -> dict:
    out: dict = {}
    for rec in _get(server, "/debug/flight", n=500).json()["records"]:
        if rec.get("trace_id"):
            out.setdefault(rec["trace_id"], []).append(rec)
    return out


def _span_trace_ids(server) -> set:
    return {s["trace_id"] for s in _get(server, "/debug/traces", n=500).json()["spans"]}


# -- TestTraceparentHelpers --------------------------------------------------------


def test_traceparent_roundtrip(p):
    tp = p.tracing.format_traceparent(0xABC123, 0x42)
    assert tp == f"00-{0xABC123:032x}-{0x42:016x}-01"
    ctx = p.tracing.parse_traceparent(tp)
    assert isinstance(ctx, p.tracing.SpanContext)
    assert ctx.trace_id == 0xABC123 and ctx.span_id == 0x42


def test_minted_traceparent_parses(p):
    ctx = p.tracing.parse_traceparent(p.tracing.mint_traceparent())
    assert ctx is not None and ctx.trace_id != 0 and ctx.span_id != 0


@pytest.mark.parametrize("bad", [
    "",
    "garbage",
    "00-zz-11-01",
    "00-" + "0" * 32 + "-" + "1" * 16 + "-01",
    "00-" + "1" * 32 + "-" + "0" * 16 + "-01",
    "00-" + "1" * 31 + "-" + "1" * 16 + "-01",
])
def test_malformed_traceparent_is_rejected(p, bad):
    assert p.tracing.parse_traceparent(bad) is None


def test_current_traceparent_requires_an_active_span(p):
    assert p.tracing.current_traceparent() is None


# -- TestTimeLedger ----------------------------------------------------------------


def test_marks_attribute_intervals(p):
    led = p.attr.TimeLedger(t0=100.0)
    led.mark("admission", now=100.010)
    led.mark("queue", now=100.030)
    led.mark("kernel", now=100.031)
    assert led.stages["admission"] == pytest.approx(0.010)
    assert led.stages["queue"] == pytest.approx(0.020)
    assert led.attributed() == pytest.approx(0.031)


def _conservation_snapshot(attr):
    led = attr.TimeLedger(t0=0.0)
    now = 0.0
    for stage, dt in [("admission", 0.001), ("queue", 0.004), ("encode", 0.002),
                      ("launch", 0.0005), ("kernel", 0.020), ("decode", 0.003),
                      ("serialize", 0.001), ("reply", 0.0002)]:
        now += dt
        led.mark(stage, now=now)
    wall = now + 0.0013
    agg = attr.AttributionLedger()
    agg.record(led, wall_s=wall)
    return led, wall, agg.snapshot()


def test_conservation_is_by_construction(p):
    led, wall, snap = _conservation_snapshot(p.attr)
    total = sum(info["seconds"] for info in snap["stages"].values())
    assert total == pytest.approx(wall, abs=1e-5)
    assert snap["stages"][p.attr.UNATTRIBUTED]["seconds"] == pytest.approx(0.0013, abs=1e-6)
    assert snap["coverage"] == pytest.approx(led.attributed() / wall, abs=1e-3)
    assert snap["coverage"] > 0.95
    ref = _conservation_snapshot(jattr)[2]
    # the reference's, exactly, beside the port's own keys
    assert {k: v for k, v in snap.items() if k not in _port_only(p.attr)} == ref
    assert set(snap) - set(ref) == _port_only(p.attr)


def test_snapshot_orders_canonical_stages_first(p):
    led = p.attr.TimeLedger(t0=0.0)
    led.mark("kernel", now=0.5)
    led.mark("zz-adhoc", now=0.6)
    agg = p.attr.AttributionLedger()
    agg.record(led, wall_s=0.7)
    snap = agg.snapshot()
    stages = list(snap["stages"])
    assert stages == ["kernel", "zz-adhoc", p.attr.UNATTRIBUTED]
    assert p.attr.ATTRIBUTION_STAGES == jattr.ATTRIBUTION_STAGES
    ref = set(jattr.AttributionLedger().snapshot())
    assert ref <= set(snap) and set(snap) - ref == _port_only(p.attr)


def test_ambient_ledger_contextvar(p):
    assert p.attr.current_ledger() is None
    p.attr.ledger_mark("kernel")  # no ambient ledger: a no-op
    led = p.attr.TimeLedger(t0=0.0)
    token = p.attr.set_current_ledger(led)
    try:
        assert p.attr.current_ledger() is led
        p.attr.ledger_mark("admission")
        assert "admission" in led.stages
    finally:
        p.attr.reset_current_ledger(token)
    assert p.attr.current_ledger() is None


# -- trace propagation against a live server ---------------------------------------


def test_client_traceparent_reaches_spans_flight_and_exemplars(server):
    with server.client.RestClient(f"http://127.0.0.1:{server.read_port}") as c:
        res = c.check("videos:/cats#view@nobody")
    tid = _trace_id_of(res.traceparent)
    assert int(tid, 16) != 0
    assert tid in _span_trace_ids(server)
    recs = _flight_trace_ids(server)
    assert tid in recs and recs[tid][0]["transport"] == "rest"
    ledger_ms = recs[tid][0].get("ledger_ms") or {}
    assert "serialize" in ledger_ms and "reply" in ledger_ms
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{server.read_port}/metrics",
                                 headers={"Accept": "application/openmetrics-text"})
    with urllib.request.urlopen(req, timeout=30) as r:
        assert tid in r.read().decode()


def test_explicit_traceparent_is_honored(server):
    tp = ttracing.mint_traceparent()
    with server.client.RestClient(f"http://127.0.0.1:{server.read_port}") as c:
        res = c.check("videos:/cats#view@nobody", traceparent=tp)
    assert res.traceparent == tp
    assert _trace_id_of(tp) in _flight_trace_ids(server)


def test_batch_check_carries_trace(server):
    tp = ttracing.mint_traceparent()
    with server.client.RestClient(f"http://127.0.0.1:{server.read_port}") as c:
        c.batch_check(["videos:/cats#view@a", "videos:/cats#view@b"], traceparent=tp)
    recs = _flight_trace_ids(server)
    assert recs[_trace_id_of(tp)][0]["transport"] == "rest_batch"


def test_grpc_check_joins_client_trace(server):
    with server.client.GrpcClient(f"127.0.0.1:{server.read_port}") as g:
        res = g.check("videos:/cats#view@nobody")
    tid = _trace_id_of(res.traceparent)
    assert tid in _span_trace_ids(server)
    recs = _flight_trace_ids(server)
    assert tid in recs and recs[tid][0]["transport"] == "grpc"


def test_hedged_duplicate_shares_trace_and_is_tagged(server):
    c = server.client
    server.faults.arm_slow("replica.slow", sleep_ms=300, times=1)
    try:
        with c.GrpcClient(f"127.0.0.1:{server.read_port}") as g:
            with c.Hedger(c.HedgePolicy(delay_s=0.03)) as h:
                out = g.check_hedged("videos:/cats#view@nobody", h)
    finally:
        server.faults.disarm("replica.slow")
    assert out.hedged is True
    tid = _trace_id_of(out.result.traceparent)
    deadline = time.monotonic() + 5.0
    recs = []
    while time.monotonic() < deadline:
        recs = _flight_trace_ids(server).get(tid, [])
        if len(recs) >= 2:
            break
        time.sleep(0.05)
    assert len(recs) == 2, recs
    assert sorted(bool(r.get("hedge")) for r in recs) == [False, True]
    assert tid in _span_trace_ids(server)


def test_ledger_conservation_under_slowness(server):
    c = server.client
    server.faults.arm_slow("device.slow", sleep_ms=20, times=3)
    server.faults.arm_slow("replica.slow", sleep_ms=20, times=3)
    try:
        with c.RestClient(f"http://127.0.0.1:{server.read_port}") as rc:
            rc.batch_check([f"videos:/cats#view@u{i}" for i in range(32)])
        with c.GrpcClient(f"127.0.0.1:{server.read_port}") as g:
            for i in range(8):
                g.check(f"videos:/cats#view@w{i}")
    finally:
        server.faults.disarm("device.slow")
        server.faults.disarm("replica.slow")
    payload = _get(server, "/debug/attribution").json()
    snap = payload["attribution"]
    assert snap["requests"] > 0 and snap["coverage"] >= 0.95
    total = sum(info["seconds"] for info in snap["stages"].values())
    assert total == pytest.approx(snap["wall_s"], abs=1e-4)
    for stage in ("serialize", "reply"):
        assert stage in snap["stages"]
    phases = payload.get("closure_build_phases")
    if phases:
        assert "total" in phases


def test_attribution_counter_exposed(server):
    body = _get(server, "/metrics").text
    assert "keto_time_attribution_seconds_total" in body
    assert 'stage="serialize"' in body


# -- the sampling profiler and tools/flame.py --------------------------------------

def _profiler(name):
    if name == "torch":
        from keto_tpu_torch.telemetry.profiler import SamplingProfiler
    else:
        from keto_tpu.telemetry.profiler import SamplingProfiler
    return SamplingProfiler


@pytest.mark.parametrize("name", ["torch", "jax"])
def test_samples_fold_and_overhead_stays_bounded(name):
    stop = threading.Event()

    def busy():
        while not stop.is_set():
            sum(i * i for i in range(2000))

    worker = threading.Thread(target=busy, name="busy-worker")
    worker.start()
    prof = _profiler(name)(hz=67.0)
    prof.start()
    try:
        time.sleep(0.6)
    finally:
        prof.stop()
        stop.set()
        worker.join(timeout=5)
    snap = prof.snapshot()
    assert snap["samples"] > 5 and snap["self_overhead"] < 0.05
    folds = prof.folded()
    assert any(k.startswith("busy-worker;") for k in folds)
    for line in prof.folded_text().splitlines():
        assert re.fullmatch(r".+ \d+", line)
    assert prof.tree()["value"] == sum(folds.values())
    # the sampler never folds itself, and frames are trimmed to the package
    assert not any("telemetry/profiler" in k.split(";")[-1] for k in folds)


@pytest.mark.parametrize("name", ["torch", "jax"])
def test_bounded_fold_table_truncates(name):
    stop = threading.Event()

    def loop():
        while not stop.is_set():
            time.sleep(0.01)

    threads = [threading.Thread(target=loop, name=n) for n in ("fold-a", "fold-b")]
    for t in threads:
        t.start()
    prof = _profiler(name)(hz=67.0, max_stacks=1)
    try:
        for _ in range(10):
            prof._sample_once()
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=5)
    folds = prof.folded()
    assert len(folds) <= 2 and folds.get("[truncated]", 0) > 0
    assert prof.snapshot()["truncated_stacks"] > 0


def test_the_port_profiler_trims_frames_to_its_package():
    from keto_tpu_torch.telemetry import profiler

    assert profiler._SELF_MODULES == ("keto_tpu_torch/telemetry/profiler",)
    frame = SimpleNamespace(f_code=SimpleNamespace(
        co_filename="/x/y/keto_tpu_torch/engine/batcher.py", co_name="check"))
    assert profiler._fold_frame(frame) == "keto_tpu_torch/engine/batcher:check"


def test_pprof_endpoint_on_demand_capture(server):
    doc = _get(server, "/debug/pprof", seconds=0.3).json()
    assert doc["profiler"]["samples"] > 0
    assert doc["tree"]["value"] == doc["profiler"]["samples"]
    assert _get(server, "/debug/pprof", format="folded").text.strip()


def _flame():
    spec = importlib.util.spec_from_file_location(
        "flame", os.path.join(_REPO, "tools", "flame.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_folded_to_html():
    flame = _flame()
    folds = flame.parse_folded("main;engine:check 42\nmain;api:reply 10\nbad line\n")
    assert folds == {("main", "engine:check"): 42, ("main", "api:reply"): 10}
    tree = flame.build_tree(folds)
    assert tree["value"] == 52
    assert "<svg" in flame.render_html(tree)


def test_profiler_folded_feeds_flame(server):
    flame = _flame()
    folds = flame.parse_folded(_get(server, "/debug/pprof", format="folded").text)
    assert folds
    assert "<svg" in flame.render_html(flame.build_tree(folds))


# -- the port's seams beside the reference's ---------------------------------------


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_the_wire_ring_ships_the_parents_stages(pkg):
    """The parent's handler runs under a fresh ledger whose stages ship back
    over the ring; RingBackend merges them into the worker's ledger and books
    the transit to queue."""
    if pkg == "torch":
        from keto_tpu_torch.api import wirecodec
        from keto_tpu_torch.engine import shmring
        attr = tattr
    else:
        from keto_tpu.api import wirecodec
        from keto_tpu.engine import shmring
        attr = jattr

    def handler(frame):
        req = wirecodec.decode_check_request(frame)
        attr.ledger_mark("admission")
        time.sleep(0.002)
        attr.ledger_mark("kernel")
        return wirecodec.encode_check_response([True] * len(req.start), "7")

    ring = shmring.WireRing(1, slot_bytes=4096)
    server = shmring.RingServer(ring, handler)
    server.start()
    client = shmring.RingClient(ring, ring.endpoints[0])
    try:
        frame = wirecodec.encode_check_request([1, 2], [3, 4], lineage="l", epoch=0)
        kind, _body, stages = pickle.loads(client.submit(frame, timeout=10))
        assert kind == "ok" and set(stages) == {"admission", "kernel"}
        assert stages["kernel"] >= 0.002
        led = attr.TimeLedger()
        token = attr.set_current_ledger(led)
        try:
            req = SimpleNamespace(lineage="l", epoch=0, ns=None, depths=None,
                                  min_version=0, traceparent=None)
            got = shmring.RingBackend(client).ring_submit(req, [1], [2], timeout=10)
        finally:
            attr.reset_current_ledger(token)
        assert list(got) == [True]
        assert {"admission", "kernel", "queue"} <= set(led.stages)
        assert led.stages["kernel"] >= 0.002
    finally:
        client.close()
        server.stop()
        ring.close()


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_the_scrubber_freezes_on_the_slo_burn(pkg):
    if pkg == "torch":
        from keto_tpu_torch.engine.scrub import ScrubDaemon
        from keto_tpu_torch.telemetry.slo import SLOTracker
    else:
        from keto_tpu.engine.scrub import ScrubDaemon
        from keto_tpu.telemetry.slo import SLOTracker
    clk = [100.0]
    slo = SLOTracker(objective=0.9, alert_burn_rate=3.0, fast_window_s=60,
                     slow_window_s=600, clock=lambda: clk[0])
    kw = dict(engine_fn=lambda: None, store_fn=lambda: None, interval_s=1.0,
              clock=lambda: clk[0], slo=slo)
    inherit = ScrubDaemon(**kw)  # freeze_burn_rate 0: the SLO's alert rate, 3.0
    explicit = ScrubDaemon(freeze_burn_rate=1.5, **kw)
    for _ in range(8):
        slo.record(0.01)
    slo.record(0.01, error=True)
    slo.record(0.01, error=True)  # 2 bad of 10: burn rate 2.0
    assert slo.burn_rate(60) == pytest.approx(2.0)
    assert inherit.step()["action"] == "cycle"
    frozen = explicit.step()
    assert frozen["action"] == "frozen" and frozen["reason"] == "slo_burn"
    assert explicit.snapshot()["frozen"] == "slo_burn"
    for _ in range(3):
        slo.record(0.01, error=True)  # 5 of 13: burn rate past 3.0
    assert inherit.step() == {"ts": clk[0], "action": "frozen", "reason": "slo_burn"}
