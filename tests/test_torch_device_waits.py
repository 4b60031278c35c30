"""keto_tpu_torch's device waits and its transport-wide REST ledger, on the
CPU (the port's own telemetry: the reference has neither).

- A packed ``DeviceCheckEngine`` batch on a small fixed graph counts each
  host<->device synchronisation site the code makes, on the ambient
  ledger and in ``keto_device_syncs_total``: 3 uploads, 1 row-pointer
  tail, ``_bits`` once for the initial frontier and once per step, one
  ``done`` read per loop test that reaches it, 1 decode. Each case states
  its step count. The pipelined batcher's stage threads, with no ambient
  ledger, count on the metrics alone.
- On the batcher's caller-thread columnar path, encode + launch + kernel +
  decode add up to the ``batcher.dispatch`` span's wall, ``kernel`` is
  positive, and the three stage spans sit under the dispatch.
- With a CPU ``torch.profiler`` recording, the exported trace holds a
  range per span and per sync site, each wait inside its stage's range;
  with none, no range is opened.
- Over REST, a ``/check/batch`` with a 20 ms delay planted in the body
  parse books it under ``admission`` with coverage >= 0.95; a write adds
  no attribution request.

Tolerance: exact on counts; a dispatch's stages and its span differ by the
two marks' distance from the span's edges, under 1 ms and 5%.
"""

import json
import time
import urllib.request

import pytest
import torch

from keto_tpu_torch.engine import DeviceCheckEngine
from keto_tpu_torch.engine.batcher import CheckBatcher
from keto_tpu_torch.graph import SnapshotManager
from keto_tpu_torch.relationtuple import RelationTuple
from keto_tpu_torch.relationtuple.columns import CheckColumns
from keto_tpu_torch.store import InMemoryTupleStore
from keto_tpu_torch.telemetry.attribution import (
    TimeLedger,
    reset_current_ledger,
    set_current_ledger,
)
from keto_tpu_torch.telemetry.devstats import DEVSTATS, WAIT_RANGE
from keto_tpu_torch.telemetry.metrics import MetricsRegistry
from keto_tpu_torch.telemetry.tracing import Tracer, profiler_range

torch.set_num_threads(1)

TUPLES = ["n:obj#access@(n:org#member)", "n:org#member@(n:team#member)",
          "n:team#member@alice", "n:doc#read@bob"]
SITES = ("device.upload", "packed.row_ptr", "packed.bits", "packed.done", "device.decode")


def packed_engine(max_depth=5):
    store = InMemoryTupleStore()
    store.write_relation_tuples(*(RelationTuple.from_string(s) for s in TUPLES))
    return DeviceCheckEngine(SnapshotManager(store), max_depth=max_depth,
                             mode="packed", device="cpu")


def columns(reqs):
    return CheckColumns.from_tuples([RelationTuple.from_string(s) for s in reqs])


def expected_syncs(steps, max_steps):
    """The sites a packed batch of ``steps`` loop iterations makes: the loop
    test reads ``done`` once per step, and once more unless it stopped on
    ``max_steps``."""
    return {"device.upload": 3, "packed.row_ptr": 1, "packed.bits": 1 + steps,
            "packed.done": steps + (0 if steps == max_steps + 1 else 1),
            "device.decode": 1}


def sync_counts(metrics):
    """``keto_device_syncs_total`` by site, as a registry bound to DEVSTATS
    exports it."""
    fam = metrics.get("keto_device_syncs_total")
    return {site: fam.labels(site=site).value for site in SITES}


def under_ledger(fn):
    led = TimeLedger()
    token = set_current_ledger(led)
    try:
        return fn(), led
    finally:
        reset_current_ledger(token)


@pytest.mark.parametrize("reqs,allowed,steps,total", [
    # a denied row between known nodes is done only at its depth: all 6
    # steps of max-depth 5, and the loop ends on max_steps (the cell's 18)
    (["n:obj#access@alice", "n:doc#read@alice"], [True, False], 6, 18),
    # an unknown subject gets depth 0; alice hits at distance 3, in step 3,
    # and the loop test before step 4 reads done and stops
    (["n:obj#access@alice", "n:obj#access@mallory"], [True, False], 4, 15),
    # both rows hit at distance 1, in step 1: 2 steps
    (["n:doc#read@bob", "n:team#member@alice"], [True, True], 2, 11),
])
def test_a_packed_batch_counts_each_sync_site(reqs, allowed, steps, total):
    eng = packed_engine()
    metrics = MetricsRegistry()
    DEVSTATS.bind(metrics, platform="cpu")
    before = sync_counts(metrics)
    got, led = under_ledger(lambda: eng.batch_check_columns(columns(reqs)))
    assert got == allowed
    want = expected_syncs(steps, eng.global_max_depth)
    assert {site: n for site, (n, _) in led.waits.items()} == want
    after = sync_counts(metrics)
    assert {site: after[site] - before[site] for site in SITES} == want
    assert sum(want.values()) == total
    # every block is "kernel", the host work between them "launch"
    waited = sum(secs for _, secs in led.waits.values())
    assert led.stages["kernel"] == pytest.approx(waited)
    assert led.stages["launch"] > 0


def test_threads_without_a_ledger_count_on_metrics():
    """The pipelined batcher's stage threads have no ambient ledger: their
    syncs reach the counters, and the requests' ledgers get no waits."""
    metrics = MetricsRegistry()
    DEVSTATS.bind(metrics, platform="cpu")
    before = sync_counts(metrics)
    b = CheckBatcher(packed_engine(), pipeline_depth=1)
    try:
        got, led = under_ledger(lambda: b.check(RelationTuple.from_string("n:doc#read@bob")))
        batches = b.n_batches
    finally:
        b.close()
    assert got is True and batches >= 1
    after = sync_counts(metrics)
    assert after["device.decode"] - before["device.decode"] == batches
    assert after["device.upload"] - before["device.upload"] == 3 * batches
    assert led.waits == {}


@pytest.mark.parametrize("encoded_cache_size", [0, 64])
def test_caller_thread_stages_add_up_to_the_dispatch(encoded_cache_size):
    tracer = Tracer()
    b = CheckBatcher(packed_engine(), tracer=tracer, encoded_cache_size=encoded_cache_size)
    try:
        got, led = under_ledger(lambda: b.check_batch_columnar(
            columns(["n:obj#access@alice", "n:obj#access@mallory", "n:doc#read@bob"])))
    finally:
        b.close()
    assert got == [True, False, True]
    (dispatch,) = tracer.finished("batcher.dispatch")
    four = sum(led.stages.get(s, 0.0) for s in ("encode", "launch", "kernel", "decode"))
    assert led.stages["kernel"] > 0
    assert abs(four - dispatch.duration) <= 1e-3 + 0.05 * dispatch.duration
    for name in ("batcher.encode", "batcher.launch", "batcher.decode"):
        (span,) = tracer.finished(name)
        assert span.parent_id == dispatch.span_id and span.trace_id == dispatch.trace_id


def test_the_profiler_trace_holds_a_range_per_span_and_sync(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    tracer = Tracer()
    b = CheckBatcher(packed_engine(), tracer=tracer)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _, led = under_ledger(lambda: b.check_batch_columnar(
                columns(["n:obj#access@alice", "n:obj#access@mallory"])))
    finally:
        b.close()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation"]
    names = [e["name"] for e in events]
    for name in ("batcher.dispatch", "batcher.encode", "batcher.launch", "batcher.decode"):
        assert names.count(name) == 1, name
    assert {n[len(WAIT_RANGE):]: names.count(n) for n in set(names)
            if n.startswith(WAIT_RANGE)} == {site: n for site, (n, _) in led.waits.items()}
    stages = [e for e in events if e["name"] in ("batcher.launch", "batcher.decode")]
    for e in events:
        if e["name"].startswith(WAIT_RANGE):
            assert any(s["tid"] == e["tid"] and s["ts"] <= e["ts"]
                       and e["ts"] + e["dur"] <= s["ts"] + s["dur"] for s in stages), e


def test_no_range_opens_without_a_profiler(monkeypatch):
    import torch.autograd.profiler as autograd_profiler

    opened = []
    monkeypatch.setattr(autograd_profiler, "record_function",
                        lambda name, *a: opened.append(name))
    assert profiler_range("anything") is None
    b = CheckBatcher(packed_engine(), tracer=Tracer())
    try:
        _, led = under_ledger(lambda: b.check_batch_columnar(columns(["n:doc#read@bob"])))
    finally:
        b.close()
    assert led.waits and opened == []


# -- the REST transport's ledger ----------------------------------------------------

VALUES = {
    "namespaces": [{"id": 1, "name": "n"}],
    "serve": {"read": {"port": 0, "host": "127.0.0.1"},
              "write": {"port": 0, "host": "127.0.0.1"}},
    "engine": {"mode": "packed"},
    "log": {"level": "error"},
}


@pytest.fixture(scope="module")
def server():
    from keto_tpu_torch.driver import Config, Registry

    reg = Registry(Config(values=VALUES), device="cpu")
    read_port, write_port = reg.start_all()
    reg.read, reg.write = f"http://127.0.0.1:{read_port}", f"http://127.0.0.1:{write_port}"
    for s in TUPLES:
        assert _send("PUT", f"{reg.write}/relation-tuples",
                     RelationTuple.from_string(s).to_dict())[0] == 201
    yield reg
    reg.stop_all()


def _send(method, url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method)
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, r.read()


def _attribution(reg, requests):
    """The snapshot once ``requests`` requests are folded in: the transport
    folds a request after its reply's last byte, so it may trail the reply."""
    deadline = time.monotonic() + 10
    while True:
        snap = reg.attribution().snapshot()
        if snap["requests"] >= requests or time.monotonic() > deadline:
            return snap
        time.sleep(0.01)


def _batch_body(reqs):
    cols = columns(reqs)
    return {"namespaces": cols.namespaces, "objects": cols.objects,
            "relations": cols.relations, "subject_ids": cols.subject_ids,
            "subject_set_namespaces": cols.subject_set_namespaces,
            "subject_set_objects": cols.subject_set_objects,
            "subject_set_relations": cols.subject_set_relations}


def test_a_planted_parse_delay_is_admission(server, monkeypatch):
    server.attribution().reset()
    parse = CheckColumns.from_rest_body.__func__

    def slow_parse(cls, body):
        time.sleep(0.020)
        return parse(cls, body)

    monkeypatch.setattr(CheckColumns, "from_rest_body", classmethod(slow_parse))
    status, body = _send("POST", f"{server.read}/check/batch",
                         _batch_body(["n:obj#access@alice", "n:obj#access@mallory"]))
    assert status == 200 and json.loads(body)["allowed"] == [True, False]
    snap = _attribution(server, 1)
    assert snap["requests"] == 1
    assert snap["stages"]["admission"]["seconds"] >= 0.020
    assert snap["coverage"] >= 0.95
    for stage in ("encode", "launch", "kernel", "decode", "serialize", "reply"):
        assert snap["stages"][stage]["seconds"] > 0, stage
    assert snap["device_waits"]["device.decode"]["count"] == 1


def test_a_write_adds_no_attribution_request(server):
    server.attribution().reset()
    assert _send("PUT", f"{server.write}/relation-tuples",
                 RelationTuple.from_string("n:doc#read@carol").to_dict())[0] == 201
    assert _send("GET", f"{server.read}/relation-tuples?namespace=n")[0] == 200
    status, _ = _send("POST", f"{server.read}/check/batch", _batch_body(["n:doc#read@carol"]))
    assert status == 200
    assert _attribution(server, 1)["requests"] == 1
    time.sleep(0.2)  # a fold of the write or the list would trail by microseconds
    assert server.attribution().snapshot()["requests"] == 1
