"""keto_tpu_torch's /debug surface vs keto_tpu's, on the CPU: both packages'
servers from the same config, the same requests to each. The payload keys
of /debug/device, /debug/scrub, /debug/overload, /debug/graph and
/debug/config, and the gating (``debug.enabled: false`` -> 404,
``debug.token`` -> 403 without it), must be equal. Tolerance: exact, on
keys, status codes and bodies of the gating responses. The port's
breaker snapshot also carries the counts both packages export as metrics
(``keto_device_engine_failures_total`` and its family, equal on both
servers' ``/metrics``) and its real-error record: that difference is stated
below, not hidden.
"""

import asyncio
import gzip
import io
import json
import tarfile
import threading
import urllib.error
import urllib.request

import pytest

from keto_tpu.driver import Config as JConfig
from keto_tpu.driver import Registry as JRegistry
from keto_tpu_torch.driver import Config as TConfig
from keto_tpu_torch.driver import Registry as TRegistry
from keto_tpu_torch.relationtuple import RelationTuple

# the breaker counts the port carries in /debug/device beside the metric
# families both packages export (BREAKER_FAMILIES), and its real-error record
PORT_BREAKER_COUNTS = {"failures", "fallback_batches", "deadline_skips", "oom_bisections",
                       "open_real", "real_failures", "last_real_error"}

BREAKER_FAMILIES = (
    "keto_device_engine_failures_total", "keto_device_fallback_batches_total",
    "keto_fallback_deadline_skips_total", "keto_device_oom_bisections_total",
    "keto_device_circuit_open", "keto_compile_quarantine_size",
)

TOKEN = "s3cret-token"


def _values(debug):
    return {
        "namespaces": [{"id": 1, "name": "n"}],
        "serve": {"read": {"port": 0, "host": "127.0.0.1"},
                  "write": {"port": 0, "host": "127.0.0.1"}},
        "engine": {"max_batch": 64, "query_mode": "device"},
        "overload": {"enabled": True},
        "scrub": {"enabled": True, "interval_s": 999},
        "debug": debug,
    }


class JaxServer:
    def __init__(self, debug):
        self.registry = JRegistry(JConfig(values={**_values(debug), "log": {"level": "error"}},
                                          env={}))
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


class TorchServer:
    def __init__(self, debug):
        self.registry = TRegistry(TConfig(values=_values(debug)), device="cpu")
        self.registry.store().write_relation_tuples(
            RelationTuple.from_string("n:doc#view@(n:g#member)"),
            RelationTuple.from_string("n:g#member@ann"),
        )
        self.read_port, _ = self.registry.start_all()

    def stop(self):
        self.registry.stop_all()


@pytest.fixture(scope="module")
def gated():
    servers = (JaxServer({"token": TOKEN}), TorchServer({"token": TOKEN}))
    yield servers
    for s in servers:
        s.stop()


def get(server, path, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{server.read_port}{path}",
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read(), resp.headers.get("Content-Type", "")
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("Content-Type", "")


AUTH = {"Authorization": f"Bearer {TOKEN}"}
ROUTES = ["/debug/stacks", "/debug/graph", "/debug/config", "/debug/device",
          "/debug/overload", "/debug/scrub"]


@pytest.mark.parametrize("route", ROUTES)
def test_a_missing_or_wrong_token_is_403_alike(gated, route):
    for headers in ({}, {"X-Debug-Token": "nope"}, {"Authorization": "Bearer nope"}):
        (js, jb, _), (ts, tb, _) = (get(s, route, headers) for s in gated)
        assert (ts, json.loads(tb)) == (js, json.loads(jb)) == (
            403, {"error": "invalid or missing debug token"})


def _doc(server, route, headers=AUTH):
    status, body, ctype = get(server, route, headers)
    assert status == 200 and ctype.startswith("application/json"), (route, status, body)
    return json.loads(body)


def test_device_payload_keys_match(gated):
    jd, td = (_doc(s, "/debug/device") for s in gated)
    assert set(td) == set(jd)
    assert set(td["supervisor"]) == set(jd["supervisor"])
    assert set(td["breaker"]) == set(jd["breaker"]) | PORT_BREAKER_COUNTS
    assert set(td["hbm"]) == set(jd["hbm"])
    assert td["backend"] == jd["backend"] == "cpu"
    assert td["quarantine"] == jd["quarantine"] == []
    assert td["supervisor"]["timeline"] == jd["supervisor"]["timeline"] == []
    assert td["breaker"]["open"] is jd["breaker"]["open"] is False
    assert td["hbm"]["budget_bytes"] is jd["hbm"]["budget_bytes"] is None  # no card
    # the counts the snapshot carries are the breaker's metric families on
    # both servers, with equal values
    from keto_tpu_torch.telemetry.openmetrics import parse_text

    expo = [parse_text(get(s, "/metrics", {})[1].decode()) for s in gated]
    for name in BREAKER_FAMILIES:
        assert expo[0].value(name) == expo[1].value(name) == 0.0, name
    assert expo[1].value("keto_device_engine_failures_total") == td["breaker"]["failures"]


def test_scrub_overload_graph_and_config_keys_match(gated):
    for route in ("/debug/scrub", "/debug/overload", "/debug/graph"):
        jd, td = (_doc(s, route, {"X-Debug-Token": TOKEN}) for s in gated)
        assert set(td) == set(jd), route
    jd, td = (_doc(s, "/debug/scrub?n=5") for s in gated)
    assert (td["enabled"], td["running"], td["history"]) == (True, True, [])
    assert (td["enabled"], td["running"]) == (jd["enabled"], jd["running"])
    jd, td = (_doc(s, "/debug/config") for s in gated)
    assert set(td) == set(jd) == {"config", "flag_overrides", "config_file"}
    assert td["config"]["debug"]["token"] == jd["config"]["debug"]["token"] == "[redacted]"


def test_stacks_is_text(gated):
    for s in gated:
        status, body, ctype = get(s, "/debug/stacks", AUTH)
        assert status == 200 and ctype.startswith("text/plain")
        assert b"--- thread" in body


def test_profile_returns_a_chrome_trace_archive(gated):
    _, port = gated
    status, body, ctype = get(port, "/debug/profile?seconds=0.1", AUTH)
    assert status == 200 and ctype == "application/gzip"
    with tarfile.open(fileobj=io.BytesIO(body), mode="r:gz") as tar:
        member = tar.extractfile("profile/trace.json")
        trace = json.loads(member.read())
    assert "traceEvents" in trace
    gzip.decompress(body)  # a plain gzip stream, as the reference sends


def test_a_disabled_surface_is_404_alike():
    servers = (JaxServer({"enabled": False}), TorchServer({"enabled": False}))
    try:
        for route in ROUTES + ["/debug/profile"]:
            (js, jb, _), (ts, tb, _) = (get(s, route, AUTH) for s in servers)
            assert (ts, tb) == (js, jb) == (404, b"404: Not Found"), route
    finally:
        for s in servers:
            s.stop()
