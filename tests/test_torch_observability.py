"""keto_tpu_torch's observability surface against keto_tpu's, on the CPU.

- One server of each package from the same config takes one request script
  over REST and gRPC (checks allowed and denied, a batch, an unknown
  namespace, an unmatched route, a write). Afterwards the two ``/metrics``
  expositions have the same family names, types and label sets; the
  histograms the same bucket bounds and counts; the counters the same
  values (those that count requests, builds and checks: seconds and the
  process-wide device tallies are left out, the tests run many servers in
  one process). Both packages parse both expositions, text and OpenMetrics.
- ``/debug/flight``, ``/debug/traces``, ``/debug/attribution`` and
  ``/debug/pprof`` answer each package with the same keys, and the port's
  ``debug snapshot`` bundle fetches every file with no error.
- The telemetry config fault: the three values the reference's schema
  refuses (a misspelt ``telemetry.slo`` key, a ``tracing.provider`` outside
  its enum, a non-integer ``telemetry.flight.capacity``) raise in both
  packages with the same message.
- A 2-worker pool of each package with ``tracing.provider: otlp`` forks
  (``otlp-exporter`` is a thread the fork inventory admits) and its replicas
  export spans to a loopback collector: the collector sees a replica's
  ``service.instance.id`` beside the parent's. Each pool boots in a fresh
  interpreter (this file run as a script, ``python
  tests/test_torch_observability.py torch|jax <collector url>``), so no
  pytest worker forks.

Tolerance: exact, on names, types, labels, bucket bounds, counts, keys and
messages.
"""

import asyncio
import json
import sys
import tarfile
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))  # run as a script, the harness imports from here

from keto_tpu_torch.poolharness import PoolProcess, emit, live_pids, serve_commands  # noqa: E402

VALUES = {
    "namespaces": [{"id": 1, "name": "videos"}],
    "serve": {"read": {"port": 0, "host": "127.0.0.1"},
              "write": {"port": 0, "host": "127.0.0.1"}},
    "engine": {"max_batch": 64, "query_mode": "host"},
    "log": {"level": "error"},
}
TUPLES = ["videos:/cats#owner@cat lady", "videos:/cats/1.mp4#owner@(videos:/cats#owner)",
          "videos:/cats/1.mp4#view@(videos:/cats/1.mp4#owner)"]

# process-wide tallies: every server and engine in the test process adds to
# them, so their values and series depend on what ran before
NOT_COMPARED = {"keto_device_transfer_bytes_total", "keto_device_kernel_seconds_total",
                "keto_device_jit_compilations_total", "keto_device_compile_seconds_total",
                "keto_device_syncs_total", "keto_device_sync_seconds_total",
                "keto_packed_loops_total", "keto_packed_passes_total"}

# the port's additions to the reference's surface, and nothing else: the
# device-wait counters of its check path and the packed loop counters
# (telemetry/devstats.py), and the waits' per-request sum on /debug/attribution
PORT_ONLY = {"families": {"keto_device_syncs_total", "keto_device_sync_seconds_total",
                          "keto_packed_loops_total", "keto_packed_passes_total"},
             "/debug/attribution": {"device_waits"}}


class JaxServer:
    def __init__(self, values=VALUES):
        from keto_tpu.driver import Config, Registry

        self.registry = Registry(Config(values=values, env={}))
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        fut = asyncio.run_coroutine_threadsafe(self.registry.start_all(), self.loop)
        self.read_port, self.write_port = fut.result(timeout=180)

    def stop(self):
        asyncio.run_coroutine_threadsafe(self.registry.stop_all(), self.loop).result(30)
        asyncio.run_coroutine_threadsafe(
            self.loop.shutdown_default_executor(), self.loop).result(timeout=30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=10)


class TorchServer:
    def __init__(self, values=VALUES):
        from keto_tpu_torch.driver import Config, Registry

        self.registry = Registry(Config(values=values), device="cpu")
        self.read_port, self.write_port = self.registry.start_all()

    def stop(self):
        self.registry.stop_all()


def _request(method, url, body=None, headers=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _script(server) -> list:
    """One REST and gRPC request script; the statuses it saw."""
    import grpc

    from keto_tpu_torch.api.gen.ory.keto.acl.v1alpha1 import acl_pb2, check_service_pb2
    from keto_tpu_torch.api.services import CheckServiceStub
    from keto_tpu_torch.relationtuple import RelationTuple

    read = f"http://127.0.0.1:{server.read_port}"
    write = f"http://127.0.0.1:{server.write_port}"
    seen = []
    for t in TUPLES:
        seen.append(_request("PUT", f"{write}/relation-tuples",
                             RelationTuple.from_string(t).to_dict())[0])
    q = {"namespace": "videos", "object": "/cats/1.mp4", "relation": "view"}
    tp = "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"
    for subject in ("cat lady", "dog", "cat lady"):
        seen.append(_request("GET", f"{read}/check?" + urllib.parse.urlencode(
            dict(q, subject_id=subject)), headers={"traceparent": tp})[0])
    seen.append(_request("GET", f"{read}/check?" + urllib.parse.urlencode(
        dict(q, namespace="nope", subject_id="x")))[0])
    seen.append(_request("POST", f"{read}/check/batch", [
        RelationTuple.from_string(t).to_dict() for t in (
            "videos:/cats#owner@cat lady", "videos:/cats#owner@dog")])[0])
    seen.append(_request("GET", f"{read}/no/such/route")[0])
    with grpc.insecure_channel(f"127.0.0.1:{server.read_port}") as ch:
        stub = CheckServiceStub(ch)
        for subject in ("cat lady", "dog"):
            resp = stub.Check(check_service_pb2.CheckRequest(
                namespace="videos", object="/cats", relation="owner",
                subject=acl_pb2.Subject(id=subject)), metadata=(("traceparent", tp),))
            seen.append(resp.allowed)
    return seen


@pytest.fixture(scope="module")
def scripted():
    """Both servers after the request script: their /metrics (text and
    OpenMetrics) and the script's answers."""
    out = {}
    for name, cls in (("torch", TorchServer), ("jax", JaxServer)):
        server = cls()
        try:
            seen = _script(server)
            read = f"http://127.0.0.1:{server.read_port}"
            text = _request("GET", f"{read}/metrics")[1].decode()
            om = _request("GET", f"{read}/metrics",
                          headers={"Accept": "application/openmetrics-text"})[1].decode()
            debug = {
                path: json.loads(_request("GET", f"{read}{path}")[1])
                for path in ("/debug/flight", "/debug/traces", "/debug/attribution",
                             "/debug/pprof")
            }
            bundle = None
            if name == "torch":
                bundle = _snapshot(server)
            out[name] = {"seen": seen, "text": text, "om": om, "debug": debug,
                         "bundle": bundle}
        finally:
            server.stop()
    return out


def _snapshot(server):
    import io
    import tempfile
    from contextlib import redirect_stdout

    from keto_tpu_torch.cli import main as cli

    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/bundle.tar.gz"
        with redirect_stdout(io.StringIO()):
            rc = cli.main(["--read-remote", f"127.0.0.1:{server.read_port}",
                           "debug", "snapshot", "-o", path])
        with tarfile.open(path) as tar:
            return rc, tar.getnames()


def _families(text: str, openmetrics: bool = False):
    from keto_tpu_torch.telemetry.openmetrics import parse_text

    doc = parse_text(text, openmetrics=openmetrics)
    assert doc.errors == []
    return doc


def test_the_request_script_answers_alike(scripted):
    assert scripted["torch"]["seen"] == scripted["jax"]["seen"] == [
        201, 201, 201, 200, 403, 200, 403, 200, 404, True, False]


def test_metrics_families_types_and_labels_are_equal(scripted):
    t = _families(scripted["torch"]["text"])
    j = _families(scripted["jax"]["text"])
    assert {n for n in t.families if n not in j.families} == PORT_ONLY["families"]
    for name in PORT_ONLY["families"]:
        assert t.families[name].type == "counter", name
    assert [n for n in t.families if n in j.families] == list(j.families)
    for name in j.families:
        ft, fj = t.families[name], j.families[name]
        assert ft.type == fj.type, name  # HELP may name the port's own events
        if name in NOT_COMPARED:
            continue  # its series depend on what ran before in this process
        assert sorted({tuple(sorted(s.labels)) for s in ft.samples}) == sorted(
            {tuple(sorted(s.labels)) for s in fj.samples}), name
        if name.startswith("keto_device_hbm_"):
            # one series per device: the reference's CPU backend in this test
            # process has the 8 virtual devices tests/conftest.py asks for
            assert {s.labels["device"] for s in ft.samples} == {"cpu:0"}
            continue
        assert sorted({(s.name, tuple(sorted(s.labels.items()))) for s in ft.samples}) \
            == sorted({(s.name, tuple(sorted(s.labels.items()))) for s in fj.samples}), name


def test_histogram_bounds_and_counts_are_equal(scripted):
    t = _families(scripted["torch"]["text"])
    j = _families(scripted["jax"]["text"])
    hists = [n for n, f in t.families.items() if f.type == "histogram"]
    assert "keto_check_duration_seconds" in hists and "keto_http_request_duration_seconds" in hists
    for name in hists:
        for suffix in ("_bucket", "_count"):
            key = (lambda s: (tuple(sorted((k, v) for k, v in s.labels.items()
                                           if suffix == "_count" or k == "le"))))
            got = {}
            for doc, pkg in ((t, "torch"), (j, "jax")):
                samples = doc.samples_named(name + suffix)
                if suffix == "_bucket":
                    got[pkg] = sorted({key(s) for s in samples})
                else:
                    got[pkg] = sorted((key(s), s.value) for s in samples)
            assert got["torch"] == got["jax"], name + suffix


def test_request_counters_are_equal(scripted):
    t = _families(scripted["torch"]["text"])
    j = _families(scripted["jax"]["text"])
    compared = []
    for name, f in t.families.items():
        if f.type != "counter" or "seconds" in name or name in NOT_COMPARED:
            continue
        vt = sorted((tuple(sorted(s.labels.items())), s.value) for s in f.samples)
        vj = sorted((tuple(sorted(s.labels.items())), s.value)
                    for s in j.families[name].samples)
        assert vt == vj, name
        compared.append(name)
    for name in ("keto_check_requests_total", "keto_http_requests_total",
                 "keto_grpc_requests_total", "keto_closure_builds_total",
                 "keto_checks_total", "keto_slo_events_total"):
        assert name in compared
    requests = {tuple(sorted(s.labels.items())): s.value
                for s in t.families["keto_check_requests_total"].samples}
    assert requests == {(("outcome", "ok"), ("transport", "rest")): 4,
                        (("outcome", "ok"), ("transport", "rest_batch")): 1,
                        (("outcome", "ok"), ("transport", "grpc")): 2}
    routes = {s.labels["route"] for s in t.families["keto_http_requests_total"].samples}
    assert "unmatched" in routes and "/no/such/route" not in routes


def test_each_parser_reads_both_servers(scripted):
    import keto_tpu.telemetry.openmetrics as jom
    import keto_tpu_torch.telemetry.openmetrics as tom

    for pkg in ("torch", "jax"):
        for mod in (tom, jom):
            assert mod.parse_text(scripted[pkg]["text"]).errors == []
            doc = mod.parse_text(scripted[pkg]["om"], openmetrics=True)
            assert doc.errors == [] and doc.saw_eof
            exemplars = [s.exemplar for s in doc.samples_named(
                "keto_check_duration_seconds_bucket") if s.exemplar]
            assert any("0af7651916cd43dd8448eb211c80319c" in e for e in exemplars), pkg


def _keys(doc, depth=2):
    if isinstance(doc, dict) and depth:
        return {k: _keys(v, depth - 1) for k, v in doc.items()}
    return type(doc).__name__ if doc is not None else None


@pytest.mark.parametrize("path", ["/debug/flight", "/debug/traces", "/debug/attribution",
                                  "/debug/pprof"])
def test_debug_payloads_have_the_same_keys(scripted, path):
    t, j = scripted["torch"]["debug"][path], scripted["jax"]["debug"][path]
    assert set(t) == set(j)
    if path == "/debug/traces":
        assert set(t["spans"][0]) == set(j["spans"][0])
        names = {s["name"] for s in t["spans"]}
        assert {"check.request", "grpc.request", "batcher.dispatch"} <= names
    elif path == "/debug/attribution":
        assert set(t["attribution"]) - set(j["attribution"]) == PORT_ONLY[path]
        assert set(j["attribution"]) <= set(t["attribution"])
        assert set(t["attribution"]["stages"]) == set(j["attribution"]["stages"])
    else:
        for key in t:
            if isinstance(t[key], dict):
                assert set(t[key]) == set(j[key]), key


def test_the_debug_snapshot_bundle_has_every_file(scripted):
    from keto_tpu_torch.cli.main import SNAPSHOT_ENDPOINTS

    rc, names = scripted["torch"]["bundle"]
    assert rc == 0 and names == [n for n, _ in SNAPSHOT_ENDPOINTS]
    assert "errors.txt" not in names


@pytest.mark.parametrize("values,message", [
    ({"telemetry": {"slo": {"objectiv": 0.9}}},
     "Additional properties are not allowed ('objectiv' was unexpected) (at telemetry/slo)"),
    ({"tracing": {"provider": "jaeger"}},
     "'jaeger' is not one of ['', 'log', 'otlp'] (at tracing/provider)"),
    ({"telemetry": {"flight": {"capacity": "x"}}},
     "'x' is not of type 'integer' (at telemetry/flight/capacity)"),
], ids=["slo-key", "provider", "capacity"])
def test_the_reference_refuses_what_the_port_refuses(values, message):
    from keto_tpu.driver.config import Config as JConfig
    from keto_tpu_torch.driver.config import Config as TConfig
    from keto_tpu_torch.utils.errors import ErrMalformedInput

    with pytest.raises(Exception) as jexc:
        JConfig(values=values, env={})
    with pytest.raises(ErrMalformedInput) as texc:
        TConfig(values=values, env={})
    assert str(texc.value) == str(jexc.value) == f"invalid configuration: {message}"


def test_the_telemetry_defaults_are_the_references():
    from keto_tpu.driver.config import DEFAULTS as JDEFAULTS
    from keto_tpu_torch.driver.config import DEFAULTS as TDEFAULTS

    keys = [k for k in JDEFAULTS if k.startswith(("telemetry.", "tracing."))]
    assert len(keys) == 15
    assert {k: TDEFAULTS[k] for k in keys} == {k: JDEFAULTS[k] for k in keys}


def test_a_durable_store_exports_its_recovery_families(tmp_path):
    """A WAL'd store's recovery reaches /metrics: keto_recovery_* with the
    boot's replay, and the WAL's append-error counter. A difference from the
    reference, whose registry builds its metrics inside the durable wrap
    while its store provider still holds the unwrapped store, so there the
    recovery families never register (keto_tpu/driver/registry.py, store()
    and _wrap_durable -> metrics())."""
    from keto_tpu_torch.driver import Config, Registry
    from keto_tpu_torch.relationtuple import RelationTuple
    from keto_tpu_torch.telemetry.openmetrics import parse_text

    values = {"namespaces": [{"id": 1, "name": "n"}], "log": {"level": "error"},
              "store": {"wal": {"dir": str(tmp_path / "wal")}}}
    first = Registry(Config(values=values), device="cpu")
    first.store().write_relation_tuples(RelationTuple.from_string("n:o#r@u"),
                                        RelationTuple.from_string("n:o#r@v"))
    # no close: the next boot replays the acked write from the WAL
    again = Registry(Config(values=values), device="cpu")
    doc = parse_text(again.metrics().expose())
    assert doc.errors == []
    assert doc.value("keto_recovery_replayed_deltas_total") == 1.0  # one delta record
    assert doc.value("keto_recovery_gap") == 0.0
    assert doc.value("keto_store_tuples") == 2.0
    assert "keto_checkpoint_age_seconds" in doc.families
    assert doc.families["keto_wal_append_errors_total"].type == "counter"
    assert again.store().recovery.replayed_deltas == 1


# -- a leader and a follower of each package: the fleet's families ------------------

FLEET_PREFIXES = ("keto_cluster_", "keto_replication_", "keto_election_", "keto_qos_")


def _fleet_values(root, role: str, instance: str, upstream: str = "") -> dict:
    wal = str(root / "wal")
    values = {
        **VALUES, "dsn": "memory",
        "replication": {"role": role, "poll_interval_ms": 10},
        "cluster": {"enabled": True, "instance_id": instance,
                    "heartbeat_interval_ms": 50, "scrape_interval_ms": 100,
                    "election": {"enabled": True, "lease_ttl_s": 30.0,
                                 "heartbeat_interval_ms": 50, "wal_dir": wal}},
        "qos": {"enabled": True},
    }
    if role == "leader":
        values["store"] = {"wal": {"dir": wal}}
    else:
        values["replication"].update(upstream=upstream, dir=str(root / instance))
    return values


def _fleet_families(text: str) -> dict:
    """The fleet's families of one exposition: name -> (type, label names of
    each series, histogram bucket bounds)."""
    doc = _families(text)
    out = {}
    for name, fam in doc.families.items():
        if not name.startswith(FLEET_PREFIXES):
            continue
        out[name] = (fam.type, sorted({tuple(sorted(s.labels)) for s in fam.samples}),
                     sorted({s.labels.get("le") for s in fam.samples if "le" in s.labels}))
    return out


@pytest.fixture(scope="module")
def fleet_metrics(tmp_path_factory):
    """For each package, a leader and a follower after one script: a write,
    a check at its token on the follower, a federation cycle that sees the
    follower's heartbeat. Their /metrics (text and OpenMetrics)."""
    out = {}
    for name, cls in (("torch", TorchServer), ("jax", JaxServer)):
        root = tmp_path_factory.mktemp(f"fleet-{name}")
        leader = cls(_fleet_values(root, "leader", "leader-0"))
        servers = [leader]
        try:
            follower = cls(_fleet_values(root, "follower", "follower-0",
                                         f"http://127.0.0.1:{leader.write_port}"))
            servers.append(follower)
            read_l = f"http://127.0.0.1:{leader.read_port}"
            read_f = f"http://127.0.0.1:{follower.read_port}"
            assert _request("PUT", f"http://127.0.0.1:{leader.write_port}/relation-tuples",
                            {"namespace": "videos", "object": "/cats", "relation": "owner",
                             "subject_id": "cat lady"})[0] == 201
            token = leader.registry.snaptoken()
            assert _request("GET", f"{read_f}/check?" + urllib.parse.urlencode({
                "namespace": "videos", "object": "/cats", "relation": "owner",
                "subject_id": "cat lady", "snaptoken": token}))[0] == 200
            want = 'keto_cluster_replication_lag_versions{instance="follower-0"}'
            deadline = time.monotonic() + 60
            while want not in _request("GET", f"{read_l}/metrics")[1].decode():
                assert time.monotonic() < deadline, "no federated follower series"
                time.sleep(0.05)
            out[name] = {
                role: (_request("GET", f"{url}/metrics")[1].decode(),
                       _request("GET", f"{url}/metrics", headers={
                           "Accept": "application/openmetrics-text"})[1].decode())
                for role, url in (("leader", read_l), ("follower", read_f))
            }
        finally:
            for server in reversed(servers):
                server.stop()
    return out


@pytest.mark.parametrize("role", ["leader", "follower"])
def test_the_fleets_families_are_equal(fleet_metrics, role):
    t = _fleet_families(fleet_metrics["torch"][role][0])
    j = _fleet_families(fleet_metrics["jax"][role][0])
    assert t == j
    want = {"leader": ("keto_cluster_members", "keto_cluster_replication_lag_versions",
                       "keto_cluster_slo_burn_rate_aggregate", "keto_election_term",
                       "keto_qos_fleet_scale"),
            "follower": ("keto_replication_lag_versions", "keto_replication_applied_total",
                         "keto_election_is_leader", "keto_qos_fleet_scale")}[role]
    assert set(want) <= set(t)
    # each package's parser reads both packages' OpenMetrics exposition
    for pkg in ("torch", "jax"):
        _families(fleet_metrics[pkg][role][1], openmetrics=True)


def test_the_leader_labels_each_member(fleet_metrics):
    for pkg in ("torch", "jax"):
        doc = _families(fleet_metrics[pkg]["leader"][0])
        instances = {s.labels["instance"]
                     for s in doc.families["keto_cluster_member_up"].samples}
        assert instances == {"leader-0", "follower-0"}, pkg


# -- a forked pool of each package exporting spans ---------------------------------

POOL_BOOT_S = 120.0


def harness(package: str, collector: str) -> None:
    """Serve a 2-worker pool of `package` with OTLP export to `collector`
    until stdin says stop."""
    values = dict(VALUES, serve={"read": {"port": 0, "host": "127.0.0.1", "workers": 2},
                                 "write": {"port": 0, "host": "127.0.0.1"}},
                  tracing={"provider": "otlp", "otlp": {"endpoint": collector}})
    values["engine"] = {"max_batch": 64}
    server = TorchServer(values) if package == "torch" else JaxServer(values)
    pool = server.registry._replica_pool

    def describe(_arg: str = "") -> dict:
        children = [link.pid for link in pool._children] if pool is not None else []
        return {"read": server.read_port, "write": server.write_port,
                "children": children,
                "alive": 1 + len(live_pids(p for p in children if p > 0))}

    def stop() -> dict:
        server.stop()
        return {"stopped": True}

    emit(describe())
    serve_commands({"pool": describe}, stop)


class Collector:
    def __init__(self):
        received = self.received = []

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                received.append(json.loads(body))
                self.send_response(200)
                self.end_headers()
                self.wfile.write(b"{}")

            def log_message(self, *a):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_port}"
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def instances(self, span_name: str) -> set:
        out = set()
        for doc in list(self.received):
            for rs in doc["resourceSpans"]:
                attrs = {a["key"]: a["value"]["stringValue"]
                         for a in rs["resource"]["attributes"]}
                if any(s["name"] == span_name for ss in rs["scopeSpans"]
                       for s in ss["spans"]):
                    out.add(attrs["service.instance.id"])
        return out

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.mark.parametrize("package", ["torch", "jax"])
def test_a_forked_pool_exports_spans_from_its_replicas(package):
    collector = Collector()
    server = PoolProcess([sys.executable, str(Path(__file__).resolve()), package,
                          collector.url], cwd=str(REPO), name=f"{package} harness")
    try:
        info = server.next_doc(POOL_BOOT_S)
        assert info["alive"] == 2, info
        child = info["children"][0]
        read = f"http://127.0.0.1:{info['read']}"
        _request("PUT", f"http://127.0.0.1:{info['write']}/relation-tuples",
                 {"namespace": "videos", "object": "o", "relation": "view",
                  "subject_id": "u"})
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            # fresh connections: SO_REUSEPORT spreads them over both processes
            for _ in range(8):
                _request("GET", f"{read}/check?namespace=videos&object=o&relation=view"
                                "&subject_id=u")
            pids = {i.rsplit("-", 1)[1] for i in collector.instances("check.request")}
            if str(child) in pids:
                break
            time.sleep(0.5)
        assert str(child) in pids, (pids, info)
        assert server.stop(60.0)["stopped"]
    finally:
        if server.proc.poll() is None:
            server.kill_group()
        collector.close()


if __name__ == "__main__":
    harness(sys.argv[1], sys.argv[2])
