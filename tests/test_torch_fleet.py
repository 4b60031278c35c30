"""A keto_tpu_torch fleet on the CPU: one leader and two followers, with
``tools/replication_gate.py``'s checks, and the SIGKILL election drill.

The in-process fleet (three ``Registry`` objects of the port on
``device="cpu"``, the closure engine, lease election over the leader's WAL
directory):

- the leader mints structured ``z<v>.<seg>.<off>`` tokens; both followers
  bootstrap from its checkpoint, tail its WAL and converge on every write;
  a fresh token answers on a follower (the wait path), an unreachable one
  bounces with 503, ``Retry-After`` and the lag (the bounce path);
- a follower's write plane refuses with ``ErrReadOnlyFollower`` and the
  leader hint; the followers export the replication families;
- ``ReplicatedRestClient`` routes checks over both followers and learns
  their versions; the leader's ``/cluster/status`` lists three members
  alive; its ``/metrics`` carries instance-labelled ``keto_cluster_*``
  series in both formats; a hedged check pair is one stitched trace with
  spans from two processes on the leader's ``/debug/traces``;
- the scrubber's replica kind finds a follower's digest equal to the
  leader's, and with ``replica.skip_delta`` armed finds the divergence and
  reseeds the follower;
- ``status --cluster`` and ``debug snapshot --cluster`` of the port's CLI
  against the leader, beside the reference's CLI against the same leader;
- failover: the leader stops without releasing its lease; a follower wins
  term 2 and opens its write plane, the other follows the hint and
  converges, and the client follows the hint.

The SIGKILL drill: a leader in an interpreter of its own (this file run as
a script, ``python tests/test_torch_fleet.py leader DIR``, so no pytest
worker forks), two followers here, a write drive cut by a SIGKILL of the
leader's process group. A follower wins the next term and replays the
shared WAL; no acked write is lost, no tuple appears that was never
written, and the term lineage increases strictly.

Each test bounds its own waits (``_until``) and carries its limit as the
``timeout`` marker.
"""

from __future__ import annotations

import io
import json
import os
import signal
import sys
import tarfile
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))  # run as a script, the harness imports from here

from keto_tpu_torch.poolharness import PoolProcess, emit, serve_commands  # noqa: E402

DEBUG_TOKEN = "fleet-debug"
BOOT_S = 120.0


def values(role: str, instance: str, root: Path, upstream: str = "") -> dict:
    wal = str(root / "wal")
    doc = {
        "namespaces": [{"id": 1, "name": "n"}],
        "log": {"level": "error"},
        "dsn": "memory",
        "serve": {"read": {"port": 0, "host": "127.0.0.1"},
                  "write": {"port": 0, "host": "127.0.0.1"}},
        "engine": {"max_batch": 64},
        "replication": {"role": role, "poll_interval_ms": 10},
        "cluster": {"enabled": True, "instance_id": instance,
                    "heartbeat_interval_ms": 100, "scrape_interval_ms": 200,
                    "election": {"enabled": True, "lease_ttl_s": 1.0,
                                 "heartbeat_interval_ms": 100, "wal_dir": wal}},
        "debug": {"token": DEBUG_TOKEN},
        # on, for the replica kind's drill, which steps the cycles itself; the
        # bounce drill's 503s burn the SLO, which must not freeze the drill
        "scrub": {"enabled": True, "interval_s": 3600, "freeze_burn_rate": 1e9},
    }
    if role == "leader":
        doc["store"] = {"wal": {"dir": wal}}
    else:
        doc["replication"].update(upstream=upstream, dir=str(root / instance))
    return doc


class Node:
    def __init__(self, values: dict):
        from keto_tpu_torch.driver import Config, Registry

        self.registry = Registry(Config(values=values), device="cpu")
        self.read_port, self.write_port = self.registry.start_all()
        self.read = f"http://127.0.0.1:{self.read_port}"
        self.write = f"http://127.0.0.1:{self.write_port}"
        self.stopped = False

    def stop(self) -> None:
        if not self.stopped:
            self.stopped = True
            self.registry.stop_all()


def _http(method, url, body=None, headers=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _put(write: str, obj: str, sub: str = "alice"):
    return _http("PUT", f"{write}/relation-tuples", {
        "namespace": "n", "object": obj, "relation": "view", "subject_id": sub})[0]


def _check(read: str, obj: str, token: str = "", headers=None):
    q = {"namespace": "n", "object": obj, "relation": "view", "subject_id": "alice"}
    if token:
        q["snaptoken"] = token
    return _http("GET", f"{read}/check?" + urllib.parse.urlencode(q), headers=headers)


def _until(what: str, fn, limit_s: float, every_s: float = 0.05):
    """fn()'s first truthy value within `limit_s` seconds, else a failure
    naming `what`."""
    deadline = time.monotonic() + limit_s
    while True:
        got = fn()
        if got:
            return got
        if time.monotonic() > deadline:
            pytest.fail(f"{what} not within {limit_s}s")
        time.sleep(every_s)


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    root = tmp_path_factory.mktemp("fleet")
    nodes = []
    try:
        leader = Node(values("leader", "leader-0", root))
        nodes.append(leader)
        for i in range(10):
            assert _put(leader.write, f"seed{i}") == 201
        followers = []
        for i in range(2):
            followers.append(Node(values("follower", f"follower-{i}", root, leader.write)))
            nodes.append(followers[-1])
        yield {"leader": leader, "followers": followers, "root": root}
    finally:
        for node in reversed(nodes):
            node.stop()


# -- replication ---------------------------------------------------------------------


@pytest.mark.timeout(60)
def test_followers_converge_on_every_write(fleet):
    leader, followers = fleet["leader"], fleet["followers"]
    for i in range(10, 20):
        assert _put(leader.write, f"tail{i}") == 201
    token = leader.registry.snaptoken()
    assert token.startswith("z") and token.count(".") == 2
    for f in followers:
        _until("follower convergence", lambda f=f: _check(f.read, "tail19", token)[0] == 200, 30)
        status, body, _ = _check(f.read, "tail19", token)
        assert json.loads(body) == {"allowed": True}
        rep = f.registry.replicator()
        assert rep.lag_versions() == 0 and rep.applied_total >= 10
        assert f.registry.store().version == leader.registry.store().version
        assert sorted(map(str, f.registry.store().all_tuples())) == sorted(
            map(str, leader.registry.store().all_tuples()))


@pytest.mark.timeout(60)
def test_the_wait_and_the_bounce(fleet):
    leader, followers = fleet["leader"], fleet["followers"]
    assert _put(leader.write, "fresh-write") == 201
    token = leader.registry.snaptoken()
    for f in followers:  # the wait path: the window covers the tail
        status, body, _ = _check(f.read, "fresh-write", token)
        assert status == 200 and json.loads(body)["allowed"]
    status, body, headers = _check(followers[0].read, "fresh-write", "z99999999.0.0",
                                   headers={"X-Request-Deadline-Ms": "50"})
    assert status == 503 and headers.get("Retry-After") == "1"
    assert "lag_versions" in json.loads(body)["error"]["details"]


@pytest.mark.timeout(30)
def test_a_follower_refuses_writes_and_names_the_leader(fleet):
    leader, followers = fleet["leader"], fleet["followers"]
    status, body, _ = _http("PUT", f"{followers[1].write}/relation-tuples", {
        "namespace": "n", "object": "x", "relation": "view", "subject_id": "alice"})
    doc = json.loads(body)["error"]
    assert status == 503 and "read-only follower" in doc["message"]
    hint = doc["details"]["leader_hint"]
    assert hint["leader_id"] == "leader-0" and hint["write_url"] == leader.write
    assert hint["term"] == 1
    text = _http("GET", f"{followers[0].read}/metrics")[1].decode()
    for name in ("keto_replication_lag_versions", "keto_replication_lag_seconds",
                 "keto_replication_staleness_seconds", "keto_replication_applied_total"):
        assert name in text


@pytest.mark.timeout(60)
def test_the_replicated_client_routes_by_token(fleet):
    from keto_tpu_torch.client import ReplicatedRestClient

    leader, followers = fleet["leader"], fleet["followers"]
    assert _put(leader.write, "routed") == 201
    token = leader.registry.snaptoken()
    with ReplicatedRestClient([f.read for f in followers], write_url=leader.write) as client:
        for _ in range(6):
            assert client.check("n:routed#view@alice", snaptoken=token).allowed
        assert any(v["known_version"] > 0 for v in client.router.snapshot().values())
        assert client.batch_check(["n:routed#view@alice", "n:routed#view@bob"],
                                  snaptoken=token) == [True, False]
        # an election-enabled follower serves the election's view of the fleet
        assert client.refresh_cluster_view()
        # a write through a follower's address follows the leader hint
        client._follow_leader(followers[0].write)
        client.create_relation_tuple("n:via-hint#view@alice")
        assert client._writer.write_url == leader.write
    _until("the write through the hint", lambda: _check(leader.read, "via-hint")[0] == 200, 10)


# -- federation ---------------------------------------------------------------------


def _cluster_status(leader):
    status, body, _ = _http("GET", f"{leader.read}/cluster/status")
    return json.loads(body) if status == 200 else {}


@pytest.mark.timeout(60)
def test_the_leader_federates_three_members(fleet):
    from keto_tpu_torch.telemetry.openmetrics import parse_text

    leader = fleet["leader"]
    doc = _until("three alive federated members", lambda: (
        lambda d: d if (d.get("cluster") or {}).get("alive", 0) >= 3
        and d["cluster"].get("health") not in (None, "unknown") else None
    )(_cluster_status(leader)), 30)
    assert {m["instance_id"] for m in doc["members"]} == {
        "leader-0", "follower-0", "follower-1"}
    assert doc["cluster"]["election"]["leader_id"] == "leader-0"
    for om in (False, True):
        headers = {"Accept": "application/openmetrics-text"} if om else {}
        text = _until("the federated follower series", lambda: (
            lambda t: t if all(f'keto_cluster_replication_lag_versions{{instance="{i}"}}' in t
                               for i in ("follower-0", "follower-1")) else None
        )(_http("GET", f"{leader.read}/metrics", headers=headers)[1].decode()), 30)
        parsed = parse_text(text, openmetrics=om)
        assert parsed.errors == []
        assert parsed.value("keto_cluster_member_up", {"instance": "follower-1"}) == 1.0
    status, body, _ = _http("GET", f"{leader.read}/debug/cluster",
                            headers={"X-Debug-Token": DEBUG_TOKEN})
    assert status == 200 and json.loads(body)["cluster"]["members"] == 3
    status, _, _ = _http("GET", f"{fleet['followers'][0].read}/debug/cluster",
                         headers={"X-Debug-Token": DEBUG_TOKEN})
    assert status == 404


@pytest.mark.timeout(90)
def test_a_hedged_check_is_one_stitched_trace(fleet):
    from keto_tpu_torch.client import ReplicatedRestClient
    from keto_tpu_torch.client.hedge import HedgePolicy, Hedger

    leader, followers = fleet["leader"], fleet["followers"]
    _until("three alive members", lambda: (
        _cluster_status(leader).get("cluster") or {}).get("alive", 0) >= 3, 30)
    token = leader.registry.snaptoken()
    hedger = Hedger(HedgePolicy(delay_s=0.0))  # always hedge
    try:
        with ReplicatedRestClient([f.read for f in followers], write_url=leader.write,
                                  hedger=hedger) as rc:
            def stitched():
                res = rc.check("n:seed0#view@alice", snaptoken=token)
                tid = res.traceparent.split("-")[1]
                for _ in range(20):  # the losing attempt's span lands later
                    status, body, _ = _http(
                        "GET", f"{leader.read}/debug/traces?trace_id={tid}",
                        headers={"X-Debug-Token": DEBUG_TOKEN})
                    doc = json.loads(body) if status == 200 else {}
                    if doc.get("stitched") and len(
                            {s.get("instance") for s in doc.get("spans", [])}) >= 2:
                        return doc
                    time.sleep(0.1)
                return None

            doc = _until("a stitched hedged trace", stitched, 60)
    finally:
        hedger.close()
    assert doc["hedge"]["winner"] and doc["timeline"] and doc["hedge"]["attempts"] >= 2
    assert set(doc["instances"]) >= {"follower-0", "follower-1"}
    assert all(r.get("instance") for r in doc["flight"])


# -- anti-entropy --------------------------------------------------------------------


def _replica_finding(event: dict) -> dict:
    return next(f for f in event["findings"] if f.get("kind") == "replica")


@pytest.mark.timeout(90)
def test_the_scrubber_finds_and_repairs_a_divergent_follower(fleet):
    from keto_tpu_torch.faults import FAULTS

    leader, followers = fleet["leader"], fleet["followers"]
    version = leader.registry.store().version
    for f in followers:
        rep = f.registry.replicator()
        _until("the follower caught up", lambda rep=rep: rep.store.version == version, 30)
        clean = _replica_finding(f.registry.scrubber().step())
        assert clean["mismatches"] == 0 and clean["version"] == version
    # the site fires once, in whichever follower's tail applies the delta
    # first (both run in this process): that one diverges, with lag 0
    FAULTS.arm("replica.skip_delta")
    try:
        assert _put(leader.write, "skipped") == 201
        for f in followers:
            rep = f.registry.replicator()
            _until("the delta's version", lambda rep=rep: rep.store.version == version + 1, 30)
        assert FAULTS.fired("replica.skip_delta") == 1
        missing = [f for f in followers if _check(f.read, "skipped")[0] == 403]
        assert len(missing) == 1
        follower = missing[0]
        rep, scrubber = follower.registry.replicator(), follower.registry.scrubber()
        assert rep.lag_versions() == 0
        reseeds = rep.reseeds_total
        found = _replica_finding(scrubber.step())
        assert found["mismatches"] >= 1 and found["divergent_chunks"]
        assert rep.reseeds_total == reseeds + 1
        assert scrubber.repairs.get("reseed") == 1
        _until("the reseeded tuple", lambda: _check(follower.read, "skipped")[0] == 200, 30)
        assert _replica_finding(scrubber.step())["mismatches"] == 0
    finally:
        FAULTS.reset()


# -- the CLI ---------------------------------------------------------------------------


def _port_cli(argv) -> tuple:
    from keto_tpu_torch.cli import main as cli

    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


def _ref_cli(argv) -> tuple:
    from click.testing import CliRunner

    from keto_tpu.cli import cli as ref_cli

    res = CliRunner().invoke(ref_cli, argv)
    if res.exception is not None and not isinstance(res.exception, SystemExit):
        raise res.exception
    return res.exit_code, res.stdout, res.stderr


def _shape(out: str) -> list:
    """A status report's members (instance, role, alive), in order: the
    health, lag, rates and reasons move between two reads of a live fleet."""
    return [tuple(w for w in line.split() if w.startswith(("role=", "alive=")) or "-" in w)
            for line in out.splitlines() if line.startswith("  ")]


@pytest.mark.timeout(60)
def test_status_cluster_and_snapshot_cluster(fleet, tmp_path):
    leader = fleet["leader"]
    _until("three alive members", lambda: (
        _cluster_status(leader).get("cluster") or {}).get("alive", 0) >= 3, 30)
    remote = ["--read-remote", f"127.0.0.1:{leader.read_port}"]
    rc, out, err = _port_cli(remote + ["status", "--cluster"])
    assert out.startswith("cluster: ") and "election: term=1 leader=leader-0" in out
    assert sum(1 for line in out.splitlines() if line.startswith("  ")) == 3
    ref = _ref_cli(remote + ["status", "--cluster"])
    assert rc in (0, 1) and _shape(out) == _shape(ref[1])
    assert ref[1].startswith("cluster: ") and ref[1].splitlines()[1].startswith("election: ")
    bundle = tmp_path / "bundle.tar.gz"
    rc, out, err = _port_cli(remote + ["debug", "snapshot", "--cluster", "--token",
                                       DEBUG_TOKEN, "-o", str(bundle)])
    assert rc == 0 and err == ""
    with tarfile.open(bundle) as tar:
        names = tar.getnames()
    assert "cluster_status.json" in names and "errors.txt" not in names
    for inst in ("follower-0", "follower-1"):
        assert f"cluster/{inst}/flight.json" in names
        assert f"cluster/{inst}/metrics.prom" in names


# -- failover (last: it ends the leader) -----------------------------------------------


@pytest.mark.timeout(90)
def test_failover_promotes_one_follower(fleet):
    from keto_tpu_torch.client import ReplicatedRestClient
    from keto_tpu_torch.cluster.election import LeaseStore

    leader, followers = fleet["leader"], fleet["followers"]
    em = leader.registry._election
    em.stop(release=False)  # crash semantics: the lease stays until its TTL
    leader.registry._election = None
    leader.stop()
    bad = []

    def promoted():
        for f in followers:
            if _check(f.read, "tail19")[0] != 200:
                bad.append(f.read)  # reads must never stop
        won = [f for f in followers if f.registry._election.role == "leader"]
        return won[0] if len(won) == 1 else None

    winner = _until("a promoted follower", promoted, 15)
    loser = next(f for f in followers if f is not winner)
    assert bad == []
    status, body, _ = _http("GET", f"{winner.read}/cluster/status")
    election = json.loads(body)["cluster"]["election"]
    assert election["role"] == "leader" and election["term"] == 2
    assert _put(winner.write, "post-failover") == 201
    def hint():  # the last lease the loser saw: current after its next tick
        status, body, _ = _http("PUT", f"{loser.write}/relation-tuples", {
            "namespace": "n", "object": "misrouted", "relation": "view",
            "subject_id": "alice"})
        assert status == 503
        return json.loads(body)["error"]["details"]["leader_hint"]["write_url"] == winner.write

    _until("the loser's hint naming the winner", hint, 5)
    with ReplicatedRestClient([f.read for f in followers], write_url=loser.write) as rc:
        rc.create_relation_tuple("n:follow-the-hint#view@alice")
    assert loser.registry.replicator().upstream == winner.write
    _until("the retargeted loser's convergence",
           lambda: _check(loser.read, "follow-the-hint")[0] == 200, 15)
    terms = [r["term"] for r in LeaseStore(str(fleet["root"] / "wal")).lineage()]
    assert terms == [1, 2]


# -- the SIGKILL drill ------------------------------------------------------------------


def harness(root: str) -> None:
    """Serve the drill's leader until stdin says stop (or a SIGKILL)."""
    from keto_tpu_torch.driver import Config, Registry

    reg = Registry(Config(values=values("leader", "leader-k", Path(root))), device="cpu")
    read_port, write_port = reg.start_all()

    def stop() -> dict:
        reg.stop_all()
        return {"stopped": True}

    emit({"read": read_port, "write": write_port, "pid": os.getpid()})
    serve_commands({}, stop)


def _all_objects(read: str) -> set:
    objects, token = set(), ""
    while True:
        q = {"namespace": "n", "page_size": 500}
        if token:
            q["page_token"] = token
        status, body, _ = _http("GET", f"{read}/relation-tuples?" + urllib.parse.urlencode(q))
        assert status == 200
        doc = json.loads(body)
        objects |= {t["object"] for t in doc["relation_tuples"]}
        token = doc["next_page_token"]
        if not token:
            return objects


@pytest.mark.timeout(180)
def test_a_sigkilled_leader_loses_no_acked_write(tmp_path):
    from keto_tpu_torch.cluster.election import LeaseStore

    server = PoolProcess([sys.executable, str(Path(__file__).resolve()), "leader",
                          str(tmp_path)], cwd=str(REPO), name="fleet leader")
    followers = []
    try:
        info = server.next_doc(BOOT_S)
        write = f"http://127.0.0.1:{info['write']}"
        seeds = {f"seed{i}" for i in range(20)}
        for obj in sorted(seeds):
            assert _put(write, obj) == 201
        for i in range(2):
            followers.append(Node(values("follower", f"follower-k{i}", tmp_path, write)))
        acked, attempted = set(), set()
        lock = threading.Lock()
        stop = threading.Event()

        def writer(k: int) -> None:
            for j in range(10_000):
                if stop.is_set():
                    return
                obj = f"drive-{k}-{j}"
                with lock:
                    attempted.add(obj)
                try:
                    if _put(write, obj) == 201:
                        with lock:
                            acked.add(obj)
                except OSError:
                    return  # the leader is gone

        with ThreadPoolExecutor(4) as pool:
            for k in range(4):
                pool.submit(writer, k)
            _until("100 acked writes", lambda: len(acked) >= 100, 60, 0.01)
            t_kill = time.monotonic()
            os.killpg(server.proc.pid, signal.SIGKILL)  # mid-drive, lease held
            server.proc.wait(timeout=30)
            stop.set()
        server.stopped = True
        winner = _until("a promoted follower", lambda: next(
            (f for f in followers if f.registry._election.role == "leader"), None), 30)
        failover_s = time.monotonic() - t_kill
        loser = next(f for f in followers if f is not winner)
        assert _put(winner.write, "after-kill") == 201
        present = _all_objects(winner.read)
        lost = acked - present
        phantom = present - seeds - attempted - {"after-kill"}
        assert lost == set(), f"{len(lost)} acked writes lost"
        assert phantom == set(), f"phantom tuples {sorted(phantom)[:5]}"
        terms = [r["term"] for r in LeaseStore(str(tmp_path / "wal")).lineage()]
        assert terms == sorted(set(terms)) and terms[0] == 1 and terms[-1] >= 2
        _until("the loser's convergence", lambda: _check(loser.read, "after-kill")[0] == 200, 30)
        assert failover_s < 30
    finally:
        for f in followers:
            f.stop()
        if not server.stopped:
            server.kill_group()


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "leader":
        harness(sys.argv[2])
    else:
        sys.exit("usage: python tests/test_torch_fleet.py leader DIR")
