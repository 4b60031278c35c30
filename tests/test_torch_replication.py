"""keto_tpu_torch's replicated read plane against keto_tpu's, on the CPU.

The cases of ``tests/test_replication.py`` through both packages, and then
across them:

- the token algebra (``replication/token.py``): the same spellings parse to
  the same tokens and the same garbage raises;
- the write acks: monotonic tokens on the memory, columnar and durable
  stores, and on a WAL'd store the same writes mint the same
  ``z<version>.<segment>.<offset>`` tokens in both packages (the WAL
  segments are byte-equal), through the store and through gRPC
  ``TransactRelationTuples`` against a WAL'd server of each package (a REST
  PUT answers the tuple and no token, in both);
- the follower's waits (``wait_for_version``): the zero-window bounce with
  its lag details, the freshness window, the return once replay passes the
  token, the LATEST sentinel; the errors' envelopes equal;
- a live leader and follower over the real ``/replication`` routes, for
  each pair of packages (a port follower of a keto_tpu leader and a
  keto_tpu follower of a port leader included): checkpoint bootstrap and
  tail, the reseed on a pruned cursor, and ``promote`` over the leader's
  WAL; the two followers of one script hold equal tuples and answer equal
  checks (each package's host ``CheckEngine`` over its follower's store);
- the anti-entropy digest of one script on each store kind (the columnar
  store's id-fragment path included) equal across the packages;
- one port leader server, then one keto_tpu leader server, each with a
  follower server of each package: both followers converge, a fresh token
  answers on the wait path, an unreachable token bounces with equal 503
  bodies and ``Retry-After`` headers, the read-only write plane answers the
  same error (REST and gRPC), and both export the replication families.

Tolerance: exact.
"""

from __future__ import annotations

import asyncio
import json
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from types import SimpleNamespace

import pytest

import keto_tpu.engine.check as jcheck
import keto_tpu.replication.digest as jdigest
import keto_tpu.replication.follower as jfollower
import keto_tpu.replication.leader as jleader
import keto_tpu.replication.token as jtoken
import keto_tpu.store as jstore
import keto_tpu.utils.errors as jerrors
import keto_tpu_torch.engine.check as tcheck
import keto_tpu_torch.replication.digest as tdigest
import keto_tpu_torch.replication.follower as tfollower
import keto_tpu_torch.replication.leader as tleader
import keto_tpu_torch.replication.token as ttoken
import keto_tpu_torch.store as tstore
import keto_tpu_torch.store.durable as tdurable
import keto_tpu_torch.utils.errors as terrors
from keto_tpu.relationtuple.definitions import RelationTuple as JTuple
from keto_tpu.relationtuple.definitions import SubjectID as JSubjectID
from keto_tpu_torch.relationtuple.definitions import RelationTuple as TTuple
from keto_tpu_torch.relationtuple.definitions import SubjectID as TSubjectID

PKGS = {
    "torch": SimpleNamespace(
        name="torch", token=ttoken, follower=tfollower, leader=tleader, store=tstore,
        DurableTupleStore=tdurable.DurableTupleStore, errors=terrors, check=tcheck,
        RelationTuple=TTuple, SubjectID=TSubjectID, digest=tdigest,
    ),
    "jax": SimpleNamespace(
        name="jax", token=jtoken, follower=jfollower, leader=jleader, store=jstore,
        DurableTupleStore=jstore.DurableTupleStore, errors=jerrors, check=jcheck,
        RelationTuple=JTuple, SubjectID=JSubjectID, digest=jdigest,
    ),
}
PAIRS = [(lead, follow) for lead in ("torch", "jax") for follow in ("torch", "jax")]


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def _tup(p, i: int, sub: str = "alice"):
    return p.RelationTuple(namespace="n", object=f"o{i}", relation="view",
                           subject=p.SubjectID(id=sub))


# -- the token algebra ------------------------------------------------------------


def test_token_roundtrip(pkg):
    t = pkg.token.SnapToken(7, 3, 1200)
    assert t.encode() == "z7.3.1200" and str(t) == t.encode()
    assert pkg.token.parse_snaptoken("z7.3.1200") == t
    assert pkg.token.encode_snaptoken(9) == "z9.0.0"


@pytest.mark.parametrize("spelling", ["42", "0", "z5.1.10", "z4.9.99999", "z0.0.0"])
def test_spellings_parse_alike(spelling):
    t = ttoken.parse_snaptoken(spelling)
    j = jtoken.parse_snaptoken(spelling)
    assert (t.version, t.segment, t.offset) == (j.version, j.segment, j.offset)
    assert t.encode() == j.encode()


@pytest.mark.parametrize("bad", ["", "z1.2", "zx.y.z", "not-a-token", "z-1.0.0", "1.2.3"])
def test_garbage_tokens_raise(pkg, bad):
    with pytest.raises(ValueError):
        pkg.token.parse_snaptoken(bad)


def test_ordering_is_by_version_alone(pkg):
    newer = pkg.token.parse_snaptoken("z5.1.10")
    older = pkg.token.parse_snaptoken("z4.9.99999")
    assert newer.version > older.version
    assert pkg.token.LATEST_SENTINEL == 1 << 62


@pytest.mark.parametrize("token,latest", [("z7.1.40", ""), ("7", "true"), ("", "yes")])
def test_the_planes_read_a_token_alike(token, latest):
    from keto_tpu.api.convert import min_version_from as jmin
    from keto_tpu_torch.api.rest import min_version_from as tmin

    assert tmin(token, latest) == jmin(token, latest)


# -- write acks ---------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["memory", "columnar", "durable"])
def test_write_ack_tokens_monotonic(pkg, kind, tmp_path):
    if kind == "durable":
        store = pkg.DurableTupleStore(pkg.store.InMemoryTupleStore(),
                                      str(tmp_path / "wal"), sync="always")
    elif kind == "memory":
        store = pkg.store.InMemoryTupleStore()
    else:
        store = pkg.store.ColumnarTupleStore()
    versions = []
    for i in range(6):
        store.write_relation_tuples(_tup(pkg, i))
        current_token = getattr(store, "current_token", None)
        token = str(current_token()) if current_token is not None else str(store.version)
        versions.append(pkg.token.parse_snaptoken(token).version)
    assert versions == sorted(versions) and len(set(versions)) == len(versions)
    if kind == "durable":
        store.close_durable()


def test_durable_stores_mint_equal_structured_tokens(tmp_path):
    tokens = {}
    for name, p in PKGS.items():
        s = p.DurableTupleStore(p.store.InMemoryTupleStore(), str(tmp_path / name),
                                sync="always")
        try:
            tokens[name] = []
            for i in range(4):
                s.write_relation_tuples(_tup(p, i))
                tokens[name].append(str(s.current_token()))
            s.transact_relation_tuples([_tup(p, 9)], [_tup(p, 0)])
            tokens[name].append(str(s.current_token()))
        finally:
            s.close_durable()
    assert tokens["torch"] == tokens["jax"]
    parsed = [ttoken.parse_snaptoken(t) for t in tokens["torch"]]
    assert [t.version for t in parsed] == [1, 2, 3, 4, 5]
    # every ack names durable bytes: a real segment, advancing offsets
    assert all(t.segment >= 1 for t in parsed)
    offsets = [t.offset for t in parsed]
    assert offsets == sorted(offsets) and len(set(offsets)) == 5


def _grpc_transact(port: int, lines) -> list:
    import grpc

    from keto_tpu_torch.api.gen.ory.keto.acl.v1alpha1 import acl_pb2
    from keto_tpu_torch.api.gen.ory.keto.acl.v1alpha1 import write_service_pb2 as W
    from keto_tpu_torch.api.services import WriteServiceStub

    def delta(line, action):
        t = TTuple.from_string(line)
        return W.RelationTupleDelta(action=action, relation_tuple=acl_pb2.RelationTuple(
            namespace=t.namespace, object=t.object, relation=t.relation,
            subject=acl_pb2.Subject(id=t.subject.id)))

    out = []
    with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
        stub = WriteServiceStub(ch)
        for inserts, deletes in lines:
            resp = stub.TransactRelationTuples(W.TransactRelationTuplesRequest(
                relation_tuple_deltas=[delta(s, W.RelationTupleDelta.INSERT) for s in inserts]
                + [delta(s, W.RelationTupleDelta.DELETE) for s in deletes]))
            out.append(list(resp.snaptokens))
    return out


def test_transact_tokens_are_equal_on_a_walled_server(tmp_path):
    """The write-snaptoken repair: gRPC TransactRelationTuples against a
    WAL'd server of each package answers the same z<v>.<seg>.<off> tokens
    (the port answered the bare version before)."""
    pytest.importorskip("grpc")
    script = [(["n:a#view@alice", "n:b#view@bob"], []), (["n:c#view@carol"], ["n:a#view@alice"]),
              ([], ["n:b#view@bob"])]
    got = {}
    for name, cls in (("torch", TorchNode), ("jax", JaxNode)):
        node = cls(_values({"dsn": "memory", "store": {"wal": {"dir": str(tmp_path / name)}}}))
        try:
            got[name] = _grpc_transact(node.write_port, script)
        finally:
            node.stop()
    assert got["torch"] == got["jax"]
    assert all(tok.startswith("z") for toks in got["torch"] for tok in toks)
    assert [len(toks) for toks in got["torch"]] == [2, 2, 1]


# -- the follower's waits -----------------------------------------------------------


def _follower(p, tmp_path, store=None, **kw):
    return p.follower.FollowerReplicator(
        store if store is not None else p.store.InMemoryTupleStore(),
        "http://127.0.0.1:1",  # never dialed by the wait cases
        scratch_dir=str(tmp_path / f"scratch-{p.name}"), **kw,
    )


def test_zero_window_bounces_with_lag_details(tmp_path):
    envelopes = []
    for p in PKGS.values():
        rep = _follower(p, tmp_path)
        rep.leader_version = 5
        with pytest.raises(p.errors.ErrFollowerLag) as ei:
            rep.wait_for_version(5, timeout_s=0.0)
        assert ei.value.lag_versions == 5 and ei.value.retry_after_s >= 1
        assert ei.value.status_code == 503 and ei.value.grpc_code == "UNAVAILABLE"
        envelopes.append(ei.value.envelope())
    assert envelopes[0] == envelopes[1]
    assert envelopes[0]["error"]["details"] == {"lag_versions": 5, "lag_seconds": 0.0}


def test_wait_honors_the_freshness_window(pkg, tmp_path):
    rep = _follower(pkg, tmp_path)
    rep.leader_version = 3
    t0 = time.monotonic()
    with pytest.raises(pkg.errors.ErrFollowerLag):
        rep.wait_for_version(3, timeout_s=0.3)
    assert 0.25 <= time.monotonic() - t0 < 3.0


def test_wait_returns_once_replay_passes_the_token(pkg, tmp_path):
    store = pkg.store.InMemoryTupleStore()
    rep = _follower(pkg, tmp_path, store)
    rep.leader_version = 1

    def catch_up():
        time.sleep(0.05)
        store.apply_replicated_delta(1, [_tup(pkg, 1)], [])
        with rep._cv:
            rep._cv.notify_all()

    threading.Thread(target=catch_up, daemon=True).start()
    assert rep.wait_for_version(1, timeout_s=5.0) == 1


def test_latest_sentinel_resolves_to_leader_position(pkg, tmp_path):
    store = pkg.store.InMemoryTupleStore()
    rep = _follower(pkg, tmp_path, store)
    rep.leader_version = 2
    store.apply_replicated_delta(1, [_tup(pkg, 1)], [])
    store.apply_replicated_delta(2, [_tup(pkg, 2)], [])
    assert not store.apply_replicated_delta(2, [_tup(pkg, 3)], [])  # a replayed overlap
    assert rep.wait_for_version(pkg.token.LATEST_SENTINEL, timeout_s=0.0) == 2
    rep.leader_version = 3
    with pytest.raises(pkg.errors.ErrFollowerLag):
        rep.wait_for_version(pkg.token.LATEST_SENTINEL, timeout_s=0.0)


@pytest.mark.parametrize("kind", ["memory", "columnar"])
def test_replayed_deltas_reach_the_delta_feed_alike(kind):
    """apply_replicated_delta goes through the ordered notifier: the
    follower's snapshot layer and write overlay see what a local write
    would show them."""
    feeds = {}
    for name, p in PKGS.items():
        store = (p.store.InMemoryTupleStore() if kind == "memory"
                 else p.store.ColumnarTupleStore())
        seen = []
        store.subscribe_deltas(lambda v, i, d, seen=seen: seen.append(
            (v, sorted(str(t) for t in i or ()), sorted(str(t) for t in d or ()))))
        store.apply_replicated_delta(3, [_tup(p, 1), _tup(p, 2)], [])
        store.apply_replicated_delta(5, [_tup(p, 2)], [_tup(p, 1), _tup(p, 7)])
        assert not store.apply_replicated_delta(5, [_tup(p, 9)], [])
        feeds[name] = (seen, store.version, sorted(str(t) for t in store.all_tuples()))
    assert feeds["torch"] == feeds["jax"]
    assert feeds["torch"][1] == 5


def test_read_only_follower_error_contract():
    envelopes = []
    for p in PKGS.values():
        e = p.errors.ErrReadOnlyFollower()
        assert "read-only follower" in str(e) and "leader" in e.envelope()["error"]["message"]
        hint = {"leader_id": "l", "term": 2, "read_url": "", "write_url": "http://l:1"}
        envelopes.append((e.envelope(), p.errors.ErrReadOnlyFollower(
            leader_hint=hint).envelope(), e.status_code, e.grpc_code))
    assert envelopes[0] == envelopes[1]


# -- a live leader and follower over the /replication routes -----------------------


class _Leader:
    """A durable store serving the /replication routes: the leader's
    replication half without the engine stack."""

    def __init__(self, p, directory: str):
        self.p = p
        self.store = p.DurableTupleStore(p.store.InMemoryTupleStore(), directory,
                                          sync="always")
        self.src = p.leader.ReplicationSource(self.store, poll_interval_s=0.01)
        if p.name == "torch":
            from keto_tpu_torch.api.daemon import PlaneServer
            from keto_tpu_torch.api.rest import Router

            router = Router()
            self.src.register(router)
            self._plane = PlaneServer(router, "127.0.0.1", 0)
            self.port = self._plane.start()
        else:
            from aiohttp import web

            app = web.Application()
            self.src.register(app)
            self._loop = asyncio.new_event_loop()
            self._thread = threading.Thread(target=self._loop.run_forever, daemon=True)
            self._thread.start()

            async def serve():
                runner = web.AppRunner(app)
                await runner.setup()
                site = web.TCPSite(runner, "127.0.0.1", 0)
                await site.start()
                return runner, site._server.sockets[0].getsockname()[1]

            self._runner, self.port = asyncio.run_coroutine_threadsafe(
                serve(), self._loop).result(timeout=60)
        self.url = f"http://127.0.0.1:{self.port}"

    def write(self, i: int, sub: str = "alice") -> None:
        self.store.write_relation_tuples(_tup(self.p, i, sub))

    def stop(self) -> None:
        if self.p.name == "torch":
            self._plane.stop()
        else:
            asyncio.run_coroutine_threadsafe(self._runner.cleanup(), self._loop).result(10)
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._thread.join(timeout=5)
        self.store.close_durable()


@pytest.fixture
def leaders(tmp_path):
    made = []

    def make(name: str) -> _Leader:
        leader = _Leader(PKGS[name], str(tmp_path / f"wal-{name}-{len(made)}"))
        made.append(leader)
        return leader

    yield make
    for leader in made:
        leader.stop()


def _tail_until(rep, version: int, limit_s: float = 30.0) -> None:
    deadline = time.monotonic() + limit_s
    while rep.store.version < version and time.monotonic() < deadline:
        rep.poll_once(wait_ms=200)
    assert rep.store.version == version


def _state(p, store) -> tuple:
    """(version, sorted tuples, the host oracle's answers to a fixed set of
    checks) of a follower's store."""
    engine = p.check.CheckEngine(store)
    reqs = [p.RelationTuple(namespace="n", object=f"o{i}", relation="view",
                            subject=p.SubjectID(id=s))
            for i in range(12) for s in ("alice", "bob")]
    return (store.version, sorted(str(t) for t in store.all_tuples()),
            engine.batch_check(reqs, 5))


@pytest.mark.parametrize("lead,follow", PAIRS)
def test_follower_bootstraps_from_checkpoint_and_tails(leaders, tmp_path, lead, follow):
    leader = leaders(lead)
    for i in range(5):
        leader.write(i)
    p = PKGS[follow]
    rep = p.follower.FollowerReplicator(p.store.InMemoryTupleStore(), leader.url,
                                        scratch_dir=str(tmp_path / f"f-{lead}-{follow}"),
                                        poll_interval_s=0.01)
    seeded = rep.bootstrap()
    # the leader cuts a checkpoint on demand: the seed, not a replay
    assert seeded == {"seeded_version": 5, "leader_version": 5}
    for i in range(5, 8):
        leader.write(i)
    leader.store.transact_relation_tuples([_tup(leader.p, 9, "bob")], [_tup(leader.p, 1)])
    _tail_until(rep, 9)
    assert rep.applied_total >= 4 and rep.lag_versions() == 0
    # the leader's ack token is servable here; one from the future bounces
    token = p.token.parse_snaptoken(str(leader.store.current_token()))
    assert rep.wait_for_version(token.version, timeout_s=0.0) == 9
    with pytest.raises(p.errors.ErrFollowerLag):
        rep.wait_for_version(token.version + 1, timeout_s=0.05)
    assert _state(p, rep.store) == _state(leader.p, leader.store.inner)
    lag = rep.lag()
    assert lag["role"] == "follower" and lag["cursor"][0] >= 1


@pytest.mark.parametrize("lead", ["torch", "jax"])
def test_both_packages_followers_converge_alike(leaders, tmp_path, lead):
    """One leader, a follower of each package, one script: equal stores and
    equal answers."""
    leader = leaders(lead)
    for i in range(4):
        leader.write(i)
    reps = {}
    for name, p in PKGS.items():
        reps[name] = p.follower.FollowerReplicator(
            p.store.ColumnarTupleStore(), leader.url,
            scratch_dir=str(tmp_path / f"c-{name}"), poll_interval_s=0.01)
    # a columnar follower of a memory leader refuses the seed, in both
    for name, rep in reps.items():
        with pytest.raises(PKGS[name].follower.ReplicationError, match="kind 'memory'"):
            rep.bootstrap()
    reps = {name: p.follower.FollowerReplicator(
        p.store.InMemoryTupleStore(), leader.url,
        scratch_dir=str(tmp_path / f"m-{name}"), poll_interval_s=0.01)
        for name, p in PKGS.items()}
    for rep in reps.values():
        rep.bootstrap()
    for i in range(4, 10):
        leader.write(i, "bob" if i % 2 else "alice")
    for rep in reps.values():
        _tail_until(rep, 10)
    assert _state(PKGS["torch"], reps["torch"].store) == _state(
        PKGS["jax"], reps["jax"].store)


@pytest.mark.parametrize("lead,follow", PAIRS)
def test_follower_reseeds_when_cursor_is_pruned(leaders, tmp_path, lead, follow):
    leader = leaders(lead)
    for i in range(3):
        leader.write(i)
    p = PKGS[follow]
    rep = p.follower.FollowerReplicator(p.store.InMemoryTupleStore(), leader.url,
                                        scratch_dir=str(tmp_path / "f2"),
                                        poll_interval_s=0.01)
    rep.bootstrap()
    # a segment that never existed: the leader answers reset and the
    # follower re-seeds from a fresh checkpoint
    rep._cursor = [999999, 0]
    leader.write(99)
    rep.poll_once()
    assert rep.reseeds_total == 1 and rep._cursor == [0, 0]
    _tail_until(rep, 4)


@pytest.mark.parametrize("lead,follow", PAIRS)
def test_promote_replays_the_leaders_wal_suffix(leaders, tmp_path, lead, follow):
    leader = leaders(lead)
    for i in range(3):
        leader.write(i)
    p = PKGS[follow]
    rep = p.follower.FollowerReplicator(p.store.InMemoryTupleStore(), leader.url,
                                        scratch_dir=str(tmp_path / "f3"),
                                        poll_interval_s=0.01)
    rep.bootstrap()
    _tail_until(rep, 3)
    # acked writes the follower never pulled: only the WAL holds them
    for i in range(3, 7):
        leader.write(i)
    report = rep.promote(leader.store.wal_dir)
    assert report == {"applied": 4, "final_version": 7, "gap": False}
    assert rep.role == "leader" and rep.leader_version == 7
    assert _state(p, rep.store) == _state(leader.p, leader.store.inner)


def test_the_wal_pull_answers_alike(leaders):
    """read_wal_from over both packages' WAL of one script: equal pulls,
    cursors, resets and eof."""
    pulls = {}
    for name in ("torch", "jax"):
        leader = leaders(name)
        for i in range(6):
            leader.write(i)
        d = leader.store.wal_dir
        read = leader.p.leader.read_wal_from
        first = read(d, 0, 0, 4)
        rest = read(d, first["next"][0], first["next"][1], 512)
        pulls[name] = [first, rest, read(d, 123456, 0), read(d, 0, 0, 0)]
    assert pulls["torch"] == pulls["jax"]
    assert len(pulls["torch"][0]["records"]) == 4 and pulls["torch"][1]["eof"]
    assert pulls["torch"][2]["reset"]


# -- follower servers of both packages, behind one leader server ---------------------


def _values(extra: dict) -> dict:
    return {
        "namespaces": [{"id": 1, "name": "n"}],
        "serve": {"read": {"port": 0, "host": "127.0.0.1"},
                  "write": {"port": 0, "host": "127.0.0.1"}},
        "engine": {"mode": "host", "max_batch": 64},
        "log": {"level": "error"},
        **extra,
    }


class JaxNode:
    def __init__(self, values):
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


class TorchNode:
    def __init__(self, values):
        from keto_tpu_torch.driver import Config, Registry

        self.registry = Registry(Config(values=values), device="cpu")
        self.read_port, self.write_port = self.registry.start_all()

    def stop(self):
        self.registry.stop_all()


NODES = {"torch": TorchNode, "jax": JaxNode}


def _http(method, url, body=None, headers=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _check_url(port: int, obj: str, token: str = "") -> str:
    q = {"namespace": "n", "object": obj, "relation": "view", "subject_id": "alice"}
    if token:
        q["snaptoken"] = token
    return f"http://127.0.0.1:{port}/check?" + urllib.parse.urlencode(q)


def _put(port: int, obj: str):
    return _http("PUT", f"http://127.0.0.1:{port}/relation-tuples",
                 {"namespace": "n", "object": obj, "relation": "view",
                  "subject_id": "alice"})


@pytest.fixture(scope="module", params=["torch", "jax"])
def fleet(request, tmp_path_factory):
    """A leader server of one package with a follower server of each."""
    root = tmp_path_factory.mktemp(f"fleet-{request.param}")
    leader = NODES[request.param](_values({
        "dsn": "memory", "store": {"wal": {"dir": str(root / "wal")}},
        "replication": {"role": "leader", "poll_interval_ms": 10},
    }))
    nodes = [leader]
    try:
        for i in range(3):
            assert _put(leader.write_port, f"seed{i}")[0] == 201
        followers = {}
        for name, cls in NODES.items():
            followers[name] = cls(_values({
                "dsn": "memory",
                "replication": {"role": "follower",
                                "upstream": f"http://127.0.0.1:{leader.write_port}",
                                "dir": str(root / f"f-{name}"), "poll_interval_ms": 10},
            }))
            nodes.append(followers[name])
        yield SimpleNamespace(leader=leader, followers=followers, lead=request.param)
    finally:
        for node in reversed(nodes):
            node.stop()


def test_follower_servers_converge_and_wait(fleet):
    for i in range(3, 8):
        assert _put(fleet.leader.write_port, f"tail{i}")[0] == 201
    token = fleet.leader.registry.snaptoken()
    assert token.startswith("z")
    answers = {}
    for name, f in fleet.followers.items():
        # the wait path: a just-minted token answers inside the window
        status, body, _ = _http("GET", _check_url(f.read_port, "tail7", token))
        answers[name] = (status, json.loads(body))
        status, body, _ = _http("GET", f"http://127.0.0.1:{f.read_port}/relation-tuples?"
                                + urllib.parse.urlencode({"namespace": "n",
                                                          "snaptoken": token}))
        assert status == 200
        answers[name] += (sorted(t["object"] for t in json.loads(body)["relation_tuples"]),)
    assert answers["torch"] == answers["jax"]
    assert answers["torch"][:2] == (200, {"allowed": True})
    assert len(answers["torch"][2]) == 8


def test_bounce_path_answers_alike(fleet):
    got = {}
    for name, f in fleet.followers.items():
        status, body, headers = _http(
            "GET", _check_url(f.read_port, "seed0", "z99999999.0.0"),
            headers={"X-Request-Deadline-Ms": "50"})
        doc = json.loads(body)
        version = f.registry.store().version
        # the lag is the token's distance from this follower's version
        assert doc["error"]["details"]["lag_versions"] == 99999999 - version
        got[name] = (status, doc, headers.get("Retry-After"))
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == 503 and got["torch"][2] == "1"


def test_read_only_write_plane_answers_alike(fleet):
    got = {}
    for name, f in fleet.followers.items():
        status, body, headers = _put(f.write_port, "x")
        got[name] = (status, json.loads(body), headers.get("Retry-After"))
        status, body, _ = _http("DELETE", f"http://127.0.0.1:{f.write_port}/relation-tuples"
                                "?namespace=n")
        got[name] += (status, json.loads(body))
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == 503 and "read-only follower" in got["torch"][1]["error"]["message"]


def test_read_only_write_service_answers_alike(fleet):
    pytest.importorskip("grpc")
    import grpc

    got = {}
    for name, f in fleet.followers.items():
        try:
            _grpc_transact(f.write_port, [(["n:x#view@alice"], [])])
        except grpc.RpcError as e:
            got[name] = (e.code().name, e.details())
    assert got["torch"] == got["jax"] == (
        "UNAVAILABLE", "This replica is a read-only follower; write to the leader.")


def test_followers_export_the_replication_families(fleet):
    from keto_tpu_torch.telemetry.openmetrics import parse_text

    names = {}
    for name, f in fleet.followers.items():
        text = _http("GET", f"http://127.0.0.1:{f.read_port}/metrics")[1].decode()
        doc = parse_text(text)
        assert not doc.errors
        names[name] = sorted(n for n in doc.families if n.startswith("keto_replication_"))
        status, body, _ = _http("GET", f"http://127.0.0.1:{f.write_port}/replication/status")
        assert status == 200 and json.loads(body)["role"] == "follower"
    assert names["torch"] == names["jax"] == [
        "keto_replication_applied_total", "keto_replication_lag_seconds",
        "keto_replication_lag_versions", "keto_replication_reseeds_total",
        "keto_replication_staleness_seconds",
    ]


def test_a_follower_config_skips_the_wal_and_refuses_a_bare_leader(tmp_path):
    """The config repair: a follower boots as a follower (its store starts
    from the leader, not empty and writable), and a leader without a WAL is
    refused alike."""
    from keto_tpu.driver import Config as JConfig
    from keto_tpu.driver import Registry as JRegistry
    from keto_tpu_torch.driver import Config as TConfig
    from keto_tpu_torch.driver import Registry as TRegistry
    from keto_tpu_torch.utils.errors import ErrMalformedInput

    values = _values({"dsn": "memory", "store": {"wal": {"dir": str(tmp_path / "w")}},
                      "replication": {"role": "follower", "upstream": "http://127.0.0.1:1"}})
    t = TRegistry(TConfig(values=values), device="cpu")
    j = JRegistry(JConfig(values=values, env={}))
    assert type(t.store()).__name__ == type(j.store()).__name__ == "InMemoryTupleStore"
    assert t.replicator() is not None and t._write_read_only() is True
    bare = _values({"dsn": "memory", "replication": {"role": "leader"}})
    with pytest.raises(ErrMalformedInput) as te:
        TRegistry(TConfig(values=bare), device="cpu").replication_source()
    with pytest.raises(Exception) as je:
        JRegistry(JConfig(values=bare, env={})).replication_source()
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("kind", ["memory", "columnar", "durable"])
def test_the_digest_is_the_references_on_every_store(kind, tmp_path):
    """compute_digest of the same tuples, each package's store of one kind
    (the columnar store's id-fragment path included: subject sets, quotes,
    non-ASCII ids), is equal chunk for chunk, and diff_digests localizes one
    changed tuple to its chunk in both."""
    lines = [f'n:o{i}#view@{"u" if i % 3 else "ü"}{i}' for i in range(300)]
    lines += ['n:say "hi"#view@(n:g1#member)', "n:g1#member@alice", "n:z#view@(n:g1#)"]
    digests = {}
    for name, p in PKGS.items():
        if kind == "durable":
            store = p.DurableTupleStore(p.store.ColumnarTupleStore(),
                                        str(tmp_path / name), sync="off")
        elif kind == "memory":
            store = p.store.InMemoryTupleStore()
        else:
            store = p.store.ColumnarTupleStore()
        store.write_relation_tuples(*[p.RelationTuple.from_string(s) for s in lines])
        store.delete_relation_tuples(p.RelationTuple.from_string("n:o7#view@u7"))
        d = p.digest.compute_digest(store, chunk_size=64)
        other = dict(d, chunks=list(d["chunks"]))
        other["chunks"][2] = "0" * 64
        digests[name] = (d, p.digest.diff_digests(d, other))
        if kind == "durable":
            store.close_durable()
    assert digests["torch"] == digests["jax"]
    assert digests["torch"][0]["count"] == len(lines) - 1
    assert digests["torch"][1] == [2]


@pytest.mark.timeout(120)
def test_reseeds_racing_the_tail_leave_the_follower_converged(leaders, tmp_path):
    """The port's reseed holds the tail's apply lock and drops a tail answer
    fetched before it (in the reference the tail's stale cursor can
    overwrite the reset one and strand the follower at the checkpoint's
    version). Writes on the leader, the tail thread and a thread of reseeds
    interleave, with a short switch interval: the follower still converges
    to the leader's tuples and version, and each reseed ran its hook."""
    import sys

    leader = leaders("torch")
    for i in range(20):
        leader.write(i)
    hooks = []
    rep = tfollower.FollowerReplicator(tstore.InMemoryTupleStore(), leader.url,
                                       scratch_dir=str(tmp_path / "race"),
                                       poll_interval_s=0.005, wait_ms=20)
    rep.on_reseed = lambda: hooks.append(rep.store.version)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        rep.start()
        done = threading.Event()

        def writes():
            for i in range(20, 220):
                leader.write(i, "bob" if i % 3 else "alice")
            done.set()

        def reseeds():
            for _ in range(10):
                rep.reseed()
                time.sleep(0.01)

        threads = [threading.Thread(target=writes), threading.Thread(target=reseeds)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert all(not t.is_alive() for t in threads) and done.is_set()
        deadline = time.monotonic() + 30
        while rep.store.version < leader.store.version and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        sys.setswitchinterval(old)
        rep.stop()
    assert rep.store.version == leader.store.version == 220, rep.lag()
    assert sorted(map(str, rep.store.all_tuples())) == sorted(
        map(str, leader.store.inner.all_tuples()))
    assert rep.reseeds_total == len(hooks) == 10


@pytest.mark.timeout(60)
def test_promotion_does_not_wait_for_a_request_to_a_dead_leader(leaders, tmp_path):
    """A leader that died with the tail's long-poll open answers only at the
    HTTP timeout. The port's promote (and retarget) drop that request
    instead of joining the thread: the WAL replay starts at once, so the
    new leader renews its lease in time (the reference joins for up to the
    timeout plus 5 s, past a short lease's TTL)."""
    import socket

    leader = leaders("torch")
    for i in range(5):
        leader.write(i)
    silent = socket.socket()
    silent.bind(("127.0.0.1", 0))
    silent.listen(8)  # accepts into the backlog, never answers
    try:
        rep = tfollower.FollowerReplicator(
            tstore.InMemoryTupleStore(), f"http://127.0.0.1:{silent.getsockname()[1]}",
            scratch_dir=str(tmp_path / "dead"), http_timeout_s=20.0)
        rep._start_tail()
        time.sleep(0.3)  # the tail is inside its request now
        t0 = time.monotonic()
        report = rep.promote(leader.store.wal_dir)
        took = time.monotonic() - t0
        assert took < 2.0, took
        assert report == {"applied": 5, "final_version": 5, "gap": False}
        assert rep.role == "leader" and rep._thread is None and rep.store.version == 5
    finally:
        silent.close()
