"""The e2e case suite of ``tests/test_e2e_matrix.py`` through the port's four
adapters, on the CPU.

One behavioural case suite (reference internal/e2e/full_suit_test.go:45-86
runs runCases through gRPC, raw REST, the CLI binary and the generated SDK)
goes through the port's ``GrpcClient``, ``RestClient``, raw ``http.client``
REST and the port's CLI (``cli.main(argv)`` in process), against a port
server (``device="cpu"``) in every configuration:

- memory, columnar and sqlite at 1 worker, started in this process by
  ``driver/factory.py``;
- memory (forked read replicas) and sqlite (spawned workers) at 3 workers,
  each booted in a fresh interpreter (this file run as a script: ``python
  tests/test_torch_e2e_matrix.py memory|sqlite <dir>``, through
  ``keto_tpu_torch/poolharness.py``), as ``tests/test_torch_replicas.py``
  and ``tests/test_torch_spawn.py`` do, so nothing forks a pytest worker.

A read after a write may reach a worker the write has not reached yet, so
every read waits for its expected answer (deadline 30 s) instead of
sleeping. Tolerances: exact.
"""

import contextlib
import http.client
import io
import json
import sys
import tempfile
import time
from pathlib import Path
from urllib.parse import urlencode

import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))  # run as a script, the harness imports from here

from keto_tpu_torch.poolharness import PoolProcess, emit, serve_commands  # noqa: E402

BOOT_S = 180.0
VISIBLE_S = 30.0
IN_PROCESS = [("memory", 1), ("columnar", 1), ("sqlite", 1)]
POOLED = [("memory", 3), ("sqlite", 3)]


def registry_for(kind: str, workers: int, tmpdir: str):
    from keto_tpu_torch.driver.factory import new_sqlite_test_registry, new_test_registry

    values = {"serve": {"read": {"workers": workers}}}
    if kind == "sqlite":
        return new_sqlite_test_registry(f"{tmpdir}/e2e.db", values=values, device="cpu")
    if kind == "columnar":
        values["dsn"] = "columnar"
    return new_test_registry(values=values, device="cpu")


def harness(kind: str, tmpdir: str) -> None:
    """Serve a 3-worker pool of `kind` until stdin says stop."""
    reg = registry_for(kind, 3, tmpdir)
    read_port, write_port = reg.start_all()
    emit({"read": read_port, "write": write_port})

    def stop() -> dict:
        reg.stop_all()
        return {"stopped": True}

    serve_commands({}, stop)


class InProcess:
    def __init__(self, kind: str, tmpdir: str):
        self.registry = registry_for(kind, 1, tmpdir)
        self.read_port, self.write_port = self.registry.start_all()

    def stop(self):
        self.registry.stop_all()


class Pooled(PoolProcess):
    def __init__(self, kind: str, tmpdir: str):
        super().__init__([sys.executable, str(Path(__file__).resolve()), kind, tmpdir],
                         cwd=str(REPO), name=f"{kind} pool harness")

    def boot(self) -> "Pooled":
        info = self.next_doc(BOOT_S)
        self.read_port, self.write_port = info["read"], info["write"]
        return self


@pytest.fixture(scope="module")
def pools():
    """Both pooled servers, booted at once and stopped at the end."""
    dirs = [tempfile.TemporaryDirectory() for _ in POOLED]
    servers = {}
    try:
        for (kind, w), d in zip(POOLED, dirs):
            servers[(kind, w)] = Pooled(kind, d.name)
        for server in servers.values():
            server.boot()
        yield servers
    finally:
        for server in servers.values():
            try:
                server.stop(60.0)
            except Exception:
                server.kill_group()
        for d in dirs:
            d.cleanup()


@pytest.fixture(
    scope="module",
    params=IN_PROCESS + POOLED,
    ids=[f"{k}-w{w}" for k, w in IN_PROCESS + POOLED],
)
def server(request):
    if request.param in POOLED:
        yield request.getfixturevalue("pools")[request.param]
        return
    with tempfile.TemporaryDirectory() as tmpdir:
        s = InProcess(request.param[0], tmpdir)
        yield s
        s.stop()


def t(s: str):
    from keto_tpu_torch.relationtuple import RelationTuple

    return RelationTuple.from_string(s)


class GrpcAdapter:
    name = "grpc"

    def __init__(self, server):
        from keto_tpu_torch.client import GrpcClient

        self.c = GrpcClient(f"127.0.0.1:{server.read_port}",
                            f"127.0.0.1:{server.write_port}")

    def create(self, tup):
        assert self.c.transact(insert=[tup])  # a snaptoken comes back

    def check(self, tup):
        return self.c.check(tup).allowed

    def expand_subjects(self, ss):
        tree = self.c.expand(ss)
        return "" if tree is None else str(tree)

    def list_count(self, namespace):
        from keto_tpu_torch.api.gen.ory.keto.acl.v1alpha1 import read_service_pb2

        total, token = 0, ""
        while True:
            resp = self.c.read_service.ListRelationTuples(
                read_service_pb2.ListRelationTuplesRequest(
                    query=read_service_pb2.ListRelationTuplesRequest.Query(
                        namespace=namespace),
                    page_token=token,
                )
            )
            total += len(resp.relation_tuples)
            token = resp.next_page_token
            if not token:
                return total

    def delete_all(self, namespace):
        from keto_tpu_torch.api.gen.ory.keto.acl.v1alpha1 import write_service_pb2

        self.c.write_service.DeleteRelationTuples(
            write_service_pb2.DeleteRelationTuplesRequest(
                query=write_service_pb2.DeleteRelationTuplesRequest.Query(
                    namespace=namespace)
            )
        )

    def close(self):
        self.c.close()


class SdkAdapter:
    name = "sdk"

    def __init__(self, server):
        from keto_tpu_torch.client import RestClient

        self.c = RestClient(f"http://127.0.0.1:{server.read_port}",
                            f"http://127.0.0.1:{server.write_port}")

    def create(self, tup):
        self.c.create_relation_tuple(tup)

    def check(self, tup):
        return self.c.check(tup).allowed

    def expand_subjects(self, ss):
        tree = self.c.expand(ss)
        return "" if tree is None else str(tree)

    def list_count(self, namespace):
        from keto_tpu_torch.relationtuple import RelationQuery

        return len(list(self.c.iter_relation_tuples(RelationQuery(namespace=namespace))))

    def delete_all(self, namespace):
        from keto_tpu_torch.relationtuple import RelationQuery

        self.c.delete_relation_tuples(RelationQuery(namespace=namespace))

    def close(self):
        self.c.close()


class RawRestAdapter:
    """Raw REST on ``http.client``, a fresh connection per request."""

    name = "rest"

    def __init__(self, server):
        self.read, self.write = server.read_port, server.write_port

    def _send(self, port, method, path, params=None, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        try:
            if params:
                path += "?" + urlencode(params)
            data = None if body is None else json.dumps(body).encode()
            conn.request(method, path, body=data,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            raw = resp.read()
            return resp.status, (json.loads(raw) if raw else None)
        finally:
            conn.close()

    def create(self, tup):
        status, doc = self._send(self.write, "PUT", "/relation-tuples",
                                 body=t(tup).to_dict())
        assert status == 201, doc

    def check(self, tup):
        tu = t(tup)
        params = {"namespace": tu.namespace, "object": tu.object,
                  "relation": tu.relation}
        s = tu.subject
        if hasattr(s, "id"):
            params["subject_id"] = s.id
        else:
            params.update({"subject_set.namespace": s.namespace,
                           "subject_set.object": s.object,
                           "subject_set.relation": s.relation})
        status, doc = self._send(self.read, "GET", "/check", params)
        assert status in (200, 403)
        return doc["allowed"]

    def expand_subjects(self, ss):
        status, doc = self._send(self.read, "GET", "/expand", {
            "namespace": ss.namespace, "object": ss.object, "relation": ss.relation})
        assert status == 200
        return json.dumps(doc)

    def list_count(self, namespace):
        total, token = 0, ""
        while True:
            status, doc = self._send(self.read, "GET", "/relation-tuples",
                                     {"namespace": namespace, "page_token": token})
            assert status == 200, doc
            total += len(doc["relation_tuples"])
            token = doc["next_page_token"]
            if not token:
                return total

    def delete_all(self, namespace):
        status, _ = self._send(self.write, "DELETE", "/relation-tuples",
                               {"namespace": namespace})
        assert status == 204

    def close(self):
        pass


class CliAdapter:
    name = "cli"

    def __init__(self, server):
        self.remotes = ["--read-remote", f"127.0.0.1:{server.read_port}",
                        "--write-remote", f"127.0.0.1:{server.write_port}"]

    def _run(self, args, stdin="", ok=(0,)):
        from keto_tpu_torch.cli.main import main

        out, err = io.StringIO(), io.StringIO()
        old, sys.stdin = sys.stdin, io.StringIO(stdin)
        try:
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                rc = main(self.remotes + args)
        finally:
            sys.stdin = old
        assert rc in ok, err.getvalue()
        return rc, out.getvalue()

    def create(self, tup):
        self._run(["relation-tuple", "create", "-"], json.dumps(t(tup).to_dict()))

    def check(self, tup):
        tu = t(tup)
        rc, _ = self._run(["check", str(tu.subject), tu.relation, tu.namespace,
                           tu.object], ok=(0, 1))
        return rc == 0

    def expand_subjects(self, ss):
        return self._run(["expand", ss.relation, ss.namespace, ss.object])[1]

    def list_count(self, namespace):
        total, token = 0, ""
        while True:
            args = ["relation-tuple", "get", "--namespace", namespace, "--format", "json"]
            if token:
                args += ["--page-token", token]
            doc = json.loads(self._run(args)[1])
            total += len(doc["relation_tuples"])
            token = doc.get("next_page_token", "")
            if not token:
                return total

    def delete_all(self, namespace):
        self._run(["relation-tuple", "delete-all", "--namespace", namespace, "--force"])

    def close(self):
        pass


ADAPTERS = [GrpcAdapter, SdkAdapter, RawRestAdapter, CliAdapter]


def eventually(read, want, what: str):
    """Poll `read()` until it gives `want` (a pooled read may reach a worker
    the write has not reached yet); fail after VISIBLE_S."""
    deadline = time.monotonic() + VISIBLE_S
    while True:
        got = read()
        if got == want or (callable(want) and want(got)):
            return got
        assert time.monotonic() < deadline, f"{what}: {got!r}, want {want!r}"
        time.sleep(0.01)


@pytest.fixture(params=ADAPTERS, ids=lambda a: a.name)
def client(request, server):
    c = request.param(server)
    yield c
    c.delete_all("videos")
    c.close()


def run_cases(client):
    """The shared behavioural cases (reference cases_test.go:21-202)."""
    from keto_tpu_torch.relationtuple import SubjectSet

    # direct + two-level indirection
    client.create("videos:/cats#owner@cat lady")
    client.create("videos:/cats/1.mp4#owner@(videos:/cats#owner)")
    client.create("videos:/cats/1.mp4#view@(videos:/cats/1.mp4#owner)")
    for tup in ("videos:/cats#owner@cat lady", "videos:/cats/1.mp4#owner@cat lady",
                "videos:/cats/1.mp4#view@cat lady"):
        eventually(lambda: client.check(tup), True, tup)
    assert not client.check("videos:/cats/1.mp4#view@dog guy")
    # unknown object/relation/subject deny
    assert not client.check("videos:/dogs#view@cat lady")
    # expand reaches the root subject
    ss = SubjectSet(namespace="videos", object="/cats/1.mp4", relation="view")
    eventually(lambda: client.expand_subjects(ss), lambda out: "cat lady" in out, "expand")
    # listing sees exactly what was written
    eventually(lambda: client.list_count("videos"), 3, "list")
    # idempotent duplicate write
    client.create("videos:/cats#owner@cat lady")
    assert client.list_count("videos") == 3
    # delete-all empties the namespace and checks flip
    client.delete_all("videos")
    eventually(lambda: client.list_count("videos"), 0, "list after delete-all")
    eventually(lambda: client.check("videos:/cats#owner@cat lady"), False, "check after")


def test_cases_through_every_client(client):
    run_cases(client)


if __name__ == "__main__":
    harness(sys.argv[1], sys.argv[2])
