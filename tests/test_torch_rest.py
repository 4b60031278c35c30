"""keto_tpu_torch's REST server vs keto_tpu's, on the CPU.

One JAX ``Registry`` (closure engine in device query mode) and one port
``Registry(config, device="cpu")`` boot on free ports from the same
config. Each request script below goes to both servers, step by step, and
every response must agree: status code, JSON body (snaptokens included),
and the ``Location`` and ``Retry-After`` headers. The scripts follow
``tests/test_api_server.py`` without gRPC: the cat-videos drive (Expand
included; more Expand and the list routes in test_torch_rest_read.py),
malformed input (400), unknown namespaces (404), a garbage page
token, pagination, PATCH and DELETE, snaptokens, and the depth boundary at
max-depth 5. Each script first deletes every tuple through the write
plane, so the scripts are independent while both stores keep the same
version history.
"""

import asyncio
import json
import threading
import urllib.error
import urllib.parse
import urllib.request
from pathlib import Path

import pytest

from keto_tpu.driver import Config as JConfig
from keto_tpu.driver import Registry as JRegistry
from keto_tpu_torch.driver import Config as TConfig
from keto_tpu_torch.driver import Registry as TRegistry

REPO = Path(__file__).resolve().parent.parent

VALUES = {
    "namespaces": [{"id": 1, "name": "videos"}, {"id": 2, "name": "n"}],
    "serve": {
        "read": {"port": 0, "host": "127.0.0.1", "max-depth": 5},
        "write": {"port": 0, "host": "127.0.0.1"},
    },
    "engine": {"max_batch": 64, "query_mode": "device"},
}


class JaxServer:
    """The JAX Registry's planes on a background asyncio loop thread."""

    def __init__(self):
        self.registry = JRegistry(
            JConfig(values={**VALUES, "log": {"level": "error"}})
        )
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        fut = asyncio.run_coroutine_threadsafe(self.registry.start_all(), self.loop)
        self.read_port, self.write_port = fut.result(timeout=180)

    def stop(self):
        asyncio.run_coroutine_threadsafe(
            self.registry.stop_all(), self.loop
        ).result(timeout=30)
        asyncio.run_coroutine_threadsafe(
            self.loop.shutdown_default_executor(), self.loop
        ).result(timeout=30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


class TorchServer:
    def __init__(self):
        # the reference's server beside it logs at error: so does this one
        self.registry = TRegistry(
            TConfig(values={**VALUES, "log": {"level": "error"}}), device="cpu"
        )
        self.read_port, self.write_port = self.registry.start_all()

    def stop(self):
        self.registry.stop_all()


@pytest.fixture(scope="module")
def servers():
    jax_server = JaxServer()
    torch_server = TorchServer()
    yield jax_server, torch_server
    torch_server.stop()
    jax_server.stop()


def send(server, plane, method, path, params=None, body=None, raw=None):
    port = server.read_port if plane == "read" else server.write_port
    url = f"http://127.0.0.1:{port}{path}"
    if params:
        url += "?" + urllib.parse.urlencode(params)
    data = raw if raw is not None else (None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(
        url, data=data, method=method, headers={"Content-Type": "application/json"}
    )
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            status, text, headers = resp.status, resp.read(), resp.headers
    except urllib.error.HTTPError as e:
        status, text, headers = e.code, e.read(), e.headers
    ctype = headers.get("Content-Type", "")
    doc = json.loads(text) if text and ctype.startswith("application/json") else text
    return status, doc, headers.get("Location"), headers.get("Retry-After")


def run_script(servers, steps):
    """Every step to both servers; returns the port's (status, body)s."""
    jax_server, torch_server = servers
    out = []
    for step in steps:
        want = send(jax_server, *step)
        got = send(torch_server, *step)
        assert got == want, f"step {step}: port {got} != jax {want}"
        out.append(got[:2])
    return out


def clear():
    return ("write", "DELETE", "/relation-tuples")


def put(ns, obj, rel, sub):
    body = {"namespace": ns, "object": obj, "relation": rel}
    if isinstance(sub, str):
        body["subject_id"] = sub
    else:
        body["subject_set"] = dict(zip(("namespace", "object", "relation"), sub))
    return ("write", "PUT", "/relation-tuples", None, body)


def check(ns, obj, rel, sid, **extra):
    params = {"namespace": ns, "object": obj, "relation": rel, "subject_id": sid}
    return ("read", "GET", "/check", {**params, **extra})


def cat_videos_tuples():
    out = []
    for path in sorted((REPO / "contrib/cat-videos-example/relation-tuples").glob("*.json")):
        doc = json.loads(path.read_text())
        doc.pop("$schema", None)
        out.append(("write", "PUT", "/relation-tuples", None, doc))
    return out


CAT_CHECKS = [
    check("videos", "/cats", "owner", "cat lady"),
    check("videos", "/cats/1.mp4", "owner", "cat lady"),
    check("videos", "/cats/1.mp4", "view", "cat lady"),
    check("videos", "/cats/1.mp4", "view", "*"),
    check("videos", "/cats/2.mp4", "view", "*"),
    check("videos", "/cats/1.mp4", "view", "dog guy"),
]

SCRIPTS = {
    "health_and_version": [
        ("read", "GET", "/health/alive"),
        ("read", "GET", "/health/ready"),
        ("read", "GET", "/version"),
        ("write", "GET", "/health/alive"),
        ("write", "GET", "/health/ready"),
        ("write", "GET", "/version"),
        ("read", "GET", "/no-such-route"),
    ],
    "cat_videos": [clear()] + cat_videos_tuples() + CAT_CHECKS + [
        ("read", "POST", "/check", None, {
            "namespace": "videos", "object": "/cats", "relation": "owner",
            "subject_id": "cat lady"}),
        ("read", "POST", "/check/batch", None, [
            {"namespace": "videos", "object": o, "relation": r, "subject_id": s}
            for o, r, s in [("/cats/1.mp4", "view", "cat lady"),
                            ("/cats/2.mp4", "view", "*"),
                            ("/cats/1.mp4", "view", "*")]]),
        ("read", "POST", "/check/batch", None, {"tuples": [
            {"namespace": "videos", "object": "/cats/1.mp4", "relation": "view",
             "subject_id": "cat lady"}], "max_depth": 2}),
        ("read", "GET", "/relation-tuples", {"namespace": "videos"}),
        ("read", "GET", "/relation-tuples", {"namespace": "videos", "object": "/cats"}),
        ("read", "GET", "/expand", {
            "namespace": "videos", "object": "/cats/1.mp4", "relation": "view"}),
    ],
    "snaptokens": [
        clear(),
        put("n", "doc", "view", ("n", "g", "m")),
        put("n", "g", "m", "alice"),
        check("n", "doc", "view", "alice", snaptoken="2"),
        check("n", "doc", "view", "alice", latest="true"),
        check("n", "doc", "view", "alice", snaptoken="z1.0.0"),
        check("n", "doc", "view", "alice", snaptoken="bogus"),
        check("n", "doc", "view", "alice", latest="maybe"),
        ("read", "GET", "/relation-tuples", {"namespace": "n", "snaptoken": "1"}),
        ("read", "GET", "/relation-tuples", {"namespace": "n", "snaptoken": "bogus"}),
        ("read", "POST", "/check/batch", {"snaptoken": "3"}, [
            {"namespace": "n", "object": "doc", "relation": "view",
             "subject_id": "alice"}]),
    ],
    "pagination": [clear()] + [put("n", "o", "r", f"u{i}") for i in range(5)] + [
        ("read", "GET", "/relation-tuples", {"namespace": "n", "page_size": 2}),
        ("read", "GET", "/relation-tuples",
         {"namespace": "n", "page_size": 2, "page_token": "Mg"}),
        ("read", "GET", "/relation-tuples",
         {"namespace": "n", "page_size": 2, "page_token": "NA"}),
        ("read", "GET", "/relation-tuples", {"namespace": "n", "page_token": "$$garbage$$"}),
        ("read", "GET", "/relation-tuples", {"namespace": "n", "page_size": "two"}),
    ],
    "patch_and_delete": [
        clear(),
        ("write", "PATCH", "/relation-tuples", None, [
            {"action": "insert", "relation_tuple": {
                "namespace": "n", "object": "o", "relation": "r", "subject_id": s}}
            for s in ("alice", "bob")]),
        ("write", "PATCH", "/relation-tuples", None, [
            {"action": "upsert", "relation_tuple": {
                "namespace": "n", "object": "o", "relation": "r",
                "subject_id": "eve"}}]),
        ("write", "PATCH", "/relation-tuples", None, {"action": "insert"}),
        ("write", "PATCH", "/relation-tuples", None, ["not-a-delta"]),
        ("write", "DELETE", "/relation-tuples", {"namespace": "n", "subject_id": "bob"}),
        ("read", "GET", "/relation-tuples", {"namespace": "n"}),
        check("n", "o", "r", "bob"),
        check("n", "o", "r", "alice"),
        ("write", "PATCH", "/relation-tuples", None, [
            {"action": "delete", "relation_tuple": {
                "namespace": "n", "object": "o", "relation": "r",
                "subject_id": "alice"}}]),
        check("n", "o", "r", "alice"),
    ],
    "unknown_namespace": [
        clear(),
        put("nope", "o", "r", "alice"),
        ("read", "GET", "/relation-tuples", {"namespace": "nope"}),
        check("nope", "o", "r", "alice"),
        ("write", "PATCH", "/relation-tuples", None, [
            {"action": "insert", "relation_tuple": {
                "namespace": "nope", "object": "o", "relation": "r",
                "subject_id": "x"}}]),
    ],
    "malformed_input": [
        clear(),
        ("read", "GET", "/check", {
            "namespace": "n", "object": "o", "relation": "r", "subject_id": "x",
            "subject_set.namespace": "n", "subject_set.object": "o",
            "subject_set.relation": "r"}),
        ("read", "GET", "/check", {"namespace": "n", "object": "o", "relation": "r"}),
        ("read", "GET", "/check", {"namespace": "n", "relation": "r", "subject_id": "x"}),
        ("read", "GET", "/check", {
            "namespace": "n", "object": "o", "relation": "r",
            "subject_set.namespace": "n"}),
        check("n", "o", "r", "x", **{"max-depth": "deep"}),
        ("read", "POST", "/check", None, None, b"{not json"),
        ("read", "POST", "/check", None, {"namespace": "n", "object": "o"}),
        ("read", "POST", "/check", None, {
            "namespace": "n", "object": "o", "relation": "r"}),
        ("read", "POST", "/check", None, [1, 2]),
        ("read", "POST", "/check/batch", None, {"tuples": "x"}),
        ("read", "POST", "/check/batch", None, None, b"[,"),
        ("write", "PUT", "/relation-tuples", None, ["n:o#r@x"]),
        ("write", "PUT", "/relation-tuples", None, {
            "namespace": "n", "object": "o", "relation": "r"}),
        ("write", "PUT", "/relation-tuples", None, {
            "namespace": "n", "object": "o", "relation": "r",
            "subject_set": {"namespace": "n"}}),
    ],
    "depth_boundary": [clear()] + [
        put("n", f"c{i}", "m", ("n", f"c{i + 1}", "m")) for i in range(5)
    ] + [
        put("n", "c5", "m", "alice"),
        check("n", "c1", "m", "alice"),
        check("n", "c0", "m", "alice"),
        check("n", "c1", "m", "alice", **{"max-depth": "4"}),
        check("n", "c1", "m", "alice", **{"max-depth": "9"}),
        ("read", "POST", "/check/batch", {"max-depth": "5"}, [
            {"namespace": "n", "object": f"c{i}", "relation": "m",
             "subject_id": "alice"} for i in range(6)]),
    ],
    "read_your_writes": [
        clear(),
        put("n", "doc", "view", ("n", "grp", "m")),
        check("n", "doc", "view", "carol"),
        put("n", "grp", "m", "carol"),
        check("n", "doc", "view", "carol"),
        put("n", "grp", "m", ("n", "sub", "m")),
        put("n", "sub", "m", "dave"),
        check("n", "doc", "view", "dave"),
        ("write", "DELETE", "/relation-tuples", {
            "namespace": "n", "object": "grp", "relation": "m",
            "subject_set.namespace": "n", "subject_set.object": "sub",
            "subject_set.relation": "m"}),
        check("n", "doc", "view", "dave"),
        ("write", "DELETE", "/relation-tuples", {"namespace": "n", "subject_id": "carol"}),
        check("n", "doc", "view", "carol"),
        ("read", "POST", "/check/batch", None, [
            {"namespace": "n", "object": "doc", "relation": "view", "subject_id": s}
            for s in ("carol", "dave", "erin")]),
    ],
}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_script(servers, name):
    run_script(servers, SCRIPTS[name])


def test_cat_videos_answers(servers):
    """The cat-videos drive of the verify recipe: the checks, then the
    Expand of videos:/cats/1.mp4#view, a union holding the owner chain and
    the * leaf."""
    got = run_script(servers, [clear()] + cat_videos_tuples() + CAT_CHECKS + [
        ("read", "GET", "/expand", {
            "namespace": "videos", "object": "/cats/1.mp4", "relation": "view"}),
    ])
    assert [s for s, _ in got[-len(CAT_CHECKS) - 1 : -1]] == [
        200, 200, 200, 200, 403, 403
    ]
    status, tree = got[-1]
    assert status == 200 and tree["type"] == "union"
    owner, star = tree["children"]
    assert star == {"type": "leaf", "subject_id": "*"}
    assert owner["subject_set"] == {
        "namespace": "videos", "object": "/cats/1.mp4", "relation": "owner"}
    assert owner["children"][0]["children"] == [
        {"type": "leaf", "subject_id": "cat lady"}]


def test_port_checks_went_through_the_batcher_and_the_overlay(servers):
    """The port served those checks from one closure build, through the
    check batcher, with every write absorbed by the overlay."""
    _, torch_server = servers
    registry = torch_server.registry
    engine = registry.check_engine()
    run_script(servers, SCRIPTS["read_your_writes"])
    assert engine.n_full_builds + engine.n_incremental_builds == 1
    assert engine.served_version() == registry.store().version
    assert registry.checker().n_batches > 0
    assert registry.read_snaptoken() == registry.snaptoken()
