"""keto_tpu_torch's batch-check tiers over REST vs keto_tpu's, on the CPU.

One JAX ``Registry`` (closure engine in device query mode) and one port
``Registry(config, device="cpu")`` boot on free ports from the same config,
with the default caches and ``serve.read.encoded`` on, and qos enabled for
one namespace only (``qos.overrides``). The same request script goes to
both, step by step: the columnar ``POST /check/batch`` (valid and malformed
bodies), ``GET /vocab/snapshot`` and ``GET /vocab/deltas`` (paging, a bad
lineage's 409), ``POST /check/batch-encoded`` (frames from a ``VocabCache``
bootstrapped against each server, a stale epoch's 409 with its resync
details, a garbage frame's 400), and the 429 of a throttled namespace with
its ``Retry-After``. Status codes, bodies and headers must agree; the
vocab lineage, a random nonce per server, is compared as "present" only.
Tolerance: exact.
"""

import json
import re
import urllib.error
import urllib.parse
import urllib.request

import pytest

from keto_tpu_torch.api import wirecodec
from keto_tpu_torch.client import VocabCache
from keto_tpu_torch.client.vocabcache import post_frame
from test_torch_rest import JaxServer, TorchServer
import test_torch_rest

VALUES = {
    "namespaces": [{"id": 1, "name": "n"}, {"id": 2, "name": "hot"},
                   {"id": 3, "name": "videos"}],
    "serve": {
        "read": {"port": 0, "host": "127.0.0.1", "max-depth": 5},
        "write": {"port": 0, "host": "127.0.0.1"},
    },
    "engine": {"max_batch": 64, "query_mode": "device"},
    "qos": {"enabled": True, "overrides": {"hot": {"rate": 1.0, "burst": 2.0}}},
}

TUPLES = [
    "n:doc#view@(n:grp#member)", "n:grp#member@alice", "n:grp#member@(n:sub#member)",
    "n:sub#member@bob", "n:doc#edit@carol", "hot:x#y@dave", "videos:/cats#owner@cat lady",
]


@pytest.fixture(scope="module")
def servers(monkeypatch_module):
    monkeypatch_module.setattr(test_torch_rest, "VALUES", VALUES)
    jax_server, torch_server = JaxServer(), TorchServer()
    yield jax_server, torch_server
    torch_server.stop()
    jax_server.stop()


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def request(port, method, path, params=None, body=None, raw=None):
    url = f"http://127.0.0.1:{port}{path}"
    if params:
        url += "?" + urllib.parse.urlencode(params)
    data = raw if raw is not None else (None if body is None else json.dumps(body).encode())
    ctype = "application/octet-stream" if raw is not None else "application/json"
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            status, text, headers = resp.status, resp.read(), resp.headers
    except urllib.error.HTTPError as e:
        status, text, headers = e.code, e.read(), e.headers
    if headers.get("Content-Type", "").startswith("application/json") and text:
        return status, json.loads(text), headers.get("Retry-After")
    return status, text, headers.get("Retry-After")


def normalized(doc):
    """The response with the per-server lineage nonce masked."""
    if isinstance(doc, str):
        return re.sub(r"\b[0-9a-f]{16}\b", "<lineage>", doc)
    if isinstance(doc, dict):
        out = {}
        for k, v in doc.items():
            if k in ("lineage", "server_lineage", "client_lineage") and v:
                out[k] = "<lineage>"
            else:
                out[k] = normalized(v)
        return out
    if isinstance(doc, (list, tuple)):
        return [normalized(v) for v in doc]
    return doc


def both(servers, method, path, plane="read", **kw):
    """One step to both servers; the port's (status, body, retry-after)."""
    out = []
    for server in servers:
        port = server.read_port if plane == "read" else server.write_port
        out.append(request(port, method, path, **kw))
    want, got = normalized(out[0]), normalized(out[1])
    assert got == want, f"{method} {path}: port {got} != jax {want}"
    return out[1]


def write_all(servers, strings):
    from keto_tpu_torch.relationtuple import RelationTuple

    both(servers, "DELETE", "/relation-tuples", plane="write")
    for s in strings:
        both(servers, "PUT", "/relation-tuples", plane="write",
             body=RelationTuple.from_string(s).to_dict())


def columns(rows, **extra):
    from keto_tpu_torch.relationtuple import RelationTuple
    from keto_tpu_torch.relationtuple.columns import CheckColumns

    cols = CheckColumns.from_tuples([RelationTuple.from_string(r) for r in rows])
    body = {c: getattr(cols, c) for c in CheckColumns.__slots__}
    body.update(extra)
    return body


CHECKS = ["n:doc#view@alice", "n:doc#view@bob", "n:doc#view@carol", "n:doc#edit@carol",
          "n:doc#view@(n:sub#member)", "n:doc#view@nobody", "zzz:q#r@alice"]


def test_columnar_check_batch(servers):
    write_all(servers, TUPLES)
    status, doc, _ = both(servers, "POST", "/check/batch", body=columns(CHECKS))
    assert status == 200 and doc["allowed"] == [True, True, False, True, True, False, False]
    status, doc, _ = both(servers, "POST", "/check/batch",
                          body=columns(CHECKS, max_depth=1))
    assert doc["allowed"] == [False, False, False, True, False, False, False]
    both(servers, "POST", "/check/batch", params={"max-depth": 2}, body=columns(CHECKS))
    # the tuple body gives the same answers
    from keto_tpu_torch.relationtuple import RelationTuple

    tuples = [RelationTuple.from_string(r).to_dict() for r in CHECKS]
    status, tdoc, _ = both(servers, "POST", "/check/batch", body=tuples)
    assert tdoc["allowed"] == [True, True, False, True, True, False, False]


@pytest.mark.parametrize("body", [
    {"namespaces": ["n", "n"], "objects": ["doc"], "relations": ["view", "view"],
     "subject_ids": ["a", "b"]},
    {"namespaces": ["n"], "objects": ["doc"], "relations": ["view"]},
    {"namespaces": ["n"], "objects": ["doc"], "relations": ["view"],
     "subject_ids": ["a"], "subject_set_objects": ["x"]},
    {"namespaces": "n", "objects": ["doc"], "relations": ["view"]},
    {"namespaces": ["n"], "objects": [1], "relations": ["view"], "subject_ids": ["a"]},
    {"namespaces": [], "objects": [], "relations": []},
])
def test_columnar_bodies_edge_cases(servers, body):
    both(servers, "POST", "/check/batch", body=body)


def test_vocab_routes(servers):
    write_all(servers, TUPLES)
    pages = []
    offset = 0
    while True:
        status, doc, _ = both(servers, "GET", "/vocab/snapshot",
                              params={"offset": offset, "limit": 4})
        assert status == 200 and doc["offset"] == offset
        pages.append(doc)
        offset += len(doc["keys"])
        if offset >= doc["epoch"]:
            break
    assert sum(len(p["keys"]) for p in pages) == pages[0]["epoch"]
    both(servers, "GET", "/vocab/snapshot", params={"offset": "x"})
    status, doc, _ = both(servers, "GET", "/vocab/deltas",
                          params={"lineage": "beefbeefbeefbeef", "from": 0})
    assert status == 409 and doc["error"]["details"]["resync"] == "/vocab/snapshot"
    both(servers, "GET", "/vocab/deltas", params={"lineage": "x", "from": "y"})
    # each server's own lineage: the delta page from epoch 3
    out = []
    for server in servers:
        lineage = request(server.read_port, "GET", "/vocab/snapshot",
                          params={"limit": 1})[1]["lineage"]
        out.append(request(server.read_port, "GET", "/vocab/deltas",
                           params={"lineage": lineage, "from": 3}))
    assert normalized(out[0]) == normalized(out[1]) and out[1][0] == 200
    jdoc, tdoc = (request(s.read_port, "GET", "/pipeline")[1] for s in servers)
    # the port reports a few more counters (batches, restarts) than these
    assert {k: tdoc[k] for k in jdoc if k != "cancelled"} == {
        k: v for k, v in jdoc.items() if k != "cancelled"
    }
    assert tdoc["pipelined"] is False


def test_encoded_check_batch(servers):
    write_all(servers, TUPLES)
    caches = [VocabCache(f"http://127.0.0.1:{s.read_port}", page_size=5).bootstrap()
              for s in servers]
    assert caches[0].epoch == caches[1].epoch

    def post_both(frames):
        out = []
        for server, frame in zip(servers, frames):
            status, body = post_frame(f"http://127.0.0.1:{server.read_port}", frame)
            if status == 200:
                allowed, token = wirecodec.decode_check_response(body)
                out.append((status, allowed.tolist(), token))
            else:
                out.append((status, normalized(json.loads(body))))
        assert out[0] == out[1], f"port {out[1]} != jax {out[0]}"
        return out[1]

    status, allowed, _ = post_both([c.frame(CHECKS) for c in caches])
    assert status == 200 and allowed == [True, True, False, True, True, False, False]
    got = post_both([c.frame(CHECKS, depths=[1] * len(CHECKS)) for c in caches])
    assert got[1] == [False, False, False, True, False, False, False]
    # a write that interns a key moves the epoch: the stale frames bounce
    stale = [c.frame(CHECKS + ["n:doc#view@erin"]) for c in caches]
    both(servers, "PUT", "/relation-tuples", plane="write",
         body={"namespace": "n", "object": "grp", "relation": "member",
               "subject_id": "erin"})
    status, doc = post_both(stale)
    assert status == 409
    details = doc["error"]["details"]
    assert details["reason"] == "vocab_epoch_mismatch"
    assert details["server_epoch"] == details["client_epoch"] + 1
    for c in caches:
        c.sync()
    status, allowed, _ = post_both([c.frame(CHECKS + ["n:doc#view@erin"]) for c in caches])
    assert allowed[-1] is True
    # garbage and foreign frames are a 400
    post_both([b"nonsense"] * 2)
    post_both([wirecodec.encode_check_response([True], "")] * 2)


def test_throttled_namespace_gets_429_with_retry_after(servers):
    write_all(servers, TUPLES)
    rows = ["hot:x#y@dave"] * 3  # burst 2: one row short
    status, doc, retry = both(servers, "POST", "/check/batch", body=columns(rows))
    assert status == 429 and retry == "1"
    status, doc, retry = both(servers, "GET", "/check",
                              params={"namespace": "hot", "object": "x",
                                      "relation": "y", "subject_id": "dave"})
    assert status == 200 and doc == {"allowed": True}
    # other namespaces are not throttled
    both(servers, "POST", "/check/batch", body=columns(["n:doc#view@alice"] * 50))
