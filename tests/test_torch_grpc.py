"""keto_tpu_torch's gRPC plane vs keto_tpu's, on the CPU.

One JAX ``Registry`` (closure engine in device query mode) and one port
``Registry(config, device="cpu")`` boot on free ports from the same config
(``test_torch_rest.VALUES``). One request script goes through the port's
client stubs to both servers' public read and write ports, which answer
REST and gRPC alike: Check (a hit, a miss, max-depth, snaptokens, the
criticality metadata), BatchCheck with tuples and with columns,
BatchCheckEncoded (frames from a ``VocabCache`` bootstrapped against each
server, a stale epoch's FAILED_PRECONDITION with its resync details),
Expand (whole and paged through metadata), ListRelationTuples with paging
and a field mask, ListObjects and ListSubjects, TransactRelationTuples and
DeleteRelationTuples, GetVersion, Health and reflection, and malformed
input throughout. Every response must be byte-equal (``SerializeToString``,
or the raw bytes of the identity-serialized methods), with trailing
metadata; every error must carry the same status code, details and
trailing metadata. Masked: the version string and the vocab lineage, a
random nonce per server. Tolerance: exact.

Then the port's mux alone: one public port answers REST and gRPC, and a
REST request reaches its handler on the client's own socket (no relay).
"""

import http.client
import json
import re

import grpc
import pytest

from keto_tpu_torch.api import daemon, services as S, wirecodec
from keto_tpu_torch.api.gen.health import health_pb2
from keto_tpu_torch.api.gen.ory.keto.acl.v1alpha1 import (
    acl_pb2,
    check_service_pb2 as C,
    expand_service_pb2 as E,
    read_service_pb2 as R,
    version_pb2 as V,
    write_service_pb2 as W,
)
from keto_tpu_torch.api.gen.reflection import reflection_pb2
from keto_tpu_torch.client import VocabCache
from keto_tpu_torch.relationtuple import RelationTuple
from test_torch_rest import JaxServer, TorchServer

TUPLES = [
    "n:doc#view@(n:grp#member)", "n:grp#member@alice", "n:grp#member@(n:sub#member)",
    "n:sub#member@bob", "n:doc#edit@carol",
    "videos:/cats#owner@cat lady", "videos:/cats/1.mp4#owner@(videos:/cats#owner)",
    "videos:/cats/1.mp4#view@(videos:/cats/1.mp4#owner)", "videos:/cats/1.mp4#view@*",
]

STUBS = {
    "check": S.CheckServiceStub, "expand": S.ExpandServiceStub,
    "read": S.ReadServiceStub, "list": S.ListServiceStub,
    "write": S.WriteServiceStub, "version": S.VersionServiceStub,
    "health": S.HealthStub,
}


@pytest.fixture(scope="module")
def servers():
    jax_server, torch_server = JaxServer(), TorchServer()
    channels = {}
    for server in (jax_server, torch_server):
        for plane, port in (("read", server.read_port), ("write", server.write_port)):
            channels[id(server), plane] = grpc.insecure_channel(f"127.0.0.1:{port}")
    yield jax_server, torch_server, channels
    for ch in channels.values():
        ch.close()
    torch_server.stop()
    jax_server.stop()


def rel_tuple(s):
    t = RelationTuple.from_string(s)
    if hasattr(t.subject, "id"):
        sub = acl_pb2.Subject(id=t.subject.id)
    else:
        sub = acl_pb2.Subject(set=acl_pb2.SubjectSet(
            namespace=t.subject.namespace, object=t.subject.object,
            relation=t.subject.relation))
    return acl_pb2.RelationTuple(
        namespace=t.namespace, object=t.object, relation=t.relation, subject=sub
    )


def check_req(s, **kw):
    t = rel_tuple(s)
    return C.CheckRequest(namespace=t.namespace, object=t.object, relation=t.relation,
                          subject=t.subject, **kw)


def masked(value):
    """Trailing metadata, error details or JSON with the lineage masked."""
    return re.sub(r"\b[0-9a-f]{16}\b", "<lineage>", value)


def invoke(channels, server, plane, service, method, request, metadata=None):
    stub = STUBS[service](channels[id(server), plane])
    try:
        resp, call = getattr(stub, method).with_call(
            request, timeout=120, metadata=metadata
        )
    except grpc.RpcError as e:
        trailing = [(k, masked(v)) for k, v in e.trailing_metadata() or ()]
        return ("error", e.code(), masked(e.details() or ""), trailing)
    trailing = [(k, masked(v)) for k, v in call.trailing_metadata() or ()]
    body = resp if isinstance(resp, bytes) else resp.SerializeToString()
    return ("ok", body, trailing)


def both(servers, plane, service, method, request, metadata=None, requests=None):
    """One step to both servers (``requests`` gives each its own request);
    the port's result, after requiring it equal to keto_tpu's."""
    jax_server, torch_server, channels = servers
    reqs = requests or (request, request)
    want = invoke(channels, jax_server, plane, service, method, reqs[0], metadata)
    got = invoke(channels, torch_server, plane, service, method, reqs[1], metadata)
    assert got == want, f"{service}.{method}: port {got} != jax {want}"
    return got


def ok(result, cls=None):
    assert result[0] == "ok", result
    return cls.FromString(result[1]) if cls is not None else result[1]


def code(result):
    assert result[0] == "error", result
    return result[1]


def write(servers, inserts=(), deletes=()):
    deltas = [W.RelationTupleDelta(action=W.RelationTupleDelta.INSERT,
                                   relation_tuple=rel_tuple(s)) for s in inserts]
    deltas += [W.RelationTupleDelta(action=W.RelationTupleDelta.DELETE,
                                    relation_tuple=rel_tuple(s)) for s in deletes]
    return both(servers, "write", "write", "TransactRelationTuples",
                W.TransactRelationTuplesRequest(relation_tuple_deltas=deltas))


def reset(servers):
    both(servers, "write", "write", "DeleteRelationTuples",
         W.DeleteRelationTuplesRequest(query=W.DeleteRelationTuplesRequest.Query()))
    resp = ok(write(servers, TUPLES), W.TransactRelationTuplesResponse)
    assert len(resp.snaptokens) == len(TUPLES)


def test_check(servers):
    reset(servers)

    def check(s, **kw):
        return both(servers, "read", "check", "Check", check_req(s, **kw))

    assert ok(check("videos:/cats/1.mp4#view@cat lady"), C.CheckResponse).allowed
    assert not ok(check("videos:/cats/2.mp4#view@*"), C.CheckResponse).allowed
    assert not ok(check("n:doc#view@bob", max_depth=2), C.CheckResponse).allowed
    assert ok(check("n:doc#view@bob", max_depth=5), C.CheckResponse).allowed
    assert ok(check("n:doc#view@alice", snaptoken="1"), C.CheckResponse).allowed
    assert ok(check("n:doc#view@alice", snaptoken="z2.0.0"), C.CheckResponse).allowed
    assert ok(check("n:doc#view@alice", latest=True), C.CheckResponse).allowed
    assert code(check("n:doc#view@alice", snaptoken="bogus")) == grpc.StatusCode.INVALID_ARGUMENT
    check("nope:doc#view@alice")
    check("n:doc#view@(n:grp#member)")
    no_subject = C.CheckRequest(namespace="n", object="doc", relation="view")
    assert code(both(servers, "read", "check", "Check", no_subject)) == (
        grpc.StatusCode.INVALID_ARGUMENT
    )
    for crit in ("critical", "sheddable", "bogus"):
        result = both(servers, "read", "check", "Check", check_req("n:doc#view@alice"),
                      metadata=(("x-keto-criticality", crit),))
        assert ok(result, C.CheckResponse).allowed


def test_batch_check(servers):
    reset(servers)
    rows = ["n:doc#view@alice", "n:doc#view@bob", "n:doc#edit@alice",
            "videos:/cats/1.mp4#view@cat lady", "videos:/cats/2.mp4#view@*",
            "n:doc#view@(n:sub#member)"]
    tuples = []
    for s in rows:
        t = rel_tuple(s)
        tuples.append(C.CheckRequestTuple(namespace=t.namespace, object=t.object,
                                          relation=t.relation, subject=t.subject))
    resp = ok(both(servers, "read", "check", "BatchCheck",
                   C.BatchCheckRequest(tuples=tuples)), C.BatchCheckResponse)
    assert list(resp.allowed) == [True, True, False, True, False, True]
    both(servers, "read", "check", "BatchCheck",
         C.BatchCheckRequest(tuples=tuples, max_depth=2))
    both(servers, "read", "check", "BatchCheck",
         C.BatchCheckRequest(tuples=tuples, snaptoken="3"),
         metadata=(("x-keto-criticality", "sheddable"),))
    bad = list(tuples) + [C.CheckRequestTuple(namespace="n", object="o", relation="r")]
    assert code(both(servers, "read", "check", "BatchCheck",
                     C.BatchCheckRequest(tuples=bad))) == grpc.StatusCode.INVALID_ARGUMENT
    cols = C.BatchCheckRequest(
        namespaces=["n", "n", "videos", "n"],
        objects=["doc", "doc", "/cats/1.mp4", "doc"],
        relations=["view", "view", "view", "view"],
        subject_ids=["alice", "carol", "", ""],
        subject_set_namespaces=["", "", "videos", "n"],
        subject_set_objects=["", "", "/cats", "sub"],
        subject_set_relations=["", "", "owner", "member"],
    )
    resp = ok(both(servers, "read", "check", "BatchCheck", cols), C.BatchCheckResponse)
    assert list(resp.allowed) == [True, False, True, True]
    cols.max_depth = 1
    both(servers, "read", "check", "BatchCheck", cols)
    ragged = C.BatchCheckRequest(namespaces=["n", "n"], objects=["doc"],
                                 relations=["view", "view"], subject_ids=["a", "b"])
    assert code(both(servers, "read", "check", "BatchCheck", ragged)) == (
        grpc.StatusCode.INVALID_ARGUMENT
    )
    empty_row = C.BatchCheckRequest(namespaces=["n"], objects=["doc"], relations=["view"])
    assert code(both(servers, "read", "check", "BatchCheck", empty_row)) == (
        grpc.StatusCode.INVALID_ARGUMENT
    )


def test_batch_check_encoded(servers):
    reset(servers)
    jax_server, torch_server, _ = servers
    caches = [VocabCache(f"http://127.0.0.1:{s.read_port}").bootstrap()
              for s in (jax_server, torch_server)]
    assert caches[0].epoch == caches[1].epoch
    rows = ["n:doc#view@alice", "n:doc#view@bob", "n:doc#edit@bob",
            "videos:/cats/1.mp4#view@cat lady", "n:doc#view@nobody"]

    def frames(extra=(), **kw):
        return [c.frame(rows + list(extra), **kw) for c in caches]

    body = ok(both(servers, "read", "check", "BatchCheckEncoded", None, requests=frames()))
    allowed, token = wirecodec.decode_check_response(body)
    assert allowed.tolist() == [True, True, False, True, False]
    both(servers, "read", "check", "BatchCheckEncoded", None,
         requests=frames(depths=[1] * len(rows)))
    stale = frames(["n:doc#view@erin"])
    write(servers, ["n:grp#member@erin"])  # interns a key: the epoch moves
    result = both(servers, "read", "check", "BatchCheckEncoded", None, requests=stale)
    assert code(result) == grpc.StatusCode.FAILED_PRECONDITION
    details = json.loads(dict(result[3])["keto-error-details"])
    assert details["reason"] == "vocab_epoch_mismatch"
    for c in caches:
        c.sync()
    body = ok(both(servers, "read", "check", "BatchCheckEncoded", None,
                   requests=frames(["n:doc#view@erin"])))
    assert wirecodec.decode_check_response(body)[0].tolist()[-1]
    assert code(both(servers, "read", "check", "BatchCheckEncoded", b"nonsense")) == (
        grpc.StatusCode.INVALID_ARGUMENT
    )


def test_expand(servers):
    reset(servers)
    root = acl_pb2.Subject(set=acl_pb2.SubjectSet(
        namespace="videos", object="/cats/1.mp4", relation="view"))
    tree = ok(both(servers, "read", "expand", "Expand", E.ExpandRequest(subject=root)),
              E.ExpandResponse).tree
    assert tree.node_type == E.NODE_TYPE_UNION and len(tree.children) == 2
    both(servers, "read", "expand", "Expand", E.ExpandRequest(subject=root, max_depth=1))
    n_root = acl_pb2.Subject(set=acl_pb2.SubjectSet(namespace="n", object="doc",
                                                    relation="view"))
    both(servers, "read", "expand", "Expand", E.ExpandRequest(subject=n_root))
    both(servers, "read", "expand", "Expand", E.ExpandRequest(
        subject=acl_pb2.Subject(set=acl_pb2.SubjectSet(
            namespace="n", object="nothing", relation="here"))))
    both(servers, "read", "expand", "Expand", E.ExpandRequest(
        subject=root, snaptoken="1"))
    assert code(both(servers, "read", "expand", "Expand", E.ExpandRequest())) == (
        grpc.StatusCode.INVALID_ARGUMENT
    )
    # paged through metadata: page 1, then the continuation
    result = both(servers, "read", "expand", "Expand", E.ExpandRequest(subject=n_root),
                  metadata=(("keto-expand-page-size", "1"),))
    token = dict(result[2]).get("keto-expand-next-page-token")
    assert token
    while token:
        result = both(servers, "read", "expand", "Expand",
                      E.ExpandRequest(subject=n_root),
                      metadata=(("keto-expand-page-size", "1"),
                                ("keto-expand-page-token", token)))
        token = dict(result[2]).get("keto-expand-next-page-token")
    assert code(both(servers, "read", "expand", "Expand", E.ExpandRequest(subject=n_root),
                     metadata=(("keto-expand-page-size", "x"),))) == (
        grpc.StatusCode.INVALID_ARGUMENT
    )


def test_list_relation_tuples(servers):
    reset(servers)

    def list_(**kw):
        return both(servers, "read", "read", "ListRelationTuples",
                    R.ListRelationTuplesRequest(**kw))

    query = R.ListRelationTuplesRequest.Query(namespace="n")
    resp = ok(list_(query=query, page_size=2), R.ListRelationTuplesResponse)
    assert len(resp.relation_tuples) == 2 and resp.next_page_token
    pages = 1
    while resp.next_page_token:
        resp = ok(list_(query=query, page_size=2, page_token=resp.next_page_token),
                  R.ListRelationTuplesResponse)
        pages += 1
    assert pages == 3
    list_(query=R.ListRelationTuplesRequest.Query(namespace="videos", object="/cats"))
    list_(query=R.ListRelationTuplesRequest.Query(
        namespace="n", subject=acl_pb2.Subject(id="alice")))
    from google.protobuf import field_mask_pb2

    list_(query=query, expand_mask=field_mask_pb2.FieldMask(paths=["object", "subject"]))
    assert code(list_(query=query, expand_mask=field_mask_pb2.FieldMask(
        paths=["colour"]))) == grpc.StatusCode.INVALID_ARGUMENT
    assert code(list_(query=query, page_token="garbage!")) == (
        grpc.StatusCode.INVALID_ARGUMENT
    )
    assert code(list_(query=query, snaptoken="bogus")) == grpc.StatusCode.INVALID_ARGUMENT
    list_(query=R.ListRelationTuplesRequest.Query(namespace="unknown"))


def test_list_objects_and_subjects(servers):
    reset(servers)

    def call(method, doc):
        raw = doc if isinstance(doc, bytes) else json.dumps(doc).encode()
        return both(servers, "read", "list", method, raw)

    objects = json.loads(ok(call("ListObjects", {
        "namespace": "videos", "relation": "view", "subject_id": "cat lady"})))
    assert objects["objects"] == ["/cats/1.mp4"]
    call("ListObjects", {"namespace": "n", "relation": "view", "subject_id": "bob",
                         "max_depth": 2})
    call("ListObjects", {"namespace": "n", "relation": "view",
                         "subject_set": {"namespace": "n", "object": "sub",
                                         "relation": "member"}})
    subjects = json.loads(ok(call("ListSubjects", {
        "namespace": "n", "object": "doc", "relation": "view", "page_size": 1})))
    assert subjects["subject_ids"] == ["alice"] and subjects["next_page_token"]
    call("ListSubjects", {"namespace": "n", "object": "doc", "relation": "view",
                          "page_size": 1, "page_token": subjects["next_page_token"]})
    call("ListSubjects", {"namespace": "n", "object": "doc", "relation": "view",
                          "snaptoken": "2"})
    for bad in (b"{not json", b"[1]", {"namespace": "n", "relation": "view"},
                {"namespace": "n", "object": "doc"},
                {"namespace": "n", "object": "doc", "relation": "view",
                 "page_token": "bogus"}):
        method = "ListObjects" if isinstance(bad, dict) and "object" not in bad else (
            "ListSubjects")
        assert code(call(method, bad)) == grpc.StatusCode.INVALID_ARGUMENT


def test_writes(servers):
    reset(servers)
    check = check_req("n:doc#view@dave")
    assert not ok(both(servers, "read", "check", "Check", check), C.CheckResponse).allowed
    ok(write(servers, ["n:grp#member@dave"], ["n:grp#member@alice"]))
    assert ok(both(servers, "read", "check", "Check", check), C.CheckResponse).allowed
    assert not ok(both(servers, "read", "check", "Check",
                       check_req("n:doc#view@alice")), C.CheckResponse).allowed
    both(servers, "write", "write", "DeleteRelationTuples",
         W.DeleteRelationTuplesRequest(query=W.DeleteRelationTuplesRequest.Query(
             namespace="n", object="grp")))
    assert not ok(both(servers, "read", "check", "Check", check), C.CheckResponse).allowed
    both(servers, "read", "read", "ListRelationTuples", R.ListRelationTuplesRequest(
        query=R.ListRelationTuplesRequest.Query(namespace="n")))
    unspecified = W.TransactRelationTuplesRequest(relation_tuple_deltas=[
        W.RelationTupleDelta(relation_tuple=rel_tuple("n:a#b@c"))])
    assert code(both(servers, "write", "write", "TransactRelationTuples",
                     unspecified)) == grpc.StatusCode.INVALID_ARGUMENT
    no_subject = W.TransactRelationTuplesRequest(relation_tuple_deltas=[
        W.RelationTupleDelta(action=W.RelationTupleDelta.INSERT,
                             relation_tuple=acl_pb2.RelationTuple(
                                 namespace="n", object="a", relation="b"))])
    assert code(both(servers, "write", "write", "TransactRelationTuples",
                     no_subject)) == grpc.StatusCode.INVALID_ARGUMENT
    assert code(write(servers, ["unknown:a#b@c"])) == grpc.StatusCode.NOT_FOUND
    both(servers, "write", "write", "DeleteRelationTuples",
         W.DeleteRelationTuplesRequest(query=W.DeleteRelationTuplesRequest.Query(
             namespace="unknown")))


def test_version_health_and_reflection(servers):
    jax_server, torch_server, channels = servers
    for plane in ("read", "write"):
        got = [
            V.GetVersionResponse.FromString(ok(invoke(
                channels, s, plane, "version", "GetVersion", V.GetVersionRequest())))
            for s in (jax_server, torch_server)
        ]
        assert all(g.version for g in got)  # masked: each package's release
        health = both(servers, plane, "health", "Check", health_pb2.HealthCheckRequest())
        assert ok(health, health_pb2.HealthCheckResponse).status == (
            health_pb2.HealthCheckResponse.SERVING
        )

    def reflect(server, plane, request):
        ch = channels[id(server), plane]
        call = ch.stream_stream(
            "/grpc.reflection.v1alpha.ServerReflection/ServerReflectionInfo",
            request_serializer=reflection_pb2.ServerReflectionRequest.SerializeToString,
            response_deserializer=reflection_pb2.ServerReflectionResponse.FromString,
        )
        return [r.SerializeToString() for r in call(iter([request]), timeout=60)]

    for plane in ("read", "write"):
        for request in (
            reflection_pb2.ServerReflectionRequest(list_services=""),
            reflection_pb2.ServerReflectionRequest(
                file_containing_symbol="ory.keto.acl.v1alpha1.CheckService"),
            reflection_pb2.ServerReflectionRequest(
                file_by_filename="ory/keto/acl/v1alpha1/acl.proto"),
            reflection_pb2.ServerReflectionRequest(file_by_filename="no/such.proto"),
        ):
            want, got = (reflect(s, plane, request) for s in (jax_server, torch_server))
            assert got == want, (plane, request)
    names = reflection_pb2.ServerReflectionResponse.FromString(reflect(
        torch_server, "read",
        reflection_pb2.ServerReflectionRequest(list_services=""))[0])
    assert {s.name for s in names.list_services_response.service} == {
        "ory.keto.acl.v1alpha1.CheckService", "ory.keto.acl.v1alpha1.ExpandService",
        "ory.keto.acl.v1alpha1.ReadService", "ory.keto.acl.v1alpha1.VersionService",
        "ory.keto.acl.v1alpha1.ListService", "grpc.health.v1.Health",
        "grpc.reflection.v1alpha.ServerReflection",
    }


def test_one_port_answers_both_protocols_and_rest_is_not_relayed(servers, monkeypatch):
    _, torch_server, channels = servers
    assert torch_server.registry.grpc_enabled
    seen = []
    original = daemon._Handler.do_GET

    def spy(handler):
        seen.append(handler.client_address)
        return original(handler)

    monkeypatch.setattr(daemon._Handler, "do_GET", spy)
    conn = http.client.HTTPConnection("127.0.0.1", torch_server.read_port, timeout=60)
    try:
        conn.request("GET", "/version")
        resp = conn.getresponse()
        assert resp.status == 200 and json.loads(resp.read())["version"]
        # the handler saw the socket this client opened, not a relay's
        assert seen == [conn.sock.getsockname()]
    finally:
        conn.close()
    stub = S.VersionServiceStub(channels[id(torch_server), "read"])
    assert stub.GetVersion(V.GetVersionRequest(), timeout=60).version
    # the direct gRPC port, loopback only, answers too
    direct = torch_server.registry.read_plane().grpc_port
    assert direct and direct != torch_server.read_port
    with grpc.insecure_channel(f"127.0.0.1:{direct}") as ch:
        assert S.VersionServiceStub(ch).GetVersion(V.GetVersionRequest(),
                                                   timeout=60).version
    # the write plane's public port speaks gRPC as well
    health = S.HealthStub(channels[id(torch_server), "write"]).Check(
        health_pb2.HealthCheckRequest(), timeout=60)
    assert health.status == health_pb2.HealthCheckResponse.SERVING
