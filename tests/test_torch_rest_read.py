"""keto_tpu_torch's REST read plane vs keto_tpu's: Expand and the list
routes, on the CPU.

One JAX ``Registry`` (closure engine in device query mode) and one port
``Registry(config, device="cpu")`` boot on free ports (port 0) from the same
config, as in tests/test_torch_rest.py. Each request script goes to both
servers step by step and every response must agree: status code and JSON
body (trees, items, page tokens and snaptokens included). Covered: the
cat-videos Expand, paged Expand stitched back together, both list routes
unpaged and paged, 400 on missing parameters and garbage tokens, 409 on a
token from before a write, and the list routes left unregistered when
``serve.read.list`` is false or the engine has no reverse index.
"""

import urllib.parse

import pytest

from keto_tpu_torch.driver import Config as TConfig
from keto_tpu_torch.driver import Registry as TRegistry
from keto_tpu_torch.engine.tree import Tree, apply_expand_patches
from tests.test_torch_rest import (
    VALUES,
    JaxServer,
    TorchServer,
    cat_videos_tuples,
    clear,
    put,
    run_script,
    send,
)


@pytest.fixture(scope="module")
def servers():
    jax_server = JaxServer()
    torch_server = TorchServer()
    yield jax_server, torch_server
    torch_server.stop()
    jax_server.stop()


def expand(ns, obj, rel, **extra):
    return ("read", "GET", "/expand",
            {"namespace": ns, "object": obj, "relation": rel, **extra})


def list_objects(ns, rel, sid, **extra):
    return ("read", "GET", "/relation-tuples/list-objects",
            {"namespace": ns, "relation": rel, "subject_id": sid, **extra})


def list_subjects(ns, obj, rel, **extra):
    return ("read", "GET", "/relation-tuples/list-subjects",
            {"namespace": ns, "object": obj, "relation": rel, **extra})


GRAPH = [clear()] + [
    put("n", "doc", "view", ("n", "team", "member")),
    put("n", "doc", "view", ("n", "other", "member")),
    put("n", "doc", "view", "owner"),
    put("n", "team", "member", ("n", "sub", "member")),
    put("n", "team", "member", "carol"),
    put("n", "sub", "member", "alice"),
    put("n", "sub", "member", ("n", "team", "member")),  # a cycle
    put("n", "other", "member", "bob"),
    put("n", "other", "member", ("n", "sub", "member")),  # a diamond
    put("n", "doc2", "view", ("n", "sub", "member")),
] + [put("n", f"doc{i}", "view", "alice") for i in range(3, 9)]

SCRIPTS = {
    "expand": GRAPH + [
        expand("n", "doc", "view"),
        expand("n", "doc", "view", **{"max-depth": "2"}),
        expand("n", "sub", "member", **{"max-depth": "9"}),
        expand("n", "nothing", "here"),  # null, 200
        expand("nope", "doc", "view"),
        expand("n", "doc", "view", snaptoken="3"),
        expand("n", "doc", "view", snaptoken="bogus"),
        ("read", "GET", "/expand", {"namespace": "n", "relation": "view"}),
        expand("n", "doc", "view", **{"max-depth": "deep"}),
        expand("n", "doc", "view", page_size="two"),
        expand("n", "doc", "view", page_token="$$garbage$$"),
    ],
    "list": GRAPH + [
        list_objects("n", "view", "alice"),
        list_objects("n", "view", "bob"),
        list_objects("n", "member", "alice"),
        list_objects("n", "view", "alice", **{"max-depth": "2"}),
        list_objects("n", "view", "nobody"),
        ("read", "GET", "/relation-tuples/list-objects", {
            "namespace": "n", "relation": "view", "subject_set.namespace": "n",
            "subject_set.object": "sub", "subject_set.relation": "member"}),
        list_subjects("n", "doc", "view"),
        list_subjects("n", "doc2", "view", **{"max-depth": "3"}),
        list_subjects("n", "nothing", "here"),
        list_objects("n", "view", "alice", snaptoken="1", latest="true"),
        # missing parameters, malformed values: 400
        ("read", "GET", "/relation-tuples/list-objects",
         {"namespace": "n", "subject_id": "alice"}),
        ("read", "GET", "/relation-tuples/list-objects",
         {"namespace": "n", "relation": "view"}),
        ("read", "GET", "/relation-tuples/list-subjects",
         {"namespace": "n", "relation": "view"}),
        list_objects("n", "view", "alice", page_size="many"),
        list_objects("n", "view", "alice", page_token="%%%"),
        list_objects("n", "view", "alice", snaptoken="bogus"),
    ],
}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_script(servers, name):
    run_script(servers, SCRIPTS[name])


def test_cat_videos_expand(servers):
    got = run_script(servers, [clear()] + cat_videos_tuples() + [
        expand("videos", "/cats/1.mp4", "view"),
        expand("videos", "/cats/2.mp4", "view"),
        list_subjects("videos", "/cats/1.mp4", "view"),
        list_objects("videos", "view", "*"),
    ])
    status, tree = got[-4]
    assert status == 200 and tree["type"] == "union"
    subjects = [str(s) for s in Tree.from_dict(tree).flat_subjects()]
    assert "*" in subjects and "cat lady" in subjects
    assert "videos:/cats#owner" in subjects
    assert got[-2][1]["subject_ids"] == ["*", "cat lady"]
    assert got[-1][1]["objects"] == ["/cats/1.mp4"]


def test_paged_expand_stitches(servers):
    run_script(servers, GRAPH)
    _, unpaged = run_script(servers, [expand("n", "doc", "view")])[0]
    token, tree, pages = "", None, 0
    while True:
        params = {"page_size": "1"} if not token else {"page_size": "1",
                                                       "page_token": token}
        status, page = run_script(servers, [expand("n", "doc", "view", **params)])[0]
        assert status == 200
        if tree is None:
            tree = Tree.from_dict(page["tree"])
        else:
            # a page whose deferred sets were all visited meanwhile has none
            patches = page.get("patches", [])
            apply_expand_patches(tree, [(p["path"], p["tree"]) for p in patches])
        pages += 1
        token = page.get("next_page_token", "")
        if not token:
            break
    assert pages > 2 and tree.to_dict() == unpaged


def test_paged_lists_and_stale_tokens(servers):
    run_script(servers, GRAPH)
    for step in (list_objects("n", "view", "alice"), list_subjects("n", "doc", "view")):
        _, full = run_script(servers, [step])[0]
        key = "objects" if "objects" in full else "subject_ids"
        items, token = [], ""
        while True:
            params = dict(step[3], page_size="2")
            if token:
                params["page_token"] = token
            status, page = run_script(servers, [step[:3] + (params,)])[0]
            assert status == 200
            items += page[key]
            token = page["next_page_token"]
            if not token:
                break
        assert items == full[key] and len(items) > 2
    _, first = run_script(servers, [list_objects("n", "view", "alice", page_size="2")])[0]
    stale = first["next_page_token"]
    got = run_script(servers, [
        put("n", "doc9", "view", "alice"),
        list_objects("n", "view", "alice", page_size="2", page_token=stale),
    ])
    assert got[1][0] == 409 and got[1][1]["error"]["status"] == "Conflict"
    # the token names its query: another query's token is a 400
    _, fresh = run_script(servers, [list_objects("n", "view", "alice", page_size="2")])[0]
    status, doc = run_script(servers, [list_objects(
        "n", "view", "bob", page_size="2", page_token=fresh["next_page_token"])])[0]
    assert status == 400 and doc["error"]["status"] == "Bad Request"


def test_the_list_routes_go_through_the_reverse_index(servers):
    _, torch_server = servers
    run_script(servers, GRAPH + [list_objects("n", "view", "alice")])
    le = torch_server.registry.list_engine()
    assert le is not None and le.n_reverse > 0 and le.n_oracle == 0


@pytest.mark.parametrize(
    "engine",
    [{"engine": {"max_batch": 64}}, {"engine": {"mode": "scatter"}},
     {"engine": {"mode": "host"}}],
    ids=["list-off", "frontier-engine", "host-engine"],
)
def test_list_routes_absent_without_a_reverse_index(engine):
    values = {**VALUES, **engine}
    if "mode" not in engine["engine"]:
        values["serve"] = {**VALUES["serve"], "read": {**VALUES["serve"]["read"],
                                                       "list": False}}
    registry = TRegistry(TConfig(values=values), device="cpu")
    read_port, write_port = registry.start_all()

    class Server:
        pass

    server = Server()
    server.read_port, server.write_port = read_port, write_port
    try:
        assert registry.list_engine() is None
        send(server, "write", "PUT", "/relation-tuples", None, {
            "namespace": "n", "object": "o", "relation": "r", "subject_id": "u"})
        status, *_ = send(server, "read", "GET", "/relation-tuples/list-objects",
                          {"namespace": "n", "relation": "r", "subject_id": "u"})
        assert status == 404
        status, doc, *_ = send(server, "read", "GET", "/expand",
                               {"namespace": "n", "object": "o", "relation": "r"})
        assert status == 200 and doc["children"] == [
            {"type": "leaf", "subject_id": "u"}]
        query = urllib.parse.urlencode({"namespace": "n", "object": "o",
                                        "relation": "r", "subject_id": "u"})
        status, *_ = send(server, "read", "GET", "/check?" + query)
        assert status == 200
    finally:
        registry.stop_all()
