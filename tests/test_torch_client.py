"""keto_tpu_torch's client SDK against keto_tpu's, on the CPU.

- The surface of ``tests/test_client_sdk.py`` (and the list, columnar,
  encoded and hedged calls beside it): one script through ``RestClient``
  and one through ``GrpcClient``, each run by both packages' clients
  against both packages' servers (``JaxServer``, ``TorchServer`` of
  ``tests/test_torch_rest.py``). Every outcome (value or error class) must
  be equal across the four runs, ``metrics()`` included: both servers
  answer ``/metrics``.
- The status-to-KetoError map with the Retry-After hint, per package.
- The retry and hedging cases of ``tests/test_faults.py`` (the REST
  client's retries), ``tests/test_overload.py`` (budget, Retry-After floor,
  shed suppression) and ``tests/test_replicas.py`` (hedge masks a slow
  replica, fast primary, at most one hedge, wasted hedge): the pure cases
  for each package's module, and the REST cases for each package's
  ``RestClient`` against one scripted stub ``http.server`` (status codes,
  Retry-After, delays) under one injected ``sleep`` and ``rand``. The
  requests the stub saw, the sleeps, the outcome and the hedge counters
  must be equal between the packages.

Tolerances: exact.
"""

import importlib
import json
import socket
import sys
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace

import pytest

from tests.test_torch_rest import JaxServer, TorchServer

PKGS = ("jax", "torch")


def _pkg(name):
    root = "keto_tpu" if name == "jax" else "keto_tpu_torch"

    def m(mod):
        return importlib.import_module(f"{root}.{mod}")

    rt = m("relationtuple")
    return SimpleNamespace(
        name=name,
        client=m("client"),
        retry=m("client.retry"),
        hedge=m("client.hedge"),
        errors=m("utils.errors"),
        faults=m("faults"),
        Query=rt.RelationQuery,
        Tuple=rt.RelationTuple,
        Set=rt.SubjectSet,
    )


P = {name: _pkg(name) for name in PKGS}


@pytest.fixture(autouse=True, scope="module")
def _no_thread_outlives_the_module():
    """Every thread this module starts (servers, stubs, hedgers) has ended
    when it is done: a later test in the same worker may fork."""
    before = set(threading.enumerate())
    yield
    deadline = time.monotonic() + 20.0
    while True:
        extra = [t for t in threading.enumerate() if t not in before]
        if not extra:
            return
        if time.monotonic() > deadline:
            frames = sys._current_frames()
            stacks = {t.name: "".join(traceback.format_stack(frames[t.ident]))
                      for t in extra if t.ident in frames}
            raise AssertionError(f"threads outlived the module: {stacks}")
        time.sleep(0.05)


@pytest.fixture(scope="module")
def servers():
    jax_server = JaxServer()
    torch_server = TorchServer()
    yield {"jax": jax_server, "torch": torch_server}
    torch_server.stop()
    jax_server.stop()


def outcome(fn):
    """("ok", a comparable value) or ("err", the error's class name)."""
    try:
        value = fn()
    except Exception as e:  # noqa: BLE001 - the class is the outcome
        return ("err", type(e).__name__)
    return ("ok", _plain(value))


def _plain(v):
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if type(v).__name__ in ("RelationTuple", "Tree"):
        return str(v)
    if type(v).__name__ == "CheckResult":
        return (v.allowed, len(v.traceparent))
    if type(v).__name__ == "TuplePage":
        return ([str(t) for t in v.relation_tuples], v.next_page_token)
    if type(v).__name__ == "ListResult":
        return (v.items, v.next_page_token)
    if type(v).__name__ == "HedgedCall":
        return _plain(v.result)
    return v


# -- the live surface ------------------------------------------------------------------


def rest_script(p, server) -> dict:
    read = f"http://127.0.0.1:{server.read_port}"
    write = f"http://127.0.0.1:{server.write_port}"
    out = {}
    with p.client.RestClient(read, write) as rest:
        rest.delete_relation_tuples(p.Query())
        # test_client_sdk.py: the crud / check / expand flow
        out["create"] = outcome(lambda: rest.create_relation_tuple(
            "videos:/cats#owner@cat lady"))
        out["create_set"] = outcome(lambda: rest.create_relation_tuple(
            "videos:/cats/1.mp4#view@(videos:/cats#owner)"))
        out["check"] = outcome(lambda: rest.check("videos:/cats/1.mp4#view@cat lady"))
        out["check_no"] = outcome(lambda: rest.check("videos:/cats/1.mp4#view@dog guy"))
        out["check_latest"] = outcome(lambda: rest.check(
            "videos:/cats/1.mp4#view@cat lady", latest=True, max_depth=3))
        out["check_token"] = outcome(lambda: rest.check(
            "videos:/cats/1.mp4#view@cat lady", snaptoken="1"))
        out["check_crit"] = outcome(lambda: rest.check(
            "videos:/cats/1.mp4#view@cat lady", criticality="critical"))
        batch = ["videos:/cats/1.mp4#view@cat lady", "videos:/cats/1.mp4#view@dog guy"]
        out["batch"] = outcome(lambda: rest.batch_check(batch))
        out["expand"] = outcome(lambda: rest.expand(
            p.Set(namespace="videos", object="/cats/1.mp4", relation="view")))
        out["expand_none"] = outcome(lambda: rest.expand(
            p.Set(namespace="videos", object="/none", relation="view")))
        out["page"] = outcome(lambda: rest.get_relation_tuples(p.Query(namespace="videos")))
        out["list_objects"] = outcome(lambda: rest.list_objects("cat lady", "view", "videos"))
        out["list_subjects"] = outcome(lambda: rest.list_subjects(
            "videos", "/cats/1.mp4", "view"))
        with p.hedge.Hedger(p.hedge.HedgePolicy()) as h:
            out["hedged"] = outcome(lambda: rest.check_hedged(
                "videos:/cats/1.mp4#view@cat lady", h))
        cache = rest.vocab_cache()
        cache.bootstrap()
        out["encoded"] = outcome(lambda: rest.batch_check_encoded(cache, batch))
        # pagination
        for i in range(7):
            rest.create_relation_tuple(f"videos:v{i}#view@u{i}")
        out["iter"] = outcome(lambda: [str(t) for t in rest.iter_relation_tuples(
            p.Query(namespace="videos"), page_size=3)])
        out["list_paged"] = outcome(lambda: rest.list_subjects(
            "videos", "/cats/1.mp4", "view", page_size=1))
        # a write between encode and send: the 409 and the resync
        out["encoded_after_write"] = outcome(lambda: rest.batch_check_encoded(
            cache, ["videos:v0#view@u0", "videos:v9#view@u9"]))
        rest.delete_relation_tuples(p.Query(namespace="videos"))
        # the PATCH transaction
        t1 = p.Tuple.from_string("videos:a#r@u1")
        t2 = p.Tuple.from_string("videos:b#r@u2")
        out["patch"] = outcome(lambda: rest.patch_relation_tuples(insert=[t1, t2]))
        out["patch_delete"] = outcome(lambda: rest.patch_relation_tuples(
            insert=[], delete=[t1]))
        out["after_patch"] = outcome(lambda: rest.get_relation_tuples(
            p.Query(namespace="videos")))
        # the error taxonomy
        out["unknown_ns"] = outcome(lambda: rest.create_relation_tuple("nope:x#r@u"))
        out["garbage_token"] = outcome(lambda: rest.get_relation_tuples(
            p.Query(namespace="videos"), page_token="garbage!!"))
        out["malformed"] = outcome(lambda: rest.check("videos:x#r@u", snaptoken="zz"))
        # health and version
        out["health"] = outcome(lambda: (rest.alive(), rest.ready(), rest.version()))
        out["metrics"] = outcome(lambda: "keto_checks_total" in rest.metrics())
        rest.delete_relation_tuples(p.Query())
    return out


def grpc_script(p, server) -> dict:
    target = f"127.0.0.1:{server.read_port}"
    out = {}
    with p.client.RestClient(f"http://127.0.0.1:{server.read_port}",
                             f"http://127.0.0.1:{server.write_port}") as rest, \
            p.client.GrpcClient(target, f"127.0.0.1:{server.write_port}") as g:
        rest.delete_relation_tuples(p.Query())
        out["transact"] = outcome(lambda: bool(g.transact(insert=[
            "videos:/d#view@eve", "videos:/b#view@eve", "videos:/b#owner@(videos:/d#view)",
        ])))
        res = g.check("videos:/d#view@eve")
        out["check"] = (res.allowed, bool(res.snaptoken), len(res.traceparent))
        out["check_no"] = outcome(lambda: g.check("videos:/d#view@mallory"))
        out["check_crit"] = outcome(lambda: g.check("videos:/d#view@eve",
                                                    criticality="sheddable"))
        out["expand"] = outcome(lambda: g.expand(
            p.Set(namespace="videos", object="/d", relation="view")))
        out["expand_none"] = outcome(lambda: g.expand(
            p.Set(namespace="videos", object="/none", relation="view")))
        batch = ["videos:/b#view@eve", "videos:/b#view@nobody", "videos:/b#view@eve",
                 "videos:/b#owner@eve"]
        out["batch"] = outcome(lambda: g.batch_check(batch))
        out["batch_latest"] = outcome(lambda: g.batch_check(batch, latest=True))
        out["list_objects"] = outcome(lambda: g.list_objects("eve", "view", "videos"))
        out["list_subjects"] = outcome(lambda: g.list_subjects("videos", "/b", "owner"))
        with p.hedge.Hedger(p.hedge.HedgePolicy()) as h:
            out["hedged"] = outcome(lambda: g.check_hedged("videos:/b#owner@eve", h))
        cache = rest.vocab_cache()
        cache.bootstrap()
        out["encoded"] = outcome(lambda: g.batch_check_encoded(cache, batch))
        g.transact(insert=["videos:/e#view@zed"])
        out["encoded_after_write"] = outcome(lambda: g.batch_check_encoded(
            cache, ["videos:/e#view@zed", "videos:/b#view@eve"]))
        out["transact_delete"] = outcome(lambda: bool(g.transact(
            delete=["videos:/d#view@eve"])))
        out["check_after_delete"] = outcome(lambda: g.check("videos:/b#owner@eve"))
        out["unknown_ns"] = outcome(lambda: g.transact(insert=["nope:x#r@u"]))
        if p.name == "torch":  # the column form is the port's: the tuple form's answers
            assert g.batch_check_columns(batch) == g.batch_check(batch)
            assert rest.batch_check_columns(batch) == rest.batch_check(batch)
        rest.delete_relation_tuples(p.Query())
    return out


@pytest.mark.parametrize("script", [rest_script, grpc_script], ids=["rest", "grpc"])
def test_both_clients_answer_equal_against_both_servers(script, servers):
    got = {(c, s): script(P[c], servers[s]) for c in PKGS for s in PKGS}
    for s in PKGS:  # per server: the two packages' clients agree on everything
        assert got[("torch", s)] == got[("jax", s)], s
    # across servers: everything, the metrics route included
    assert got[("torch", "torch")] == got[("torch", "jax")]
    ref = got[("torch", "jax")]
    if script is rest_script:
        assert ref["check"] == ("ok", (True, 55)) and ref["check_no"] == ("ok", (False, 55))
        assert ref["batch"] == ("ok", [True, False]) == ref["encoded"]
        assert ref["unknown_ns"] == ("err", "ErrNotFound")
        assert ref["garbage_token"] == ("err", "ErrMalformedInput")
        assert len(ref["iter"][1]) == 9
        assert ref["metrics"] == ("ok", True)
        assert got[("torch", "torch")]["metrics"] == ("ok", True)
    else:
        assert ref["check"] == (True, True, 55)
        assert ref["batch"] == ("ok", [True, False, True, True])
        assert ref["encoded_after_write"] == ("ok", [True, True])
        assert ref["check_after_delete"] == ("ok", (False, 55))


# -- the status map ------------------------------------------------------------------------


@pytest.mark.parametrize("code", [400, 403, 404, 409, 429, 500, 502, 503])
def test_the_status_map_and_the_retry_after_hint(code):
    got = {}
    for name, p in P.items():
        body = {"error": {"code": code, "message": "m"}}
        plain = p.client._error_for(code, body)
        hinted = p.client._error_for(code, body, {"Retry-After": "2.5"})
        lower = p.client._error_for(code, {}, {"retry-after": "bad"})
        got[name] = (type(plain).__name__, plain.message, plain.status_code,
                     hinted.retry_after_s, getattr(lower, "retry_after_s", None))
    assert got["torch"] == got["jax"]
    assert got["torch"][3] == 2.5


# -- pure retry and hedging cases, per package ----------------------------------------------


@pytest.fixture(params=PKGS)
def p(request):
    return P[request.param]


class Counter:
    def __init__(self):
        self.value = 0

    def inc(self, v=1):
        self.value += v


def counters():
    return tuple(Counter() for _ in range(4))


def test_budget_burst_then_exhaustion(p):
    budget = p.retry.RetryBudget(ratio=0.1, burst=5.0)
    assert sum(1 for _ in range(20) if budget.spend()) == 5
    assert budget.exhausted == 15


def test_budget_deposits_cap_amplification(p):
    budget = p.retry.RetryBudget(ratio=0.1, burst=1.0)
    retries = 0
    for _ in range(1000):
        budget.on_request()
        retries += budget.spend()
    assert retries <= 1000 * 0.1 + 1
    capped = p.retry.RetryBudget(ratio=0.5, burst=2.0)
    for _ in range(100):
        capped.on_request()
    assert capped.tokens() == 2.0


def test_retry_after_hint_floors_backoff(p):
    sleeps = []
    policy = p.retry.RetryPolicy(max_attempts=3, base_delay_s=0.001, jitter=0.0,
                                 sleep=sleeps.append)
    err = p.errors.ErrResourceExhausted("shed")
    err.retry_after_s = 0.5
    calls = []

    def attempt(_remaining):
        calls.append(1)
        if len(calls) < 3:
            raise err
        return "ok"

    assert p.retry.retry_after_hint_s(err) == 0.5
    assert p.retry.run_with_retry(attempt, policy, lambda e: True) == "ok"
    assert sleeps == [0.5, 0.5]


def test_budget_exhaustion_stops_retrying(p):
    policy = p.retry.RetryPolicy(max_attempts=10, base_delay_s=0.0, jitter=0.0,
                                 sleep=lambda s: None)
    budget = p.retry.RetryBudget(ratio=0.0, burst=1.0)
    calls = []

    def attempt(_remaining):
        calls.append(1)
        raise p.errors.ErrResourceExhausted("still overloaded")

    with pytest.raises(p.errors.ErrResourceExhausted):
        p.retry.run_with_retry(attempt, policy, lambda e: True, budget=budget)
    assert len(calls) == 2


def test_a_deadline_is_not_slept_past(p):
    now = [0.0]
    sleeps = []
    policy = p.retry.RetryPolicy(max_attempts=10, base_delay_s=1.0, jitter=0.0,
                                 sleep=lambda s: (sleeps.append(s), now.__setitem__(
                                     0, now[0] + s)))
    remaining = []

    def attempt(rem):
        remaining.append(rem)
        raise p.errors.ErrUnavailable("down")

    with pytest.raises(p.errors.ErrUnavailable):
        p.retry.run_with_retry(attempt, policy, lambda e: True, timeout=3.5,
                               clock=lambda: now[0])
    assert sleeps == [1.0, 2.0] and remaining == [3.5, 2.5, 0.5]


def test_grpc_codes_are_read_duck_typed(p):
    class _Code:
        def __init__(self, name):
            self.name = name

    class _Rpc(Exception):
        def __init__(self, name):
            self._name = name

        def code(self):
            return _Code(self._name)

    assert p.retry.grpc_retryable(_Rpc("UNAVAILABLE"))
    assert p.retry.grpc_retryable(_Rpc("RESOURCE_EXHAUSTED"))
    assert not p.retry.grpc_retryable(_Rpc("INVALID_ARGUMENT"))
    assert p.retry.grpc_code_name(ValueError()) == ""


def test_is_overload_error_shapes(p):
    shed = p.errors.ErrResourceExhausted("x")
    assert shed.status_code == 429 and p.hedge.is_overload_error(shed)

    class _Typed(Exception):
        grpc_code = "RESOURCE_EXHAUSTED"

    class _Code:
        name = "RESOURCE_EXHAUSTED"

    class _Rpc(Exception):
        def code(self):
            return _Code()

    assert p.hedge.is_overload_error(_Typed()) and p.hedge.is_overload_error(_Rpc())
    assert not p.hedge.is_overload_error(None)
    assert not p.hedge.is_overload_error(ValueError("boom"))


def test_shed_primary_suppresses_hedge(p):
    fired, won, wasted, suppressed = c = counters()
    hedge_ran = threading.Event()
    with p.hedge.Hedger(p.hedge.HedgePolicy(delay_s=0.01), counters=c) as h:
        with pytest.raises(p.errors.ErrResourceExhausted):
            h.call(lambda: (_ for _ in ()).throw(p.errors.ErrResourceExhausted("shed")),
                   hedge=lambda: hedge_ran.set() or True)
    assert suppressed.value == 1 and fired.value == 0
    assert not hedge_ran.wait(0.05)


def test_hedge_masks_a_slow_replica(p):
    c = counters()
    p.faults.FAULTS.reset()
    p.faults.FAULTS.arm_slow("replica.slow", sleep_ms=400, times=1)

    def replica_check():
        p.faults.FAULTS.maybe_sleep("replica.slow")
        return True

    try:
        with p.hedge.Hedger(p.hedge.HedgePolicy(delay_s=0.05), counters=c) as h:
            out = h.call(replica_check)
    finally:
        p.faults.FAULTS.reset()
    assert out.result is True and out.hedged and out.hedge_won
    assert out.elapsed_s < 0.35
    assert [x.value for x in c] == [1, 1, 0, 0]


def test_a_fast_primary_never_hedges(p):
    c = counters()
    calls = []
    with p.hedge.Hedger(p.hedge.HedgePolicy(delay_s=0.2), counters=c) as h:
        out = h.call(lambda: calls.append("primary") or 7)
    assert (out.result, out.hedged, calls) == (7, False, ["primary"])
    assert [x.value for x in c] == [0, 0, 0, 0]


def test_at_most_one_hedge_and_a_wasted_one(p):
    c = counters()
    started = []
    release = threading.Event()
    try:
        with p.hedge.Hedger(p.hedge.HedgePolicy(delay_s=0.02), counters=c) as h:
            out = h.call(lambda: started.append("primary") or release.wait(5) and "stale",
                         hedge=lambda: started.append("hedge") or "fresh")
    finally:
        release.set()
    assert out.result == "fresh" and started == ["primary", "hedge"]
    assert [x.value for x in c] == [1, 1, 0, 0]
    c = counters()
    release = threading.Event()
    try:
        with p.hedge.Hedger(p.hedge.HedgePolicy(delay_s=0.02), counters=c) as h:
            out = h.call(lambda: time.sleep(0.08) or "primary",
                         hedge=lambda: release.wait(5) and "hedge")
    finally:
        release.set()
    assert out.result == "primary" and out.hedged and not out.hedge_won
    assert [x.value for x in c] == [1, 0, 1, 0]


def test_the_hedge_delay_estimate(p):
    pol = p.hedge.HedgePolicy(quantile=0.9, min_samples=5, max_delay_s=1.0,
                              min_delay_s=0.001)
    assert pol.current_delay_s() == 1.0  # cold
    for ms in range(1, 21):
        pol.observe(ms / 1000)
    assert pol.current_delay_s() == 0.019
    pol.advertise(5.0)
    assert pol.current_delay_s() == 1.0  # clamped
    pol.advertise(None)
    assert pol.current_delay_s() == 0.019


def test_the_endpoint_router(p):
    now = [0.0]
    r = p.hedge.EndpointRouter(["http://a/", "http://b", "http://c"], cool_off_s=1.0,
                               clock=lambda: now[0])
    r.observe_version("http://b", 7)
    assert r.pick(7)[0] == "http://b"
    r.observe_error("http://b")
    primary, hedge = r.pick(7)
    assert primary != "http://b" and hedge != primary
    now[0] += 1.0
    assert r.snapshot()["http://b"]["benched"] is False
    r.observe_leader({"write_url": "http://w/", "term": 3})
    assert r.leader()["write_url"] == "http://w"


# -- the REST client against one scripted stub ----------------------------------------------


DROP = "drop"  # a step that reads the request and closes without an answer
CLOSE = "close"  # a step that answers 200 and then closes the kept connection


class Stub:
    """A scripted HTTP/1.1 server: each request takes the next step
    ``(status, retry_after, delay_s)`` in arrival order and answers after
    ``delay_s`` (``DROP`` and ``CLOSE`` are the two status steps that end
    the connection; ``closed`` is set once a ``CLOSE`` has); it records
    (method, path, traceparent, x-keto-hedge)."""

    def __init__(self, steps):
        self.steps = list(steps)
        self.seen = []
        self.lock = threading.Lock()
        self.closed = threading.Event()
        stub = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            disable_nagle_algorithm = True
            timeout = 2.0  # an idle keep-alive connection's thread ends

            def _serve(self):
                length = int(self.headers.get("Content-Length") or 0)
                if length:
                    self.rfile.read(length)
                with stub.lock:
                    stub.seen.append((self.command, self.path.split("?")[0],
                                      self.headers.get("traceparent"),
                                      self.headers.get("x-keto-hedge")))
                    # a request past the script is seen, then dropped
                    status, retry_after, delay = (stub.steps.pop(0) if stub.steps
                                                  else (DROP, None, 0))
                time.sleep(delay)
                if status == DROP:
                    self.close_connection = True
                    return
                if status in (200, 403, CLOSE):
                    body = {"allowed": status != 403}
                elif status == 201:
                    body = {"namespace": "n", "object": "o", "relation": "r",
                            "subject_id": "u"}
                else:
                    body = {"error": {"code": status, "message": "busy"}}
                data = json.dumps(body).encode()
                self.send_response(200 if status == CLOSE else status)
                if retry_after is not None:
                    self.send_header("Retry-After", retry_after)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                if status == CLOSE:  # no Connection: close, as an idle timeout
                    self.wfile.flush()
                    self.connection.shutdown(socket.SHUT_RDWR)
                    self.close_connection = True
                    stub.closed.set()

            do_GET = do_PUT = do_POST = _serve

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        self.server.handle_error = lambda *args: None  # a client hung up
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        threading.Thread(target=self.server.serve_forever, daemon=True).start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def stub_run(p, steps, call, max_attempts=4, budget=None):
    """One scripted run: (outcome, requests seen, sleeps, budget refusals)."""
    stub = Stub(steps)
    sleeps = []
    kw = {} if budget is None else {"retry_budget": budget}
    client = p.client.RestClient(
        stub.url,
        retry=p.retry.RetryPolicy(max_attempts=max_attempts, sleep=sleeps.append,
                                  rand=lambda: 0.5),
        **kw,
    )
    try:
        result = outcome(lambda: call(client))
    finally:
        client.close()
        stub.close()
    seen = [(m, path, bool(tp), h) for m, path, tp, h in stub.seen]
    return result, seen, sleeps, getattr(budget, "exhausted", None)


CHECK = "n:o#r@u"
SCRIPTS = {
    # test_faults.py: 429 and 503 retried, the Retry-After floor honoured
    "shed_then_ok": ([(429, "1", 0), (503, "1", 0), (200, None, 0)],
                     lambda c: c.check(CHECK), {}),
    # test_faults.py: a client error is not retried
    "client_error": ([(400, None, 0)], lambda c: c.check(CHECK), {}),
    # the exponential schedule, jittered at rand 0.5, to max_attempts
    "unavailable": ([(503, None, 0)] * 4, lambda c: c.check(CHECK), {}),
    # a write is retried on a shed (the server did no work)
    "write_shed": ([(429, "0.25", 0), (201, None, 0)],
                   lambda c: c.create_relation_tuple(CHECK), {}),
    # a batch through the same discipline
    "batch_shed": ([(429, None, 0), (200, None, 0)],
                   lambda c: c._request("POST", f"{c.read_url}/check/batch").json(), {}),
    # test_overload.py: an exhausted budget stops the retries
    "budget": ([(429, None, 0)] * 10, lambda c: c.check(CHECK), {"max_attempts": 10}),
}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_rest_retries_follow_one_script(name):
    steps, call, kw = SCRIPTS[name]
    got = {}
    for pkg, p in P.items():
        if name == "budget":
            kw = dict(kw, budget=p.retry.RetryBudget(ratio=0.0, burst=1.0))
        got[pkg] = stub_run(p, steps, call, **kw)
    assert got["torch"] == got["jax"]
    result, seen, sleeps, refused = got["torch"]
    expect = {
        "shed_then_ok": (("ok", (True, 55)), 3, [1.0, 1.0]),
        "client_error": (("err", "ErrMalformedInput"), 1, []),
        "unavailable": (("err", "ErrUnavailable"), 4, [0.0375, 0.075, 0.15]),
        "write_shed": (("ok", "n:o#r@u"), 2, [0.25]),
        # a 429 without Retry-After floors on ErrResourceExhausted's 1 s
        "batch_shed": (("ok", {"allowed": True}), 2, [1.0]),
        "budget": (("err", "ErrResourceExhausted"), 2, [1.0]),
    }[name]
    assert (result, len(seen), [round(s, 12) for s in sleeps]) == expect
    if name == "budget":
        assert refused == 1


# name -> the stub's steps; each run checks once to open the kept connection,
# then makes the second call on it
KEPT = {
    # the server closed the idle connection: the write goes out once, on a
    # new one
    "stale_idle_write": [(CLOSE, None, 0), (201, None, 0)],
    # the server took the write and hung up without answering: it may have
    # applied it, so it is not sent again
    "dropped_write": [(200, None, 0), (DROP, None, 0)],
    # a read that lost its answer is retried, after the backoff
    "dropped_read": [(200, None, 0), (DROP, None, 0), (200, None, 0)],
}


@pytest.mark.parametrize("name", list(KEPT))
def test_rest_kept_connection_failures_follow_one_script(name):
    got = {}
    for pkg, p in P.items():
        stub = Stub(KEPT[name])
        sleeps = []
        client = p.client.RestClient(
            stub.url, retry=p.retry.RetryPolicy(max_attempts=4, sleep=sleeps.append,
                                                rand=lambda: 0.5))

        def call():
            client.check(CHECK)
            if name == "stale_idle_write":
                assert stub.closed.wait(5)
                return str(client.create_relation_tuple(CHECK))
            if name == "dropped_write":
                return str(client.create_relation_tuple(CHECK))
            return client.check(CHECK).allowed

        try:
            kind, value = outcome(call)
        finally:
            client.close()
            stub.close()
        # the transport error's class is each HTTP library's own
        got[pkg] = (kind, value if kind == "ok" else None,
                    [(m, path) for m, path, _, _ in stub.seen], sleeps)
    assert got["torch"] == got["jax"]
    check, put = ("GET", "/check"), ("PUT", "/relation-tuples")
    expect = {
        "stale_idle_write": (("ok", "n:o#r@u"), [check, put], []),
        "dropped_write": (("err", None), [check, put], []),
        "dropped_read": (("ok", True), [check, check, check], [0.0375]),
    }[name]
    result, seen, sleeps = expect
    assert (got["torch"][:2], got["torch"][2], [round(x, 12) for x in got["torch"][3]]) \
        == (result, seen, sleeps)


# name -> (the stub's steps, the hedge delay); the margins are wide so a
# loaded host cannot reorder the answers
HEDGES = {
    # test_replicas.py: the slow primary is masked, the duplicate wins
    "slow_primary": ([(200, None, 2.0), (200, None, 0)], 0.2),
    # the primary answers before the hedge delay: no duplicate
    "fast_primary": ([(200, None, 0)], 2.0),
    # the primary wins after the duplicate went out: a wasted hedge
    "primary_wins": ([(200, None, 0.6), (403, None, 1.0)], 0.1),
    # test_overload.py: a shed primary is never hedged
    "shed_primary": ([(429, "1", 0)], 0.1),
}


@pytest.mark.parametrize("name", list(HEDGES))
def test_rest_hedging_follows_one_script(name):
    got = {}
    for pkg, p in P.items():
        c = counters()

        steps, delay_s = HEDGES[name]

        def call(client):
            # the hedger's threads are ours, so the losing attempt has its
            # answer before the client closes the connection under it
            with ThreadPoolExecutor(max_workers=2) as pool:
                h = p.hedge.Hedger(p.hedge.HedgePolicy(delay_s=delay_s), counters=c,
                                   executor=pool)
                res = client.check_hedged(CHECK, h)
            return (res.hedged, res.hedge_won, res.result.allowed)

        result, seen, sleeps, _ = stub_run(p, steps, call, max_attempts=1)
        got[pkg] = (result, seen, sleeps, [x.value for x in c])
        if len(seen) == 2:  # one trace for both, the duplicate marked
            stub_tp = {tp for _, _, tp, _ in seen}
            assert stub_tp == {True} and [h for *_, h in seen] == [None, "1"]
    assert got["torch"] == got["jax"]
    expect = {
        "slow_primary": (("ok", [True, True, True]), [1, 1, 0, 0]),
        "fast_primary": (("ok", [False, False, True]), [0, 0, 0, 0]),
        "primary_wins": (("ok", [True, False, True]), [1, 0, 1, 0]),
        "shed_primary": (("err", "ErrResourceExhausted"), [0, 0, 0, 1]),
    }[name]
    assert (got["torch"][0], got["torch"][3]) == expect
