"""keto_tpu_torch's tracer against keto_tpu's, on the CPU.

For each package's ``telemetry/tracing.py``: nested spans build one tree
(parent ids, one trace id, the ambient ``current_traceparent``), a caller's
``traceparent`` is joined, an exception lands in the span's attributes, the
``log`` provider logs each span's fields, ``reconfigure`` builds, keeps and
drops the OTLP exporter as the provider and endpoint change,
``restart_after_fork`` rebuilds the exporter from its own settings, and a
dead collector never blocks a span (the cases of ``tests/test_observability.py``
``TestTracing`` and ``TestOtlpExport``). Then the same spans, with fixed ids
and times, through both packages' exporters: the OTLP JSON bodies of
``_encode`` must be equal, and so must the bodies a loopback collector
receives from each. The port's client stamps the active span's trace on a
check (``current_traceparent``). Tolerance: exact.
"""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

import keto_tpu.telemetry.tracing as jtracing
import keto_tpu_torch.telemetry.tracing as ttracing

PKGS = {"torch": ttracing, "jax": jtracing}


@pytest.fixture(params=sorted(PKGS))
def tr(request):
    return PKGS[request.param]


class Collector:
    """A loopback OTLP/HTTP collector: every POSTed (path, JSON body)."""

    def __init__(self):
        received = self.received = []
        self.got = threading.Event()
        got = self.got

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                received.append((self.path, json.loads(body)))
                got.set()
                self.send_response(200)
                self.end_headers()
                self.wfile.write(b"{}")

            def log_message(self, *a):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_port}"
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def test_nested_spans_build_one_tree(tr):
    tracer = tr.Tracer()
    assert tr.current_traceparent() is None
    with tracer.span("a", k=1) as a:
        with tracer.span("b") as b:
            with tracer.span("c") as c:
                assert tr.current_traceparent() == tr.format_traceparent(
                    c.trace_id, c.span_id)
        assert tr.current_traceparent() == a.traceparent()
    assert tr.current_traceparent() is None
    names = [s.name for s in tracer.finished()]
    assert names == ["c", "b", "a"]
    assert a.parent_id is None and b.parent_id == a.span_id and c.parent_id == b.span_id
    assert a.trace_id == b.trace_id == c.trace_id
    assert len({a.span_id, b.span_id, c.span_id}) == 3
    assert all(s.duration is not None and s.duration >= 0 for s in (a, b, c))
    assert [s.name for s in tracer.finished("b")] == ["b"]


def test_a_callers_traceparent_is_joined(tr):
    tracer = tr.Tracer()
    header = "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"
    remote = tr.parse_traceparent(header)
    with tracer.span("server", parent=remote) as root:
        with tracer.span("child") as child:
            pass
    assert root.trace_id == 0x0AF7651916CD43DD8448EB211C80319C
    assert root.parent_id == 0xB7AD6B7169203331
    assert child.trace_id == root.trace_id and child.parent_id == root.span_id
    for bad in ("", "00-00000000000000000000000000000000-b7ad6b7169203331-01",
                "00-zz-b7ad6b7169203331-01", "garbage"):
        assert tr.parse_traceparent(bad) is None


def test_an_exception_lands_in_the_span(tr):
    tracer = tr.Tracer()
    with pytest.raises(ValueError):
        with tracer.span("boom"):
            raise ValueError("no")
    (span,) = tracer.finished("boom")
    assert span.attrs["error"] == "ValueError('no')"
    assert tr.current_traceparent() is None


def _logged_fields(tr):
    logged = []

    class Log:
        def debug(self, msg, **fields):
            logged.append((msg, fields))

    tracer = tr.Tracer(provider="log", logger=Log())
    with tracer.span("outer", edges=3) as outer:
        with tracer.span("inner"):
            pass
    out = []
    for msg, f in logged:
        assert f["trace"] == outer.trace_id and f["ms"] >= 0
        out.append((msg, f["span"], f["parent"] == 0, sorted(k for k in f if k not in (
            "trace", "parent", "ms"))))
    return out


def test_the_log_provider_logs_each_span_alike():
    assert _logged_fields(ttracing) == _logged_fields(jtracing) == [
        ("span", "inner", False, ["span"]),
        ("span", "outer", True, ["edges", "span"]),
    ]


def test_reconfigure_builds_keeps_and_drops_the_exporter(tr):
    col = Collector()
    tracer = tr.Tracer()
    try:
        assert tracer._otlp is None
        tracer.reconfigure("otlp", otlp_endpoint=col.url, flush_interval_s=0.05)
        first = tracer._otlp
        assert first is not None and first.url == col.url + "/v1/traces"
        assert first._thread.name == "otlp-exporter" and first._thread.is_alive()
        tracer.reconfigure("otlp", otlp_endpoint=col.url + "/")
        assert tracer._otlp is first  # the same collector: kept
        tracer.reconfigure("log")
        assert tracer.provider == "log" and tracer._otlp is None
        assert not first._thread.is_alive()
        tracer.reconfigure("otlp", otlp_endpoint=col.url, service_name="other")
        assert tracer._otlp is not None and tracer._otlp.service_name == "other"
        with tracer.span("after"):
            pass
        tracer.flush(10)
        assert col.got.wait(10)
        assert col.received[-1][0] == "/v1/traces"
    finally:
        tracer.close()
        col.close()


def test_restart_after_fork_rebuilds_the_exporter(tr):
    col = Collector()
    tracer = tr.Tracer(provider="otlp", otlp_endpoint=col.url, service_name="svc",
                       flush_interval_s=0.05)
    old = tracer._otlp
    try:
        tracer.restart_after_fork()
        new = tracer._otlp
        assert new is not old and new._thread.is_alive()
        assert (new.endpoint, new.service_name, new.interval_s) == (
            old.endpoint, old.service_name, old.interval_s)
        with tracer.span("in-the-child"):
            pass
        tracer.flush(10)
        assert col.got.wait(10)
        names = [s["name"] for _, doc in col.received for rs in doc["resourceSpans"]
                 for ss in rs["scopeSpans"] for s in ss["spans"]]
        assert "in-the-child" in names
    finally:
        old.close()
        tracer.close()
        col.close()
    plain = tr.Tracer()
    plain.restart_after_fork()  # no exporter: nothing to rebuild
    assert plain._otlp is None


def test_a_dead_collector_never_blocks_spans(tr):
    tracer = tr.Tracer(provider="otlp", otlp_endpoint="http://127.0.0.1:1",
                       flush_interval_s=0.05)
    try:
        for _ in range(50):
            with tracer.span("work"):
                pass
        tracer.flush(10)
        assert len(tracer.finished("work")) == 50
    finally:
        tracer.close()


def _fixed_spans(tr, tracer):
    """Three spans of one trace, then their ids, times and attributes fixed."""
    with tracer.span("check.request", transport="rest", batch_size=1):
        with tracer.span("batcher.dispatch", batch_size=4):
            pass
    with pytest.raises(KeyError):
        with tracer.span("closure.build", edges=10):
            raise KeyError("x")
    spans = tracer.finished()
    fixed = [
        (0x11, 0x0A, 0x0B, 1700000000.25, 0.0015),
        (0x11, 0x0B, None, 1700000000.0, 0.5),
        (0x22, 0x0C, None, 1700000001.0, 0.125),
    ]
    for s, (trace, span, parent, start, dur) in zip(spans, fixed):
        s.trace_id, s.span_id, s.parent_id, s.start, s.duration = (
            trace, span, parent, start, dur)
    return spans


def test_the_otlp_body_equals_the_references():
    col = Collector()
    bodies = {}
    try:
        for name, tr in PKGS.items():
            tracer = tr.Tracer(provider="otlp", otlp_endpoint=col.url,
                               service_name="keto-tpu", flush_interval_s=60)
            try:
                spans = _fixed_spans(tr, tracer)
                tracer._otlp.instance_id = "host-1"
                bodies[name] = json.dumps(tracer._otlp._encode(spans))
            finally:
                tracer.close()
    finally:
        col.close()
    assert bodies["torch"] == bodies["jax"]
    doc = json.loads(bodies["torch"])
    spans = doc["resourceSpans"][0]["scopeSpans"][0]["spans"]
    assert [s["name"] for s in spans] == ["batcher.dispatch", "check.request",
                                          "closure.build"]
    assert spans[0]["parentSpanId"] == "000000000000000b"
    assert "parentSpanId" not in spans[1]
    assert [s["status"]["code"] for s in spans] == [1, 1, 2]


def test_both_exporters_post_equal_bodies_to_a_loopback_collector():
    col = Collector()
    try:
        for tr in (ttracing, jtracing):
            tracer = tr.Tracer(provider="otlp", otlp_endpoint=col.url,
                               service_name="keto-tpu", flush_interval_s=0.05)
            try:
                tracer._otlp.instance_id = "host-1"
                spans = _fixed_spans(tr, tracer)
                # the live spans were queued already; ship the fixed copies
                tracer.flush(10)
                n = len(col.received)
                for s in spans:
                    tracer._otlp.enqueue(s)
                tracer.flush(10)
                assert len(col.received) == n + 1
            finally:
                tracer.close()
    finally:
        col.close()
    (tpath, tdoc), (jpath, jdoc) = col.received[1], col.received[3]
    assert tpath == jpath == "/v1/traces"
    assert tdoc == jdoc


def test_the_client_stamps_the_active_spans_trace():
    from keto_tpu_torch.client import _trace_headers

    tracer = ttracing.Tracer()
    with tracer.span("caller") as span:
        tp, headers = _trace_headers(None, False)
    assert tp == span.traceparent() == headers[ttracing.TRACEPARENT_HEADER]
    tp2, headers2 = _trace_headers(None, True)  # outside a span: a fresh root
    remote = ttracing.parse_traceparent(tp2)
    assert remote is not None and remote.trace_id != span.trace_id
    assert headers2[ttracing.HEDGE_HEADER] == "1"
