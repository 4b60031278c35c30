"""Tracing: lightweight spans over engine phases and requests (counterpart of
``keto_tpu/telemetry/tracing.py``).

Spans export three ways:

- to the structured log (``tracing.provider: log``) — one line per span
  with name, duration, parentage, and attributes;
- over the wire (``tracing.provider: otlp`` + ``tracing.otlp.endpoint``)
  — OTLP/HTTP JSON batches POSTed to ``<endpoint>/v1/traces`` from a
  background flusher thread named ``otlp-exporter`` (stdlib urllib), the
  encoding every OpenTelemetry collector and Jaeger ingests; the body is
  the reference's, key for key (the instrumentation scope keeps the name
  ``keto_tpu``), so one collector pipeline reads both packages;
- always to a bounded in-process ring buffer, which tests and
  ``/debug/traces`` read back.

Span context propagates through a contextvar, so nested ``with
tracer.span(...)`` calls build real parent/child trees across the serving
stack (REST handler -> batcher -> engine -> closure build) without any
explicit plumbing. The client SDK stamps ``current_traceparent()`` (the
active span's id, or a fresh trace outside any span) on every request.

A span that times device work closes after the card has finished it: the
closure build waits on a CUDA event recorded after its last launch before
it closes ``closure.semiring`` (``engine/closure.py``). The check path
never synchronises for a span.

Spans time themselves on ``time.perf_counter``, the monotonic clock of the
attribution ledger and of the device trace; their wall start (OTLP,
``/debug/traces``, cross-node stitching) comes from one anchor pair of
wall and monotonic readings taken when this module loads. While a
``torch.profiler`` records in the process, each span also opens a
``record_function`` range of its own name (:func:`profiler_range`), so the
program's spans sit in the Chrome trace beside the kernels, on the thread
that ran them. With no profiler recording, no range opens and nothing is
imported.
"""

from __future__ import annotations

import contextvars
import os as _os
import sys
import threading
import time
from collections import deque
from typing import Any, Optional

_current_span: contextvars.ContextVar[Optional["Span"]] = (
    contextvars.ContextVar("keto_tpu_torch_span", default=None)
)

# W3C Trace Context (https://www.w3.org/TR/trace-context/) wire names.
# TRACEPARENT_HEADER doubles as the gRPC metadata key (metadata keys are
# lowercase by spec, and the header name already is).
TRACEPARENT_HEADER = "traceparent"
# marks the duplicate request a Hedger fires so server-side spans/flight
# records can distinguish it from the primary carrying the same trace id
HEDGE_HEADER = "x-keto-hedge"


class SpanContext:
    """Remote span identity parsed off a ``traceparent`` header — just
    enough (trace id + parent span id) for a server-side span to join a
    trace minted in another process."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: int, span_id: int):
        self.trace_id = trace_id
        self.span_id = span_id


def format_traceparent(trace_id: int, span_id: int) -> str:
    """``00-<32 hex trace>-<16 hex span>-01`` (version 00, sampled)."""
    return f"00-{trace_id:032x}-{span_id:016x}-01"


def parse_traceparent(value) -> Optional[SpanContext]:
    """Parse a W3C traceparent header; None on anything malformed.
    Per spec, all-zero trace or span ids are invalid and ignored."""
    if not value:
        return None
    parts = str(value).strip().split("-")
    if len(parts) < 4 or len(parts[1]) != 32 or len(parts[2]) != 16:
        return None
    try:
        trace_id = int(parts[1], 16)
        span_id = int(parts[2], 16)
    except ValueError:
        return None
    if trace_id == 0 or span_id == 0:
        return None
    return SpanContext(trace_id, span_id)


def mint_traceparent() -> str:
    """A fresh client-side traceparent: new root trace, new span id.
    Clients stamp this on the outbound request (REST header / gRPC
    metadata) so server-side spans, flight records, and exemplars all
    carry an id the caller knows."""
    return format_traceparent(_new_trace_id(), _new_span_id())


def current_traceparent() -> Optional[str]:
    """traceparent for the active span, or None outside any span."""
    span = _current_span.get()
    if span is None:
        return None
    return format_traceparent(span.trace_id, span.span_id)


def _new_trace_id() -> int:
    """Random 128-bit trace id (W3C/OTLP convention). Sequential
    per-process counters collide across processes — spawn workers and
    forked replicas sharing one collector would merge unrelated spans
    into the same traces."""
    return int.from_bytes(_os.urandom(16), "big") or 1


def _new_span_id() -> int:
    return int.from_bytes(_os.urandom(8), "big") or 1


# the per-process anchor: a span's wall start is _WALL0 plus its
# perf_counter start's distance from _PERF0
_WALL0 = time.time()
_PERF0 = time.perf_counter()


def profiler_range(name: str):
    """An entered ``record_function`` range named ``name`` while a torch
    profiler records in this process, else None; the caller exits it.
    The profiler's flag is read off ``sys.modules``: a process that never
    loaded the profiler is not recording, and nothing gets imported."""
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is None or not getattr(prof, "_is_profiler_enabled", False):
        return None
    rf = prof.record_function(name)
    rf.__enter__()
    return rf


def _warn_missing_endpoint() -> None:
    import logging

    logging.getLogger("keto_tpu_torch.telemetry").warning(
        "tracing.provider is 'otlp' but tracing.otlp.endpoint is unset: "
        "spans stay in-process only (set the endpoint to export)"
    )


class Span:
    __slots__ = (
        "name", "trace_id", "span_id", "parent_id", "start", "duration",
        "attrs", "_tracer", "_token", "_t0", "_range",
    )

    def __init__(
        self,
        tracer: "Tracer",
        name: str,
        attrs: dict[str, Any],
        parent: Optional[SpanContext] = None,
    ):
        self.name = name
        self.attrs = attrs
        if parent is None:
            parent = _current_span.get()
        self.parent_id = parent.span_id if parent else None
        self.trace_id = parent.trace_id if parent else _new_trace_id()
        self.span_id = _new_span_id()
        self._t0 = time.perf_counter()
        self.start = _WALL0 + (self._t0 - _PERF0)
        self.duration = None
        self._tracer = tracer
        self._token = None
        self._range = None

    def set_attr(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def traceparent(self) -> str:
        return format_traceparent(self.trace_id, self.span_id)

    def __enter__(self) -> "Span":
        self._token = _current_span.set(self)
        self._range = profiler_range(self.name)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.duration = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        if exc_type is not None:
            self.attrs["error"] = repr(exc)
        _current_span.reset(self._token)
        self._tracer._finish(self)


class Tracer:
    """Factory + exporter for spans. ``provider``: "log" mirrors every
    finished span into the structured log; "otlp" also ships batches to
    ``otlp_endpoint``; anything else keeps spans only in the ring
    buffer."""

    def __init__(
        self,
        provider: str = "",
        logger=None,
        buffer_size: int = 2048,
        otlp_endpoint: str = "",
        service_name: str = "keto-tpu",
        flush_interval_s: float = 2.0,
    ):
        self.provider = provider
        self._logger = logger
        self._lock = threading.Lock()
        self._finished: deque[Span] = deque(maxlen=buffer_size)
        self._otlp = None
        if provider == "otlp" and otlp_endpoint:
            self._otlp = _OtlpExporter(
                otlp_endpoint, service_name, flush_interval_s
            )
        elif provider == "otlp":
            _warn_missing_endpoint()

    def span(
        self, name: str, parent: Optional[SpanContext] = None, **attrs
    ) -> Span:
        """New span. ``parent`` (a SpanContext off a remote traceparent)
        overrides the ambient contextvar parent — the cross-process join
        point: the server's root span adopts the caller's trace id."""
        return Span(self, name, attrs, parent=parent)

    def _finish(self, span: Span) -> None:
        with self._lock:
            self._finished.append(span)
        if self.provider == "log" and self._logger is not None:
            self._logger.debug(
                "span",
                span=span.name,
                trace=span.trace_id,
                parent=span.parent_id or 0,
                ms=round(1000 * span.duration, 3),
                **span.attrs,
            )
        if self._otlp is not None:
            self._otlp.enqueue(span)

    def finished(self, name: Optional[str] = None) -> list[Span]:
        with self._lock:
            spans = list(self._finished)
        if name is not None:
            spans = [s for s in spans if s.name == name]
        return spans

    def flush(self, timeout_s: float = 5.0) -> None:
        """Push any queued OTLP batch now (shutdown/test sync)."""
        if self._otlp is not None:
            self._otlp.flush(timeout_s)

    def close(self) -> None:
        if self._otlp is not None:
            self._otlp.close()
            self._otlp = None

    def restart_after_fork(self) -> None:
        """Forked replicas inherit this tracer but not the exporter's
        flusher thread; rebuild the exporter from its own recorded
        configuration so replica-served spans still reach the collector."""
        old = self._otlp
        if old is not None:
            self._otlp = _OtlpExporter(
                old.endpoint, old.service_name, old.interval_s
            )

    def reconfigure(
        self,
        provider: str,
        otlp_endpoint: str = "",
        service_name: str = "keto-tpu",
        flush_interval_s: float = 2.0,
    ) -> None:
        """Apply a config hot-reload: swap the provider AND rebuild the
        wire exporter to match (assigning ``provider`` alone would leave
        an old exporter shipping, or a new one never created)."""
        old = self._otlp
        self.provider = provider
        if provider == "otlp" and otlp_endpoint:
            if (
                old is None
                or old.url != otlp_endpoint.rstrip("/") + "/v1/traces"
                or old.service_name != service_name
            ):
                self._otlp = _OtlpExporter(
                    otlp_endpoint, service_name, flush_interval_s
                )
                if old is not None:
                    old.close()
        else:
            if provider == "otlp":
                _warn_missing_endpoint()
            self._otlp = None
            if old is not None:
                old.close()


class _OtlpExporter:
    """Background OTLP/HTTP JSON trace exporter (stdlib only).

    Spans queue in a bounded deque; a flusher thread POSTs batches to
    ``<endpoint>/v1/traces`` in the OTLP JSON encoding (hex trace/span
    ids, unix-nano timestamps, stringified attributes). Export failures
    drop the batch after logging once per streak — tracing must never
    wedge the serving path."""

    MAX_QUEUE = 8192
    MAX_BATCH = 512

    def __init__(self, endpoint: str, service_name: str, interval_s: float):
        self.endpoint = endpoint
        self.url = endpoint.rstrip("/") + "/v1/traces"
        self.service_name = service_name
        # unique per process so a collector can tell the daemon apart
        # from its forked replicas (restart_after_fork rebuilds the
        # exporter, so a replica picks up its own pid here)
        import socket as _socket

        self.instance_id = f"{_socket.gethostname()}-{_os.getpid()}"
        self.interval_s = interval_s
        self._q: deque[Span] = deque(maxlen=self.MAX_QUEUE)
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self._warned = False
        self._thread = threading.Thread(
            target=self._run, name="otlp-exporter", daemon=True
        )
        self._thread.start()

    def enqueue(self, span: Span) -> None:
        self._q.append(span)
        self._idle.clear()

    def flush(self, timeout_s: float) -> None:
        self._wake.set()
        self._idle.wait(timeout_s)

    def close(self) -> None:
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=5)

    def _run(self) -> None:
        while True:
            self._wake.wait(timeout=self.interval_s)
            self._wake.clear()
            while self._q:
                batch = []
                while self._q and len(batch) < self.MAX_BATCH:
                    batch.append(self._q.popleft())
                self._post(batch)
            self._idle.set()
            if self._q:
                # an enqueue raced the drain/_idle.set window: a flush()
                # waiter must not observe idle with work pending
                self._idle.clear()
                continue
            if self._stop.is_set():
                return

    def _post(self, batch: list[Span]) -> None:
        import json
        import urllib.error
        import urllib.request

        body = json.dumps(self._encode(batch)).encode()
        req = urllib.request.Request(
            self.url,
            data=body,
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=5) as resp:
                resp.read()
            self._warned = False
        except Exception:
            # ANY export failure (refused, timeout, malformed collector
            # response raising HTTPException, ...) drops the batch — an
            # exception escaping here would kill the exporter thread and
            # wedge every future flush()
            if not self._warned:
                self._warned = True
                import logging

                logging.getLogger("keto_tpu_torch.telemetry").warning(
                    "OTLP trace export to %s failing; dropping batches "
                    "until it recovers",
                    self.url,
                )

    def _encode(self, batch: list[Span]) -> dict:
        def attr(k, v):
            return {"key": str(k), "value": {"stringValue": str(v)}}

        return {
            "resourceSpans": [
                {
                    "resource": {
                        "attributes": [
                            attr("service.name", self.service_name),
                            attr("service.instance.id", self.instance_id),
                        ]
                    },
                    "scopeSpans": [
                        {
                            "scope": {"name": "keto_tpu"},
                            "spans": [
                                {
                                    "traceId": f"{s.trace_id:032x}",
                                    "spanId": f"{s.span_id:016x}",
                                    **(
                                        {
                                            "parentSpanId":
                                                f"{s.parent_id:016x}"
                                        }
                                        if s.parent_id
                                        else {}
                                    ),
                                    "name": s.name,
                                    "kind": 1,  # SPAN_KIND_INTERNAL
                                    "startTimeUnixNano": str(
                                        int(s.start * 1e9)
                                    ),
                                    "endTimeUnixNano": str(
                                        int(
                                            (s.start + (s.duration or 0))
                                            * 1e9
                                        )
                                    ),
                                    "attributes": [
                                        attr(k, v)
                                        for k, v in s.attrs.items()
                                    ],
                                    # STATUS_CODE_ERROR when the span
                                    # exited via an exception, else OK —
                                    # collectors use this for error-rate
                                    # rollups and trace coloring
                                    "status": {
                                        "code": (
                                            2
                                            if "error" in s.attrs
                                            else 1
                                        )
                                    },
                                }
                                for s in batch
                            ],
                        }
                    ],
                }
            ]
        }


NOOP_TRACER = Tracer()
