"""gRPC server interceptor: request logging, metrics, the tracing span and
error parity (counterpart of ``keto_tpu/api/interceptors.py``).

- every finished unary RPC logs one ``grpc`` line (plane, method, code, ms)
  at info and counts ``keto_grpc_requests_total{plane,method,code}`` with a
  ``keto_grpc_request_duration_seconds{plane}`` observation;
- a ``grpc.request`` span wraps the handler and parents the spans the call
  produces; a ``traceparent`` in the invocation metadata makes it join the
  caller's trace;
- the error backstop: the servicers map their errors at the call site
  (``_abort`` in ``api/services.py``), and an uncaught ``KetoError``
  becomes its canonical status code here, an uncaught ``TimeoutError``
  DEADLINE_EXCEEDED, as the REST router maps it to a 504.

Streaming handlers (health Watch, reflection) pass through un-instrumented:
their lifetime is the stream, not a request.
"""

from __future__ import annotations

import time

import grpc

from ..telemetry.tracing import TRACEPARENT_HEADER, parse_traceparent
from ..utils.errors import DeadlineExceeded, KetoError


class TelemetryInterceptor(grpc.ServerInterceptor):
    def __init__(self, plane: str, logger=None, metrics=None, tracer=None):
        self.plane = plane
        self.logger = logger
        self.tracer = tracer
        self._requests = self._duration = None
        if metrics is not None:
            self._requests = metrics.counter(
                "keto_grpc_requests_total",
                "gRPC requests by plane/method/code",
                labelnames=("plane", "method", "code"),
            )
            self._duration = metrics.histogram(
                "keto_grpc_request_duration_seconds",
                "gRPC request duration",
                labelnames=("plane",),
            )

    def _observe(self, method: str, code: str, elapsed: float) -> None:
        if self._requests is not None:
            self._requests.labels(plane=self.plane, method=method, code=code).inc()
            self._duration.labels(plane=self.plane).observe(elapsed)
        if self.logger is not None:
            self.logger.info(
                "grpc", plane=self.plane, method=method, code=code,
                ms=round(1000 * elapsed, 2),
            )

    def intercept_service(self, continuation, handler_call_details):
        handler = continuation(handler_call_details)
        if handler is None or not handler.unary_unary:
            return handler
        method = handler_call_details.method
        inner = handler.unary_unary
        remote = None
        for key, value in handler_call_details.invocation_metadata or ():
            if key == TRACEPARENT_HEADER:
                remote = parse_traceparent(value)
                break

        def wrapped(request, context):
            t0 = time.perf_counter()
            code = "OK"
            span = (
                self.tracer.span("grpc.request", method=method, parent=remote)
                if self.tracer is not None
                else None
            )
            try:
                if span is not None:
                    with span:
                        return inner(request, context)
                return inner(request, context)
            except TimeoutError:
                err = DeadlineExceeded()
                code = err.grpc_code
                context.abort(getattr(grpc.StatusCode, err.grpc_code), err.message)
            except KetoError as e:
                code = e.grpc_code
                context.abort(
                    getattr(grpc.StatusCode, e.grpc_code, grpc.StatusCode.INTERNAL),
                    e.message,
                )
            except Exception:
                # context.abort raises to unwind the stack: the servicers'
                # own aborts land here; report the code they set
                code = "INTERNAL"
                try:
                    set_code = context.code()
                    if set_code is not None:
                        code = set_code.name
                except Exception:
                    pass
                raise
            finally:
                self._observe(method, code, time.perf_counter() - t0)

        return grpc.unary_unary_rpc_method_handler(
            wrapped,
            request_deserializer=handler.request_deserializer,
            response_serializer=handler.response_serializer,
        )
