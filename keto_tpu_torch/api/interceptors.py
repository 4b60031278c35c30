"""gRPC server interceptor: the error half of the reference's chain
(counterpart of ``keto_tpu/api/interceptors.py``).

The servicers already map their errors at the call site (``_abort`` in
``api/services.py``); this interceptor is the backstop that guarantees the
same mapping for any handler: an uncaught ``KetoError`` becomes its
canonical status code, and an uncaught ``TimeoutError`` becomes
DEADLINE_EXCEEDED, as the REST router maps it to a 504. Streaming handlers
(health Watch, reflection) pass through.

Not ported yet: the request log line, the ``keto_grpc_requests_total``
counter and duration histogram, and the tracing span (ROADMAP 14.5).
"""

from __future__ import annotations

import grpc

from ..utils.errors import DeadlineExceeded, KetoError


class ErrorInterceptor(grpc.ServerInterceptor):
    def intercept_service(self, continuation, handler_call_details):
        handler = continuation(handler_call_details)
        if handler is None or not handler.unary_unary:
            return handler
        inner = handler.unary_unary

        def wrapped(request, context):
            try:
                return inner(request, context)
            except TimeoutError:
                err = DeadlineExceeded()
                context.abort(getattr(grpc.StatusCode, err.grpc_code), err.message)
            except KetoError as e:
                context.abort(
                    getattr(grpc.StatusCode, e.grpc_code, grpc.StatusCode.INTERNAL),
                    e.message,
                )

        return grpc.unary_unary_rpc_method_handler(
            wrapped,
            request_deserializer=handler.request_deserializer,
            response_serializer=handler.response_serializer,
        )
