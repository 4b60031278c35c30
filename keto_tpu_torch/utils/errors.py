"""Herodot-style rich errors (counterpart of ``keto_tpu/utils/errors.py``).

Only the errors the closure Check path and its stores raise are kept. Each
carries its HTTP status and gRPC code, so a later serving plane can map
them to the wire unchanged.
"""

from __future__ import annotations


class KetoError(Exception):
    """Base domain error with HTTP + gRPC mapping."""

    status_code = 500
    status = "Internal Server Error"
    grpc_code = "INTERNAL"

    def __init__(self, message: str | None = None):
        self.message = message or self.default_message()
        super().__init__(self.message)

    def default_message(self) -> str:
        return self.status


class ErrNotFound(KetoError):
    status_code = 404
    status = "Not Found"
    grpc_code = "NOT_FOUND"


class ErrNamespaceNotFound(ErrNotFound):
    def __init__(self, namespace: str = ""):
        self.namespace = namespace
        super().__init__(
            f"Unknown namespace {namespace!r}. Please add it to the configuration first."
            if namespace
            else None
        )


class ErrMalformedInput(KetoError):
    status_code = 400
    status = "Bad Request"
    grpc_code = "INVALID_ARGUMENT"

    def default_message(self) -> str:
        return "The provided input was malformed."


class ErrMalformedPageToken(ErrMalformedInput):
    def default_message(self) -> str:
        return "The provided page token is malformed."


class ErrInvalidTuple(ErrMalformedInput):
    def default_message(self) -> str:
        return "The provided relation tuple is invalid."


class ErrUnavailable(KetoError):
    """A freshness/availability condition, not a server bug."""

    status_code = 503
    status = "Service Unavailable"
    grpc_code = "UNAVAILABLE"
