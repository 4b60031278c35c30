"""Herodot-style rich errors (counterpart of ``keto_tpu/utils/errors.py``).

Only the errors the Check, Expand and list paths, their stores, the fleet
(``ErrFollowerLag``, ``ErrReadOnlyFollower``) and the REST plane raise are
kept. Each carries its HTTP status and gRPC code, and renders the herodot
JSON envelope ``{"error": {code, status, message}}`` the transports send.
"""

from __future__ import annotations


class KetoError(Exception):
    """Base domain error with HTTP + gRPC mapping."""

    status_code = 500
    status = "Internal Server Error"
    grpc_code = "INTERNAL"
    reason = ""

    def __init__(self, message: str | None = None, reason: str | None = None):
        self.message = message or self.default_message()
        super().__init__(self.message)
        if reason is not None:
            self.reason = reason

    def default_message(self) -> str:
        return self.status

    def envelope(self) -> dict:
        """JSON body matching herodot's error envelope."""
        err = {
            "code": self.status_code,
            "status": self.status,
            "message": self.message,
        }
        if self.reason:
            err["reason"] = self.reason
        return {"error": err}


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


class ErrStalePageToken(ErrMalformedPageToken):
    """A well-formed continuation token whose pinned data version has been
    superseded (the store moved between pages). The client raced a write,
    so the wire mapping is 409 (restart the listing), not 400."""

    status_code = 409
    status = "Conflict"
    grpc_code = "FAILED_PRECONDITION"

    def default_message(self) -> str:
        return (
            "The page token was issued against a superseded data version; "
            "restart the listing."
        )


class ErrInvalidTuple(ErrMalformedInput):
    def default_message(self) -> str:
        return "The provided relation tuple is invalid."


class ErrVocabEpochMismatch(KetoError):
    """An id-native (pre-encoded) check arrived tagged with a vocab
    ``(lineage, epoch)`` that is not the serving vocab. Ids are only
    meaningful against the exact vocab instance the client encoded with:
    a rebuild swaps lineage (ids reassigned), a write advances the epoch
    (new ids the client has not seen). The envelope carries the server's
    current coordinates so the client can resync from the vocab delta
    feed and retry."""

    status_code = 409
    status = "Conflict"
    grpc_code = "FAILED_PRECONDITION"

    def __init__(
        self,
        message: str | None = None,
        *,
        server_lineage: str = "",
        server_epoch: int = 0,
        client_lineage: str = "",
        client_epoch: int = 0,
    ):
        self.server_lineage = str(server_lineage)
        self.server_epoch = int(server_epoch)
        self.client_lineage = str(client_lineage)
        self.client_epoch = int(client_epoch)
        super().__init__(message)

    def default_message(self) -> str:
        return (
            "The encoded request's vocab epoch does not match the serving "
            f"vocab (client {self.client_lineage}@{self.client_epoch}, "
            f"server {self.server_lineage}@{self.server_epoch}); resync "
            "from the vocab delta feed and retry."
        )

    def envelope(self) -> dict:
        doc = super().envelope()
        same_lineage = (
            bool(self.client_lineage)
            and self.client_lineage == self.server_lineage
        )
        doc["error"]["details"] = {
            "reason": "vocab_epoch_mismatch",
            "server_lineage": self.server_lineage,
            "server_epoch": self.server_epoch,
            "client_lineage": self.client_lineage,
            "client_epoch": self.client_epoch,
            # delta catch-up only works within one lineage; a lineage
            # change means ids were reassigned and the cache must
            # re-bootstrap from /vocab/snapshot
            "resync": (
                f"/vocab/deltas?lineage={self.server_lineage}"
                f"&from={self.client_epoch}"
                if same_lineage
                else "/vocab/snapshot"
            ),
        }
        return doc


class ErrForbidden(KetoError):
    """The client's status map spells a 403 that is not a check answer
    (a protected ``/debug`` route) as this."""

    status_code = 403
    status = "Forbidden"
    grpc_code = "PERMISSION_DENIED"


class ErrUnavailable(KetoError):
    """A freshness/availability condition, not a server bug."""

    status_code = 503
    status = "Service Unavailable"
    grpc_code = "UNAVAILABLE"


class ErrFollowerLag(ErrUnavailable):
    """A follower could not catch up to the requested snaptoken within the
    freshness window. Retryable: the response carries the follower's
    current lag so the caller can back off or re-route to the leader."""

    retry_after_s = 1

    def __init__(
        self,
        message: str | None = None,
        *,
        lag_versions: int = 0,
        lag_seconds: float = 0.0,
        retry_after_s: float | None = None,
    ):
        self.lag_versions = int(lag_versions)
        self.lag_seconds = float(lag_seconds)
        if retry_after_s is not None:
            self.retry_after_s = retry_after_s
        super().__init__(message)

    def default_message(self) -> str:
        return (
            "The follower replica is behind the requested snaptoken "
            f"(lag: {self.lag_versions} versions); retry or route to "
            "the leader."
        )

    def envelope(self) -> dict:
        doc = super().envelope()
        doc["error"]["details"] = {
            "lag_versions": self.lag_versions,
            "lag_seconds": round(self.lag_seconds, 3),
        }
        return doc


class ErrReadOnlyFollower(ErrUnavailable):
    """A mutation reached a follower replica, which serves reads only. When
    the node knows who leads (an election lease on file), the envelope
    carries a ``leader_hint`` so the client can follow the leader without
    another discovery round trip."""

    def __init__(self, message: str | None = None, *, leader_hint: dict | None = None):
        #: {"leader_id", "term", "read_url", "write_url"} or None
        self.leader_hint = leader_hint
        super().__init__(message)

    def default_message(self) -> str:
        return "This replica is a read-only follower; write to the leader."

    def envelope(self) -> dict:
        doc = super().envelope()
        if self.leader_hint:
            doc["error"]["details"] = {"leader_hint": self.leader_hint}
        return doc


class ErrInternal(KetoError):
    status_code = 500
    status = "Internal Server Error"
    grpc_code = "INTERNAL"


class DeadlineExceeded(KetoError):
    """The caller's deadline passed before (or while) the request was
    served: the request ran out of time, the server was healthy."""

    status_code = 504
    status = "Gateway Timeout"
    grpc_code = "DEADLINE_EXCEEDED"

    def default_message(self) -> str:
        return "The request deadline was exceeded."


class ErrResourceExhausted(KetoError):
    """Load shed: the server chose to reject rather than queue without
    bound. Retryable after backoff (the transports send Retry-After)."""

    status_code = 429
    status = "Too Many Requests"
    grpc_code = "RESOURCE_EXHAUSTED"
    retry_after_s = 1

    def default_message(self) -> str:
        return "The server is overloaded; retry with backoff."
