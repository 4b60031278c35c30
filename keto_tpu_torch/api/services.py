"""gRPC services of the ``ory.keto.acl.v1alpha1`` contract (counterpart of
``keto_tpu/api/services.py``).

The servicers mirror the reference's handlers: CheckService (Check,
BatchCheck with tuples or columns, and the id-native BatchCheckEncoded),
ExpandService, ReadService, the keto_tpu ListService (ListObjects,
ListSubjects), WriteService, VersionService, and the standard
``grpc.health.v1`` protocol. The service wiring and the client stubs are
written out by hand (no grpc_tools plugin); they register the method
names the reference serves, so any Keto gRPC client interoperates.

Snaptokens are real, as in the reference: a response carries the store
version it was answered at, and a request's snaptoken or ``latest`` makes
the batcher catch up first. The criticality class of a check rides the
``x-keto-criticality`` metadata into the overload plane's admission.

``Check`` carries the ``replica.slow`` fault site (``faults.py``). Each
check and list RPC runs inside the check telemetry's record
(``telemetry/flight.py``), labelled ``grpc``, ``grpc_batch``,
``grpc-encoded`` and ``grpc_list`` as in the reference, and joins the
caller's trace from the ``traceparent`` metadata (``x-keto-hedge: 1`` tags
a hedged duplicate). On a follower every read RPC with a snaptoken first
waits for replication to replay past it (``replication_waiter``, the
follower's ``wait_for_version``: ``ErrFollowerLag`` when the window closes
first), and the write service answers ``ErrReadOnlyFollower``
(UNAVAILABLE) while ``read_only`` says so.
"""

from __future__ import annotations

import json
import math
import threading
import time
from typing import Callable, Iterator, Optional

import grpc

from ..engine.overload import parse_criticality
from ..faults import FAULTS
from ..engine.tree import NodeType, Tree
from ..relationtuple.columns import CheckColumns, proto_has_columns
from ..relationtuple.definitions import RelationTuple, SubjectID, subject_from_dict
from ..telemetry.flight import NOOP_CHECK_TELEMETRY
from ..telemetry.tracing import HEDGE_HEADER, TRACEPARENT_HEADER
from ..utils.errors import ErrMalformedInput, ErrReadOnlyFollower, KetoError
from ..utils.pagination import PaginationOptions
from . import wirecodec
from .convert import (
    min_version_from,
    query_from_proto_fields,
    subject_from_proto,
    tree_to_proto,
    tuple_from_proto,
    tuple_to_proto,
)
from .gen.health import health_pb2
from .gen.ory.keto.acl.v1alpha1 import (
    check_service_pb2,
    expand_service_pb2,
    read_service_pb2,
    version_pb2,
    write_service_pb2,
)

_PKG = "ory.keto.acl.v1alpha1"

#: gRPC spelling of the REST X-Request-Criticality header: the overload
#: brownout ladder's shed class (critical | default | sheddable)
CRITICALITY_METADATA_KEY = "x-keto-criticality"


def _criticality_from_metadata(context, default: str = "default") -> str:
    try:
        metadata = context.invocation_metadata() or ()
    except Exception:
        return parse_criticality(None, default=default)
    for key, value in metadata:
        if key == CRITICALITY_METADATA_KEY:
            return parse_criticality(value, default=default)
    return parse_criticality(None, default=default)


def _await_freshness(version_waiter, min_version: int, timeout_s: float):
    """A snaptoken gate: the follower's replication wait on every read RPC,
    and the engine's wait on the routes that do not pass through the check
    batcher (the list service). Block until ``min_version`` is served or
    raise; None means there is nothing to wait for here."""
    if version_waiter is None or min_version <= 0:
        return
    version_waiter(min_version, timeout_s=timeout_s)


def _timeout_and_deadline(cap, context) -> tuple[float, Optional[float]]:
    """The freshness wait's bound (the RPC's remaining time, capped) and the
    caller's absolute ``time.monotonic()`` deadline, or None."""
    cap = float(cap()) if callable(cap) else float(cap)
    remaining = context.time_remaining()
    if remaining is None:
        return cap, None
    return min(remaining, cap), time.monotonic() + remaining


def _abort(context: grpc.ServicerContext, err: Exception):
    if isinstance(err, KetoError):
        code = getattr(grpc.StatusCode, err.grpc_code, grpc.StatusCode.INTERNAL)
        trailing = []
        retry_after = getattr(err, "retry_after_s", None)
        if retry_after is not None:
            # the gRPC spelling of Retry-After: a trailing-metadata hint for
            # shed requests, rounded UP and never 0
            trailing.append(("retry-after", str(max(1, math.ceil(retry_after)))))
        details = err.envelope().get("error", {}).get("details")
        if details is not None:
            # structured error details (the vocab-epoch resync hint) ride
            # trailing metadata as the JSON the REST envelope carries
            trailing.append(("keto-error-details", json.dumps(details)))
        if trailing:
            context.set_trailing_metadata(tuple(trailing))
        context.abort(code, err.message)
    context.abort(grpc.StatusCode.INTERNAL, str(err))


def _trace_from_metadata(context) -> tuple:
    """(traceparent, hedge) off the call's invocation metadata (keys arrive
    lower-cased, as the gRPC spec has them)."""
    traceparent = None
    hedge = False
    try:
        metadata = context.invocation_metadata() or ()
    except Exception:
        return None, False
    for key, value in metadata:
        if key == TRACEPARENT_HEADER:
            traceparent = value
        elif key == HEDGE_HEADER:
            hedge = value == "1"
    return traceparent, hedge


class CheckServicer:
    """``checker`` is a CheckBatcher or a DirectChecker; ``snaptoken_fn``
    yields the version checks are answered at. ``max_freshness_wait_s``
    caps any snaptoken catch-up wait (a float or a zero-arg callable)."""

    def __init__(
        self,
        checker,
        snaptoken_fn: Callable[[], str],
        max_freshness_wait_s=30.0,
        encoded_front=None,
        default_criticality: str = "default",
        telemetry=None,
        replication_waiter=None,
    ):
        self.checker = checker
        self.snaptoken_fn = snaptoken_fn
        self._freshness_cap = max_freshness_wait_s
        # the follower's replication gate (None on a leader or standalone)
        self.replication_waiter = replication_waiter
        # the per-request check telemetry, entered on the handler thread so
        # its span is the ambient parent inside checker.check()
        self.telemetry = telemetry or NOOP_CHECK_TELEMETRY
        # the id-native wire tier (api/encoded.EncodedCheckFront); None when
        # serve.read.encoded is off or the checker has no encoded path
        self.encoded_front = encoded_front
        # the class of calls without x-keto-criticality metadata
        # (overload.default_criticality)
        self.default_criticality = default_criticality

    def Check(self, request, context):
        try:
            # fault site: THIS process answers slowly (each forked replica
            # owns its registry copy); the seam hedged client reads mask
            FAULTS.maybe_sleep("replica.slow")
            subject = subject_from_proto(
                request.subject if request.HasField("subject") else None
            )
            if subject is None:
                raise ErrMalformedInput("check request without subject")
            tup = RelationTuple(
                namespace=request.namespace,
                object=request.object,
                relation=request.relation,
                subject=subject,
            )
            min_version = min_version_from(request.snaptoken, request.latest)
            # a freshness wait is bounded by the RPC deadline; the batcher
            # rejects dead-on-arrival work and culls expiry mid-queue
            timeout, deadline = _timeout_and_deadline(self._freshness_cap, context)
            _await_freshness(self.replication_waiter, min_version, timeout)
            # RPC termination (the client gone) cancels the queued entry
            entries: list = []
            context.add_callback(lambda: [f.cancel() for f in entries])
            traceparent, hedge = _trace_from_metadata(context)
            criticality = _criticality_from_metadata(context, self.default_criticality)
            # the response is built inside the record, so its construction
            # is the ledger's serialize stage
            with self.telemetry.record_check(
                "grpc", deadline=deadline, detail={"namespace": request.namespace},
                traceparent=traceparent, hedge=hedge,
            ) as rec:
                allowed = self.checker.check(
                    tup,
                    request.max_depth,
                    timeout=timeout,
                    min_version=min_version,
                    deadline=deadline,
                    entry_hook=entries.append,
                    criticality=criticality,
                )
                resp = check_service_pb2.CheckResponse(
                    allowed=allowed, snaptoken=self.snaptoken_fn()
                )
                rec.mark("serialize")
            return resp
        except Exception as e:
            _abort(context, e)

    def BatchCheck(self, request, context):
        """Many checks per RPC (the binary twin of REST /check/batch).
        Columnar requests (parallel string columns, fields 5-11) skip
        per-tuple object construction."""
        try:
            timeout, deadline = _timeout_and_deadline(self._freshness_cap, context)
            min_version = min_version_from(request.snaptoken, request.latest)
            _await_freshness(self.replication_waiter, min_version, timeout)
            traceparent, hedge = _trace_from_metadata(context)
            if proto_has_columns(request):
                cols = CheckColumns.from_proto(request)
                run = getattr(self.checker, "check_batch_columnar", None)
                with self.telemetry.record_check(
                    "grpc_batch", batch_size=len(cols), deadline=deadline,
                    traceparent=traceparent, hedge=hedge,
                ) as rec:
                    if run is not None:
                        allowed = run(
                            cols, request.max_depth, min_version=min_version,
                            timeout=timeout,
                        )
                    else:
                        allowed = self.checker.check_batch(
                            cols.materialize(), request.max_depth,
                            min_version=min_version, timeout=timeout,
                        )
                    resp = check_service_pb2.BatchCheckResponse(
                        allowed=allowed, snaptoken=self.snaptoken_fn()
                    )
                    rec.mark("serialize")
                return resp
            tuples = []
            for item in request.tuples:
                subject = subject_from_proto(
                    item.subject if item.HasField("subject") else None
                )
                if subject is None:
                    raise ErrMalformedInput("batch check tuple without subject")
                tuples.append(
                    RelationTuple(
                        namespace=item.namespace,
                        object=item.object,
                        relation=item.relation,
                        subject=subject,
                    )
                )
            with self.telemetry.record_check(
                "grpc_batch", batch_size=len(tuples), deadline=deadline,
                traceparent=traceparent, hedge=hedge,
            ) as rec:
                allowed = self.checker.check_batch(
                    tuples,
                    request.max_depth,
                    min_version=min_version,
                    timeout=timeout,
                    deadline=deadline,
                    criticality=_criticality_from_metadata(
                        context, self.default_criticality
                    ),
                )
                resp = check_service_pb2.BatchCheckResponse(
                    allowed=allowed, snaptoken=self.snaptoken_fn()
                )
                rec.mark("serialize")
            return resp
        except Exception as e:
            _abort(context, e)

    def BatchCheckEncoded(self, request, context):
        """The id-native wire tier: the request is a raw ``wirecodec`` frame
        (int32 id columns tagged with the client's vocab lineage and
        epoch), registered with identity serializers so no protobuf runs on
        this path. An epoch mismatch aborts FAILED_PRECONDITION with the
        resync hint in trailing metadata (``keto-error-details``)."""
        try:
            if self.encoded_front is None:
                context.abort(
                    grpc.StatusCode.UNIMPLEMENTED,
                    "the encoded check tier is disabled (serve.read.encoded)",
                )
            req = wirecodec.decode_check_request(request)
            timeout, deadline = _timeout_and_deadline(self._freshness_cap, context)
            _await_freshness(self.replication_waiter, req.min_version, timeout)
            with self.telemetry.record_check(
                "grpc-encoded", batch_size=len(req.start), deadline=deadline,
                traceparent=req.traceparent,
            ) as rec:
                allowed = self.encoded_front.check(req, timeout=timeout)
                resp = wirecodec.encode_check_response(allowed, self.snaptoken_fn())
                rec.mark("serialize")
            return resp
        except Exception as e:
            _abort(context, e)


class ExpandServicer:
    def __init__(self, expand_engine, replication_waiter=None, max_freshness_wait_s=30.0):
        self.expand_engine = expand_engine
        self.replication_waiter = replication_waiter
        self._freshness_cap = max_freshness_wait_s

    def Expand(self, request, context):
        try:
            subject = subject_from_proto(
                request.subject if request.HasField("subject") else None
            )
            if subject is None:
                raise ErrMalformedInput("expand request without subject")
            # snaptoken: validated, then satisfied by construction on a
            # leader (the expand engine reads the live store version); a
            # follower waits for replay first
            min_version = min_version_from(request.snaptoken, False)
            timeout, _ = _timeout_and_deadline(self._freshness_cap, context)
            _await_freshness(self.replication_waiter, min_version, timeout)
            # paged expand rides invocation metadata (the proto has no
            # paging fields): keto-expand-page-size / -page-token request
            # it; the continuation token and the patch paths come back as
            # trailing metadata. Later pages return the patch subtrees as
            # children of a synthetic union root.
            md = dict(context.invocation_metadata() or ())
            page_size_raw = md.get("keto-expand-page-size")
            page_token = md.get("keto-expand-page-token", "")
            if page_size_raw is not None or page_token:
                try:
                    page_size = int(page_size_raw) if page_size_raw else 0
                except ValueError as e:
                    raise ErrMalformedInput(
                        f"malformed keto-expand-page-size: {page_size_raw!r}"
                    ) from e
                page = self.expand_engine.build_tree_page(
                    subject, request.max_depth, page_size=page_size,
                    page_token=page_token,
                )
                trailing = []
                if page.next_page_token:
                    trailing.append(("keto-expand-next-page-token", page.next_page_token))
                if page.patches:
                    trailing.append((
                        "keto-expand-patch-paths",
                        json.dumps([list(p) for p, _ in page.patches]),
                    ))
                    tree = Tree(
                        type=NodeType.UNION,
                        subject=subject,
                        children=[t for _, t in page.patches],
                    )
                else:
                    tree = page.tree
                if trailing:
                    context.set_trailing_metadata(trailing)
            else:
                tree = self.expand_engine.build_tree(subject, request.max_depth)
            proto_tree = tree_to_proto(tree)
            if proto_tree is None:
                return expand_service_pb2.ExpandResponse()
            return expand_service_pb2.ExpandResponse(tree=proto_tree)
        except Exception as e:
            _abort(context, e)


class ReadServicer:
    # RelationTuple fields a ListRelationTuplesRequest.expand_mask may name
    _MASKABLE = frozenset({"namespace", "object", "relation", "subject"})

    def __init__(self, manager, replication_waiter=None, max_freshness_wait_s=30.0):
        self.manager = manager
        self.replication_waiter = replication_waiter
        self._freshness_cap = max_freshness_wait_s

    def ListRelationTuples(self, request, context):
        try:
            q = request.query
            query = query_from_proto_fields(
                q.namespace,
                q.object,
                q.relation,
                q.subject if q.HasField("subject") else None,
            )
            # snaptoken: validated, then satisfied on a leader (the list
            # reads the live store); a follower waits for replay first
            min_version = min_version_from(request.snaptoken, False)
            timeout, _ = _timeout_and_deadline(self._freshness_cap, context)
            _await_freshness(self.replication_waiter, min_version, timeout)
            mask = None
            # an empty path list means "no projection" (FieldMask read
            # convention), not "clear everything"
            if request.HasField("expand_mask") and request.expand_mask.paths:
                mask = set(request.expand_mask.paths)
                unknown = mask - self._MASKABLE
                if unknown:
                    raise ErrMalformedInput(
                        "expand_mask names unknown RelationTuple fields: "
                        + ", ".join(sorted(unknown))
                    )
            tuples, next_token = self.manager.get_relation_tuples(
                query,
                PaginationOptions(token=request.page_token, size=request.page_size),
            )
            protos = [tuple_to_proto(t) for t in tuples]
            if mask is not None:
                # FieldMask projection: clear every unnamed field
                for pt in protos:
                    for f in self._MASKABLE - mask:
                        pt.ClearField(f)
            return read_service_pb2.ListRelationTuplesResponse(
                relation_tuples=protos,
                next_page_token=next_token,
            )
        except Exception as e:
            _abort(context, e)


class ListServicer:
    """Reverse-index list serving over gRPC (a keto_tpu extension). The
    protos predate the list surface, so both methods are registered with
    identity serializers and speak compact JSON: the request mirrors the
    REST query ({"namespace", "relation", "subject_id" | "subject_set":
    {...}, "max_depth", "page_size", "page_token", "snaptoken",
    "latest"}), the response the REST body ({"objects" | "subject_ids":
    [...], "next_page_token", "snaptoken"})."""

    def __init__(
        self,
        list_engine,
        snaptoken_fn: Callable[[], str],
        version_waiter=None,
        max_freshness_wait_s=30.0,
        telemetry=None,
        replication_waiter=None,
    ):
        self.list_engine = list_engine
        self.snaptoken_fn = snaptoken_fn
        self.version_waiter = version_waiter
        self.replication_waiter = replication_waiter
        self._freshness_cap = max_freshness_wait_s
        self.telemetry = telemetry or NOOP_CHECK_TELEMETRY

    def _decode(self, request: bytes) -> dict:
        try:
            body = json.loads(bytes(request) or b"{}")
        except Exception as e:
            raise ErrMalformedInput(f"malformed list request: {e}") from e
        if not isinstance(body, dict):
            raise ErrMalformedInput("expected a json list-request object")
        return body

    def _serve(self, request, context, items_key: str, run) -> bytes:
        try:
            body = self._decode(request)
            min_version = min_version_from(
                body.get("snaptoken", ""), body.get("latest", "")
            )
            timeout, deadline = _timeout_and_deadline(self._freshness_cap, context)
            _await_freshness(self.replication_waiter, min_version, timeout)
            _await_freshness(self.version_waiter, min_version, timeout)
            traceparent, hedge = _trace_from_metadata(context)
            with self.telemetry.record_check(
                "grpc_list", deadline=deadline,
                detail={"namespace": body.get("namespace", "")},
                traceparent=traceparent, hedge=hedge,
            ) as rec:
                page = run(body, deadline, rec)
                resp = json.dumps(
                    {
                        items_key: page.items,
                        "next_page_token": page.next_page_token,
                        "snaptoken": self.snaptoken_fn(),
                    },
                    separators=(",", ":"),
                ).encode()
                rec.mark("serialize")
            return resp
        except Exception as e:
            _abort(context, e)

    def ListObjects(self, request, context):
        def run(body, deadline, rec):
            if body.get("subject_id") is not None:
                subject = SubjectID(id=body["subject_id"])
            elif body.get("subject_set") is not None:
                subject = subject_from_dict(body["subject_set"])
            else:
                raise ErrMalformedInput("either subject_id or subject_set is required")
            for key in ("namespace", "relation"):
                if body.get(key) is None:
                    raise ErrMalformedInput(f"missing field {key}")
            return self.list_engine.list_objects(
                subject=subject,
                relation=body["relation"],
                namespace=body["namespace"],
                max_depth=int(body.get("max_depth", 0) or 0),
                page_size=int(body.get("page_size", 0) or 0),
                page_token=body.get("page_token", ""),
                deadline=deadline,
                rec=rec,
            )

        return self._serve(request, context, "objects", run)

    def ListSubjects(self, request, context):
        def run(body, deadline, rec):
            for key in ("namespace", "object", "relation"):
                if body.get(key) is None:
                    raise ErrMalformedInput(f"missing field {key}")
            return self.list_engine.list_subjects(
                namespace=body["namespace"],
                object=body["object"],
                relation=body["relation"],
                max_depth=int(body.get("max_depth", 0) or 0),
                page_size=int(body.get("page_size", 0) or 0),
                page_token=body.get("page_token", ""),
                deadline=deadline,
                rec=rec,
            )

        return self._serve(request, context, "subject_ids", run)


class WriteServicer:
    def __init__(self, manager, snaptoken_fn: Callable[[], str], read_only=False):
        self.manager = manager
        self.snaptoken_fn = snaptoken_fn
        # a follower serves the write port (health, version, replication) but
        # rejects mutations; a callable is asked per call (under election a
        # promoted follower accepts, a fenced ex-leader rejects)
        self.read_only = read_only

    def _is_read_only(self) -> bool:
        ro = self.read_only
        return bool(ro() if callable(ro) else ro)

    def TransactRelationTuples(self, request, context):
        try:
            if self._is_read_only():
                raise ErrReadOnlyFollower()
            inserts: list[RelationTuple] = []
            deletes: list[RelationTuple] = []
            for delta in request.relation_tuple_deltas:
                tup = tuple_from_proto(delta.relation_tuple)
                if delta.action == write_service_pb2.RelationTupleDelta.INSERT:
                    inserts.append(tup)
                elif delta.action == write_service_pb2.RelationTupleDelta.DELETE:
                    deletes.append(tup)
                else:
                    raise ErrMalformedInput(f"unspecified delta action for {tup}")
            self.manager.transact_relation_tuples(inserts, deletes)
            token = self.snaptoken_fn()
            return write_service_pb2.TransactRelationTuplesResponse(
                snaptokens=[token] * len(request.relation_tuple_deltas)
            )
        except Exception as e:
            _abort(context, e)

    def DeleteRelationTuples(self, request, context):
        try:
            if self._is_read_only():
                raise ErrReadOnlyFollower()
            q = request.query
            query = query_from_proto_fields(
                q.namespace,
                q.object,
                q.relation,
                q.subject if q.HasField("subject") else None,
            )
            self.manager.delete_all_relation_tuples(query)
            return write_service_pb2.DeleteRelationTuplesResponse()
        except Exception as e:
            _abort(context, e)


class VersionServicer:
    def __init__(self, version: str):
        self.version = version

    def GetVersion(self, request, context):
        return version_pb2.GetVersionResponse(version=self.version)


class HealthServicer:
    """grpc.health.v1 with Watch (a client blocks until SERVING, as the
    reference's ``keto status --block``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # NOT_SERVING until the registry finishes bring-up (warmup included)
        self._status = health_pb2.HealthCheckResponse.NOT_SERVING

    def set_serving(self, serving: bool) -> None:
        with self._cv:
            self._status = (
                health_pb2.HealthCheckResponse.SERVING
                if serving
                else health_pb2.HealthCheckResponse.NOT_SERVING
            )
            self._cv.notify_all()

    def Check(self, request, context):
        with self._lock:
            return health_pb2.HealthCheckResponse(status=self._status)

    def Watch(self, request, context) -> Iterator:
        last = None
        while context.is_active():
            with self._cv:
                if self._status == last:
                    self._cv.wait(timeout=1.0)
                status = self._status
            if status != last:
                last = status
                yield health_pb2.HealthCheckResponse(status=status)


# -- server wiring (what protoc's grpc plugin would have generated) -----------


def _unary(fn, req_cls, resp_cls):
    return grpc.unary_unary_rpc_method_handler(
        fn,
        request_deserializer=req_cls.FromString,
        response_serializer=resp_cls.SerializeToString,
    )


def _add(server, service: str, handlers: dict) -> None:
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(service, handlers),)
    )


def add_check_service(server, servicer: CheckServicer):
    _add(server, f"{_PKG}.CheckService", {
        "Check": _unary(
            servicer.Check,
            check_service_pb2.CheckRequest,
            check_service_pb2.CheckResponse,
        ),
        "BatchCheck": _unary(
            servicer.BatchCheck,
            check_service_pb2.BatchCheckRequest,
            check_service_pb2.BatchCheckResponse,
        ),
        # identity serializers: the body is a raw wirecodec frame
        "BatchCheckEncoded": grpc.unary_unary_rpc_method_handler(
            servicer.BatchCheckEncoded
        ),
    })


def add_expand_service(server, servicer: ExpandServicer):
    _add(server, f"{_PKG}.ExpandService", {
        "Expand": _unary(
            servicer.Expand,
            expand_service_pb2.ExpandRequest,
            expand_service_pb2.ExpandResponse,
        )
    })


def add_read_service(server, servicer: ReadServicer):
    _add(server, f"{_PKG}.ReadService", {
        "ListRelationTuples": _unary(
            servicer.ListRelationTuples,
            read_service_pb2.ListRelationTuplesRequest,
            read_service_pb2.ListRelationTuplesResponse,
        )
    })


def add_list_service(server, servicer: ListServicer):
    # identity serializers: compact JSON bytes both ways
    _add(server, f"{_PKG}.ListService", {
        "ListObjects": grpc.unary_unary_rpc_method_handler(servicer.ListObjects),
        "ListSubjects": grpc.unary_unary_rpc_method_handler(servicer.ListSubjects),
    })


def add_write_service(server, servicer: WriteServicer):
    _add(server, f"{_PKG}.WriteService", {
        "TransactRelationTuples": _unary(
            servicer.TransactRelationTuples,
            write_service_pb2.TransactRelationTuplesRequest,
            write_service_pb2.TransactRelationTuplesResponse,
        ),
        "DeleteRelationTuples": _unary(
            servicer.DeleteRelationTuples,
            write_service_pb2.DeleteRelationTuplesRequest,
            write_service_pb2.DeleteRelationTuplesResponse,
        ),
    })


def add_version_service(server, servicer: VersionServicer):
    _add(server, f"{_PKG}.VersionService", {
        "GetVersion": _unary(
            servicer.GetVersion,
            version_pb2.GetVersionRequest,
            version_pb2.GetVersionResponse,
        )
    })


def add_health_service(server, servicer: HealthServicer):
    _add(server, "grpc.health.v1.Health", {
        "Check": _unary(
            servicer.Check,
            health_pb2.HealthCheckRequest,
            health_pb2.HealthCheckResponse,
        ),
        "Watch": grpc.unary_stream_rpc_method_handler(
            servicer.Watch,
            request_deserializer=health_pb2.HealthCheckRequest.FromString,
            response_serializer=health_pb2.HealthCheckResponse.SerializeToString,
        ),
    })


# -- client stubs -------------------------------------------------------------


def _method(channel, path: str, req_cls=None, resp_cls=None):
    if req_cls is None:  # raw bytes both ways (wirecodec or JSON frames)
        return channel.unary_unary(path)
    return channel.unary_unary(
        path,
        request_serializer=req_cls.SerializeToString,
        response_deserializer=resp_cls.FromString,
    )


class CheckServiceStub:
    def __init__(self, channel: grpc.Channel):
        svc = f"/{_PKG}.CheckService"
        self.Check = _method(
            channel, f"{svc}/Check",
            check_service_pb2.CheckRequest, check_service_pb2.CheckResponse,
        )
        self.BatchCheck = _method(
            channel, f"{svc}/BatchCheck",
            check_service_pb2.BatchCheckRequest, check_service_pb2.BatchCheckResponse,
        )
        self.BatchCheckEncoded = _method(channel, f"{svc}/BatchCheckEncoded")


class ExpandServiceStub:
    def __init__(self, channel: grpc.Channel):
        self.Expand = _method(
            channel, f"/{_PKG}.ExpandService/Expand",
            expand_service_pb2.ExpandRequest, expand_service_pb2.ExpandResponse,
        )


class ReadServiceStub:
    def __init__(self, channel: grpc.Channel):
        self.ListRelationTuples = _method(
            channel, f"/{_PKG}.ReadService/ListRelationTuples",
            read_service_pb2.ListRelationTuplesRequest,
            read_service_pb2.ListRelationTuplesResponse,
        )


class ListServiceStub:
    def __init__(self, channel: grpc.Channel):
        self.ListObjects = _method(channel, f"/{_PKG}.ListService/ListObjects")
        self.ListSubjects = _method(channel, f"/{_PKG}.ListService/ListSubjects")


class WriteServiceStub:
    def __init__(self, channel: grpc.Channel):
        svc = f"/{_PKG}.WriteService"
        self.TransactRelationTuples = _method(
            channel, f"{svc}/TransactRelationTuples",
            write_service_pb2.TransactRelationTuplesRequest,
            write_service_pb2.TransactRelationTuplesResponse,
        )
        self.DeleteRelationTuples = _method(
            channel, f"{svc}/DeleteRelationTuples",
            write_service_pb2.DeleteRelationTuplesRequest,
            write_service_pb2.DeleteRelationTuplesResponse,
        )


class VersionServiceStub:
    def __init__(self, channel: grpc.Channel):
        self.GetVersion = _method(
            channel, f"/{_PKG}.VersionService/GetVersion",
            version_pb2.GetVersionRequest, version_pb2.GetVersionResponse,
        )


class HealthStub:
    def __init__(self, channel: grpc.Channel):
        self.Check = _method(
            channel, "/grpc.health.v1.Health/Check",
            health_pb2.HealthCheckRequest, health_pb2.HealthCheckResponse,
        )
        self.Watch = channel.unary_stream(
            "/grpc.health.v1.Health/Watch",
            request_serializer=health_pb2.HealthCheckRequest.SerializeToString,
            response_deserializer=health_pb2.HealthCheckResponse.FromString,
        )
