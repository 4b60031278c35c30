"""REST transport on the standard library (counterpart of
``keto_tpu/api/rest.py``): the reference's routes, status codes and JSON
bodies, served by ``http.server.ThreadingHTTPServer`` (``api/daemon.py``).

Read port:
- GET  /relation-tuples   paginated query, ``snaptoken`` validated
- GET  /check, POST /check          200 {"allowed":true} / 403 {"allowed":false}
- POST /check/batch       a json array of tuples, {"tuples": [...],
                          "max_depth": n}, or the columnar form
                          {"namespaces": [...], "objects": [...], ...} ->
                          {"allowed": [...], "snaptoken"}
- POST /check/batch-encoded   a ``wirecodec`` KTE1 frame of vocab ids
                          (application/octet-stream) -> a KTR1 bitset frame;
                          a vocab (lineage, epoch) mismatch is a 409 whose
                          details carry the resync hint
- GET  /vocab/snapshot    one page (``offset``/``limit``) of the vocab keys
                          with the server's (lineage, epoch)
- GET  /vocab/deltas      keys interned since ``from`` on ``lineage``; the
                          encoded and vocab routes are registered only with
                          an encoded front (``serve.read.encoded``)
- GET  /pipeline          the check batcher's queue and stage occupancy
- GET  /expand            the subject tree, or null (200) for a set with no
                          tuples; with ``page_size`` or ``page_token``
                          {"tree"|"patches", "next_page_token"?}
- GET  /relation-tuples/list-objects   {"objects", "next_page_token",
                          "snaptoken"}; registered only with a list engine
- GET  /relation-tuples/list-subjects  {"subject_ids", ...}; likewise

Write port:
- PUT    /relation-tuples   create -> 201 + Location
- DELETE /relation-tuples   delete by query -> 204
- PATCH  /relation-tuples   [{action: insert|delete, relation_tuple}] -> 204

Both ports: /health/alive, /health/ready, /version and, with a metrics
registry, /metrics (Prometheus text, or OpenMetrics with exemplars and
``# EOF`` when the scraper sends ``Accept: application/openmetrics-text``).
Errors use the
herodot envelope {"error": {code, status, message}}: unknown namespaces are
404, malformed input 400, a shed or throttled request 429 (with
Retry-After), an unavailable snapshot 503, a passed deadline 504, a list
page token from before a write or a stale encoded vocab 409, anything else
500. Subjects arrive either as ``subject_id`` or dotted
``subject_set.*`` query params; supplying both (or neither, where one is
required) is a 400.

A single check and a tuple batch carry a criticality class for the
overload plane in ``X-Request-Criticality`` (``critical``, ``default`` or
``sheddable``; absent or unknown means ``overload.default_criticality``);
a shed check is a 429 with ``Retry-After``.

The ``/debug/*`` routes (``api/debug.py``) are registered on the read
port by the registry, behind ``debug.enabled`` and ``debug.token``.

CORS (``serve.<plane>.cors``, reference rs/cors options) wraps dispatch as
the reference's middleware does: with ``enabled`` and an ``Origin`` header,
an ``OPTIONS`` preflight (it carries ``Access-Control-Request-Method``) is
answered 204 without reaching a route, and an allowed origin gets the
``Access-Control-Allow-{Origin,Methods,Headers}`` headers on every answer,
errors included; a disallowed origin gets none. Without an ``Origin``, or
with CORS off, requests pass through untouched.

Each request runs on its connection's thread, so concurrent single checks
meet in the check batcher.

The fleet's routes, as the reference's: ``/cluster/status`` on the read
port (the federation rollup); on the write port a leader's
``/replication/{status,checkpoint,wal,digest}`` and
``POST /cluster/heartbeat``, a follower's ``/replication/status``. On a
follower every read route with a ``snaptoken`` first waits for replication
to replay past it (``ErrFollowerLag``, a 503 with ``Retry-After`` and the
lag, when the freshness window closes first), and the write routes answer
``ErrReadOnlyFollower``, a 503 whose details carry the ``leader_hint``.

Telemetry, as the reference's middleware and read API: the router counts
``keto_http_requests_total{plane,method,route,code}`` and observes
``keto_http_request_duration_seconds{plane}``, with ``route`` the matched
route pattern or ``unmatched``, never the raw path, and logs one ``http``
line per request at info. Every check route runs inside the check
telemetry's record (``telemetry/flight.py CheckTelemetry``): a
``check.request`` span that joins the caller's ``traceparent``, the
``keto_check_duration_seconds`` histogram with a trace-id exemplar,
``keto_check_requests_total{transport,outcome}``, the SLO, the flight
recorder and the attribution ledger, whose ``serialize`` stage covers the
response body. Served by ``api/daemon.py``, the record adopts the
transport's ledger, which runs from the body read (``admission``) to the
socket write (``reply``). The transports are labelled as in the reference: ``rest``,
``rest_batch``, ``rest-encoded`` and ``rest_list``. ``x-keto-hedge: 1``
tags a client's hedged duplicate.
"""

from __future__ import annotations

import json
import math
import time
from dataclasses import dataclass, field
from typing import Callable, Optional
from urllib.parse import parse_qsl, urlencode, urlsplit

from ..engine.overload import parse_criticality
from ..graph import vocabsync
from ..relationtuple.columns import CheckColumns
from ..replication.token import LATEST_SENTINEL, parse_snaptoken
from ..relationtuple.definitions import (
    RelationQuery,
    RelationTuple,
    Subject,
    SubjectID,
    SubjectSet,
)
from ..telemetry.flight import NOOP_CHECK_TELEMETRY
from ..telemetry.tracing import HEDGE_HEADER, TRACEPARENT_HEADER
from ..utils.errors import (
    DeadlineExceeded,
    ErrMalformedInput,
    ErrReadOnlyFollower,
    KetoError,
)
from ..utils.pagination import PaginationOptions
from . import wirecodec

ROUTE_TUPLES = "/relation-tuples"
ROUTE_CHECK = "/check"
ROUTE_CHECK_BATCH = "/check/batch"
# the id-native wire tier: pre-encoded int32 batches as raw wirecodec
# frames, and the vocab feed trusted clients keep their encode cache with
ROUTE_CHECK_BATCH_ENCODED = "/check/batch-encoded"
ROUTE_VOCAB_SNAPSHOT = "/vocab/snapshot"
ROUTE_VOCAB_DELTAS = "/vocab/deltas"
ROUTE_PIPELINE = "/pipeline"
ROUTE_EXPAND = "/expand"
ROUTE_LIST_OBJECTS = "/relation-tuples/list-objects"
ROUTE_LIST_SUBJECTS = "/relation-tuples/list-subjects"

#: the REST spelling of a deadline: milliseconds of budget the caller grants
#: this request, measured from when the header is parsed
DEADLINE_HEADER = "X-Request-Deadline-Ms"

#: criticality class for the overload brownout ladder: ``critical`` |
#: ``default`` | ``sheddable``. Unknown values fall back to the default
#: (a typo must not change the answer, only the shed priority)
CRITICALITY_HEADER = "X-Request-Criticality"



@dataclass
class Request:
    method: str
    path: str
    query: dict  # first value of each query parameter
    headers: dict  # lower-cased names
    body: bytes = b""

    @classmethod
    def parse(cls, method: str, target: str, headers, body: bytes) -> "Request":
        parts = urlsplit(target)
        query: dict = {}
        for k, v in parse_qsl(parts.query, keep_blank_values=True):
            query.setdefault(k, v)
        return cls(
            method=method,
            path=parts.path,
            query=query,
            headers={k.lower(): v for k, v in headers.items()},
            body=body,
        )


@dataclass
class Response:
    status: int
    body: bytes = b""
    content_type: str = "application/json"
    headers: dict = field(default_factory=dict)
    # a 404 or 405 of the route table itself: the reference's router raises
    # these past its CORS middleware, so they carry no CORS headers
    unrouted: bool = False


def json_response(doc, status: int = 200, headers: Optional[dict] = None) -> Response:
    return Response(status, json.dumps(doc).encode(), headers=headers or {})


def json_error(err: KetoError) -> Response:
    headers = {}
    retry_after = getattr(err, "retry_after_s", None)
    if retry_after is not None or err.status_code in (429, 503):
        # invite the retry-with-backoff; round UP and never emit 0
        headers["Retry-After"] = str(max(1, math.ceil(retry_after or 1)))
    return json_response(err.envelope(), err.status_code, headers)


class Cors:
    """The ``serve.<plane>.cors`` subtree with the reference's defaults
    (``make_cors_middleware``: every origin, the five write-capable methods,
    Authorization and Content-Type)."""

    def __init__(self, cfg: Optional[dict] = None):
        cfg = cfg or {}
        self.enabled = bool(cfg.get("enabled", False))
        self.allowed_origins = cfg.get("allowed_origins", ["*"])
        self.allowed_methods = cfg.get(
            "allowed_methods", ["GET", "POST", "PUT", "PATCH", "DELETE"]
        )
        self.allowed_headers = cfg.get(
            "allowed_headers", ["Authorization", "Content-Type"]
        )

    def wrap(self, req: Request, handle) -> Response:
        origin = req.headers.get("origin")
        if not self.enabled or not origin:
            return handle(req)
        if req.method == "OPTIONS" and "access-control-request-method" in req.headers:
            resp = Response(204)  # the preflight never reaches a route
        else:
            resp = handle(req)
        if resp.unrouted:
            return resp
        if "*" in self.allowed_origins or origin in self.allowed_origins:
            resp.headers["Access-Control-Allow-Origin"] = origin
            resp.headers["Access-Control-Allow-Methods"] = ", ".join(self.allowed_methods)
            resp.headers["Access-Control-Allow-Headers"] = ", ".join(self.allowed_headers)
        return resp


class Router:
    """(method, path) -> handler; dispatch maps errors to the wire exactly
    as the reference's error middleware does, inside the CORS wrap, and,
    outermost, counts and logs the request under its ``plane`` (the
    reference's telemetry middleware)."""

    def __init__(
        self, cors: Optional[dict] = None, plane: str = "", metrics=None, logger=None
    ):
        self._routes: dict[tuple[str, str], Callable[[Request], Response]] = {}
        self._paths: set[str] = set()
        self.cors = Cors(cors)
        self.plane = plane
        self.logger = logger
        self._m_requests = self._m_duration = None
        if metrics is not None:
            self._m_requests = metrics.counter(
                "keto_http_requests_total",
                "HTTP requests by plane/method/route/code",
                labelnames=("plane", "method", "route", "code"),
            )
            self._m_duration = metrics.histogram(
                "keto_http_request_duration_seconds",
                "HTTP request duration",
                labelnames=("plane",),
            )

    def add(self, method: str, path: str, handler) -> None:
        self._routes[(method, path)] = handler
        self._paths.add(path)

    def dispatch(self, req: Request) -> Response:
        t0 = time.perf_counter()
        resp = self.cors.wrap(req, self._route)
        if self._m_requests is not None or self.logger is not None:
            elapsed = time.perf_counter() - t0
            # the matched route pattern, never the raw path: raw paths
            # are unbounded-cardinality label values
            route = req.path if req.path in self._paths else "unmatched"
            if self._m_requests is not None:
                self._m_requests.labels(
                    plane=self.plane, method=req.method, route=route,
                    code=str(resp.status),
                ).inc()
                self._m_duration.labels(plane=self.plane).observe(elapsed)
            if self.logger is not None:
                self.logger.info(
                    "http", plane=self.plane, method=req.method, route=route,
                    code=resp.status, ms=round(1000 * elapsed, 2),
                )
        return resp

    def _route(self, req: Request) -> Response:
        handler = self._routes.get((req.method, req.path))
        if handler is None:
            allowed = sorted(m for m, p in self._routes if p == req.path)
            if allowed:
                return Response(
                    405, b"405: Method Not Allowed", "text/plain",
                    {"Allow": ",".join(allowed)}, unrouted=True,
                )
            return Response(404, b"404: Not Found", "text/plain", unrouted=True)
        try:
            return handler(req)
        except KetoError as e:
            return json_error(e)
        except TimeoutError:
            # a timeout that escaped typed handling is still "the request
            # ran out of time", not a server bug
            return json_error(DeadlineExceeded())
        except Exception as e:  # internal
            return json_response(
                {
                    "error": {
                        "code": 500,
                        "status": "Internal Server Error",
                        "message": str(e),
                    }
                },
                500,
            )


def deadline_from_headers(req: Request) -> Optional[float]:
    """:data:`DEADLINE_HEADER` as an absolute ``time.monotonic()`` deadline
    (None when absent); a non-numeric or negative value is a 400."""
    raw = req.headers.get(DEADLINE_HEADER.lower())
    if raw is None:
        return None
    try:
        ms = float(raw)
    except ValueError:
        raise ErrMalformedInput(
            f"{DEADLINE_HEADER} must be a number of milliseconds, got {raw!r}"
        ) from None
    if ms < 0:
        raise ErrMalformedInput(f"{DEADLINE_HEADER} must be >= 0, got {raw!r}")
    return time.monotonic() + ms / 1000.0


def criticality_from_headers(req: Request, default: str = "default") -> str:
    return parse_criticality(
        req.headers.get(CRITICALITY_HEADER.lower()), default=default
    )


def min_version_from(snaptoken: str, latest) -> int:
    """`snaptoken` (a structured ``z<version>.<segment>.<offset>`` token or
    a bare version) and `latest` -> the minimum version a read must be
    answered at; malformed spellings are a 400, not a silent stale read."""
    min_version = 0
    if snaptoken:
        try:
            # the structured token or a bare version: freshness keys on the
            # version component either way (replication/token.py)
            min_version = parse_snaptoken(snaptoken).version
        except ValueError:
            raise ErrMalformedInput(f"malformed snaptoken {snaptoken!r}") from None
    if isinstance(latest, str):
        val = latest.strip().lower()
        if val in ("true", "1", "yes"):
            latest = True
        elif val in ("", "false", "0", "no"):
            latest = False
        else:
            raise ErrMalformedInput(f"malformed latest flag {latest!r}")
    if latest:
        min_version = max(min_version, LATEST_SENTINEL)
    return min_version


def _min_version_from_query(params) -> int:
    return min_version_from(params.get("snaptoken", ""), params.get("latest", ""))


def subject_from_query(params, required: bool) -> Optional[Subject]:
    """subject_id XOR subject_set.{namespace,object,relation}."""
    sid = params.get("subject_id")
    sns = params.get("subject_set.namespace")
    sobj = params.get("subject_set.object")
    srel = params.get("subject_set.relation")
    has_set = sns is not None or sobj is not None or srel is not None
    if sid is not None and has_set:
        raise ErrMalformedInput("exactly one of subject_id or subject_set.* is allowed")
    if sid is not None:
        return SubjectID(id=sid)
    if has_set:
        if sns is None or sobj is None or srel is None:
            raise ErrMalformedInput("subject_set requires namespace, object, and relation")
        return SubjectSet(namespace=sns, object=sobj, relation=srel)
    if required:
        raise ErrMalformedInput("either subject_id or subject_set.* is required")
    return None


def max_depth_from_query(params) -> int:
    raw = params.get("max-depth", "0")
    try:
        return int(raw)
    except ValueError:
        raise ErrMalformedInput(f"max-depth must be an integer, got {raw!r}") from None


def _tuple_from_query(params) -> RelationTuple:
    _require_params(params, "namespace", "object", "relation")
    return RelationTuple(
        namespace=params["namespace"],
        object=params["object"],
        relation=params["relation"],
        subject=subject_from_query(params, required=True),
    )


def _query_from_params(params) -> RelationQuery:
    return RelationQuery(
        namespace=params.get("namespace"),
        object=params.get("object"),
        relation=params.get("relation"),
        subject=subject_from_query(params, required=False),
    )


def _json_body(req: Request):
    try:
        return json.loads(req.body.decode("utf-8"))
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise ErrMalformedInput(f"invalid json body: {e}") from None


def _require_params(params, *keys) -> None:
    for key in keys:
        if params.get(key) is None:
            raise ErrMalformedInput(f"missing query parameter {key}")


def _dead_on_arrival(deadline: Optional[float]) -> None:
    if deadline is not None and time.monotonic() >= deadline:
        raise DeadlineExceeded()


def _trace_from_headers(req: Request) -> tuple[Optional[str], bool]:
    """(the raw W3C traceparent, whether this is a hedged duplicate) off the
    request headers, for the check telemetry's record."""
    return (
        req.headers.get(TRACEPARENT_HEADER),
        req.headers.get(HEDGE_HEADER) == "1",
    )


class ReadAPI:
    def __init__(
        self,
        manager,
        checker,
        snaptoken_fn,
        expand_engine=None,
        list_engine=None,
        version_waiter=None,
        max_freshness_wait_s=30.0,  # seconds, or a zero-argument callable
        encoded_front=None,
        default_criticality: str = "default",
        telemetry=None,
        replication_waiter=None,
    ):
        self.manager = manager
        # the follower's replication gate (replication/follower.py
        # wait_for_version): every read route with a snaptoken blocks until
        # replay passes it, else ErrFollowerLag (503, Retry-After, the lag).
        # None on a leader or standalone node
        self.replication_waiter = replication_waiter
        # the per-request check telemetry (span, exemplar, SLO, flight
        # record, attribution ledger); the no-op when none is wired in
        self.telemetry = telemetry or NOOP_CHECK_TELEMETRY
        # the id-native wire tier (api/encoded.EncodedCheckFront); None when
        # serve.read.encoded is off, and then its routes are not registered
        self.encoded_front = encoded_front
        self.checker = checker
        self.snaptoken_fn = snaptoken_fn
        self.expand_engine = expand_engine
        # reverse-index list serving (engine/listing.ListEngine); None when
        # serve.read.list is off or the check engine has no reverse index
        self.list_engine = list_engine
        # the list routes' snaptoken gate: engine.wait_for_version
        self.version_waiter = version_waiter
        self.max_freshness_wait_s = max_freshness_wait_s
        # the class of requests that carry no X-Request-Criticality header
        # (overload.default_criticality)
        self.default_criticality = default_criticality

    def register(self, router: Router) -> None:
        router.add("GET", ROUTE_TUPLES, self.get_relations)
        router.add("GET", ROUTE_CHECK, self.get_check)
        router.add("POST", ROUTE_CHECK, self.post_check)
        router.add("POST", ROUTE_CHECK_BATCH, self.post_check_batch)
        if self.encoded_front is not None:
            router.add("POST", ROUTE_CHECK_BATCH_ENCODED, self.post_check_batch_encoded)
            router.add("GET", ROUTE_VOCAB_SNAPSHOT, self.get_vocab_snapshot)
            router.add("GET", ROUTE_VOCAB_DELTAS, self.get_vocab_deltas)
        router.add("GET", ROUTE_PIPELINE, self.get_pipeline)
        if self.expand_engine is not None:
            router.add("GET", ROUTE_EXPAND, self.get_expand)
        if self.list_engine is not None:
            router.add("GET", ROUTE_LIST_OBJECTS, self.get_list_objects)
            router.add("GET", ROUTE_LIST_SUBJECTS, self.get_list_subjects)

    def _freshness_timeout(self, deadline: Optional[float]) -> float:
        cap = self.max_freshness_wait_s
        timeout = float(cap() if callable(cap) else cap)
        if deadline is not None:
            timeout = min(timeout, max(0.0, deadline - time.monotonic()))
        return timeout

    def _await_replication(self, min_version: int, deadline: Optional[float] = None) -> None:
        """A follower blocks until replication replays past ``min_version``
        (within the freshness cap and the caller's deadline); a no-op on a
        leader. It runs before the batcher, unclamped."""
        if self.replication_waiter is None or min_version <= 0:
            return
        self.replication_waiter(min_version, timeout_s=self._freshness_timeout(deadline))

    def _await_freshness(self, min_version: int, deadline: Optional[float]) -> None:
        """Block until the engine answers at >= min_version, within the
        freshness cap and the caller's deadline."""
        self._await_replication(min_version, deadline)
        if self.version_waiter is None or min_version <= 0:
            return
        self.version_waiter(min_version, timeout_s=self._freshness_timeout(deadline))

    def get_expand(self, req: Request) -> Response:
        p = req.query
        # snaptoken: validated; the snapshot expand engine reads the live
        # store version by construction, so any token is already satisfied
        # on a leader, and a follower waits for replay first
        self._await_replication(_min_version_from_query(p))
        _dead_on_arrival(deadline_from_headers(req))
        _require_params(p, "namespace", "object", "relation")
        subject = SubjectSet(
            namespace=p["namespace"], object=p["object"], relation=p["relation"]
        )
        depth = max_depth_from_query(p)
        page_token = p.get("page_token", "")
        page_size_raw = p.get("page_size")
        if page_size_raw is not None or page_token:
            # paged expand: the response shape changes only when the client
            # opted into paging
            try:
                page_size = int(page_size_raw) if page_size_raw else 0
            except ValueError:
                raise ErrMalformedInput(
                    f"malformed page_size: {page_size_raw!r}"
                ) from None
            page = self.expand_engine.build_tree_page(
                subject, depth, page_size=page_size, page_token=page_token
            )
            return json_response(page.to_dict())
        tree = self.expand_engine.build_tree(subject, depth)
        # a nil tree is null with 200, like the reference's herodot Write
        # of a nil pointer (expand/handler.go:90)
        return json_response(None if tree is None else tree.to_dict())

    def _list_response(self, req: Request, items_key: str, run) -> Response:
        p = req.query
        min_version = _min_version_from_query(p)
        try:
            size = int(p.get("page_size", "0"))
        except ValueError:
            raise ErrMalformedInput("page_size must be an integer") from None
        deadline = deadline_from_headers(req)
        _dead_on_arrival(deadline)
        traceparent, hedge = _trace_from_headers(req)
        with self.telemetry.record_check(
            "rest_list", deadline=deadline,
            detail={"namespace": p.get("namespace", "")},
            traceparent=traceparent, hedge=hedge,
        ) as rec:
            self._await_freshness(min_version, deadline)
            page = run(size, p.get("page_token", ""), deadline, rec)
            body = json.dumps(
                {
                    items_key: page.items,
                    "next_page_token": page.next_page_token,
                    "snaptoken": self.snaptoken_fn(),
                }
            ).encode()
            rec.mark("serialize")
        return Response(200, body)

    def get_list_objects(self, req: Request) -> Response:
        p = req.query
        _require_params(p, "namespace", "relation")
        subject = subject_from_query(p, required=True)
        depth = max_depth_from_query(p)
        return self._list_response(
            req,
            "objects",
            lambda size, token, deadline, rec: self.list_engine.list_objects(
                subject=subject,
                relation=p["relation"],
                namespace=p["namespace"],
                max_depth=depth,
                page_size=size,
                page_token=token,
                deadline=deadline,
                rec=rec,
            ),
        )

    def get_list_subjects(self, req: Request) -> Response:
        p = req.query
        _require_params(p, "namespace", "object", "relation")
        depth = max_depth_from_query(p)
        return self._list_response(
            req,
            "subject_ids",
            lambda size, token, deadline, rec: self.list_engine.list_subjects(
                namespace=p["namespace"],
                object=p["object"],
                relation=p["relation"],
                max_depth=depth,
                page_size=size,
                page_token=token,
                deadline=deadline,
                rec=rec,
            ),
        )

    def get_relations(self, req: Request) -> Response:
        p = req.query
        # snaptoken: validated, then trivially satisfied on a leader (listing
        # reads the live store); a follower waits for replay first
        self._await_replication(_min_version_from_query(p))
        query = _query_from_params(p)
        try:
            size = int(p.get("page_size", "0"))
        except ValueError:
            raise ErrMalformedInput("page_size must be an integer") from None
        tuples, next_token = self.manager.get_relation_tuples(
            query, PaginationOptions(token=p.get("page_token", ""), size=size)
        )
        return json_response(
            {
                "relation_tuples": [t.to_dict() for t in tuples],
                "next_page_token": next_token,
            }
        )

    def get_check(self, req: Request) -> Response:
        p = req.query
        tup = _tuple_from_query(p)
        return self._check_response(
            req, tup, max_depth_from_query(p), _min_version_from_query(p)
        )

    def post_check(self, req: Request) -> Response:
        tup = RelationTuple.from_dict(_json_body(req))
        p = req.query
        return self._check_response(
            req, tup, max_depth_from_query(p), _min_version_from_query(p)
        )

    def post_check_batch(self, req: Request) -> Response:
        """Many checks per request: a bare json array of relation tuples,
        {"tuples": [...], "max_depth": n}, or the columnar form
        {"namespaces": [...], "objects": [...], "relations": [...],
        "subject_ids": [...], "subject_set_namespaces": [...], ...} of
        parallel string arrays (no per-tuple objects on the hot path).
        Always 200, answers in request order with the snaptoken they were
        answered at."""
        body = _json_body(req)
        p = req.query
        max_depth = max_depth_from_query(p)
        min_version = _min_version_from_query(p)
        deadline = deadline_from_headers(req)
        _dead_on_arrival(deadline)
        traceparent, hedge = _trace_from_headers(req)
        if isinstance(body, dict) and "namespaces" in body:
            cols = CheckColumns.from_rest_body(body)
            max_depth = int(body.get("max_depth", max_depth) or max_depth)
            run = getattr(self.checker, "check_batch_columnar", None)
            with self.telemetry.record_check(
                "rest_batch", batch_size=len(cols), deadline=deadline,
                traceparent=traceparent, hedge=hedge,
            ) as rec:
                self._await_replication(min_version, deadline)
                if run is None:
                    allowed = self.checker.check_batch(
                        cols.materialize(), max_depth, min_version=min_version
                    )
                else:
                    allowed = run(cols, max_depth, min_version=min_version)
                # the body is serialized inside the record: the ledger's
                # serialize stage covers the json dump
                out = json.dumps({"allowed": allowed, "snaptoken": self.snaptoken_fn()})
                rec.mark("serialize")
            return Response(200, out.encode())
        if isinstance(body, dict):
            items = body.get("tuples")
            max_depth = int(body.get("max_depth", max_depth) or max_depth)
        else:
            items = body
        if not isinstance(items, list):
            raise ErrMalformedInput("expected a json array of relation tuples")
        tuples = [RelationTuple.from_dict(d) for d in items]
        with self.telemetry.record_check(
            "rest_batch", batch_size=len(tuples), deadline=deadline,
            traceparent=traceparent, hedge=hedge,
        ) as rec:
            self._await_replication(min_version, deadline)
            allowed = self.checker.check_batch(
                tuples, max_depth, min_version=min_version, deadline=deadline,
                criticality=criticality_from_headers(req, self.default_criticality),
            )
            out = json.dumps({"allowed": allowed, "snaptoken": self.snaptoken_fn()})
            rec.mark("serialize")
        return Response(200, out.encode())

    def post_check_batch_encoded(self, req: Request) -> Response:
        """The id-native wire tier: the body is a raw ``wirecodec`` frame of
        pre-encoded int32 (start, target) columns tagged with the client's
        vocab lineage and epoch; the answer is the codec's bitset frame. An
        epoch mismatch is a typed 409 with the resync hint in the JSON
        error envelope."""
        frame = wirecodec.decode_check_request(req.body)
        deadline = deadline_from_headers(req)
        _dead_on_arrival(deadline)
        timeout = None if deadline is None else max(0.0, deadline - time.monotonic())
        # the bitset frame is packed inside the record, so the ledger's
        # serialize stage covers it
        with self.telemetry.record_check(
            "rest-encoded", batch_size=len(frame.start), deadline=deadline,
            traceparent=frame.traceparent,
        ) as rec:
            self._await_replication(frame.min_version, deadline)
            allowed = self.encoded_front.check(frame, timeout=timeout)
            payload = wirecodec.encode_check_response(allowed, self.snaptoken_fn())
            rec.mark("serialize")
        return Response(200, payload, "application/octet-stream")

    def get_vocab_snapshot(self, req: Request) -> Response:
        """Vocab bootstrap for encoded-wire clients: one page of the
        append-only key list plus the (lineage, epoch) it was read at.
        Clients page with offset/limit, then follow ``/vocab/deltas``."""
        p = req.query
        try:
            offset = int(p.get("offset", "0"))
            limit = int(p.get("limit", "200000"))
        except ValueError:
            raise ErrMalformedInput("offset/limit must be integers") from None
        page = vocabsync.snapshot_page(self.encoded_front.vocab(), offset, limit)
        page["snaptoken"] = self.snaptoken_fn()
        return json_response(page)

    def get_vocab_deltas(self, req: Request) -> Response:
        """Incremental vocab catch-up: keys interned since ``from`` on
        lineage ``lineage``. A lineage mismatch is the same typed 409 the
        encoded check uses: the client re-bootstraps."""
        p = req.query
        try:
            from_epoch = int(p.get("from", "0"))
        except ValueError:
            raise ErrMalformedInput("from must be an integer") from None
        page = vocabsync.delta_page(
            self.encoded_front.vocab(), p.get("lineage", ""), from_epoch
        )
        page["snaptoken"] = self.snaptoken_fn()
        return json_response(page)

    def get_pipeline(self, req: Request) -> Response:
        """The check batcher's queue and stage occupancy as one object."""
        stats_fn = getattr(self.checker, "pipeline_stats", None)
        return json_response(stats_fn() if callable(stats_fn) else {"pipelined": False})

    def _check_response(
        self, req: Request, tup: RelationTuple, max_depth: int, min_version: int
    ) -> Response:
        deadline = deadline_from_headers(req)
        criticality = criticality_from_headers(req, self.default_criticality)
        traceparent, hedge = _trace_from_headers(req)
        with self.telemetry.record_check(
            "rest", deadline=deadline, detail={"namespace": tup.namespace},
            traceparent=traceparent, hedge=hedge,
        ) as rec:
            self._await_replication(min_version, deadline)
            allowed = self.checker.check(
                tup, max_depth, min_version=min_version, deadline=deadline,
                criticality=criticality,
            )
            body = json.dumps({"allowed": allowed}).encode()
            rec.mark("serialize")
        # 200 when allowed, 403 when denied — both carry the body
        return Response(200 if allowed else 403, body)


class WriteAPI:
    def __init__(self, manager, read_only=False, leader_hint_fn=None):
        self.manager = manager
        # a follower serves this port (health, version, replication) but
        # rejects mutations: writes belong on the leader. A callable is asked
        # per request: an elected node turns writable the moment it holds the
        # lease, a fenced ex-leader read-only the moment it loses it
        self.read_only = read_only
        # () -> {"write_url", ...} | None: a rejected writer learns where the
        # leader lives from the 503's envelope instead of probing again
        self.leader_hint_fn = leader_hint_fn

    def register(self, router: Router) -> None:
        router.add("PUT", ROUTE_TUPLES, self.create_relation)
        router.add("DELETE", ROUTE_TUPLES, self.delete_relations)
        router.add("PATCH", ROUTE_TUPLES, self.patch_relations)

    def _reject_if_read_only(self) -> None:
        ro = self.read_only() if callable(self.read_only) else self.read_only
        if ro:
            hint = None
            if self.leader_hint_fn is not None:
                try:
                    hint = self.leader_hint_fn()
                except Exception:
                    hint = None
            raise ErrReadOnlyFollower(leader_hint=hint)

    def create_relation(self, req: Request) -> Response:
        self._reject_if_read_only()
        body = _json_body(req)
        if not isinstance(body, dict):
            raise ErrMalformedInput("expected a json relation-tuple object")
        tup = RelationTuple.from_dict(body)
        self.manager.write_relation_tuples(tup)
        location = ROUTE_TUPLES + "?" + _tuple_location_query(tup)
        return json_response(tup.to_dict(), 201, {"Location": location})

    def delete_relations(self, req: Request) -> Response:
        self._reject_if_read_only()
        self.manager.delete_all_relation_tuples(_query_from_params(req.query))
        return Response(204)

    def patch_relations(self, req: Request) -> Response:
        self._reject_if_read_only()
        body = _json_body(req)
        if not isinstance(body, list):
            raise ErrMalformedInput("expected a json array of deltas")
        inserts: list[RelationTuple] = []
        deletes: list[RelationTuple] = []
        for delta in body:
            if not isinstance(delta, dict):
                raise ErrMalformedInput("expected delta object")
            action = delta.get("action")
            tup = RelationTuple.from_dict(delta.get("relation_tuple") or {})
            if action == "insert":
                inserts.append(tup)
            elif action == "delete":
                deletes.append(tup)
            else:
                # an unknown action is a 400 and nothing is applied
                raise ErrMalformedInput(f"unknown action {action!r}")
        self.manager.transact_relation_tuples(inserts, deletes)
        return Response(204)


def _tuple_location_query(t: RelationTuple) -> str:
    q = {"namespace": t.namespace, "object": t.object, "relation": t.relation}
    if isinstance(t.subject, SubjectID):
        q["subject_id"] = t.subject.id
    else:
        q["subject_set.namespace"] = t.subject.namespace
        q["subject_set.object"] = t.subject.object
        q["subject_set.relation"] = t.subject.relation
    return urlencode(q)


def register_common(router: Router, version: str, healthy_fn=None, metrics=None) -> None:
    """/health/alive, /health/ready and /version on both ports, and /metrics
    with a metrics registry."""

    def alive(_req):
        return json_response({"status": "ok"})

    def ready(_req):
        if healthy_fn is not None and not healthy_fn():
            return json_response({"errors": {"server": "not ready"}}, 503)
        return json_response({"status": "ok"})

    def get_version(_req):
        return json_response({"version": version})

    router.add("GET", "/health/alive", alive)
    router.add("GET", "/health/ready", ready)
    router.add("GET", "/version", get_version)
    if metrics is None:
        return

    def get_metrics(req):
        # OpenMetrics (exemplars and "# EOF") only when the scraper asks
        # for it: a plain text scrape stays Prometheus text 0.0.4
        if "application/openmetrics-text" in req.headers.get("accept", ""):
            return Response(
                200, metrics.expose(openmetrics=True).encode(),
                "application/openmetrics-text; version=1.0.0; charset=utf-8",
            )
        return Response(200, metrics.expose().encode(), "text/plain; charset=utf-8")

    router.add("GET", "/metrics", get_metrics)


def _json_default(doc) -> Response:
    """A status document as JSON, with anything json cannot spell as its
    ``str`` (the reference's ``default=str`` round trip)."""
    return json_response(json.loads(json.dumps(doc, default=str)))


def build_read_router(
    manager, checker, snaptoken_fn, version: str, healthy_fn=None,
    cors: Optional[dict] = None, metrics=None, logger=None,
    cluster_status_fn=None, **read_kw,
):
    """The read plane's routes; ``read_kw`` goes to ReadAPI (the expand and
    list engines, the list routes' snaptoken gate, the follower's
    replication gate, the check telemetry). ``cluster_status_fn`` serves
    ``/cluster/status``, the fleet's health rollup, public as /metrics."""
    router = Router(cors, plane="read", metrics=metrics, logger=logger)
    ReadAPI(manager, checker, snaptoken_fn, **read_kw).register(router)
    register_common(router, version, healthy_fn, metrics)
    if cluster_status_fn is not None:
        router.add("GET", "/cluster/status", lambda _req: _json_default(cluster_status_fn()))
    return router


_NOT_LEADER = {"error": "not the replication leader"}


def build_write_router(
    manager, version: str, healthy_fn=None, cors: Optional[dict] = None,
    metrics=None, logger=None, read_only=False, leader_hint_fn=None,
    replication_source=None, replication_source_fn=None,
    replication_status_fn=None, cluster_membership=None, directives_fn=None,
):
    """The write plane's routes, and the fleet's:

    - a leader's ``replication_source`` registers ``/replication/*``;
    - an election-enabled follower (``replication_source_fn``) registers
      ``/replication/{status,checkpoint,wal}`` that delegate per request:
      503 (or its lag view) until a promotion installs a source;
    - a plain follower (``replication_status_fn``) serves its lag view at
      ``/replication/status`` for the federation scraper;
    - a leader's ``cluster_membership`` takes ``POST /cluster/heartbeat``,
      whose reply carries ``directives_fn()``'s fleet orders."""
    router = Router(cors, plane="write", metrics=metrics, logger=logger)
    WriteAPI(manager, read_only=read_only, leader_hint_fn=leader_hint_fn).register(router)
    register_common(router, version, healthy_fn, metrics)
    if replication_source is not None:
        replication_source.register(router)
    elif replication_source_fn is not None:

        def repl_status(req):
            src = replication_source_fn()
            if src is not None:
                return src.handle_status(req)
            if replication_status_fn is not None:
                return _json_default(replication_status_fn())
            return json_response({"role": "follower"})

        def delegate(name):
            def route(req):
                src = replication_source_fn()
                if src is None:
                    return json_response(_NOT_LEADER, 503)
                return getattr(src, name)(req)

            return route

        router.add("GET", "/replication/status", repl_status)
        router.add("GET", "/replication/checkpoint", delegate("handle_checkpoint"))
        router.add("GET", "/replication/wal", delegate("handle_wal"))
    elif replication_status_fn is not None:
        router.add("GET", "/replication/status",
                   lambda _req: _json_default(replication_status_fn()))
    if cluster_membership is not None:

        def heartbeat(req):
            try:
                payload = json.loads(req.body.decode("utf-8"))
                if not isinstance(payload, dict):
                    raise ValueError("heartbeat body must be an object")
                row = cluster_membership.upsert(payload)
            except Exception as e:
                raise ErrMalformedInput(str(e)) from None
            reply = {"ok": True, "heartbeats": row["heartbeats"]}
            if directives_fn is not None:
                try:
                    reply["directives"] = directives_fn()
                except Exception:
                    pass
            return json_response(reply)

        router.add("POST", "/cluster/heartbeat", heartbeat)
    return router
