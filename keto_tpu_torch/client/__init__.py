"""Client SDK: typed Python clients for the REST and gRPC APIs (counterpart
of ``keto_tpu/client/__init__.py``).

- ``RestClient`` — the REST surface (check, hedged check, batch check as
  tuples, as columns and as encoded frames, expand, the list routes,
  relation-tuple CRUD with pagination, health, version, metrics), returning
  domain objects (RelationTuple, Tree) and raising the KetoError taxonomy
  the server maps from. It runs on ``http.client``: one keep-alive
  connection per thread and server, replaced before a request when the
  server has closed it, so a loop of single checks pays one TCP handshake,
  not one per check.
- ``GrpcClient`` (``client/grpc_client.py``) — the five
  ``ory.keto.acl.v1alpha1`` services. It is exported lazily: this package
  imports where grpc is not installed, and ``RestClient`` works there.
- ``RetryPolicy``/``RetryBudget`` (``retry.py``) and ``HedgePolicy``/
  ``Hedger``/``EndpointRouter`` (``hedge.py``): the client half of the
  overload plane.

- ``ReplicatedRestClient`` — reads fanned across a replicated read fleet,
  snaptoken-aware (a replica known to be past the token is preferred, a
  hedge lands on a different replica), and writes that follow the leader
  (a 503 with a ``leader_hint`` retargets and retries once).
"""

from __future__ import annotations

import http.client
import json
import select
import threading
from dataclasses import dataclass
from typing import Iterable, Optional, Sequence
from urllib.parse import urlencode, urlsplit

from ..engine.tree import Tree
from ..relationtuple.columns import CheckColumns
from ..relationtuple.definitions import (
    RelationQuery,
    RelationTuple,
    Subject,
    SubjectID,
    SubjectSet,
)
from ..telemetry.tracing import (
    HEDGE_HEADER,
    TRACEPARENT_HEADER,
    current_traceparent,
    mint_traceparent,
)
from ..utils.errors import (
    ErrFollowerLag,
    ErrForbidden,
    ErrInternal,
    ErrMalformedInput,
    ErrNotFound,
    ErrReadOnlyFollower,
    ErrResourceExhausted,
    ErrStalePageToken,
    ErrUnavailable,
    KetoError,
)
from ..utils.urlfetch import ssl_context
from .hedge import EndpointRouter, HedgePolicy, Hedger
from .retry import RETRYABLE_HTTP_STATUS, RetryBudget, RetryPolicy, run_with_retry
from .vocabcache import VocabCache, batch_check_encoded

#: REST header / gRPC metadata key carrying the overload brownout ladder's
#: criticality class (critical | default | sheddable)
CRITICALITY_HEADER = "X-Request-Criticality"
CRITICALITY_METADATA_KEY = "x-keto-criticality"

__all__ = [
    "RestClient",
    "GrpcClient",
    "ReplicatedRestClient",
    "CheckResult",
    "TuplePage",
    "ListResult",
    "RetryPolicy",
    "RetryBudget",
    "HedgePolicy",
    "Hedger",
    "EndpointRouter",
    "VocabCache",
    "batch_check_encoded",
    "RETRYABLE_HTTP_STATUS",
    "CRITICALITY_HEADER",
    "CRITICALITY_METADATA_KEY",
]

def __getattr__(name: str):
    # the gRPC client imports grpc: reach it only when it is asked for
    if name == "GrpcClient":
        from .grpc_client import GrpcClient

        return GrpcClient
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _snaptoken_version(snaptoken: str) -> int:
    """Snaptoken -> minimum store version (the encoded wire frame carries
    the version number, not the token string; the replicated client routes
    by it): a structured ``z<v>.<s>.<o>`` token or a bare version
    (replication/token.py). Anything else is 0 (the server 400s it)."""
    if not snaptoken:
        return 0
    from ..replication.token import parse_snaptoken

    try:
        return parse_snaptoken(snaptoken).version
    except ValueError:
        return 0


@dataclass(frozen=True)
class CheckResult:
    allowed: bool
    snaptoken: str = ""
    # the W3C traceparent this check was sent under — the client mints one
    # per request, so callers can correlate with the server's records
    traceparent: str = ""


def _trace_headers(traceparent: Optional[str], hedge: bool) -> tuple[str, dict]:
    """(traceparent_used, headers) for one check attempt: reuse the given
    traceparent (hedged duplicate), else continue any active span's trace,
    else mint a fresh root. Duplicates carry ``x-keto-hedge: 1``."""
    tp = traceparent or current_traceparent() or mint_traceparent()
    headers = {TRACEPARENT_HEADER: tp}
    if hedge:
        headers[HEDGE_HEADER] = "1"
    return tp, headers


@dataclass(frozen=True)
class TuplePage:
    relation_tuples: list[RelationTuple]
    next_page_token: str


@dataclass(frozen=True)
class ListResult:
    """One page of a list-objects / list-subjects answer: sorted object
    names or subject-id strings, a continuation token ("" on the last
    page), and the snaptoken the page was served at."""

    items: list[str]
    next_page_token: str = ""
    snaptoken: str = ""


def _error_for(status_code: int, body: dict, headers=None) -> KetoError:
    """The KetoError of a non-answer HTTP status, with the server's
    Retry-After hint as ``retry_after_s`` (run_with_retry floors its backoff
    on it). A 503 whose details carry a ``leader_hint`` (a read-only
    follower, or an ex-leader fenced mid-election) is ErrReadOnlyFollower,
    so the write path can follow it; one with the lag details is
    ErrFollowerLag."""
    err = body.get("error") or {} if isinstance(body, dict) else {}
    message = err.get("message", "")
    details = err.get("details") or {}
    hint = details.get("leader_hint")
    if status_code == 503 and isinstance(hint, dict):
        return ErrReadOnlyFollower(message or None, leader_hint=hint)
    if status_code == 503 and "lag_versions" in details:
        e = ErrFollowerLag(
            message or None,
            lag_versions=details.get("lag_versions") or 0,
            lag_seconds=details.get("lag_seconds") or 0.0,
        )
        _retry_after_from(e, headers)
        return e
    cls = {
        400: ErrMalformedInput,
        403: ErrForbidden,
        404: ErrNotFound,
        409: ErrStalePageToken,
        429: ErrResourceExhausted,
        503: ErrUnavailable,
    }.get(status_code, ErrInternal)
    e = cls(message or None)
    _retry_after_from(e, headers)
    return e


def _retry_after_from(e: KetoError, headers) -> None:
    if headers is None:
        return
    ra = headers.get("Retry-After") or headers.get("retry-after")
    if ra is not None:
        try:
            e.retry_after_s = max(0.0, float(ra))
        except (TypeError, ValueError):
            pass


def _subject_params(subject: Subject, prefix: str = "") -> dict:
    if isinstance(subject, SubjectID):
        return {f"{prefix}subject_id": subject.id}
    return {
        f"{prefix}subject_set.namespace": subject.namespace,
        f"{prefix}subject_set.object": subject.object,
        f"{prefix}subject_set.relation": subject.relation,
    }


def _as_tuple(t: RelationTuple | str) -> RelationTuple:
    return RelationTuple.from_string(t) if isinstance(t, str) else t


class Response:
    """One HTTP answer: status, headers (case-insensitive ``get``), body."""

    __slots__ = ("status_code", "headers", "content")

    def __init__(self, status_code: int, headers, content: bytes):
        self.status_code = status_code
        self.headers = headers
        self.content = content

    @property
    def text(self) -> str:
        return self.content.decode("utf-8", "replace")

    def json(self):
        return json.loads(self.content) if self.content else None


class _Pool:
    """Keep-alive connections: one per (thread, scheme, host, port). A kept
    connection whose socket the server has closed (an idle keep-alive
    timed out) is replaced before the request goes out, as httpx's pool
    does. A request that has gone out is never sent again here: a failure
    after that raises, and ``RestClient._request`` retries reads only."""

    def __init__(self, timeout: float, verify):
        self.timeout = timeout
        self.verify = verify
        self._ssl = None  # built at the first https connection
        self._local = threading.local()
        self._all: list = []
        self._lock = threading.Lock()

    def _connect(self, scheme: str, host: str, port: int):
        if scheme == "https":
            if self._ssl is None:
                self._ssl = ssl_context(self.verify)
            return http.client.HTTPSConnection(host, port, timeout=self.timeout,
                                               context=self._ssl)
        return http.client.HTTPConnection(host, port, timeout=self.timeout)

    def _conn(self, key):
        conns = self._local.__dict__.setdefault("conns", {})
        conn = conns.get(key)
        if conn is not None:
            # an idle keep-alive socket that reads as ready holds the
            # server's FIN (or stray bytes): it cannot carry a request
            if conn.sock is None or not select.select([conn.sock], [], [], 0)[0]:
                return conn
            conn.close()
        conn = self._connect(*key)
        conns[key] = conn
        with self._lock:
            self._all.append(conn)
        return conn

    def request(self, method: str, url: str, params=None, body: Optional[bytes] = None,
                headers: Optional[dict] = None) -> Response:
        parts = urlsplit(url)
        scheme = parts.scheme or "http"
        key = (scheme, parts.hostname or "127.0.0.1",
               parts.port or (443 if scheme == "https" else 80))
        target = parts.path or "/"
        query = urlencode(params) if params else ""
        if parts.query:
            query = parts.query + ("&" + query if query else "")
        if query:
            target += "?" + query
        conn = self._conn(key)
        try:
            conn.request(method, target, body=body, headers=headers or {})
            resp = conn.getresponse()
            data = resp.read()
        except BaseException:
            conn.close()
            self._local.conns.pop(key, None)
            raise
        if resp.will_close:
            conn.close()
            self._local.conns.pop(key, None)
        return Response(resp.status, resp.headers, data)

    def close(self) -> None:
        with self._lock:
            conns, self._all = self._all, []
        for conn in conns:
            conn.close()


class RestClient:
    """The REST surface over ``http.client``. ``read_url``/``write_url``
    like ``http://127.0.0.1:4466`` (no trailing slash needed), or
    ``https://``; ``verify`` is httpx's: True (the system's CAs), False, a CA
    bundle file or directory, or an ``ssl.SSLContext``."""

    def __init__(
        self,
        read_url: str,
        write_url: Optional[str] = None,
        timeout: float = 30.0,
        verify=True,
        retry: Optional[RetryPolicy] = None,
        retry_budget: Optional[RetryBudget] = None,
        criticality: Optional[str] = None,  # default shed class for checks
    ):
        self.read_url = read_url.rstrip("/")
        self.write_url = (write_url or read_url).rstrip("/")
        self.timeout = timeout
        self.retry = RetryPolicy() if retry is None else retry
        # shared across every call of this instance: retries are capped at
        # ~10% of request volume so a sustained shed cannot be amplified
        # into a retry storm (engine/overload.py is the server half)
        self.retry_budget = RetryBudget() if retry_budget is None else retry_budget
        self.criticality = criticality
        self._http = _Pool(timeout, verify)

    def close(self) -> None:
        self._http.close()

    def __enter__(self) -> "RestClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- internals -------------------------------------------------------------

    def _request(self, method: str, url: str, ok=(200,), params=None, json_body=None,
                 content: Optional[bytes] = None, headers: Optional[dict] = None):
        # 429/503 are shed-before-work signals and safe to retry for ANY
        # method; transport failures (a refused connection around a replica
        # restart) are retried for reads only — a write whose response was
        # lost may have been applied
        read_method = method.upper() in ("GET", "HEAD")
        headers = dict(headers or {})
        if json_body is not None:
            content = json.dumps(json_body).encode()
            headers.setdefault("Content-Type", "application/json")

        def retryable(e: BaseException) -> bool:
            if isinstance(e, (ErrResourceExhausted, ErrUnavailable)):
                return True
            return read_method and isinstance(e, (OSError, http.client.HTTPException))

        def attempt(_remaining):
            resp = self._http.request(method, url, params, content, headers)
            if resp.status_code not in ok:
                try:
                    body = resp.json() or {}
                except ValueError:
                    body = {}
                raise _error_for(resp.status_code, body, resp.headers)
            return resp

        return run_with_retry(
            attempt, self.retry, retryable, timeout=self.timeout,
            budget=self.retry_budget,
        )

    def _check_headers(self, traceparent, hedge, criticality) -> tuple[str, dict]:
        tp, headers = _trace_headers(traceparent, hedge)
        crit = criticality or self.criticality
        if crit:
            headers[CRITICALITY_HEADER] = crit
        return tp, headers

    # -- read plane ------------------------------------------------------------

    def check(
        self,
        tuple_or_str: RelationTuple | str,
        max_depth: int = 0,
        snaptoken: str = "",
        latest: bool = False,
        traceparent: Optional[str] = None,
        hedge: bool = False,
        criticality: Optional[str] = None,
    ) -> CheckResult:
        """200 and 403 are both answers (allowed true/false); other codes
        raise. ``snaptoken``/``latest`` request at-least-as-fresh
        evaluation. Every check carries a W3C ``traceparent`` header (minted
        here unless supplied); ``hedge`` tags the request as a hedged
        duplicate; ``criticality`` (or the client's default) tags its shed
        class for the server's brownout ladder."""
        t = _as_tuple(tuple_or_str)
        params = {
            "namespace": t.namespace,
            "object": t.object,
            "relation": t.relation,
            **_subject_params(t.subject),
        }
        if max_depth:
            params["max-depth"] = str(max_depth)
        if snaptoken:
            params["snaptoken"] = snaptoken
        if latest:
            params["latest"] = "true"
        tp, headers = self._check_headers(traceparent, hedge, criticality)
        resp = self._request(
            "GET", f"{self.read_url}/check", ok=(200, 403), params=params,
            headers=headers,
        )
        return CheckResult(allowed=bool(resp.json().get("allowed")), traceparent=tp)

    def check_hedged(
        self,
        tuple_or_str: RelationTuple | str,
        hedger: Hedger,
        max_depth: int = 0,
        snaptoken: str = "",
        latest: bool = False,
    ):
        """One hedged check through ``hedger``: the primary and any fired
        duplicate share ONE traceparent, and the duplicate alone carries
        ``x-keto-hedge: 1``. The duplicate runs on another hedger thread,
        so on a connection of its own. Returns the hedger's HedgedCall
        (``.result`` is the CheckResult)."""
        tp = current_traceparent() or mint_traceparent()

        def attempt(is_hedge: bool):
            return self.check(
                tuple_or_str, max_depth, snaptoken, latest, traceparent=tp,
                hedge=is_hedge,
            )

        return hedger.call(lambda: attempt(False), hedge=lambda: attempt(True))

    def _batch(self, body: dict, max_depth, snaptoken, latest, traceparent,
               criticality) -> list[bool]:
        if max_depth:
            body["max_depth"] = max_depth
        params = {}
        if snaptoken:
            params["snaptoken"] = snaptoken
        if latest:
            params["latest"] = "true"
        _, headers = self._check_headers(traceparent, False, criticality)
        resp = self._request(
            "POST", f"{self.read_url}/check/batch", json_body=body, params=params,
            headers=headers,
        )
        return [bool(v) for v in resp.json()["allowed"]]

    def batch_check(
        self,
        tuples: Sequence[RelationTuple | str],
        max_depth: int = 0,
        snaptoken: str = "",
        latest: bool = False,
        traceparent: Optional[str] = None,
        criticality: Optional[str] = None,
    ) -> list[bool]:
        """The /check/batch transport: many checks, one request.
        ``snaptoken``/``latest`` apply to the whole batch."""
        body = {"tuples": [_as_tuple(t).to_dict() for t in tuples]}
        return self._batch(body, max_depth, snaptoken, latest, traceparent, criticality)

    def batch_check_columns(
        self,
        columns: CheckColumns | Sequence[RelationTuple | str],
        max_depth: int = 0,
        snaptoken: str = "",
        latest: bool = False,
        traceparent: Optional[str] = None,
        criticality: Optional[str] = None,
    ) -> list[bool]:
        """/check/batch with the columnar body (parallel string arrays, no
        per-tuple objects on either side)."""
        if not isinstance(columns, CheckColumns):
            columns = CheckColumns.from_tuples([_as_tuple(t) for t in columns])
        body = {c: getattr(columns, c) for c in CheckColumns.__slots__}
        return self._batch(body, max_depth, snaptoken, latest, traceparent, criticality)

    def batch_check_encoded(
        self,
        cache: VocabCache,
        tuples: Sequence[RelationTuple | str],
        snaptoken: str = "",
        traceparent: Optional[str] = None,
        max_resyncs: int = 2,
    ) -> list[bool]:
        """The id-native transport: tuples are vocab-encoded locally against
        ``cache`` and shipped as packed int32 columns (``POST
        /check/batch-encoded``). A write landing between encode and send
        bumps the server's vocab epoch; the typed 409 makes the cache
        re-sync and the batch is re-encoded and re-sent (at most
        ``max_resyncs`` times)."""
        from ..api import wirecodec

        mv = _snaptoken_version(snaptoken)
        tp, headers = _trace_headers(traceparent, hedge=False)
        headers["Content-Type"] = "application/octet-stream"
        for attempt in range(max_resyncs + 1):
            frame = cache.frame(tuples, min_version=mv, traceparent=tp)
            resp = self._http.request(
                "POST", f"{self.read_url}/check/batch-encoded", body=frame,
                headers=headers,
            )
            if resp.status_code == 200:
                allowed, _tok = wirecodec.decode_check_response(resp.content)
                return [bool(v) for v in allowed]
            if resp.status_code == 409 and attempt < max_resyncs:
                cache.sync()
                continue
            try:
                body = resp.json() or {}
            except ValueError:
                body = {}
            raise _error_for(resp.status_code, body)
        raise ErrUnavailable("encoded batch check exhausted resyncs")

    def vocab_cache(self, **kw) -> VocabCache:
        """A VocabCache over this client's read plane, with its ``verify``."""
        kw.setdefault("timeout", self.timeout)
        kw.setdefault("verify", self._http.verify)
        return VocabCache(self.read_url, **kw)

    def expand(self, subject_set: SubjectSet, max_depth: int = 0) -> Optional[Tree]:
        params = {
            "namespace": subject_set.namespace,
            "object": subject_set.object,
            "relation": subject_set.relation,
        }
        if max_depth:
            params["max-depth"] = str(max_depth)
        doc = self._request("GET", f"{self.read_url}/expand", params=params).json()
        return None if doc is None else Tree.from_dict(doc)

    @staticmethod
    def _list_params(base: dict, max_depth: int, page_size: int, page_token: str,
                     snaptoken: str, latest: bool) -> dict:
        if max_depth:
            base["max-depth"] = str(max_depth)
        if page_size:
            base["page_size"] = str(page_size)
        if page_token:
            base["page_token"] = page_token
        if snaptoken:
            base["snaptoken"] = snaptoken
        if latest:
            base["latest"] = "true"
        return base

    def list_objects(
        self,
        subject: Subject | str,
        relation: str,
        namespace: str,
        max_depth: int = 0,
        page_size: int = 0,
        page_token: str = "",
        snaptoken: str = "",
        latest: bool = False,
    ) -> ListResult:
        """Every object the subject holds ``relation`` on in ``namespace``.
        A stale ``page_token`` (a write landed between pages) raises
        :class:`ErrStalePageToken`; restart from the first page."""
        if isinstance(subject, str):
            subject = SubjectID(id=subject)
        params = {"namespace": namespace, "relation": relation}
        params.update(_subject_params(subject))
        doc = self._request(
            "GET", f"{self.read_url}/relation-tuples/list-objects",
            params=self._list_params(params, max_depth, page_size, page_token,
                                     snaptoken, latest),
        ).json()
        return ListResult(
            items=doc.get("objects", []),
            next_page_token=doc.get("next_page_token", ""),
            snaptoken=doc.get("snaptoken", ""),
        )

    def list_subjects(
        self,
        namespace: str,
        object: str,
        relation: str,
        max_depth: int = 0,
        page_size: int = 0,
        page_token: str = "",
        snaptoken: str = "",
        latest: bool = False,
    ) -> ListResult:
        """Every subject id ``namespace:object#relation`` resolves to (see
        :meth:`list_objects` for paging)."""
        doc = self._request(
            "GET", f"{self.read_url}/relation-tuples/list-subjects",
            params=self._list_params(
                {"namespace": namespace, "object": object, "relation": relation},
                max_depth, page_size, page_token, snaptoken, latest,
            ),
        ).json()
        return ListResult(
            items=doc.get("subject_ids", []),
            next_page_token=doc.get("next_page_token", ""),
            snaptoken=doc.get("snaptoken", ""),
        )

    def get_relation_tuples(
        self,
        query: Optional[RelationQuery] = None,
        page_size: int = 0,
        page_token: str = "",
    ) -> TuplePage:
        params: dict = {}
        if query is not None:
            for k in ("namespace", "object", "relation"):
                v = getattr(query, k)
                if v is not None:
                    params[k] = v
            if query.subject is not None:
                params.update(_subject_params(query.subject))
        if page_size:
            params["page_size"] = str(page_size)
        if page_token:
            params["page_token"] = page_token
        doc = self._request("GET", f"{self.read_url}/relation-tuples",
                            params=params).json()
        return TuplePage(
            relation_tuples=[RelationTuple.from_dict(d) for d in doc["relation_tuples"]],
            next_page_token=doc.get("next_page_token", ""),
        )

    def iter_relation_tuples(
        self, query: Optional[RelationQuery] = None, page_size: int = 0
    ) -> Iterable[RelationTuple]:
        """Auto-paginating iterator over matching tuples."""
        token = ""
        while True:
            page = self.get_relation_tuples(query, page_size=page_size, page_token=token)
            yield from page.relation_tuples
            token = page.next_page_token
            if not token:
                return

    # -- write plane -----------------------------------------------------------

    def create_relation_tuple(self, t: RelationTuple | str) -> RelationTuple:
        resp = self._request(
            "PUT", f"{self.write_url}/relation-tuples", ok=(201,),
            json_body=_as_tuple(t).to_dict(),
        )
        return RelationTuple.from_dict(resp.json())

    def delete_relation_tuples(self, query: RelationQuery) -> None:
        params: dict = {}
        for k in ("namespace", "object", "relation"):
            v = getattr(query, k)
            if v is not None:
                params[k] = v
        if query.subject is not None:
            params.update(_subject_params(query.subject))
        self._request("DELETE", f"{self.write_url}/relation-tuples", ok=(204,),
                      params=params)

    def patch_relation_tuples(
        self,
        insert: Sequence[RelationTuple] = (),
        delete: Sequence[RelationTuple] = (),
    ) -> None:
        """Atomic insert+delete transaction (PATCH deltas)."""
        deltas = [
            {"action": "insert", "relation_tuple": t.to_dict()} for t in insert
        ] + [{"action": "delete", "relation_tuple": t.to_dict()} for t in delete]
        self._request("PATCH", f"{self.write_url}/relation-tuples", ok=(204,),
                      json_body=deltas)

    # -- common ----------------------------------------------------------------

    def version(self) -> str:
        return self._request("GET", f"{self.read_url}/version").json()["version"]

    def alive(self) -> bool:
        return self._http.request("GET", f"{self.read_url}/health/alive").status_code == 200

    def ready(self) -> bool:
        return self._http.request("GET", f"{self.read_url}/health/ready").status_code == 200

    def metrics(self) -> str:
        """``GET /metrics``: the server's Prometheus text exposition."""
        return self._request("GET", f"{self.read_url}/metrics").text


class ReplicatedRestClient:
    """Reads fanned across a replicated read fleet, snaptoken-aware.

    One ``RestClient`` per read endpoint (followers and/or the leader's read
    plane) and one write endpoint (the leader). Reads route through an
    ``EndpointRouter``: the primary prefers a replica already known to have
    replayed past the request's snaptoken (so the server's freshness wait is
    a no-op), and any hedge the ``Hedger`` fires lands on a different
    replica.

    The router learns from routed traffic: a successful at-least-token read
    proves the endpoint reached that version; a shed or unavailable answer
    (the follower's typed lag bounce too) adds a decaying penalty.
    ``refresh_cluster_view`` folds a ``/cluster/status`` rollup in: red
    members demoted, the leader remembered. Writes follow the leader: a 503
    carrying a ``leader_hint`` (a read-only follower, or an ex-leader fenced
    mid-election) retargets the write endpoint and retries once, so a
    leadership change costs one round trip, not an outage.
    """

    def __init__(
        self,
        read_urls: Sequence[str],
        write_url: Optional[str] = None,
        timeout: float = 30.0,
        verify=True,
        retry: Optional[RetryPolicy] = None,
        hedger: Optional[Hedger] = None,
        router: Optional[EndpointRouter] = None,
    ):
        self.router = router or EndpointRouter(read_urls)
        self._clients = {
            ep: RestClient(ep, write_url=write_url, timeout=timeout, verify=verify,
                           retry=retry)
            for ep in self.router.endpoints
        }
        self._own_hedger = hedger is None
        self._hedger = hedger or Hedger()
        # any client reaches the one write endpoint; keep one handle
        self._writer = self._clients[self.router.endpoints[0]]

    def close(self) -> None:
        if self._own_hedger:
            self._hedger.close()
        for c in self._clients.values():
            c.close()

    def __enter__(self) -> "ReplicatedRestClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _routed(self, endpoint: str, min_version: int, fn):
        """Run one attempt against ``endpoint`` and feed the router."""
        try:
            result = fn(self._clients[endpoint])
        except (ErrResourceExhausted, ErrUnavailable):
            self.router.observe_error(endpoint)
            raise
        if min_version:
            # an at-least-token read succeeded: the endpoint has replayed
            # through the token's version
            self.router.observe_version(endpoint, min_version)
        return result

    def check(
        self,
        tuple_or_str: RelationTuple | str,
        max_depth: int = 0,
        snaptoken: str = "",
        latest: bool = False,
    ) -> CheckResult:
        """One hedged, routed check. Primary and hedge share a traceparent;
        the hedge carries ``x-keto-hedge: 1`` and goes to a different
        endpoint whenever the fleet has more than one."""
        mv = _snaptoken_version(snaptoken)
        primary_ep, hedge_ep = self.router.pick(mv)
        tp = current_traceparent() or mint_traceparent()

        def attempt(endpoint: str, is_hedge: bool) -> CheckResult:
            return self._routed(
                endpoint, mv,
                lambda c: c.check(tuple_or_str, max_depth, snaptoken, latest,
                                  traceparent=tp, hedge=is_hedge),
            )

        call = self._hedger.call(
            lambda: attempt(primary_ep, False),
            hedge=(lambda: attempt(hedge_ep, True)) if hedge_ep is not None else None,
        )
        return call.result

    def batch_check(
        self,
        tuples: Sequence[RelationTuple | str],
        max_depth: int = 0,
        snaptoken: str = "",
        latest: bool = False,
    ) -> list[bool]:
        """One routed batch check (not hedged: a batch duplicate doubles real
        work, unlike a single point read)."""
        mv = _snaptoken_version(snaptoken)
        endpoint, _ = self.router.pick(mv)
        return self._routed(
            endpoint, mv, lambda c: c.batch_check(tuples, max_depth, snaptoken, latest)
        )

    def list_objects(
        self,
        subject: Subject | str,
        relation: str,
        namespace: str,
        max_depth: int = 0,
        page_size: int = 0,
        page_token: str = "",
        snaptoken: str = "",
        latest: bool = False,
    ) -> ListResult:
        """One routed list-objects read (not hedged: a duplicate repeats a
        whole row gather)."""
        mv = _snaptoken_version(snaptoken)
        endpoint, _ = self.router.pick(mv)
        return self._routed(
            endpoint, mv,
            lambda c: c.list_objects(subject, relation, namespace, max_depth,
                                     page_size, page_token, snaptoken, latest),
        )

    def list_subjects(
        self,
        namespace: str,
        object: str,
        relation: str,
        max_depth: int = 0,
        page_size: int = 0,
        page_token: str = "",
        snaptoken: str = "",
        latest: bool = False,
    ) -> ListResult:
        mv = _snaptoken_version(snaptoken)
        endpoint, _ = self.router.pick(mv)
        return self._routed(
            endpoint, mv,
            lambda c: c.list_subjects(namespace, object, relation, max_depth,
                                      page_size, page_token, snaptoken, latest),
        )

    def refresh_cluster_view(self) -> bool:
        """Fetch ``/cluster/status`` from the first endpoint that answers
        and fold it into the router (health demotions, versions, the
        leader's coordinates). Best effort: False when none answered."""
        for ep in self.router.endpoints:
            try:
                r = self._clients[ep]._http.request("GET", f"{ep}/cluster/status")
                if r.status_code == 200:
                    self.router.observe_status(r.json())
                    return True
            except Exception:
                continue
        return False

    # -- the write plane (leader-following) -------------------------------------

    def _follow_leader(self, write_url: str) -> None:
        """Point every client's write endpoint at the new leader."""
        write_url = write_url.rstrip("/")
        for c in self._clients.values():
            c.write_url = write_url

    def _write(self, fn):
        """One write against the current leader; on a 503 that names another
        leader (a read-only follower, or an ex-leader fenced mid-election),
        follow the hint and retry exactly once."""
        try:
            return fn(self._writer)
        except ErrUnavailable as e:
            hint = getattr(e, "leader_hint", None)
            if isinstance(hint, dict):
                self.router.observe_leader(hint)
            else:
                hint = self.router.leader()
            target = str((hint or {}).get("write_url") or "").rstrip("/")
            if not target or target == self._writer.write_url:
                raise
            self._follow_leader(target)
            return fn(self._writer)

    def create_relation_tuple(self, t: RelationTuple | str) -> RelationTuple:
        return self._write(lambda c: c.create_relation_tuple(t))

    def patch_relation_tuples(
        self,
        insert: Sequence[RelationTuple] = (),
        delete: Sequence[RelationTuple] = (),
    ) -> None:
        self._write(lambda c: c.patch_relation_tuples(insert=insert, delete=delete))

    def delete_relation_tuples(self, query: RelationQuery) -> None:
        self._write(lambda c: c.delete_relation_tuples(query))
