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

``ReplicatedRestClient``, the reference's snaptoken-aware client over a
replicated read fleet, waits for the fleet (ROADMAP 14.6): constructing it
raises.
"""

from __future__ import annotations

import http.client
import json
import re
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
    ErrForbidden,
    ErrInternal,
    ErrMalformedInput,
    ErrNotFound,
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

_REPLICATED_MSG = (
    "ReplicatedRestClient routes reads across a replicated read fleet, which "
    "is not ported to keto_tpu_torch yet: ROADMAP item 14.6, the fleet"
)

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

_TOKEN_RE = re.compile(r"^z(\d+)\.")


def __getattr__(name: str):
    # the gRPC client imports grpc: reach it only when it is asked for
    if name == "GrpcClient":
        from .grpc_client import GrpcClient

        return GrpcClient
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _snaptoken_version(snaptoken: str) -> int:
    """Snaptoken -> minimum store version for the encoded wire frame (which
    carries the version number, not the token string). The server's
    snaptokens are bare version counters; a structured ``z<v>.<s>.<o>``
    token is read too. Anything else is 0 (the server 400s it elsewhere)."""
    if not snaptoken:
        return 0
    m = _TOKEN_RE.match(snaptoken)
    try:
        return int(m.group(1)) if m is not None else int(snaptoken)
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
    on it). A 503 with a ``leader_hint`` (the fleet's read-only follower)
    stays ErrUnavailable until ROADMAP 14.6."""
    err = body.get("error") or {} if isinstance(body, dict) else {}
    message = err.get("message", "")
    cls = {
        400: ErrMalformedInput,
        403: ErrForbidden,
        404: ErrNotFound,
        409: ErrStalePageToken,
        429: ErrResourceExhausted,
        503: ErrUnavailable,
    }.get(status_code, ErrInternal)
    e = cls(message or None)
    if headers is not None:
        ra = headers.get("Retry-After") or headers.get("retry-after")
        if ra is not None:
            try:
                e.retry_after_s = max(0.0, float(ra))
            except (TypeError, ValueError):
                pass
    return e


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
    """Reads fanned across a replicated read fleet (the reference's
    snaptoken-aware, hedging, leader-following client). The fleet is not
    ported yet: constructing one raises, naming ROADMAP 14.6."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_REPLICATED_MSG)
