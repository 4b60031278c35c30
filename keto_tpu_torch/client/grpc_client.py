"""The gRPC client (counterpart of ``GrpcClient`` in
``keto_tpu/client/__init__.py``): the five ``ory.keto.acl.v1alpha1``
services over one read and one write channel, with the port's own stubs
(``api/services.py``) and the channel options the servers use
(``api/grpc_servers.py grpc_message_options``).

A module of the gRPC plane: it imports grpc, and nothing outside the plane
imports it when it is imported (``keto_tpu_torch.client`` reaches it
lazily). Retries follow ``client/retry.py``: UNAVAILABLE and
RESOURCE_EXHAUSTED back off and re-send, floored on the server's
``retry-after`` trailing metadata, under the client's shared retry budget.
"""

from __future__ import annotations

import json
from typing import Optional, Sequence

import grpc

from ..api import wirecodec
from ..api.convert import subject_to_proto, tree_from_proto, tuple_to_proto
from ..api.gen.ory.keto.acl.v1alpha1 import (
    check_service_pb2,
    expand_service_pb2,
    write_service_pb2,
)
from ..api.grpc_servers import grpc_message_options
from ..api.services import (
    CheckServiceStub,
    ExpandServiceStub,
    HealthStub,
    ListServiceStub,
    ReadServiceStub,
    VersionServiceStub,
    WriteServiceStub,
)
from ..engine.tree import Tree
from ..relationtuple.columns import CheckColumns
from ..relationtuple.definitions import RelationTuple, Subject, SubjectID, SubjectSet
from ..telemetry.tracing import (
    HEDGE_HEADER,
    TRACEPARENT_HEADER,
    current_traceparent,
    mint_traceparent,
)
from ..utils.errors import ErrUnavailable
from . import (
    CRITICALITY_METADATA_KEY,
    CheckResult,
    ListResult,
    _as_tuple,
    _snaptoken_version,
)
from .hedge import Hedger
from .retry import RetryBudget, RetryPolicy, grpc_retryable, run_with_retry
from .vocabcache import VocabCache


class GrpcClient:
    """All five v1alpha1 services over read/write channels (the surface of
    the published Keto gRPC clients)."""

    def __init__(
        self,
        read_target: str,
        write_target: Optional[str] = None,
        retry: Optional[RetryPolicy] = None,
        max_message_bytes: int = 64 << 20,
        retry_budget: Optional[RetryBudget] = None,
        criticality: Optional[str] = None,  # default shed class for checks
    ):
        # the default matches the server's serve.*.grpc-max-message-size
        # default so columnar batch payloads round-trip out of the box
        options = grpc_message_options(max_message_bytes)
        self._read_channel = grpc.insecure_channel(read_target, options=options)
        self._write_channel = (
            grpc.insecure_channel(write_target, options=options)
            if write_target
            else self._read_channel
        )
        self.check_service = CheckServiceStub(self._read_channel)
        self.expand_service = ExpandServiceStub(self._read_channel)
        self.read_service = ReadServiceStub(self._read_channel)
        self.list_service = ListServiceStub(self._read_channel)
        self.write_service = WriteServiceStub(self._write_channel)
        self.version_service = VersionServiceStub(self._read_channel)
        self.health = HealthStub(self._read_channel)
        self.retry = RetryPolicy() if retry is None else retry
        # shared retry-token bucket: caps this instance's retry amplification
        # at ~1.1x under sustained overload
        self.retry_budget = RetryBudget() if retry_budget is None else retry_budget
        self.criticality = criticality

    @staticmethod
    def _attach_retry_after(err: BaseException) -> None:
        """Copy the server's ``retry-after`` trailing-metadata hint onto the
        raised RpcError as ``retry_after_s`` (the gRPC spelling of the
        Retry-After header)."""
        trailing = getattr(err, "trailing_metadata", None)
        if not callable(trailing):
            return
        try:
            for key, value in trailing() or ():
                if key == "retry-after":
                    err.retry_after_s = max(0.0, float(value))
                    return
        except Exception:
            pass

    def _call(self, rpc, request, timeout: Optional[float], metadata=None):
        """One retried unary RPC: every attempt gets the REMAINING deadline
        budget, and the shared retry budget caps total amplification.
        Writes are safe to retry here: transactions are idempotent per
        delta, and shed/unavailable mean the server did not execute."""

        def attempt(remaining):
            try:
                if metadata:
                    return rpc(request, timeout=remaining, metadata=metadata)
                return rpc(request, timeout=remaining)
            except Exception as e:
                self._attach_retry_after(e)
                raise

        return run_with_retry(
            attempt, self.retry, grpc_retryable, timeout=timeout,
            budget=self.retry_budget,
        )

    @staticmethod
    def _trace_metadata(traceparent: Optional[str], hedge: bool) -> tuple[str, tuple]:
        """(traceparent_used, invocation metadata): the gRPC spelling of the
        REST client's trace headers."""
        tp = traceparent or current_traceparent() or mint_traceparent()
        metadata = [(TRACEPARENT_HEADER, tp)]
        if hedge:
            metadata.append((HEDGE_HEADER, "1"))
        return tp, tuple(metadata)

    def _check_metadata(self, traceparent, hedge: bool, criticality) -> tuple[str, tuple]:
        """The trace metadata plus the check's shed class, where it has one."""
        tp, metadata = self._trace_metadata(traceparent, hedge)
        crit = criticality or self.criticality
        if crit:
            metadata += ((CRITICALITY_METADATA_KEY, crit),)
        return tp, metadata

    def close(self) -> None:
        self._read_channel.close()
        if self._write_channel is not self._read_channel:
            self._write_channel.close()

    def __enter__(self) -> "GrpcClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- checks ----------------------------------------------------------------

    def check(
        self,
        t: RelationTuple | str,
        max_depth: int = 0,
        timeout: Optional[float] = None,
        traceparent: Optional[str] = None,
        hedge: bool = False,
        criticality: Optional[str] = None,
    ) -> CheckResult:
        t = _as_tuple(t)
        tp, metadata = self._check_metadata(traceparent, hedge, criticality)
        resp = self._call(
            self.check_service.Check,
            check_service_pb2.CheckRequest(
                namespace=t.namespace,
                object=t.object,
                relation=t.relation,
                subject=subject_to_proto(t.subject),
                max_depth=max_depth,
            ),
            timeout,
            metadata=metadata,
        )
        return CheckResult(allowed=resp.allowed, snaptoken=resp.snaptoken, traceparent=tp)

    def check_hedged(
        self,
        t: RelationTuple | str,
        hedger: Hedger,
        max_depth: int = 0,
        timeout: Optional[float] = None,
    ):
        """Hedged single check: primary and duplicate share one traceparent,
        the duplicate tagged ``x-keto-hedge: 1`` on its metadata."""
        tp = current_traceparent() or mint_traceparent()

        def attempt(is_hedge: bool):
            return self.check(t, max_depth, timeout, traceparent=tp, hedge=is_hedge)

        return hedger.call(lambda: attempt(False), hedge=lambda: attempt(True))

    def _batch(self, request, timeout, traceparent, criticality) -> list[bool]:
        _, metadata = self._check_metadata(traceparent, False, criticality)
        resp = self._call(self.check_service.BatchCheck, request, timeout,
                          metadata=metadata)
        return list(resp.allowed)

    def batch_check(
        self,
        tuples: Sequence[RelationTuple | str],
        max_depth: int = 0,
        snaptoken: str = "",
        latest: bool = False,
        timeout: Optional[float] = None,
        traceparent: Optional[str] = None,
        criticality: Optional[str] = None,
    ) -> list[bool]:
        """The BatchCheck RPC, one message per tuple: many checks, one round
        trip. ``snaptoken``/``latest`` apply to the whole batch."""
        items = []
        for t in tuples:
            t = _as_tuple(t)
            items.append(
                check_service_pb2.CheckRequestTuple(
                    namespace=t.namespace,
                    object=t.object,
                    relation=t.relation,
                    subject=subject_to_proto(t.subject),
                )
            )
        request = check_service_pb2.BatchCheckRequest(
            tuples=items, max_depth=max_depth, snaptoken=snaptoken, latest=latest,
        )
        return self._batch(request, timeout, traceparent, criticality)

    def batch_check_columns(
        self,
        columns: CheckColumns | Sequence[RelationTuple | str],
        max_depth: int = 0,
        snaptoken: str = "",
        latest: bool = False,
        timeout: Optional[float] = None,
        traceparent: Optional[str] = None,
        criticality: Optional[str] = None,
    ) -> list[bool]:
        """The BatchCheck RPC in its column form (the request's parallel
        string fields 5-11): no per-tuple messages on either side."""
        if not isinstance(columns, CheckColumns):
            columns = CheckColumns.from_tuples([_as_tuple(t) for t in columns])
        request = check_service_pb2.BatchCheckRequest(
            max_depth=max_depth, snaptoken=snaptoken, latest=latest,
            **{c: getattr(columns, c) for c in CheckColumns.__slots__},
        )
        return self._batch(request, timeout, traceparent, criticality)

    def batch_check_encoded(
        self,
        cache: VocabCache,
        tuples: Sequence[RelationTuple | str],
        snaptoken: str = "",
        timeout: Optional[float] = None,
        traceparent: Optional[str] = None,
        max_resyncs: int = 2,
    ) -> list[bool]:
        """The id-native BatchCheckEncoded RPC: raw wirecodec frames over a
        no-serializer stub. Epoch-mismatch bounces (FAILED_PRECONDITION with
        a ``vocab_epoch_mismatch`` detail) re-sync ``cache``, re-encode and
        re-send, at most ``max_resyncs`` times."""
        mv = _snaptoken_version(snaptoken)
        tp, metadata = self._trace_metadata(traceparent, hedge=False)
        for attempt in range(max_resyncs + 1):
            frame = cache.frame(tuples, min_version=mv, traceparent=tp)
            try:
                resp = self._call(self.check_service.BatchCheckEncoded, frame, timeout,
                                  metadata=metadata)
            except grpc.RpcError as e:
                if (
                    e.code() == grpc.StatusCode.FAILED_PRECONDITION
                    and attempt < max_resyncs
                ):
                    details = {}
                    for k, v in e.trailing_metadata() or ():
                        if k == "keto-error-details":
                            try:
                                details = json.loads(v)
                            except ValueError:
                                pass
                    if details.get("reason") == "vocab_epoch_mismatch":
                        cache.sync()
                        continue
                raise
            allowed, _tok = wirecodec.decode_check_response(resp)
            return [bool(v) for v in allowed]
        raise ErrUnavailable("encoded batch check exhausted resyncs")

    # -- writes, expand, lists ---------------------------------------------------

    def transact(
        self,
        insert: Sequence[RelationTuple | str] = (),
        delete: Sequence[RelationTuple | str] = (),
        timeout: Optional[float] = None,
    ) -> str:
        """Atomic insert/delete transaction over WriteService; returns the
        commit snaptoken."""

        def deltas(tuples, action):
            for item in tuples:
                yield write_service_pb2.RelationTupleDelta(
                    action=action, relation_tuple=tuple_to_proto(_as_tuple(item))
                )

        resp = self._call(
            self.write_service.TransactRelationTuples,
            write_service_pb2.TransactRelationTuplesRequest(
                relation_tuple_deltas=[
                    *deltas(insert, write_service_pb2.RelationTupleDelta.INSERT),
                    *deltas(delete, write_service_pb2.RelationTupleDelta.DELETE),
                ]
            ),
            timeout,
        )
        return resp.snaptokens[0] if resp.snaptokens else ""

    def expand(
        self,
        subject_set: SubjectSet,
        max_depth: int = 0,
        timeout: Optional[float] = None,
    ) -> Optional[Tree]:
        resp = self._call(
            self.expand_service.Expand,
            expand_service_pb2.ExpandRequest(
                subject=subject_to_proto(subject_set), max_depth=max_depth,
            ),
            timeout,
        )
        if not resp.HasField("tree"):
            return None
        return tree_from_proto(resp.tree)

    def _list_call(self, rpc, body: dict, items_key: str,
                   timeout: Optional[float]) -> ListResult:
        # ListService speaks compact JSON bytes over identity serializers
        # (the checked-in protos predate the list surface)
        resp = self._call(
            rpc,
            json.dumps({k: v for k, v in body.items() if v},
                       separators=(",", ":")).encode(),
            timeout,
        )
        doc = json.loads(bytes(resp) or b"{}")
        return ListResult(
            items=doc.get(items_key, []),
            next_page_token=doc.get("next_page_token", ""),
            snaptoken=doc.get("snaptoken", ""),
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
        timeout: Optional[float] = None,
    ) -> ListResult:
        if isinstance(subject, str):
            subject = SubjectID(id=subject)
        body: dict = {
            "namespace": namespace,
            "relation": relation,
            "max_depth": max_depth,
            "page_size": page_size,
            "page_token": page_token,
            "snaptoken": snaptoken,
            "latest": latest,
        }
        if isinstance(subject, SubjectID):
            body["subject_id"] = subject.id
        else:
            body["subject_set"] = subject.to_dict()
        return self._list_call(self.list_service.ListObjects, body, "objects", timeout)

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
        timeout: Optional[float] = None,
    ) -> ListResult:
        return self._list_call(
            self.list_service.ListSubjects,
            {
                "namespace": namespace,
                "object": object,
                "relation": relation,
                "max_depth": max_depth,
                "page_size": page_size,
                "page_token": page_token,
                "snaptoken": snaptoken,
                "latest": latest,
            },
            "subject_ids",
            timeout,
        )
