"""The CLI's gRPC verbs (counterpart of the client commands of
``keto_tpu/cli/main.py``): ``check``, ``expand``, ``relation-tuple
create|delete|delete-all|get`` and ``status``, over the port's stubs
(``api/services.py``) with the servers' channel options.

A module of the gRPC plane: ``cli/main.py`` imports it inside the verbs
that need it, so the CLI's other verbs run where grpc is not installed.
Each channel is dialled with the reference's 3 s timeout
(cmd/client/grpc_client.go:49-70).
"""

from __future__ import annotations

import json
import time

import grpc

from ..api.convert import subject_to_proto, tree_from_proto, tuple_from_proto, tuple_to_proto
from ..api.gen.health import health_pb2
from ..api.gen.ory.keto.acl.v1alpha1 import (
    acl_pb2,
    check_service_pb2,
    expand_service_pb2,
    read_service_pb2,
    write_service_pb2,
)
from ..api.grpc_servers import grpc_message_options
from ..api.services import (
    CheckServiceStub,
    ExpandServiceStub,
    HealthStub,
    ReadServiceStub,
    WriteServiceStub,
)
from ..relationtuple.definitions import relation_collection_table, subject_from_string
from .main import CliError, confirm, echo, read_remote, read_tuple_sources, write_remote

_CONN_TIMEOUT_S = 3  # the reference dials with a 3 s timeout


def channel(remote: str) -> grpc.Channel:
    # the server's lifted message cap (serve.*.grpc-max-message-size
    # default), so large batch payloads round-trip
    ch = grpc.insecure_channel(remote, options=grpc_message_options(64 << 20))
    try:
        grpc.channel_ready_future(ch).result(timeout=_CONN_TIMEOUT_S)
    except grpc.FutureTimeoutError:
        # close before raising: an unclosed channel leaks its
        # connectivity-poller thread for the process lifetime
        ch.close()
        raise CliError(f"cannot connect to {remote} within {_CONN_TIMEOUT_S}s") from None
    return ch


def _call(remote: str, stub_cls, method: str, request):
    with channel(remote) as ch:
        try:
            return getattr(stub_cls(ch), method)(request)
        except grpc.RpcError as e:
            raise CliError(f"{e.code().name}: {e.details()}") from None


def check(args) -> int:
    """Check whether SUBJECT has RELATION on NAMESPACE:OBJECT (reference
    cmd/check/root.go:27-72); exit 1 on Denied."""
    resp = _call(
        read_remote(args), CheckServiceStub, "Check",
        check_service_pb2.CheckRequest(
            namespace=args.namespace,
            object=args.object,
            relation=args.relation,
            subject=subject_to_proto(subject_from_string(args.subject)),
            max_depth=args.max_depth,
        ),
    )
    if args.fmt == "json":
        echo(json.dumps({"allowed": resp.allowed}))
    else:
        echo("Allowed" if resp.allowed else "Denied")
    return 0 if resp.allowed else 1


def expand(args) -> int:
    """Expand the subject set NAMESPACE:OBJECT#RELATION into its tree
    (reference cmd/expand/root.go:18-88)."""
    resp = _call(
        read_remote(args), ExpandServiceStub, "Expand",
        expand_service_pb2.ExpandRequest(
            subject=acl_pb2.Subject(
                set=acl_pb2.SubjectSet(
                    namespace=args.namespace, object=args.object,
                    relation=args.relation,
                )
            ),
            max_depth=args.max_depth,
        ),
    )
    tree = tree_from_proto(resp.tree) if resp.HasField("tree") else None
    if args.fmt == "json":
        echo(json.dumps(None if tree is None else tree.to_dict(), indent=2))
    elif tree is None:
        echo("null")
    else:
        echo(str(tree))
    return 0


def _transact(args, tuples, action) -> None:
    _call(
        write_remote(args), WriteServiceStub, "TransactRelationTuples",
        write_service_pb2.TransactRelationTuplesRequest(
            relation_tuple_deltas=[
                write_service_pb2.RelationTupleDelta(
                    action=action, relation_tuple=tuple_to_proto(t)
                )
                for t in tuples
            ]
        ),
    )


def create(args) -> int:
    """Create tuples from JSON files, dirs, or stdin."""
    tuples = read_tuple_sources(args.sources)
    _transact(args, tuples, write_service_pb2.RelationTupleDelta.INSERT)
    echo(f"created {len(tuples)} relation tuples")
    return 0


def delete(args) -> int:
    """Delete the exact tuples given as JSON files, dirs, or stdin."""
    tuples = read_tuple_sources(args.sources)
    _transact(args, tuples, write_service_pb2.RelationTupleDelta.DELETE)
    echo(f"deleted {len(tuples)} relation tuples")
    return 0


def _query(query_cls, args):
    q = query_cls(
        namespace=args.namespace or "", object=args.object or "",
        relation=args.relation or "",
    )
    if args.subject_id:
        q.subject.CopyFrom(acl_pb2.Subject(id=args.subject_id))
    return q


def delete_all(args) -> int:
    """Delete all tuples matching the query flags (reference
    cmd/relationtuple/delete.go)."""
    if not args.force:
        confirm("Are you sure you want to delete all matching relation tuples?",
                abort=True)
    _call(
        write_remote(args), WriteServiceStub, "DeleteRelationTuples",
        write_service_pb2.DeleteRelationTuplesRequest(
            query=_query(write_service_pb2.DeleteRelationTuplesRequest.Query, args)
        ),
    )
    echo("deleted all matching relation tuples")
    return 0


def get(args) -> int:
    """Query tuples as a table or JSON (reference cmd/relationtuple/get.go)."""
    resp = _call(
        read_remote(args), ReadServiceStub, "ListRelationTuples",
        read_service_pb2.ListRelationTuplesRequest(
            query=_query(read_service_pb2.ListRelationTuplesRequest.Query, args),
            page_size=args.page_size,
            page_token=args.page_token,
        ),
    )
    tuples = [tuple_from_proto(p) for p in resp.relation_tuples]
    if args.fmt == "json":
        echo(json.dumps(
            {"relation_tuples": [t.to_dict() for t in tuples],
             "next_page_token": resp.next_page_token},
            indent=2,
        ))
    else:
        echo(relation_collection_table(tuples))
        if resp.next_page_token:
            echo(f"\nnext page token: {resp.next_page_token}")
    return 0


def status(args) -> int:
    """The read API's gRPC health; with --block, poll each second until
    SERVING (or --timeout)."""
    deadline = time.monotonic() + args.timeout_s if args.timeout_s else None
    while True:
        try:
            resp = _call(read_remote(args), HealthStub, "Check",
                         health_pb2.HealthCheckRequest())
            echo(health_pb2.HealthCheckResponse.ServingStatus.Name(resp.status))
            if resp.status == health_pb2.HealthCheckResponse.SERVING or not args.block:
                return 0
        except CliError:
            if not args.block:
                raise
            echo("NOT_REACHABLE")
        if deadline is not None and time.monotonic() > deadline:
            raise CliError("timed out waiting for SERVING")
        time.sleep(1)
