"""Proto <-> domain conversions for the gRPC plane (counterpart of
``keto_tpu/api/convert.py``; the reference's proto utils and the
ToProto/FromProto methods on its tuples and trees).

The snaptoken parsing is the REST plane's own (``api/rest.py
min_version_from``, over ``replication/token.py``), so both transports
accept the same spellings and raise the same error.
"""

from __future__ import annotations

from typing import Optional

from ..engine.tree import NodeType, Tree
from ..relationtuple.definitions import (
    RelationQuery,
    RelationTuple,
    Subject,
    SubjectID,
    SubjectSet,
)
from ..replication.token import (  # noqa: F401  (LATEST_SENTINEL re-export)
    LATEST_SENTINEL,
    parse_snaptoken,
)
from ..utils.errors import ErrMalformedInput
from .gen.ory.keto.acl.v1alpha1 import acl_pb2, expand_service_pb2
# the snaptoken helper of both transports, for the servicers
from .rest import min_version_from  # noqa: F401

_NODE_TYPE_TO_PROTO = {
    NodeType.UNION: expand_service_pb2.NODE_TYPE_UNION,
    NodeType.EXCLUSION: expand_service_pb2.NODE_TYPE_EXCLUSION,
    NodeType.INTERSECTION: expand_service_pb2.NODE_TYPE_INTERSECTION,
    NodeType.LEAF: expand_service_pb2.NODE_TYPE_LEAF,
}
_NODE_TYPE_FROM_PROTO = {v: k for k, v in _NODE_TYPE_TO_PROTO.items()}


def subject_to_proto(s: Subject) -> acl_pb2.Subject:
    if isinstance(s, SubjectID):
        return acl_pb2.Subject(id=s.id)
    return acl_pb2.Subject(
        set=acl_pb2.SubjectSet(
            namespace=s.namespace, object=s.object, relation=s.relation
        )
    )


def subject_from_proto(p: Optional[acl_pb2.Subject]) -> Optional[Subject]:
    """None / an unset oneof -> None: a wildcard in queries, an error for
    tuples (the caller decides, as the reference's SubjectFromProto)."""
    if p is None:
        return None
    which = p.WhichOneof("ref")
    if which == "id":
        return SubjectID(id=p.id)
    if which == "set":
        return SubjectSet(
            namespace=p.set.namespace,
            object=p.set.object,
            relation=p.set.relation,
        )
    return None


def tuple_to_proto(t: RelationTuple) -> acl_pb2.RelationTuple:
    return acl_pb2.RelationTuple(
        namespace=t.namespace,
        object=t.object,
        relation=t.relation,
        subject=subject_to_proto(t.subject),
    )


def tuple_from_proto(p: acl_pb2.RelationTuple) -> RelationTuple:
    subject = subject_from_proto(p.subject if p.HasField("subject") else None)
    if subject is None:
        raise ErrMalformedInput("relation tuple without subject")
    return RelationTuple(
        namespace=p.namespace,
        object=p.object,
        relation=p.relation,
        subject=subject,
    )


def query_from_proto_fields(namespace, object, relation, subject_proto):
    """A RelationQuery from proto query fields; proto3 empty strings are
    wildcards (the reference's zero-value query semantics)."""
    return RelationQuery(
        namespace=namespace or None,
        object=object or None,
        relation=relation or None,
        subject=subject_from_proto(subject_proto),
    )


def tree_to_proto(t: Optional[Tree]) -> Optional[expand_service_pb2.SubjectTree]:
    if t is None:
        return None
    return expand_service_pb2.SubjectTree(
        node_type=_NODE_TYPE_TO_PROTO[t.type],
        subject=subject_to_proto(t.subject),
        children=[tree_to_proto(c) for c in t.children],
    )


def tree_from_proto(p: Optional[expand_service_pb2.SubjectTree]) -> Optional[Tree]:
    if p is None:
        return None
    try:
        node_type = _NODE_TYPE_FROM_PROTO[p.node_type]
    except KeyError:
        raise ErrMalformedInput(f"unknown node type {p.node_type}") from None
    subject = subject_from_proto(p.subject if p.HasField("subject") else None)
    if subject is None:
        raise ErrMalformedInput("tree node without subject")
    return Tree(
        type=node_type,
        subject=subject,
        children=[tree_from_proto(c) for c in p.children],
    )
