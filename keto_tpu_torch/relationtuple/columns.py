"""Columnar check-request batches: parallel column lists instead of
per-item ``RelationTuple``/``Subject`` objects (counterpart of
``keto_tpu/relationtuple/columns.py``).

The REST ``/check/batch`` columnar body and the gRPC ``BatchCheck``
columnar fields (``from_proto``) decode straight into a
``CheckColumns`` — seven parallel string lists — and the engine path
vocab-encodes the columns in bulk
(``GraphSnapshot.encode_requests_columnar``). Tuples are materialized
lazily ONLY where a host oracle needs real objects (the closure engine's
oversized-interior fallback and its overflow rows), so hot-path answers
never touch per-item Python objects.

Row semantics: row ``i`` is a subject-ID row when ``subject_ids[i]`` is
non-empty, a subject-set row when any of the three ``subject_set_*``
columns is non-empty at ``i``. A row with neither (or both) is malformed
and rejects the whole batch with ``ErrMalformedInput`` (HTTP 400 /
INVALID_ARGUMENT), matching the per-tuple path's "tuple without subject"
semantics.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence

from ..utils.errors import ErrMalformedInput
from .definitions import RelationTuple, SubjectID, SubjectSet

_EMPTY: tuple = ()


def _as_str_list(value, field: str) -> List[str]:
    if value is None:
        return []
    if isinstance(value, str):
        raise ErrMalformedInput(
            f"columnar field {field!r} must be an array of strings"
        )
    try:
        out = list(value)
    except TypeError:
        raise ErrMalformedInput(
            f"columnar field {field!r} must be an array of strings"
        ) from None
    for v in out:
        if not isinstance(v, str):
            raise ErrMalformedInput(
                f"columnar field {field!r} must be an array of strings"
            )
    return out


class CheckColumns:
    """A batch of check requests as parallel columns (no per-row objects).

    ``namespaces``/``objects``/``relations`` name the object#relation
    side; the four subject columns carry either a subject id or a
    subject-set triple per row (see module docstring). Subject columns
    may be omitted entirely (length 0) and are normalized to all-empty
    by ``validate``.
    """

    __slots__ = (
        "namespaces",
        "objects",
        "relations",
        "subject_ids",
        "subject_set_namespaces",
        "subject_set_objects",
        "subject_set_relations",
    )

    def __init__(
        self,
        namespaces: Sequence[str],
        objects: Sequence[str],
        relations: Sequence[str],
        subject_ids: Sequence[str] = _EMPTY,
        subject_set_namespaces: Sequence[str] = _EMPTY,
        subject_set_objects: Sequence[str] = _EMPTY,
        subject_set_relations: Sequence[str] = _EMPTY,
    ):
        self.namespaces = list(namespaces)
        self.objects = list(objects)
        self.relations = list(relations)
        self.subject_ids = list(subject_ids)
        self.subject_set_namespaces = list(subject_set_namespaces)
        self.subject_set_objects = list(subject_set_objects)
        self.subject_set_relations = list(subject_set_relations)

    def __len__(self) -> int:
        return len(self.namespaces)

    # -- validation ---------------------------------------------------------

    def validate(self) -> "CheckColumns":
        """Normalize omitted subject columns and reject malformed batches
        with ``ErrMalformedInput`` (maps to 400 / INVALID_ARGUMENT)."""
        n = len(self.namespaces)
        for name in ("objects", "relations"):
            if len(getattr(self, name)) != n:
                raise ErrMalformedInput(
                    f"columnar batch length mismatch: {name} has "
                    f"{len(getattr(self, name))} rows, namespaces has {n}"
                )
        for name in (
            "subject_ids",
            "subject_set_namespaces",
            "subject_set_objects",
            "subject_set_relations",
        ):
            col = getattr(self, name)
            if len(col) == 0 and n:
                setattr(self, name, [""] * n)
            elif len(col) != n:
                raise ErrMalformedInput(
                    f"columnar batch length mismatch: {name} has "
                    f"{len(col)} rows, namespaces has {n}"
                )
        sid = self.subject_ids
        sns = self.subject_set_namespaces
        sobj = self.subject_set_objects
        srel = self.subject_set_relations
        for i in range(n):
            has_id = bool(sid[i])
            has_set = bool(sns[i] or sobj[i] or srel[i])
            if has_id and has_set:
                raise ErrMalformedInput(
                    f"batch check row {i} has both subject_id and "
                    "subject_set columns"
                )
            if not has_id and not has_set:
                raise ErrMalformedInput(
                    "batch check tuple without subject"
                )
        return self

    # -- encode-side views (no object churn) --------------------------------

    def start_keys(self) -> List[tuple]:
        """Vocab keys for the object#relation side — 3-tuples, the exact
        shape ``NodeVocab.lookup_bulk`` probes."""
        return list(zip(self.namespaces, self.objects, self.relations))

    def target_keys(self) -> List[tuple]:
        """Vocab keys for the subject side: ``(id,)`` for subject-ID rows,
        ``(ns, obj, rel)`` for subject-set rows."""
        return [
            (s,) if s else (ns, obj, rel)
            for s, ns, obj, rel in zip(
                self.subject_ids,
                self.subject_set_namespaces,
                self.subject_set_objects,
                self.subject_set_relations,
            )
        ]

    def row_keys(self, max_depth: int) -> List[tuple]:
        """Hashable per-row cache keys for engines without the encoded
        id-triple path — flat string tuples, no RelationTuple churn."""
        return [
            (ns, obj, rel, s, sns, sobj, srel, max_depth)
            for ns, obj, rel, s, sns, sobj, srel in zip(
                self.namespaces,
                self.objects,
                self.relations,
                self.subject_ids,
                self.subject_set_namespaces,
                self.subject_set_objects,
                self.subject_set_relations,
            )
        ]

    # -- lazy materialization (fallback / oracle paths only) -----------------

    def tuple_at(self, i: int) -> RelationTuple:
        s = self.subject_ids[i]
        subject = (
            SubjectID(id=s)
            if s
            else SubjectSet(
                namespace=self.subject_set_namespaces[i],
                object=self.subject_set_objects[i],
                relation=self.subject_set_relations[i],
            )
        )
        return RelationTuple(
            namespace=self.namespaces[i],
            object=self.objects[i],
            relation=self.relations[i],
            subject=subject,
        )

    def materialize(self) -> List[RelationTuple]:
        return [self.tuple_at(i) for i in range(len(self))]

    def select(self, keep: Iterable[int]) -> "CheckColumns":
        idx = list(keep)
        return CheckColumns(
            [self.namespaces[i] for i in idx],
            [self.objects[i] for i in idx],
            [self.relations[i] for i in idx],
            [self.subject_ids[i] for i in idx],
            [self.subject_set_namespaces[i] for i in idx],
            [self.subject_set_objects[i] for i in idx],
            [self.subject_set_relations[i] for i in idx],
        )

    # -- constructors --------------------------------------------------------

    @classmethod
    def from_proto(cls, request) -> "CheckColumns":
        """Decode the columnar repeated fields of a gRPC
        ``BatchCheckRequest`` (fields 5..11) straight into columns."""
        return cls(
            list(request.namespaces),
            list(request.objects),
            list(request.relations),
            list(request.subject_ids),
            list(request.subject_set_namespaces),
            list(request.subject_set_objects),
            list(request.subject_set_relations),
        ).validate()

    @classmethod
    def from_rest_body(cls, body: dict) -> "CheckColumns":
        """Decode the REST columnar body
        ``{"namespaces": [...], "objects": [...], ...}``."""
        return cls(
            _as_str_list(body.get("namespaces"), "namespaces"),
            _as_str_list(body.get("objects"), "objects"),
            _as_str_list(body.get("relations"), "relations"),
            _as_str_list(body.get("subject_ids"), "subject_ids"),
            _as_str_list(
                body.get("subject_set_namespaces"), "subject_set_namespaces"
            ),
            _as_str_list(
                body.get("subject_set_objects"), "subject_set_objects"
            ),
            _as_str_list(
                body.get("subject_set_relations"), "subject_set_relations"
            ),
        ).validate()

    @classmethod
    def from_tuples(
        cls, tuples: Sequence[RelationTuple]
    ) -> "CheckColumns":
        ns: List[str] = []
        obj: List[str] = []
        rel: List[str] = []
        sid: List[str] = []
        sns: List[str] = []
        sobj: List[str] = []
        srel: List[str] = []
        for t in tuples:
            ns.append(t.namespace)
            obj.append(t.object)
            rel.append(t.relation)
            s = t.subject
            if type(s) is SubjectID:
                sid.append(s.id)
                sns.append("")
                sobj.append("")
                srel.append("")
            else:
                sid.append("")
                sns.append(s.namespace)
                sobj.append(s.object)
                srel.append(s.relation)
        return cls(ns, obj, rel, sid, sns, sobj, srel)


def proto_has_columns(request) -> bool:
    """True when a ``BatchCheckRequest`` carries the columnar fields (the
    fast path); empty columns + ``tuples`` means the per-tuple path."""
    return len(request.namespaces) > 0
