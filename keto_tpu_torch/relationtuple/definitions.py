"""Relation-tuple domain model (counterpart of
``keto_tpu/relationtuple/definitions.py``).

Mirrors the reference's domain layer (internal/relationtuple/definitions.go):

- ``RelationTuple``: ``{namespace, object, relation, subject}``.
- ``Subject`` is either a plain ``SubjectID`` or a ``SubjectSet``
  (an indirection: "everyone with `relation` on `namespace:object`").
- String grammar ``namespace:object#relation@subject``: tuple parsing splits
  on the *first* ``:``, ``#``, ``@`` in that order and trims optional
  parentheses around the subject (definitions.go:276-305); subject strings
  containing ``#`` parse as subject sets (definitions.go:137-142).
- ``RelationQuery``: partial-match filter over tuples (definitions.go:45-65).
- ``Manager``: the storage contract the engines depend on
  (definitions.go:28-34).
- ``parse_tuples_text`` and ``relation_collection_table``: the CLI's
  ``relation-tuple parse`` input and ``relation-tuple get`` table.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Iterable, Mapping, Optional, Sequence, Union

from ..utils.errors import ErrInvalidTuple, ErrMalformedInput
from ..utils.pagination import PaginationOptions


@dataclass(frozen=True, slots=True)
class SubjectID:
    """A concrete subject, e.g. a user id."""

    id: str

    def __str__(self) -> str:
        return self.id

    def to_dict(self) -> dict:
        return {"id": self.id}

    def equals(self, other: "Subject") -> bool:
        return isinstance(other, SubjectID) and other.id == self.id


@dataclass(frozen=True, slots=True)
class SubjectSet:
    """An indirect subject: all subjects that have `relation` on `namespace:object`."""

    namespace: str
    object: str
    relation: str

    def __str__(self) -> str:
        return f"{self.namespace}:{self.object}#{self.relation}"

    def to_dict(self) -> dict:
        return {
            "namespace": self.namespace,
            "object": self.object,
            "relation": self.relation,
        }

    def equals(self, other: "Subject") -> bool:
        return (
            isinstance(other, SubjectSet)
            and other.namespace == self.namespace
            and other.object == self.object
            and other.relation == self.relation
        )


Subject = Union[SubjectID, SubjectSet]


def subject_from_string(s: str) -> Subject:
    """Parse a subject string: contains '#' -> SubjectSet, else SubjectID."""
    if "#" in s:
        ns, sep, rest = s.partition(":")
        if not sep:
            raise ErrMalformedInput("expected subject set to contain ':'")
        obj, sep, rel = rest.partition("#")
        if not sep:
            raise ErrMalformedInput("expected subject set to contain '#'")
        return SubjectSet(namespace=ns, object=obj, relation=rel)
    return SubjectID(id=s)


def subject_from_dict(d: Mapping) -> Subject:
    """Parse a subject from its JSON form: {"id": ...} or {namespace,object,relation}."""
    if "id" in d:
        return SubjectID(id=d["id"])
    try:
        return SubjectSet(
            namespace=d["namespace"], object=d["object"], relation=d["relation"]
        )
    except KeyError as e:
        raise ErrMalformedInput(f"malformed subject: missing {e}") from e


@dataclass(frozen=True, slots=True)
class RelationTuple:
    """namespace:object#relation@subject — one edge of the permission graph."""

    namespace: str
    object: str
    relation: str
    subject: Subject

    def __post_init__(self):
        if self.subject is None:
            raise ErrInvalidTuple("subject is not allowed to be nil")

    def __str__(self) -> str:
        return f"{self.namespace}:{self.object}#{self.relation}@{self.subject}"

    def to_dict(self) -> dict:
        """The REST JSON form: ``subject_id`` or ``subject_set``."""
        d = {
            "namespace": self.namespace,
            "object": self.object,
            "relation": self.relation,
        }
        if isinstance(self.subject, SubjectID):
            d["subject_id"] = self.subject.id
        else:
            d["subject_set"] = self.subject.to_dict()
        return d

    def to_query(self) -> "RelationQuery":
        """The query that matches exactly this tuple."""
        return RelationQuery(
            namespace=self.namespace,
            object=self.object,
            relation=self.relation,
            subject=self.subject,
        )

    @classmethod
    def from_dict(cls, d: Mapping) -> "RelationTuple":
        try:
            ns, obj, rel = d["namespace"], d["object"], d["relation"]
        except KeyError as e:
            raise ErrMalformedInput(f"malformed relation tuple: missing {e}") from e
        if d.get("subject_id") is not None:
            subject: Subject = SubjectID(id=d["subject_id"])
        elif d.get("subject_set") is not None:
            subject = subject_from_dict(d["subject_set"])
        elif d.get("subject") is not None:
            # legacy flat form: {"subject": "string"}
            sub = d["subject"]
            subject = (
                subject_from_string(sub)
                if isinstance(sub, str)
                else subject_from_dict(sub)
            )
        else:
            raise ErrMalformedInput("malformed relation tuple: missing subject")
        return cls(namespace=ns, object=obj, relation=rel, subject=subject)

    @classmethod
    def from_string(cls, s: str) -> "RelationTuple":
        """Parse ``ns:obj#rel@subject`` (subject may be wrapped in parentheses)."""
        ns, sep, rest = s.partition(":")
        if not sep:
            raise ErrMalformedInput("expected input to contain ':'")
        obj, sep, rest = rest.partition("#")
        if not sep:
            raise ErrMalformedInput("expected input to contain '#'")
        rel, sep, sub = rest.partition("@")
        if not sep:
            raise ErrMalformedInput("expected input to contain '@'")
        sub = sub.strip("()")
        return cls(
            namespace=ns, object=obj, relation=rel,
            subject=subject_from_string(sub),
        )


@dataclass(frozen=True, slots=True)
class RelationQuery:
    """Partial-match filter; None fields are wildcards."""

    namespace: Optional[str] = None
    object: Optional[str] = None
    relation: Optional[str] = None
    subject: Optional[Subject] = None

    def matches(self, t: RelationTuple) -> bool:
        if self.namespace is not None and t.namespace != self.namespace:
            return False
        if self.object is not None and t.object != self.object:
            return False
        if self.relation is not None and t.relation != self.relation:
            return False
        if self.subject is not None and not self.subject.equals(t.subject):
            return False
        return True


class Manager(abc.ABC):
    """Storage contract for relation tuples (reference definitions.go:28-34)."""

    @abc.abstractmethod
    def get_relation_tuples(
        self, query: RelationQuery, pagination: PaginationOptions | None = None
    ) -> tuple[list[RelationTuple], str]:
        """Return (tuples, next_page_token); "" token means no further pages."""

    @abc.abstractmethod
    def write_relation_tuples(self, *tuples: RelationTuple) -> None: ...

    @abc.abstractmethod
    def delete_relation_tuples(self, *tuples: RelationTuple) -> None: ...

    @abc.abstractmethod
    def delete_all_relation_tuples(self, query: RelationQuery) -> None: ...

    @abc.abstractmethod
    def transact_relation_tuples(
        self,
        insert: Sequence[RelationTuple],
        delete: Sequence[RelationTuple],
    ) -> None:
        """Atomically insert and delete; either all or none are applied."""


def parse_tuples_text(text: str) -> list[RelationTuple]:
    """Parse newline-separated human-readable tuples; '//'-comments and blank
    lines are skipped (reference cmd/relationtuple/parse.go:47-88)."""
    out = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("//"):
            continue
        if "//" in line:  # a trailing comment
            line = line.split("//", 1)[0].strip()
        out.append(RelationTuple.from_string(line))
    return out


def relation_collection_table(tuples: Iterable[RelationTuple]) -> str:
    """Human-readable table of tuples (reference definitions.go:555-642)."""
    header = ("NAMESPACE", "OBJECT", "RELATION NAME", "SUBJECT")
    rows = [(t.namespace, t.object, t.relation, str(t.subject)) for t in tuples]
    widths = [
        max(len(header[i]), *(len(r[i]) for r in rows)) if rows else len(header[i])
        for i in range(4)
    ]
    lines = ["\t".join(h.ljust(widths[i]) for i, h in enumerate(header))]
    for r in rows:
        lines.append("\t".join(c.ljust(widths[i]) for i, c in enumerate(r)))
    return "\n".join(lines)
