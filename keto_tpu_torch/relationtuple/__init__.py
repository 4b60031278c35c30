from .definitions import (
    Manager,
    RelationQuery,
    RelationTuple,
    Subject,
    SubjectID,
    SubjectSet,
    subject_from_dict,
    subject_from_string,
)

__all__ = [
    "Manager",
    "RelationQuery",
    "RelationTuple",
    "Subject",
    "SubjectID",
    "SubjectSet",
    "subject_from_dict",
    "subject_from_string",
]
