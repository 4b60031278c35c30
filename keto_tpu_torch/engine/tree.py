"""Expand result tree (counterpart of ``keto_tpu/engine/tree.py``; the
reference's internal/expand/tree.go).

``Tree{type, subject, children}`` with NodeType union/exclusion/
intersection/leaf (only union and leaf are produced). The JSON wire form is
the reference's ``expandTree``: ``{"type", "children"?, "subject_id"? |
"subject_set"?}``.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Mapping, Optional

from ..relationtuple.definitions import Subject, SubjectID, subject_from_dict
from ..utils.errors import ErrMalformedInput


class NodeType(str, enum.Enum):
    UNION = "union"
    EXCLUSION = "exclusion"
    INTERSECTION = "intersection"
    LEAF = "leaf"

    def __str__(self) -> str:  # json value
        return self.value


@dataclass
class Tree:
    type: NodeType
    subject: Subject
    children: list["Tree"] = field(default_factory=list)

    def to_dict(self) -> dict:
        # wire form: subject_id XOR subject_set (tree.go:84-90)
        n: dict = {"type": self.type.value}
        if isinstance(self.subject, SubjectID):
            n["subject_id"] = self.subject.id
        else:
            n["subject_set"] = self.subject.to_dict()
        if self.children:
            n["children"] = [c.to_dict() for c in self.children]
        return n

    @classmethod
    def from_dict(cls, d: Mapping) -> "Tree":
        try:
            node_type = NodeType(d["type"])
        except (KeyError, ValueError) as e:
            raise ErrMalformedInput(f"unknown node type: {d.get('type')!r}") from e
        if d.get("subject_id") is not None and d.get("subject_set") is not None:
            raise ErrMalformedInput("subject_id and subject_set are mutually exclusive")
        if d.get("subject_id") is not None:
            subject: Subject = SubjectID(id=d["subject_id"])
        elif d.get("subject_set") is not None:
            subject = subject_from_dict(d["subject_set"])
        else:
            raise ErrMalformedInput("tree node without subject")
        children = [cls.from_dict(c) for c in d.get("children") or []]
        return cls(type=node_type, subject=subject, children=children)

    def __str__(self) -> str:
        """The reference CLI's rendering (tree.go:218-235): leaves marked
        with a clover, unions with ∪."""
        if self.type == NodeType.LEAF:
            return f"☘ {self.subject}️"
        children = [
            "\n│  ".join(str(c).split("\n")) for c in self.children
        ]
        return f"∪ {self.subject}\n├─ " + "\n├─ ".join(children)

    def flat_subjects(self) -> list[Subject]:
        """Every node's subject, preorder (an explicit stack: trees deeper
        than the recursion limit flatten too)."""
        out: list[Subject] = []
        stack = [self]
        while stack:
            node = stack.pop()
            out.append(node.subject)
            stack.extend(reversed(node.children))
        return out


def tree_to_optional_dict(t: Optional[Tree]) -> Optional[dict]:
    return None if t is None else t.to_dict()


def apply_expand_patches(tree: Tree, patches) -> Tree:
    """Stitch paged-Expand continuation pages into the first page's tree.

    Each patch is ``(path, subtree)``: ``path`` is the child-index path from
    the root to a placeholder Leaf the paged traversal deferred; the
    placeholder is replaced in place by its expansion. Applying every
    page's patches in order reproduces the unpaged tree exactly.
    """
    for path, sub in patches:
        if not path:
            raise ErrMalformedInput("expand patch with empty path")
        node = tree
        for idx in path[:-1]:
            try:
                node = node.children[idx]
            except (IndexError, TypeError) as e:
                raise ErrMalformedInput(
                    f"expand patch path {list(path)} does not resolve"
                ) from e
        last = path[-1]
        if not (0 <= last < len(node.children)):
            raise ErrMalformedInput(
                f"expand patch path {list(path)} does not resolve"
            )
        node.children[last] = (
            sub if isinstance(sub, Tree) else Tree.from_dict(sub)
        )
    return tree
