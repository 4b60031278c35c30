"""Expand engine: the subject tree of a subject set, read through the store
(counterpart of ``keto_tpu/engine/expand.py``; the reference's
internal/expand/engine.go:33-102).

- SubjectID (or depth exhausted) -> Leaf.
- SubjectSet -> Union node whose children are the expansions of each
  tuple's subject; depth <= 1 degrades the node to a Leaf.
- A subject set already visited on the walk, or one with no tuples, yields
  no node (``None``); as a child it renders as a Leaf.
- Tuple pages are followed do-while style.

The traversal is an explicit work stack, not recursion, so a chain deeper
than Python's recursion limit walks fine. The same machinery gives paged
Expand: ``build_tree_page`` expands until ~``page_size`` tree nodes exist,
returns the partial tree (deferred sets as placeholder Leaves) and a
continuation token; later pages return path-addressed subtree patches
(``engine/tree.py apply_expand_patches``). Deferred work resumes in
DFS-preorder, so the visited set mutates in the same order as in the
unpaged walk and the stitched tree equals it exactly. The token pins the
data version; after a write it raises ``ErrStalePageToken``.

This engine is the node-for-node oracle of ``SnapshotExpandEngine``
(``engine/device.py``), and the Expand engine of ``engine.mode: host``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..relationtuple.definitions import (
    Manager,
    RelationQuery,
    Subject,
    SubjectSet,
)
from ..utils.errors import ErrMalformedPageToken, ErrNotFound
from ..utils.pagination import PaginationOptions
from .check import DEFAULT_MAX_DEPTH, clamp_depth
from .paging import decode_page_token, encode_page_token
from .tree import NodeType, Tree

# page budget when a client asks for paging without naming a size and no
# default is configured (engine.expand_page_size)
FALLBACK_PAGE_SIZE = 1024


@dataclass
class ExpandPage:
    """One page of a paged Expand. The first page carries ``tree`` (deferred
    sets as placeholder Leaves); continuation pages carry ``patches``,
    (path, subtree) pairs addressing placeholder Leaves of the stitched tree
    so far. ``next_page_token`` is empty when the expansion is complete."""

    tree: Optional[Tree] = None
    patches: list = field(default_factory=list)
    next_page_token: str = ""

    def to_dict(self) -> dict:
        out: dict = {}
        if self.patches:
            out["patches"] = [
                {"path": list(path), "tree": t.to_dict()}
                for path, t in self.patches
            ]
        else:
            out["tree"] = None if self.tree is None else self.tree.to_dict()
        if self.next_page_token:
            out["next_page_token"] = self.next_page_token
        return out


def encode_expand_page_token(kind: str, version, pending, visited) -> str:
    """Continuation cursor: the deferred work items (in DFS-preorder resume
    order), the visited set and the data version the page was cut at."""
    return encode_page_token(
        kind,
        version,
        {
            "p": [[list(path), ref, rest] for path, ref, rest in pending],
            "vis": visited,
        },
    )


def decode_expand_page_token(token: str, kind: str, version):
    """-> (pending, visited). Raises ErrMalformedPageToken on garbage or a
    cursor of the other engine flavor, ErrStalePageToken on a version
    mismatch."""
    payload = decode_page_token(token, kind, version, what="expand page")
    try:
        pending = [
            (list(path), ref, int(rest)) for path, ref, rest in payload["p"]
        ]
        visited = payload["vis"]
    except Exception as e:
        raise ErrMalformedPageToken("malformed expand page token") from e
    return pending, visited


class _Frame:
    """One open Union node on the explicit traversal stack."""

    __slots__ = ("subject", "children", "subjects", "i", "rest", "path")

    def __init__(self, subject, subjects, rest, path):
        self.subject = subject
        self.children: list[Tree] = []
        self.subjects = subjects  # child subjects, store insertion order
        self.i = 0
        self.rest = rest
        self.path = path


class ExpandEngine:
    def __init__(
        self,
        manager: Manager,
        max_depth: int = DEFAULT_MAX_DEPTH,
        default_page_size: int = 0,
    ):
        self.manager = manager
        self.global_max_depth = max_depth
        self.default_page_size = default_page_size

    def build_tree(self, subject: Subject, max_depth: int = 0) -> Optional[Tree]:
        depth = clamp_depth(max_depth, self.global_max_depth)
        if not isinstance(subject, SubjectSet):
            return Tree(type=NodeType.LEAF, subject=subject)
        # unbounded budget: nothing defers, the walk completes in one call
        return self._expand_one(subject, depth, [], set(), [float("inf")], [])

    def build_tree_page(
        self,
        subject: Subject,
        max_depth: int = 0,
        page_size: int = 0,
        page_token: str = "",
    ) -> ExpandPage:
        """Frontier-bounded Expand: materialize ~page_size tree nodes (the
        last entered node may overshoot by its fan-out), defer the rest."""
        depth = clamp_depth(max_depth, self.global_max_depth)
        if page_size <= 0:
            page_size = self.default_page_size or FALLBACK_PAGE_SIZE
        if not isinstance(subject, SubjectSet):
            return ExpandPage(tree=Tree(type=NodeType.LEAF, subject=subject))
        version = getattr(self.manager, "version", 0)
        if page_token:
            pending, vis = decode_expand_page_token(page_token, "host", version)
            visited = set(vis)
            work = [
                (path, SubjectSet(ref[0], ref[1], ref[2]), rest)
                for path, ref, rest in pending
            ]
            first = False
        else:
            visited = set()
            work = [([], subject, depth)]
            first = True
        budget = [page_size]
        tree: Optional[Tree] = None
        patches = []
        while work and budget[0] > 0:
            path, subj, rest = work.pop(0)
            deferred: list = []
            t = self._expand_one(subj, rest, path, visited, budget, deferred)
            # deferred descendants resume BEFORE later pending items: that
            # is their DFS-preorder position in the unpaged walk
            work = deferred + work
            if first:
                tree = t
                first = False
            elif t is not None:
                patches.append((path, t))
        token = ""
        if work:
            token = encode_expand_page_token(
                "host",
                version,
                [
                    (path, [s.namespace, s.object, s.relation], rest)
                    for path, s, rest in work
                ],
                sorted(visited),
            )
        return ExpandPage(tree=tree, patches=patches, next_page_token=token)

    # -- traversal core --------------------------------------------------------

    def _subjects_of(self, subject: SubjectSet) -> Optional[list[Subject]]:
        """Every tuple subject of the set, following store pages; None for
        an unknown namespace or a set with no tuples."""
        query = RelationQuery(
            namespace=subject.namespace,
            object=subject.object,
            relation=subject.relation,
        )
        rels, token = [], ""
        while True:
            try:
                page, token = self.manager.get_relation_tuples(
                    query, PaginationOptions(token=token)
                )
            except ErrNotFound:
                return None
            rels.extend(page)
            if not token:
                break
        if not rels:
            return None
        return [r.subject for r in rels]

    def _enter(self, subject, rest, path, visited, budget):
        """The visited/fetch/depth gate of one subject set: a terminal
        Optional[Tree] or an open _Frame for its union node."""
        key = str(subject)
        if key in visited:
            return None
        visited.add(key)
        subjects = self._subjects_of(subject)
        if subjects is None:
            return None
        budget[0] -= 1
        if rest <= 1:
            return Tree(type=NodeType.LEAF, subject=subject)
        return _Frame(subject, subjects, rest, path)

    def _expand_one(
        self, subject, rest, path, visited, budget, deferred
    ) -> Optional[Tree]:
        """Expand one work item with an explicit stack. Once `budget` is
        spent, every not-yet-entered subject set renders as a placeholder
        Leaf and is appended to `deferred` (in DFS-preorder)."""
        res = self._enter(subject, rest, path, visited, budget)
        if not isinstance(res, _Frame):
            return res
        stack = [res]
        while True:
            fr = stack[-1]
            if fr.i >= len(fr.subjects):
                stack.pop()
                tree = Tree(
                    type=NodeType.UNION, subject=fr.subject, children=fr.children
                )
                if not stack:
                    return tree
                stack[-1].children.append(tree)
                continue
            idx = fr.i
            fr.i += 1
            child_subject = fr.subjects[idx]
            if not isinstance(child_subject, SubjectSet):
                budget[0] -= 1
                fr.children.append(Tree(type=NodeType.LEAF, subject=child_subject))
                continue
            child_path = fr.path + [idx]
            if budget[0] <= 0:
                # page budget spent: a placeholder Leaf now, the expansion on
                # a later page (whose _enter re-checks visited, as the
                # unpaged walk would at this preorder position)
                fr.children.append(Tree(type=NodeType.LEAF, subject=child_subject))
                deferred.append((child_path, child_subject, fr.rest - 1))
                continue
            res = self._enter(child_subject, fr.rest - 1, child_path, visited, budget)
            if isinstance(res, _Frame):
                stack.append(res)
            else:
                # a nil child (visited, or a set with no tuples) renders as
                # a Leaf for that subject, never dropped (engine.go:80-86)
                fr.children.append(
                    res
                    if res is not None
                    else Tree(type=NodeType.LEAF, subject=child_subject)
                )
