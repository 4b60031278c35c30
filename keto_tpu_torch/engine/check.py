"""Host (oracle) check engine (counterpart of ``keto_tpu/engine/check.py``).

Answers "is `subject` reachable from `namespace:object#relation`" over any
``relationtuple.Manager`` by breadth-first search: ``allowed`` iff the
target subject is reachable within ``max_depth`` tuple indirections along a
*shortest* path. This is the exact semantics of the closure engine, which
uses it as its fallback for rows and snapshots the closure cannot answer.

Depth accounting matches the reference (internal/check/engine.go:116-123):
a match among the tuples of the queried object#relation is at depth 1; each
subject-set indirection adds 1; ``max_depth <= 0`` or values above the
global cap clamp to the global cap.
"""

from __future__ import annotations

import time
from typing import Optional

from ..relationtuple.definitions import (
    Manager,
    RelationQuery,
    RelationTuple,
    SubjectSet,
)
from ..utils.errors import ErrNotFound
from ..utils.pagination import PaginationOptions

DEFAULT_MAX_DEPTH = 5  # reference config.schema.json serve.read.max-depth


def clamp_depth(requested: int, global_max: int) -> int:
    """Global max-depth takes precedence when lesser, or when the request
    depth is <= 0 (reference engine.go:117-120)."""
    if requested <= 0 or global_max < requested:
        return global_max
    return requested


class CheckEngine:
    def __init__(self, manager: Manager, max_depth: int = DEFAULT_MAX_DEPTH):
        self.manager = manager
        self.global_max_depth = max_depth

    def subject_is_allowed(
        self, requested: RelationTuple, max_depth: int = 0
    ) -> bool:
        return bool(self._search(requested, max_depth, None))

    def check_until(
        self, requested: RelationTuple, max_depth: int, deadline: float
    ) -> Optional[bool]:
        """``subject_is_allowed`` that gives up at ``deadline`` (absolute
        ``time.monotonic()``): the clock is read before every page the
        search asks the store for, and None comes back once it has passed.
        An answer it does return is the search's full answer. The device
        breaker bounds its host oracle with it (engine/fallback.py); the
        reference's oracle has no such bound."""
        return self._search(requested, max_depth, deadline)

    def _search(
        self, requested: RelationTuple, max_depth: int, deadline: Optional[float]
    ) -> Optional[bool]:
        depth = clamp_depth(max_depth, self.global_max_depth)
        start = SubjectSet(
            namespace=requested.namespace,
            object=requested.object,
            relation=requested.relation,
        )
        frontier: list[SubjectSet] = [start]
        visited = {str(start)}
        for _level in range(depth):
            next_frontier: list[SubjectSet] = []
            for node in frontier:
                # page loop with early exit on the first match, like the
                # reference's checkOneIndirectionFurther (engine.go:97-113);
                # an unknown namespace counts as no tuples
                query = RelationQuery(
                    namespace=node.namespace,
                    object=node.object,
                    relation=node.relation,
                )
                token = ""
                while True:
                    if deadline is not None and time.monotonic() >= deadline:
                        return None
                    try:
                        page, token = self.manager.get_relation_tuples(
                            query, PaginationOptions(token=token)
                        )
                    except ErrNotFound:
                        break
                    for rel in page:
                        subj = rel.subject
                        if requested.subject.equals(subj):
                            return True
                        if (
                            isinstance(subj, SubjectSet)
                            and str(subj) not in visited
                        ):
                            visited.add(str(subj))
                            next_frontier.append(subj)
                    if not token:
                        break
            if not next_frontier:
                return False
            frontier = next_frontier
        return False

    def batch_check(
        self,
        requests: list[RelationTuple],
        max_depth: int = 0,
        depths: list[int] | None = None,
    ) -> list[bool]:
        if depths is None:
            depths = [max_depth] * len(requests)
        return [
            self.subject_is_allowed(r, d)
            for r, d in zip(requests, depths, strict=True)
        ]
