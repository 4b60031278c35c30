"""List serving: reverse-closure answers to "what can this subject see?"
(counterpart of ``keto_tpu/engine/listing.py``).

Check answers one (object#relation, subject) cell of the ACL matrix; the
list queries walk a whole row or column of it:

- ``list_objects(subject, relation, namespace)``: every object on which
  the subject holds ``relation``;
- ``list_subjects(namespace, object, relation)``: every subject id the
  object's relation resolves to.

Both are answered by gathers against the closure engine's reverse
residency (``engine/closure.py reverse_artifacts``): the transposed closure
``D^T`` on the card and the reverse boundary CSRs (``graph/reverse.py``).
The check decomposition (``graph/interior.py``) factors every path as

    start -> s (boundary in) ~~> s' (interior, D) -> target (boundary out)

so fixing the target and asking "which starts?" is one masked row gather:

- ``list_objects``, subject-id target T: interior nodes with
  ``min over s' in L(T) of D[s, s'] <= depth - 2`` (an elementwise min of
  the D^T rows at L(T)); the answers are their ``set_in`` preimages and
  T's direct predecessors;
- ``list_objects``, subject-set target: the D^T row at the target's
  interior index, threshold ``depth - 1``;
- ``list_subjects`` from set S: the min of the forward D rows at F0(S),
  threshold ``depth - 2``; the answers are their ``id_out`` images and S's
  direct id successors.

``_rows_min`` is the device work: ``index_select`` + ``amin`` on the card,
one [m_pad] row back to the host. In host query mode D and D^T are numpy
arrays and it is a numpy gather-min, with no torch op at all (a forked
read replica lists from them). The rest is host numpy.

The serving shape is the check path's: encode (resolve the residency) ->
gather -> decode (ids -> sorted strings, page slice), with the caller's
deadline checked between stages. When the reverse path cannot answer
exactly (no resident closure, reverse serving disabled) or a gather fails,
the request is answered by the live-store oracle, which is always exact;
a run of gather failures opens a breaker that pins the oracle for a
cooldown. The oracle is the reference's exact-answer escalation, not a
device fallback: an error of the card still counts as a failure and opens
the breaker. Both reverse gathers carry the ``list.gather_fail`` fault
site (``faults.py``), which drives that breaker in the tests.

Pages ride the shared continuation tokens (``engine/paging.py``): they pin
the data version (stale -> 409 ``ErrStalePageToken``) and echo the query
(reuse on another query -> 400).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..faults import FAULTS
from ..relationtuple.definitions import (
    RelationQuery,
    RelationTuple,
    Subject,
    SubjectID,
)
from ..utils.errors import DeadlineExceeded, ErrMalformedPageToken, KetoError
from ..utils.pagination import PaginationOptions
from .check import clamp_depth
from .paging import decode_page_token, encode_page_token

#: consecutive reverse-path failures before the breaker pins the oracle
_BREAKER_THRESHOLD = 3
#: seconds the open breaker serves from the oracle before re-probing
_BREAKER_COOLDOWN_S = 30.0
#: oracle candidate loops re-check the caller's deadline this often
_DEADLINE_STRIDE = 256


@dataclass
class ListPage:
    """One page of a list query. ``items`` are object names
    (``list_objects``) or subject ids (``list_subjects``), sorted;
    ``version`` is the store version the page was computed at; ``source``
    says which path answered ("reverse" or "oracle") — diagnostics, not
    part of the wire contract."""

    items: list = field(default_factory=list)
    next_page_token: str = ""
    version: int = 0
    source: str = "reverse"


def _csr_row(indptr: np.ndarray, vals: np.ndarray, row: int) -> np.ndarray:
    return vals[indptr[row] : indptr[row + 1]]


def _csr_rows_concat(
    indptr: np.ndarray, vals: np.ndarray, rows: np.ndarray
) -> np.ndarray:
    """Many CSR rows concatenated (the ``set_in``/``id_out`` preimage of
    every qualifying interior node)."""
    if rows.size == 0:
        return np.empty(0, dtype=np.int32)
    counts = indptr[rows + 1] - indptr[rows]
    out = np.empty(int(counts.sum()), dtype=np.int32)
    pos = 0
    for r, c in zip(rows.tolist(), counts.tolist()):
        out[pos : pos + c] = vals[indptr[r] : indptr[r] + c]
        pos += c
    return out


def _rows_min(mat, rows: np.ndarray) -> np.ndarray:
    """Elementwise min over a set of rows of a closure matrix (uint8
    [m_pad, m_pad], a tensor or a host-mode numpy array) -> numpy
    uint8[m_pad]. On the card: one index_select and one amin, one row back
    to the host; a numpy array or a CPU tensor takes numpy."""
    if isinstance(mat, np.ndarray):
        return mat[rows].min(axis=0)
    if mat.device.type == "cpu":
        return mat.numpy()[rows].min(axis=0)
    idx = torch.from_numpy(np.asarray(rows, dtype=np.int64)).to(mat.device)
    return mat.index_select(0, idx).amin(dim=0).cpu().numpy()


class ListEngine:
    """Reverse-index list serving over a ClosureCheckEngine's residency.

    Safe for concurrent list calls (the gathers only read; the breaker
    fields are guarded). Every path that cannot guarantee the forward
    fixpoint goes to the live-store oracle: the engine never answers
    inexactly."""

    def __init__(
        self,
        engine,
        default_page_size: int = 0,
        breaker_threshold: int = _BREAKER_THRESHOLD,
        breaker_cooldown_s: float = _BREAKER_COOLDOWN_S,
        clock=time.monotonic,
    ):
        self.engine = engine
        self.default_page_size = default_page_size
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown_s = breaker_cooldown_s
        self._clock = clock
        self._lock = threading.Lock()
        self._fail_streak = 0
        self._open_until = 0.0
        # served-request counters (tests, the smoke run)
        self.n_reverse = 0
        self.n_oracle = 0
        self.n_reverse_failures = 0
        self.last_failure: Optional[BaseException] = None

    # -- breaker ---------------------------------------------------------------

    def breaker_open(self) -> bool:
        with self._lock:
            return self._clock() < self._open_until

    def _note_reverse_ok(self) -> None:
        with self._lock:
            self._fail_streak = 0
            self.n_reverse += 1

    def _note_reverse_failure(self, exc: Exception) -> None:
        with self._lock:
            self.n_reverse_failures += 1
            self.last_failure = exc
            self._fail_streak += 1
            if self._fail_streak >= self.breaker_threshold:
                self._open_until = self._clock() + self.breaker_cooldown_s
                self._fail_streak = 0

    # -- public API ------------------------------------------------------------

    def list_objects(
        self,
        subject: Subject,
        relation: str,
        namespace: str,
        max_depth: int = 0,
        page_size: int = 0,
        page_token: str = "",
        deadline: Optional[float] = None,
        rec=None,
    ) -> ListPage:
        depth = clamp_depth(max_depth, self.engine.global_max_depth)
        query = ["objects", namespace, relation, str(subject), depth]
        return self._serve(
            query,
            lambda view: self._reverse_list_objects(
                view, subject, relation, namespace, depth
            ),
            lambda: self._oracle_list_objects(
                subject, relation, namespace, depth, deadline
            ),
            page_size,
            page_token,
            deadline,
            rec,
        )

    def list_subjects(
        self,
        namespace: str,
        object: str,
        relation: str,
        max_depth: int = 0,
        page_size: int = 0,
        page_token: str = "",
        deadline: Optional[float] = None,
        rec=None,
    ) -> ListPage:
        depth = clamp_depth(max_depth, self.engine.global_max_depth)
        query = ["subjects", namespace, object, relation, depth]
        return self._serve(
            query,
            lambda view: self._reverse_list_subjects(
                view, namespace, object, relation, depth
            ),
            lambda: self._oracle_list_subjects(
                namespace, object, relation, depth, deadline
            ),
            page_size,
            page_token,
            deadline,
            rec,
        )

    # -- the encode -> gather -> decode spine ----------------------------------

    def _serve(
        self,
        query: list,
        reverse_fn,
        oracle_fn,
        page_size: int,
        page_token: str,
        deadline: Optional[float],
        rec,
    ) -> ListPage:
        """``rec`` (the transport's check-telemetry record, or None) marks
        the encode, gather ("launch") and decode stages on the request's
        attribution ledger."""
        # encode: pick the serving residency. reverse_artifacts() is None
        # whenever the reverse path could be inexact; those requests answer
        # from the oracle without touching the breaker
        self._check_deadline(deadline)
        view = None
        if not self.breaker_open():
            view = self.engine.reverse_artifacts()
        if rec is not None:
            rec.mark("encode")

        # gather: the full sorted result, recomputed per page. Slicing one
        # deterministic sorted list makes paged == unpaged, and the version
        # pin below turns a write between two pages into a 409
        source = "reverse"
        items: Optional[list] = None
        if view is not None:
            try:
                self._check_deadline(deadline)
                items = reverse_fn(view)
                self._note_reverse_ok()
            except KetoError:
                raise  # deadline and typed errors are the caller's
            except Exception as e:  # noqa: BLE001 — the breaker seam
                self._note_reverse_failure(e)
                items = None
        if items is None:
            source = "oracle"
            self._check_deadline(deadline)
            items = oracle_fn()
            with self._lock:
                self.n_oracle += 1
        version = (
            view.version if source == "reverse" else self.engine.snapshots.store.version
        )
        if rec is not None:
            rec.mark("launch")

        # decode: validate the cursor against the version that answered,
        # slice, mint the continuation
        offset = self._decode_list_token(page_token, query, version)
        self._check_deadline(deadline)
        if page_size <= 0:
            page_size = self.default_page_size
        next_token = ""
        if page_size > 0:
            end = offset + page_size
            if end < len(items):
                next_token = encode_page_token("list", version, {"q": query, "o": end})
            items = items[offset:end]
        elif offset:
            items = items[offset:]
        if rec is not None:
            rec.mark("decode")
        return ListPage(
            items=items, next_page_token=next_token, version=version, source=source
        )

    @staticmethod
    def _check_deadline(deadline: Optional[float]) -> None:
        if deadline is not None and time.monotonic() > deadline:
            raise DeadlineExceeded()

    @staticmethod
    def _decode_list_token(token: str, query: list, version) -> int:
        if not token:
            return 0
        payload = decode_page_token(token, "list", version, what="list page")
        try:
            offset = int(payload["o"])
            tq = payload["q"]
        except Exception as e:
            raise ErrMalformedPageToken("malformed list page token") from e
        if tq != query or offset < 0:
            raise ErrMalformedPageToken(
                "list page token was minted for a different query"
            )
        return offset

    # -- reverse gathers -------------------------------------------------------

    def _reverse_list_objects(
        self, view, subject, relation: str, namespace: str, depth: int
    ) -> list:
        FAULTS.fire("list.gather_fail")
        snap, ig, rev = view.snap, view.ig, view.rev
        t = snap.node_for_subject(subject)
        cand: list[np.ndarray] = []
        if depth >= 1:
            cand.append(rev.direct_preds(t))
        if depth >= 2:
            t_int = int(ig.interior_index[t])
            if t_int >= 0:
                # set target: start -> s (1 edge) ~~> target (D[s, t]);
                # one D^T row, threshold depth - 1
                mins = _rows_min(view.d_rev, np.asarray([t_int], dtype=np.int64))
                qual = np.nonzero(mins[: ig.m] <= depth - 1)[0]
            else:
                # id target: start -> s ~~> s' -> target, s' in L(target);
                # elementwise min of the D^T rows at L, threshold depth - 2
                l_idx = _csr_row(ig.id_in_indptr, ig.id_in_vals, t)
                if l_idx.size:
                    mins = _rows_min(view.d_rev, l_idx.astype(np.int64))
                    qual = np.nonzero(mins[: ig.m] <= depth - 2)[0]
                else:
                    qual = np.empty(0, dtype=np.int64)
            cand.append(_csr_rows_concat(rev.set_in_indptr, rev.set_in_vals, qual))
        vocab = snap.vocab
        out = set()
        for nid in np.unique(np.concatenate(cand)) if cand else ():
            k = vocab.key(int(nid))
            if len(k) == 3 and k[0] == namespace and k[2] == relation:
                out.add(k[1])
        return sorted(out)

    def _reverse_list_subjects(
        self, view, namespace: str, object: str, relation: str, depth: int
    ) -> list:
        FAULTS.fire("list.gather_fail")
        snap, ig, rev = view.snap, view.ig, view.rev
        s = snap.node_for_set(namespace, object, relation)
        cand: list[np.ndarray] = []
        if depth >= 1:
            cand.append(snap.out_neighbors(s))
        if depth >= 2:
            f0 = _csr_row(ig.set_out_indptr, ig.set_out_vals, s)
            if f0.size:
                # start -> s (1) ~~> s' (D) -> id (1): the forward D rows at
                # F0(start), threshold depth - 2
                mins = _rows_min(view.d, f0.astype(np.int64))
                qual = np.nonzero(mins[: ig.m] <= depth - 2)[0]
                cand.append(_csr_rows_concat(rev.id_out_indptr, rev.id_out_vals, qual))
        vocab = snap.vocab
        out = set()
        for nid in np.unique(np.concatenate(cand)) if cand else ():
            k = vocab.key(int(nid))
            if len(k) == 1:
                out.add(k[0])
        return sorted(out)

    # -- the live-store oracle -------------------------------------------------
    #
    # The candidate universes are the reverse path's: a qualifying object
    # has at least one (ns, obj, rel) tuple, a qualifying subject id appears
    # as some tuple's subject. Each candidate is settled by the exact
    # fallback check engine over the live store.

    def _scan_tuples(self, query: RelationQuery, deadline):
        mgr = self.engine.snapshots.store
        token = ""
        while True:
            self._check_deadline(deadline)
            page, token = mgr.get_relation_tuples(query, PaginationOptions(token=token))
            yield from page
            if not token:
                return

    def _oracle_list_objects(
        self, subject, relation: str, namespace: str, depth: int, deadline
    ) -> list:
        objects = set()
        for t in self._scan_tuples(
            RelationQuery(namespace=namespace, relation=relation), deadline
        ):
            objects.add(t.object)
        fb = self.engine.fallback_engine()
        out = []
        for i, o in enumerate(sorted(objects)):
            if i % _DEADLINE_STRIDE == 0:
                self._check_deadline(deadline)
            if fb.subject_is_allowed(
                RelationTuple(
                    namespace=namespace, object=o, relation=relation, subject=subject
                ),
                depth,
            ):
                out.append(o)
        return out

    def _oracle_list_subjects(
        self, namespace: str, object: str, relation: str, depth: int, deadline
    ) -> list:
        subjects = set()
        for t in self._scan_tuples(RelationQuery(), deadline):
            if isinstance(t.subject, SubjectID):
                subjects.add(t.subject.id)
        fb = self.engine.fallback_engine()
        out = []
        for i, sid in enumerate(sorted(subjects)):
            if i % _DEADLINE_STRIDE == 0:
                self._check_deadline(deadline)
            if fb.subject_is_allowed(
                RelationTuple(
                    namespace=namespace,
                    object=object,
                    relation=relation,
                    subject=SubjectID(id=sid),
                ),
                depth,
            ):
                out.append(sid)
        return out
