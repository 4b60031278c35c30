"""The id-native check front: everything between a decoded encoded-check
frame and the check batcher (counterpart of ``keto_tpu/api/encoded.py``).

``POST /check/batch-encoded`` (and gRPC ``BatchCheckEncoded``) decodes the
wire frame and hands it here. The front owns the parts every transport must
agree on:

- the strict vocab ``(lineage, epoch)`` gate (``graph/vocabsync``) — a
  mismatch raises the typed resync error before any engine work;
- the defensive id clamp: epoch equality already proves every client id is
  in range, but pre-encoded ids are still caller-supplied integers, so
  anything outside ``[0, padded_nodes)`` is clamped to the inert dummy node
  (the idiom of ``GraphSnapshot.encode_requests``) instead of indexing out
  of bounds;
- the QoS mapping: the request's namespace-id column is bucketed with
  ``np.bincount`` and only the *unique* ids are mapped back to tenant names
  through the NamespaceTable — per-namespace counts flow into the
  batcher's ``NamespaceQos`` buckets with O(tenants) string work.

The ``backend`` is anything with the batcher's ``check_batch_encoded``
signature: the in-process ``CheckBatcher`` in single-process mode, or a
``shmring.RingBackend`` in a wire worker (an accept/parse worker process
funneling into the parent's single batcher), which the front finds by its
``ring_submit`` hook.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..graph import vocabsync
from .wirecodec import EncodedCheckRequest


class EncodedCheckFront:
    """``validate=False`` is the parent-side ring consumer's mode: the
    worker that accepted the request already ran the strict epoch gate
    against a vocab at least as old as the parent's (ids are append-only
    within a lineage), so the parent must not gate again: its epoch has
    usually moved past the client's by the time the frame crosses the
    ring."""

    def __init__(self, manager, backend, validate: bool = True):
        self.manager = manager
        self.backend = backend
        self.validate = validate

    def vocab(self):
        return self.manager.snapshot().vocab

    def check(
        self,
        req: EncodedCheckRequest,
        timeout: Optional[float] = None,
    ) -> np.ndarray:
        snap = self.manager.snapshot()
        vocab = snap.vocab
        if self.validate:
            vocabsync.validate_epoch(vocab, req.lineage, req.epoch)
        pn = snap.padded_nodes
        dummy = snap.dummy_node
        s = req.start.astype(np.int64)
        t = req.target.astype(np.int64)
        s = np.where((s < 0) | (s >= pn), dummy, s)
        t = np.where((t < 0) | (t >= pn), dummy, t)
        ring = getattr(self.backend, "ring_submit", None)
        if ring is not None:
            # a wire worker: ship the hop-ready batch to the parent's
            # batcher; the qos counts are derived (and debited once) there
            return np.asarray(ring(req, s, t, timeout=timeout), dtype=bool)
        allowed = self.backend.check_batch_encoded(
            s,
            t,
            depths=req.depths,
            min_version=req.min_version,
            timeout=timeout,
            ns_counts=self.ns_counts(vocab, req.ns),
        )
        return np.asarray(allowed, dtype=bool)

    @staticmethod
    def ns_counts(vocab, ns_ids) -> Optional[dict]:
        """Per-tenant row counts from the namespace-id column; None when the
        client sent no column (QoS then sees nothing to debit, as for an
        engine-direct caller)."""
        if ns_ids is None or len(ns_ids) == 0:
            return None
        table = vocabsync.ns_table_of(vocab)
        ids = np.asarray(ns_ids)
        valid = (ids >= 0) & (ids < len(table))
        counts: dict[str, int] = {}
        n_valid = int(valid.sum())
        if n_valid:
            c = np.bincount(ids[valid], minlength=len(table))
            for i in np.nonzero(c)[0]:
                counts[table.names[int(i)]] = int(c[i])
        unknown = len(ids) - n_valid
        if unknown:
            counts[vocabsync.NS_UNKNOWN_LABEL] = unknown
        return counts
