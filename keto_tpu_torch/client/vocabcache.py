"""Client-side versioned vocab cache for the id-native wire tier
(counterpart of ``keto_tpu/client/vocabcache.py``, on ``urllib.request``
instead of httpx: ``utils/urlfetch.py``).

A trusted client (sidecar, gateway, load generator) that wants the encoded
``POST /check/batch-encoded`` path must encode tuples to node ids with the
SAME vocab the server serves from. This cache mirrors that vocab over the
read plane's two sync endpoints:

- ``GET /vocab/snapshot`` — paged bootstrap of the full key list, tagged
  with the server's ``(lineage, epoch)``;
- ``GET /vocab/deltas?lineage=..&from=..`` — keys interned since the
  cache's epoch (the epoch doubles as the delta cursor).

The cache derives the dense namespace-id table from the synced keys with
the same first-appearance scan the server uses
(:class:`keto_tpu_torch.graph.vocabsync.NamespaceTable`), so the namespace
ids it stamps on encoded rows agree with the server's QoS bucketing by
construction — the table is never shipped.

``encode()`` maps unknown keys to ``-1``; the server clamps any
out-of-range id to the inert dummy node, so a subject the cache has never
seen checks to False exactly like the string path. Staleness is the
server's to detect: a write between ``encode()`` and the request landing
bumps the server epoch and bounces the request with the typed mismatch
error (409), whose details carry the resync hint ``sync()`` follows (delta
catch-up within a lineage, full re-bootstrap across a vocab change).

``batch_check_encoded(cache, tuples)`` is the whole round trip: encode,
send the frame, and on a 409 sync and resend. It is
``RestClient.batch_check_encoded`` on a client of the cache's read URL.
"""

from __future__ import annotations

import json
from typing import Sequence
from urllib.parse import urlencode

import numpy as np

from ..api import wirecodec
from ..graph.vocab import subject_node_key
from ..graph.vocabsync import NS_UNKNOWN, NamespaceTable
from ..relationtuple.definitions import RelationTuple
from ..utils.errors import ErrVocabEpochMismatch, KetoError
from ..utils.urlfetch import fetch


class VocabCache:
    """A synced mirror of the serving vocab: key -> id, plus the derived
    namespace table. Not thread-safe; give each encoding thread its own
    cache or serialize access externally."""

    def __init__(
        self, read_url: str, timeout: float = 30.0, page_size: int = 200_000,
        verify=True,  # httpx's: True, False, a CA path or an SSLContext
    ):
        self.read_url = read_url.rstrip("/")
        self.timeout = timeout
        self.verify = verify
        self.page_size = int(page_size)
        self.lineage: str = ""
        self.epoch: int = 0
        self._keys: list[tuple] = []
        self._id_of: dict[tuple, int] = {}
        self._ns_table = NamespaceTable()

    def __len__(self) -> int:
        return len(self._keys)

    # -- sync ------------------------------------------------------------------

    def _get_json(self, path: str, params: dict) -> dict:
        status, raw, _ = fetch(
            f"{self.read_url}{path}?{urlencode(params)}", timeout=self.timeout,
            verify=self.verify,
        )
        if status == 409:
            try:
                details = json.loads(raw)["error"]["details"]
            except (ValueError, KeyError, TypeError):
                details = {}
            raise ErrVocabEpochMismatch(
                server_lineage=details.get("server_lineage", ""),
                server_epoch=int(details.get("server_epoch", 0)),
                client_lineage=self.lineage,
                client_epoch=self.epoch,
            )
        if status != 200:
            raise KetoError(f"vocab sync {path} failed: HTTP {status}")
        return json.loads(raw)

    def _absorb(self, keys: Sequence[Sequence[str]]) -> None:
        id_of = self._id_of
        store = self._keys
        for k in keys:
            t = tuple(k)
            id_of[t] = len(store)
            store.append(t)

    def bootstrap(self) -> "VocabCache":
        """Full (re-)bootstrap: page the snapshot until the cache covers the
        epoch the first page reported, then delta-sync to now (the vocab
        may have grown while paging)."""
        self.lineage = ""
        self.epoch = 0
        self._keys = []
        self._id_of = {}
        self._ns_table = NamespaceTable()
        offset = 0
        target_epoch = None
        while target_epoch is None or offset < target_epoch:
            page = self._get_json(
                "/vocab/snapshot", {"offset": offset, "limit": self.page_size}
            )
            if target_epoch is None:
                self.lineage = page["lineage"]
                target_epoch = int(page["epoch"])
            elif page["lineage"] != self.lineage:
                # vocab replaced mid-bootstrap: start over on the new lineage
                return self.bootstrap()
            keys = page["keys"]
            self._absorb(keys)
            offset += len(keys)
            if not keys and offset < target_epoch:
                raise KetoError("vocab snapshot paging stalled")
        self.epoch = offset
        self._ns_table.extend_from_keys(self._keys)
        return self.sync()

    def sync(self) -> "VocabCache":
        """Catch up to the server's current epoch. Delta within the lineage;
        transparent re-bootstrap when the server's vocab was replaced
        (lineage changed) or the cache has never bootstrapped."""
        if not self.lineage:
            return self.bootstrap()
        try:
            page = self._get_json(
                "/vocab/deltas", {"lineage": self.lineage, "from": self.epoch}
            )
        except ErrVocabEpochMismatch:
            return self.bootstrap()
        self._absorb(page["keys"])
        self.epoch = int(page["epoch"])
        self._ns_table.extend_from_keys(self._keys)
        return self

    # -- encode ----------------------------------------------------------------

    def encode(
        self, tuples: Sequence[RelationTuple | str]
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(start_ids, target_ids, ns_ids) int32 columns for ``tuples``,
        encoded against the cache's current epoch. Unknown keys become
        ``-1`` (server-side: the inert dummy node -> allowed False);
        namespace ids index the derived table (``-1`` = unknown)."""
        n = len(tuples)
        start = np.empty(n, dtype=np.int32)
        target = np.empty(n, dtype=np.int32)
        ns = np.empty(n, dtype=np.int32)
        id_of = self._id_of.get
        ns_of = self._ns_table.id_of
        for i, t in enumerate(tuples):
            if isinstance(t, str):
                t = RelationTuple.from_string(t)
            s = id_of((t.namespace, t.object, t.relation))
            g = id_of(subject_node_key(t.subject))
            start[i] = -1 if s is None else s
            target[i] = -1 if g is None else g
            ns[i] = ns_of(t.namespace)
        return start, target, ns

    def ns_id(self, namespace: str) -> int:
        return self._ns_table.id_of(namespace)

    def frame(self, tuples: Sequence[RelationTuple | str], **kw) -> bytes:
        """One ``KTE1`` request frame for ``tuples`` at the cache's epoch;
        ``kw`` goes to ``wirecodec.encode_check_request`` (depths,
        min_version, traceparent)."""
        start, target, ns = self.encode(tuples)
        return wirecodec.encode_check_request(
            start, target, lineage=self.lineage, epoch=self.epoch, ns=ns, **kw
        )


def post_frame(read_url: str, frame: bytes, timeout: float = 30.0, verify=True):
    """POST one encoded frame to ``/check/batch-encoded``: (status, body)."""
    status, body, _ = fetch(
        f"{read_url.rstrip('/')}/check/batch-encoded", frame,
        {"Content-Type": "application/octet-stream"}, timeout, verify=verify,
    )
    return status, body


def batch_check_encoded(
    cache: VocabCache,
    tuples: Sequence[RelationTuple | str],
    max_resyncs: int = 2,
    **kw,
) -> list[bool]:
    """The id-native round trip on a one-call ``RestClient`` of the cache's
    read URL: encode ``tuples`` against ``cache``, POST the frame, decode
    the bitset, and on a 409 re-sync and resend (at most ``max_resyncs``
    times). ``kw`` (``snaptoken``, ``traceparent``) goes to
    ``RestClient.batch_check_encoded``."""
    from . import RestClient  # the client package imports this module

    with RestClient(cache.read_url, timeout=cache.timeout, verify=cache.verify) as client:
        return client.batch_check_encoded(cache, tuples, max_resyncs=max_resyncs, **kw)


__all__ = ["VocabCache", "NS_UNKNOWN", "batch_check_encoded", "post_frame"]
