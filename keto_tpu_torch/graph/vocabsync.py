"""Versioned vocab coordinates for the id-native wire tier (counterpart
of ``keto_tpu/graph/vocabsync.py``).

Pre-encoded checks are only meaningful against the exact vocab instance
the client encoded with, so every encoded request is tagged with two
coordinates and the server accepts it only on an exact match:

- **lineage** — a per-``NodeVocab``-instance nonce. The snapshot manager
  keeps one append-only vocab for its whole life, delete-triggered
  rebuilds included (deletes orphan their ids; the columnar store's vocab
  is the store's own), so ids are reassigned only when a new vocab object
  takes over — a new manager or store, a restarted server: same length,
  possibly, but a different meaning. The lineage nonce is what makes that
  swap visible on the wire; it is attached lazily to the vocab object so
  the graph layer itself stays unaware of serving.
- **epoch** — ``len(vocab)``. Within one lineage the vocab is
  append-only, so the epoch is monotonic and doubles as the delta-feed
  cursor: a client at epoch E catches up by fetching keys ``[E, len)``.

The server policy is strict equality on both. Accepting ``client_epoch
< server_epoch`` would be *safe* (old ids never move within a lineage)
but it would also let a sidecar silently fall behind the namespace
table it does QoS bucketing with — strictness keeps the client's id
space, namespace ids, and the serving vocab provably identical, and
makes staleness an explicit, typed, retryable signal instead of a
silent drift.

``NamespaceTable`` assigns dense int ids to namespaces in order of
first appearance while scanning vocab keys by ascending id. Because
both sides scan the same append-only key sequence, the table is fully
determined by ``(lineage, epoch)`` and never needs to be shipped — the
client derives it from the synced keys, the server from its own vocab,
and the ids agree by construction.
"""

from __future__ import annotations

import threading
import uuid

from ..utils.errors import ErrVocabEpochMismatch

#: namespace-id sent for rows whose start key has no namespace (should
#: not happen for well-formed object keys, but the wire allows it)
NS_UNKNOWN = -1

#: label unknown / out-of-table namespace ids are bucketed under for QoS
NS_UNKNOWN_LABEL = "_encoded_unknown"


class NamespaceTable:
    """Dense namespace-name <-> int id table, derived from vocab keys.

    Ids are assigned in order of first appearance while scanning keys by
    ascending node id; only 3-tuple (subject-set / object) keys carry a
    namespace. Append-only and incrementally extendable, mirroring the
    vocab itself.
    """

    def __init__(self) -> None:
        self.names: list[str] = []
        self._id_of: dict[str, int] = {}
        self.scanned = 0  # node ids [0, scanned) already folded in

    def extend_from_keys(self, keys, upto: int | None = None) -> None:
        """Fold ``keys[self.scanned:upto]`` into the table."""
        end = len(keys) if upto is None else min(upto, len(keys))
        if end <= self.scanned:
            return
        id_of = self._id_of
        names = self.names
        for k in keys[self.scanned : end]:
            if len(k) == 3:
                ns = k[0]
                if ns not in id_of:
                    id_of[ns] = len(names)
                    names.append(ns)
        self.scanned = end

    def id_of(self, name: str) -> int:
        return self._id_of.get(name, NS_UNKNOWN)

    def name_of(self, ns_id: int) -> str:
        if 0 <= ns_id < len(self.names):
            return self.names[ns_id]
        return NS_UNKNOWN_LABEL

    def __len__(self) -> int:
        return len(self.names)


_LINEAGE_LOCK = threading.Lock()


def lineage_of(vocab) -> str:
    """The vocab instance's lineage nonce, minted on first use."""
    lin = getattr(vocab, "_wire_lineage", None)
    if lin is None:
        with _LINEAGE_LOCK:
            lin = getattr(vocab, "_wire_lineage", None)
            if lin is None:
                lin = uuid.uuid4().hex[:16]
                vocab._wire_lineage = lin
    return lin


def epoch_of(vocab) -> int:
    return len(vocab)


def ns_table_of(vocab) -> NamespaceTable:
    """The vocab's namespace table, extended to the current epoch.

    Lazily attached like the lineage; extension only scans keys interned
    since the last call, so steady-state cost is O(new keys).
    """
    table = getattr(vocab, "_wire_ns_table", None)
    if table is None:
        with _LINEAGE_LOCK:
            table = getattr(vocab, "_wire_ns_table", None)
            if table is None:
                table = NamespaceTable()
                vocab._wire_ns_table = table
    if table.scanned < len(vocab):
        with _LINEAGE_LOCK:
            table.extend_from_keys(vocab._key_of, len(vocab))
    return table


def validate_epoch(vocab, client_lineage: str, client_epoch: int) -> None:
    """Strict (lineage, epoch) equality gate for encoded requests."""
    lin = lineage_of(vocab)
    epoch = len(vocab)
    if client_lineage != lin or int(client_epoch) != epoch:
        raise ErrVocabEpochMismatch(
            server_lineage=lin,
            server_epoch=epoch,
            client_lineage=client_lineage,
            client_epoch=int(client_epoch),
        )


# -- REST payload helpers ----------------------------------------------------


def snapshot_page(vocab, offset: int, limit: int) -> dict:
    """One page of the vocab bootstrap snapshot (``GET /vocab/snapshot``).

    Keys are JSON-friendly lists; the client rebuilds the tuple keys and
    derives the namespace table itself. ``epoch`` is read once up front
    so a concurrent write cannot make a page claim keys it does not
    carry: clients page until ``offset + len(keys) >= epoch`` and then
    use the delta feed for anything interned since.
    """
    epoch = len(vocab)
    offset = max(0, int(offset))
    limit = max(1, int(limit))
    keys = vocab._key_of[offset : min(offset + limit, epoch)]
    return {
        "lineage": lineage_of(vocab),
        "epoch": epoch,
        "offset": offset,
        "keys": [list(k) for k in keys],
    }


def delta_page(vocab, client_lineage: str, from_epoch: int) -> dict:
    """Incremental catch-up (``GET /vocab/deltas``): keys interned since
    ``from_epoch``. A lineage mismatch or a cursor past the current
    epoch means delta catch-up is impossible — the typed mismatch error
    tells the client to re-bootstrap."""
    lin = lineage_of(vocab)
    epoch = len(vocab)
    from_epoch = int(from_epoch)
    if client_lineage != lin or from_epoch > epoch or from_epoch < 0:
        raise ErrVocabEpochMismatch(
            server_lineage=lin,
            server_epoch=epoch,
            client_lineage=client_lineage,
            client_epoch=from_epoch,
        )
    return {
        "lineage": lin,
        "epoch": epoch,
        "from": from_epoch,
        "keys": [list(k) for k in vocab._key_of[from_epoch:epoch]],
    }
