"""Anti-entropy digests: per-chunk rolling hash of a store's state
(counterpart of ``keto_tpu/replication/digest.py``).

The canonical row serialization is the WAL's
(:func:`keto_tpu_torch.store.wal.encode_tuple`: explicit fields, no
string-grammar round trip), so a digest is

    sort all live tuples by their encoded spelling
    split the sorted list into fixed-size chunks
    sha256 each chunk

Two stores at the SAME applied version produce identical chunk lists; a
divergent chunk localizes the damage to ~``chunk_size`` rows. Compare
versions first: digests across versions report lag as divergence.
``doctor`` prints the digest of the state it recovers, the scrubber's
replica kind compares a follower's with the leader's ``/replication/digest``.

A store with ``snapshot_ids`` (the columnar store, bare or durable) spells
its rows from the node ids: each node's JSON fragment once, then one string
concatenation per row, the same bytes the per-tuple ``json.dumps`` gives
(at rbac1m the per-tuple path takes seconds on each side of a compare).
"""

from __future__ import annotations

import hashlib
import json

import numpy as np

from ..store.wal import encode_tuple

DIGEST_ALGO = "sha256"


def compute_digest(store, chunk_size: int = 1024) -> dict:
    """Digest ``store``'s live tuples at its current version.

    Uses the store's ``snapshot()`` surface when present (one lock
    acquisition, version and tuples observed atomically); falls back to
    ``all_tuples()`` + ``version`` for bare stores in tests.
    """
    chunk_size = max(1, int(chunk_size))
    snapshot_ids = getattr(store, "snapshot_ids", None)
    if snapshot_ids is not None:
        rows, version = _rows_from_ids(*snapshot_ids())
    else:
        snap = getattr(store, "snapshot", None)
        if snap is not None:
            tuples, version = snap()
        else:
            tuples = store.all_tuples()
            version = store.version
        rows = [
            json.dumps(encode_tuple(t), separators=(",", ":"), sort_keys=True)
            for t in tuples
        ]
    rows.sort()
    chunks = []
    for i in range(0, len(rows), chunk_size):
        h = hashlib.sha256()
        for row in rows[i: i + chunk_size]:
            h.update(row.encode("utf-8"))
            h.update(b"\n")
        chunks.append(h.hexdigest())
    return {
        "version": int(version),
        "algo": DIGEST_ALGO,
        "chunk_size": chunk_size,
        "count": len(rows),
        "chunks": chunks,
    }


def _rows_from_ids(src, dst, vocab, version) -> tuple[list, int]:
    """The canonical rows of a columnar snapshot: ``encode_tuple``'s
    ``[ns, obj, rel, 0, id]`` or ``[ns, obj, rel, 1, sns, sobj, srel]`` as
    compact JSON, built from a head fragment per object node and a tail
    fragment per subject node."""
    keys = vocab.keys()
    dumps = json.dumps
    head = {i: "[" + ",".join(dumps(x) for x in keys[i]) for i in np.unique(src).tolist()}
    tail = {}
    for i in np.unique(dst).tolist():
        k = keys[i]
        tail[i] = (",0," if len(k) == 1 else ",1,") + ",".join(dumps(x) for x in k) + "]"
    return [head[a] + tail[b] for a, b in zip(src.tolist(), dst.tolist())], int(version)


def diff_digests(local: dict, remote: dict) -> list[int]:
    """Indices of divergent chunks between two digests computed at the
    same version and chunk size. A length mismatch marks every index in
    the longer list from the first differing position."""
    a = local.get("chunks", [])
    b = remote.get("chunks", [])
    n = max(len(a), len(b))
    out = []
    for i in range(n):
        av = a[i] if i < len(a) else None
        bv = b[i] if i < len(b) else None
        if av != bv:
            out.append(i)
    return out
