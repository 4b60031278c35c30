"""The leader's replication source: checkpoint seed and WAL tail over HTTP
(counterpart of ``keto_tpu/replication/leader.py``).

The leader's durable write plane (store/durable.py) already persists what a
replica needs: an atomic checkpoint of the whole store and a segmented WAL
of every delta since. This module serves both on the write plane's router
(replication consumes the write log; the read plane stays untouched):

- ``GET /replication/status`` — role, store version, WAL cursor, newest
  checkpoint version. Followers size their lag by it.
- ``GET /replication/checkpoint`` — the newest checkpoint ``.npz``, its
  version in ``X-Keto-Checkpoint-Version``; cut on demand when none exists
  yet, 204 while the store is empty. The port's ``Response`` carries bytes,
  so the file is read whole (its size at rbac1m is in ``PERF.md``).
- ``GET /replication/wal?segment=S&offset=O&max_records=N&wait_ms=M`` —
  frames decoded from segment ``S`` (named by its first version, as the
  file) from byte ``O``, as raw frame documents with the ``next`` cursor to
  resume from, so the stream resumes after any disconnect. A consumed,
  rotated-away segment moves the cursor to the next one; a cursor naming a
  pruned segment answers ``reset: true`` and the follower re-seeds.
  ``wait_ms`` long-polls. Each connection has its own server thread
  (``api/daemon.py``), so a held poll blocks no other route of the plane.
- ``GET /replication/digest?chunk_size=N`` — the per-chunk sha256 of the
  live tuple set at the leader's current version (replication/digest.py),
  which the scrubber's replica kind compares with the follower's own.

Serving reads the segment files directly with the WAL's own frame parser:
an incomplete frame at the active tail is simply not shipped yet.
"""

from __future__ import annotations

import json
import time
import zlib
from typing import Optional

from ..api.rest import Request, Response, json_response
from ..graph import checkpoint as ckpt_mod
from ..store.wal import _FILE_MAGIC, _FRAME, _MAX_PAYLOAD, _list_segments
from .digest import compute_digest

#: cap on records per /replication/wal answer whatever the follower asks:
#: bounds the answer's size and the handler's wall time
MAX_RECORDS_CAP = 4096


def read_wal_from(directory: str, segment: int, offset: int, max_records: int = 512) -> dict:
    """One replication pull: up to ``max_records`` frame documents from the
    cursor ``(segment, offset)``, as
    ``{"records": [...], "next": [segment, offset], "reset": bool,
    "eof": bool}``. ``eof``: the cursor reached the durable tail; ``reset``:
    the cursor names a segment that no longer exists (pruned), and the
    follower must re-seed."""
    max_records = max(1, min(int(max_records), MAX_RECORDS_CAP))
    segs = _list_segments(directory)
    if not segs:
        return {"records": [], "next": [segment, offset], "reset": False, "eof": True}
    firsts = [f for f, _ in segs]
    if segment == 0:
        # a fresh follower with no cursor: start at the oldest segment
        segment, offset = firsts[0], 0
    if segment not in firsts:
        # pruned (or never existed): only the checkpoint covers the range
        return {"records": [], "next": [segment, offset], "reset": True, "eof": False}
    idx = firsts.index(segment)
    final = idx == len(segs) - 1
    with open(segs[idx][1], "rb") as f:
        data = f.read()
    size = len(data)
    if offset < len(_FILE_MAGIC):
        if size < len(_FILE_MAGIC):
            # the segment exists but its magic has not landed (only the
            # active tail): nothing to ship
            return {"records": [], "next": [segment, 0], "reset": False, "eof": True}
        offset = len(_FILE_MAGIC)
    records: list[dict] = []
    off = offset
    complete = False  # parsed through everything on disk now
    while len(records) < max_records:
        if off + _FRAME.size > size:
            complete = True
            break
        crc, ln = _FRAME.unpack_from(data, off)
        frame_end = off + _FRAME.size + ln
        if ln > _MAX_PAYLOAD or frame_end > size:
            complete = True  # a torn or short tail: not acked, not shipped
            break
        payload = data[off + _FRAME.size:frame_end]
        if zlib.crc32(payload) != crc:
            complete = True  # replay's tail contract
            break
        try:
            records.append(json.loads(payload.decode("utf-8")))
        except ValueError:
            complete = True
            break
        off = frame_end
    if complete and not final:
        # a sealed segment gets no more appends: whatever stopped the parse,
        # the cursor moves on to the next segment
        return {"records": records, "next": [firsts[idx + 1], 0], "reset": False,
                "eof": False}
    return {"records": records, "next": [segment, off], "reset": False, "eof": complete}


def _wal_query(req: Request) -> tuple[int, int, int, float]:
    """(segment, offset, max_records, wait_ms) off a /replication/wal query;
    ValueError on a malformed one."""
    q = req.query
    return (
        int(q.get("segment", 0)),
        int(q.get("offset", 0)),
        int(q.get("max_records", 512)),
        min(float(q.get("wait_ms", 0)), 30_000.0),
    )


_MALFORMED_CURSOR = {"error": "malformed replication cursor"}


class ReplicationSource:
    """The leader's serving half, bound to a ``DurableTupleStore``."""

    def __init__(self, store, *, poll_interval_s: float = 0.05):
        self.store = store  # DurableTupleStore (has .wal, .checkpoint_dir)
        self.poll_interval_s = max(0.005, float(poll_interval_s))

    # -- payloads ---------------------------------------------------------------

    def status(self) -> dict:
        segment, offset = self.store.wal.position()
        return {
            "role": "leader",
            "version": self.store.version,
            "wal": {"segment": segment, "offset": offset},
            "checkpoint_version": self.store.last_checkpoint_version(),
            "t": time.time(),
        }

    def checkpoint_entry(self) -> Optional[tuple[int, str]]:
        """(version, path) of the newest checkpoint, cutting one on demand
        the first time a follower asks while only the WAL exists."""
        latest = ckpt_mod.latest_checkpoint(self.store.checkpoint_dir)
        if latest is None and (self.store.version > 0 or len(self.store) > 0):
            self.store.checkpoint_now()
            latest = ckpt_mod.latest_checkpoint(self.store.checkpoint_dir)
        return latest

    # -- routes -----------------------------------------------------------------

    def handle_status(self, req: Request) -> Response:
        return json_response(self.status())

    def handle_checkpoint(self, req: Request) -> Response:
        entry = self.checkpoint_entry()
        if entry is None:
            return Response(204)
        version, path = entry
        with open(path, "rb") as f:
            data = f.read()
        return Response(200, data, "application/octet-stream",
                        {"X-Keto-Checkpoint-Version": str(version)})

    def handle_wal(self, req: Request) -> Response:
        try:
            segment, offset, max_records, wait_ms = _wal_query(req)
        except ValueError:
            return json_response(_MALFORMED_CURSOR, 400)
        deadline = time.monotonic() + wait_ms / 1000.0
        while True:
            out = read_wal_from(self.store.wal_dir, segment, offset, max_records)
            if (out["records"] or out["reset"] or not out["eof"]
                    or time.monotonic() >= deadline):
                out["leader_version"] = self.store.version
                return json_response(out)
            time.sleep(self.poll_interval_s)

    def handle_digest(self, req: Request) -> Response:
        try:
            chunk_size = int(req.query.get("chunk_size", 1024))
        except ValueError:
            return json_response({"error": "malformed chunk_size"}, 400)
        if chunk_size < 1:
            return json_response({"error": "chunk_size must be >= 1"}, 400)
        return json_response(compute_digest(self.store, chunk_size))

    def register(self, router) -> None:
        router.add("GET", "/replication/status", self.handle_status)
        router.add("GET", "/replication/checkpoint", self.handle_checkpoint)
        router.add("GET", "/replication/wal", self.handle_wal)
        router.add("GET", "/replication/digest", self.handle_digest)
