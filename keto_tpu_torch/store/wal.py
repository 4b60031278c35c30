"""Segmented, checksummed write-ahead delta log for the memory and columnar
stores (counterpart of ``keto_tpu/store/wal.py``; the format is the
reference's, byte for byte).

Every mutator already produces an exact ``(version, inserted, deleted)``
delta through the ``OrderedNotifier`` feed (store/notify.py), so the WAL
records those deltas: replay applies the same deltas in the same version
order.

On-disk layout — a directory of segments, each named by the first version
it holds::

    wal-00000000000000000001.seg
    wal-00000000000000004097.seg

Each segment starts with a 6-byte magic and holds length-prefixed,
CRC-checked frames::

    [crc32(payload) u32][len(payload) u32][payload bytes]

The payload is canonical JSON: ``{"v": version, "k": "d", "i": [...],
"d": [...]}`` for a delta, ``{"v": version, "k": "b"}`` for a bulk-load
marker (``ColumnarTupleStore.bulk_load_edges`` delivers no per-tuple
delta, so the marker records only that something unreplayable happened;
the durable wrapper checkpoints right after one).

Torn tails: a frame is the atomic unit. On replay, a short or CRC-invalid
frame at the tail of the FINAL segment is a torn write — never acked,
because append raises before the store acks — and is truncated silently.
The same damage mid-log (a non-final segment, or followed by more bytes)
means acked records may be unreachable: replay stops that segment and flags
``gap``, so recovery degrades loudly instead of serving wrong data quietly.

Sync policies (``store.wal.sync``): ``always`` fsyncs every append before
the store acks (no acked write lost to a SIGKILL), ``interval`` fsyncs at
most every ``sync_interval_ms`` (a bounded loss window), ``off`` leaves
flushing to the OS.

Fault sites in the append path (keto_tpu_torch/faults.py):
``wal.enospc``, ``wal.torn_write``, ``wal.corrupt_crc``,
``wal.crash_after_append``; ``inject_bitrot`` serves ``wal.bitrot``.
"""

from __future__ import annotations

import errno
import json
import os
import struct
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Optional

from ..faults import FAULTS, FaultInjected
from ..relationtuple.definitions import (
    RelationTuple,
    SubjectID,
    SubjectSet,
)

_FILE_MAGIC = b"KWAL1\n"
_FRAME = struct.Struct("<II")  # crc32(payload), len(payload)
_SEG_PREFIX = "wal-"
_SEG_SUFFIX = ".seg"
#: refuse to trust a frame header claiming a payload bigger than this —
#: a corrupted length field must not turn replay into a 4GB allocation
_MAX_PAYLOAD = 256 << 20

SYNC_POLICIES = ("always", "interval", "off")


class WalError(RuntimeError):
    """WAL append/replay failure. Append failures are fail-stop: the
    durable wrapper refuses further writes rather than silently acking
    unlogged mutations."""


def encode_tuple(t: RelationTuple) -> list:
    """JSON-safe spelling of one tuple: explicit fields, no string-grammar
    round-trip (object names may contain ':', '#', '@')."""
    s = t.subject
    if isinstance(s, SubjectSet):
        return [t.namespace, t.object, t.relation, 1,
                s.namespace, s.object, s.relation]
    return [t.namespace, t.object, t.relation, 0, s.id]


def decode_tuple(rec) -> RelationTuple:
    if rec[3]:
        subject = SubjectSet(
            namespace=rec[4], object=rec[5], relation=rec[6]
        )
    else:
        subject = SubjectID(id=rec[4])
    return RelationTuple(
        namespace=rec[0], object=rec[1], relation=rec[2], subject=subject
    )


@dataclass
class WalRecord:
    version: int
    inserted: list[RelationTuple]
    deleted: list[RelationTuple]
    kind: str = "delta"  # "delta" | "bulk"


@dataclass
class ReplayStats:
    segments: int = 0
    records: int = 0
    torn_tail_bytes: int = 0  # unacked suffix dropped (normal after a crash)
    bad_frames: int = 0
    #: True when damage was found somewhere acked records could live
    #: (mid-log corruption): the caller must degrade loudly, not silently
    gap: bool = False
    notes: list[str] = field(default_factory=list)


def _segment_path(directory: str, first_version: int) -> str:
    return os.path.join(
        directory, f"{_SEG_PREFIX}{first_version:020d}{_SEG_SUFFIX}"
    )


def _list_segments(directory: str) -> list[tuple[int, str]]:
    """[(first_version, path)] sorted ascending."""
    out = []
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return []
    for name in names:
        if not (name.startswith(_SEG_PREFIX) and name.endswith(_SEG_SUFFIX)):
            continue
        try:
            first = int(name[len(_SEG_PREFIX):-len(_SEG_SUFFIX)])
        except ValueError:
            continue
        out.append((first, os.path.join(directory, name)))
    out.sort()
    return out


def _fsync_dir(directory: str) -> None:
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return  # not supported on this platform/filesystem
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def record_from_doc(doc: dict) -> WalRecord:
    """Decode one frame's JSON document."""
    if doc.get("k") == "b":
        return WalRecord(version=int(doc["v"]), inserted=[], deleted=[],
                         kind="bulk")
    return WalRecord(
        version=int(doc["v"]),
        inserted=[decode_tuple(r) for r in doc.get("i", ())],
        deleted=[decode_tuple(r) for r in doc.get("d", ())],
    )


def _parse_payload(payload: bytes) -> WalRecord:
    return record_from_doc(json.loads(payload.decode("utf-8")))


def _scan_segment(path: str, final: bool, stats: ReplayStats):
    """Parse one segment; yields records into a list and returns
    (records, valid_end_offset). Damage handling per the torn-tail
    contract in the module docstring."""
    with open(path, "rb") as f:
        data = f.read()
    records: list[WalRecord] = []
    if not data.startswith(_FILE_MAGIC):
        if final and len(data) < len(_FILE_MAGIC):
            # a segment created but killed before the magic landed
            stats.torn_tail_bytes += len(data)
            return records, 0
        stats.gap = True
        stats.notes.append(f"{os.path.basename(path)}: bad file magic")
        return records, 0
    off = len(_FILE_MAGIC)
    size = len(data)
    while off < size:
        if off + _FRAME.size > size:
            tail = size - off
            if final:
                stats.torn_tail_bytes += tail
            else:
                stats.gap = True
                stats.notes.append(
                    f"{os.path.basename(path)}: short frame header mid-log"
                )
            return records, off
        crc, ln = _FRAME.unpack_from(data, off)
        frame_end = off + _FRAME.size + ln
        if ln > _MAX_PAYLOAD or frame_end > size:
            tail = size - off
            if final and ln <= _MAX_PAYLOAD:
                stats.torn_tail_bytes += tail  # truncated payload at tail
            else:
                stats.gap = True
                stats.notes.append(
                    f"{os.path.basename(path)}: implausible/short frame"
                )
            return records, off
        payload = data[off + _FRAME.size:frame_end]
        if zlib.crc32(payload) != crc:
            stats.bad_frames += 1
            if final and frame_end >= size:
                # last frame of the last segment: torn write, unacked
                stats.torn_tail_bytes += size - off
            else:
                # framing after a bad CRC is untrustworthy: stop the
                # segment and flag the gap
                stats.gap = True
                stats.notes.append(
                    f"{os.path.basename(path)}: CRC mismatch mid-log"
                )
            return records, off
        try:
            records.append(_parse_payload(payload))
        except (ValueError, KeyError, IndexError, TypeError):
            stats.bad_frames += 1
            stats.gap = True
            stats.notes.append(
                f"{os.path.basename(path)}: undecodable payload"
            )
            return records, off
        off = frame_end
    return records, off


def sealed_segments(directory: str) -> list[tuple[int, str]]:
    """Segments that will never be appended to again (everything but the
    active tail). These are the scrubber's bitrot-scan population: the tail
    is still being written, so 'damage' there is indistinguishable from an
    in-flight append."""
    return _list_segments(directory)[:-1]


def verify_segment(path: str) -> dict:
    """Integrity-only rescan of one sealed segment: walk every frame and
    recheck CRCs without materialising tuples for the caller. ``final=False``
    because a sealed segment has no legitimate torn tail — any damage is
    bitrot over acked records."""
    stats = ReplayStats()
    records, _end = _scan_segment(path, final=False, stats=stats)
    return {
        "path": path,
        "ok": not (stats.gap or stats.bad_frames),
        "records": len(records),
        "bad_frames": stats.bad_frames,
        "gap": stats.gap,
        "notes": list(stats.notes),
    }


def inject_bitrot(directory: str) -> Optional[str]:
    """Fault-site helper for ``wal.bitrot``: flip one byte inside the frame
    region of a sealed segment, in place. Returns the damaged path, or None
    when there is no sealed segment to damage (the drill should retry after
    a rotation)."""
    sealed = sealed_segments(directory)
    if not sealed:
        return None
    _first, path = sealed[0]
    size = os.path.getsize(path)
    # aim past the magic and the first frame header, into payload bytes
    off = len(_FILE_MAGIC) + _FRAME.size
    if size <= off:
        return None
    with open(path, "r+b") as f:
        f.seek(off)
        cur = f.read(1)
        f.seek(off)
        f.write(bytes([cur[0] ^ 0xFF]))
        f.flush()
        os.fsync(f.fileno())
    return path


class WriteAheadLog:
    """Append-side handle. Thread-safe; one instance owns the directory's
    active tail segment. Opening truncates any torn tail left by a crash
    so new frames never land after garbage."""

    def __init__(
        self,
        directory: str,
        *,
        sync: str = "always",
        sync_interval_ms: float = 50.0,
        segment_bytes: int = 16 << 20,
    ):
        if sync not in SYNC_POLICIES:
            raise WalError(
                f"unknown wal sync policy {sync!r}; expected one of "
                f"{SYNC_POLICIES}"
            )
        self.directory = directory
        self.sync_policy = sync
        self.sync_interval_s = max(float(sync_interval_ms), 0.0) / 1000.0
        self.segment_bytes = int(segment_bytes)
        self._lock = threading.Lock()
        self._f = None
        self._seg_size = 0
        self._seg_first = 0  # first version of the active tail segment
        self._last_sync = 0.0
        self.appended_records = 0
        self.synced_records = 0
        os.makedirs(directory, exist_ok=True)
        segs = _list_segments(directory)
        if segs:
            # adopt the tail segment: truncate any torn suffix, then append
            first, path = segs[-1]
            stats = ReplayStats()
            _records, valid_end = _scan_segment(path, final=True, stats=stats)
            with open(path, "r+b") as f:
                f.truncate(max(valid_end, 0))
            self._open_segment(path, fresh=False)
            self._seg_first = first
        # else: first append creates wal-<version>.seg lazily

    # -- internals -------------------------------------------------------------

    def _open_segment(self, path: str, fresh: bool) -> None:
        self._f = open(path, "ab")
        if fresh:
            self._f.write(_FILE_MAGIC)
            self._f.flush()
            os.fsync(self._f.fileno())
            _fsync_dir(self.directory)
        self._seg_size = self._f.tell()

    def _rotate_if_needed(self, next_version: int) -> None:
        if self._f is not None and self._seg_size < self.segment_bytes:
            return
        if self._f is not None:
            self._f.flush()
            os.fsync(self._f.fileno())
            self._f.close()
        self._open_segment(
            _segment_path(self.directory, next_version), fresh=True
        )
        self._seg_first = next_version

    def _sync_locked(self) -> None:
        if self._f is None:
            return
        self._f.flush()
        os.fsync(self._f.fileno())
        self._last_sync = time.monotonic()
        self.synced_records = self.appended_records

    def _write_frame(self, payload: bytes, version: int) -> None:
        if FAULTS.should_fire("wal.enospc"):
            # disk full before a single byte lands: the append raises, the
            # store never acks, and the durable wrapper fail-stops
            raise OSError(errno.ENOSPC, "No space left on device")
        self._rotate_if_needed(version)
        crc = zlib.crc32(payload)
        frame = _FRAME.pack(crc, len(payload)) + payload
        if FAULTS.should_fire("wal.corrupt_crc"):
            # the record lands framed but invalid: replay must refuse it;
            # the raise below means the write is never acked, so refusing
            # it loses nothing. fsync first so the damage is really on disk.
            bad = _FRAME.pack(crc ^ 0xFFFFFFFF, len(payload)) + payload
            self._f.write(bad)
            self._f.flush()
            os.fsync(self._f.fileno())
            raise FaultInjected("wal.corrupt_crc")
        if FAULTS.should_fire("wal.torn_write"):
            # half a frame on disk, then "the process died" — replay must
            # truncate it as an unacked torn tail
            self._f.write(frame[: max(1, len(frame) // 2)])
            self._f.flush()
            os.fsync(self._f.fileno())
            raise FaultInjected("wal.torn_write")
        self._f.write(frame)
        self._seg_size += len(frame)
        self.appended_records += 1
        if self.sync_policy == "always":
            self._sync_locked()
        elif self.sync_policy == "interval":
            self._f.flush()
            if time.monotonic() - self._last_sync >= self.sync_interval_s:
                self._sync_locked()
        else:  # off
            self._f.flush()
        FAULTS.fire("wal.crash_after_append")

    # -- append surface --------------------------------------------------------

    def append(
        self,
        version: int,
        inserted: list[RelationTuple],
        deleted: list[RelationTuple],
    ) -> None:
        """Log one delta. Raises on any failure — the caller must NOT ack
        the write when this raises."""
        payload = json.dumps(
            {
                "v": version,
                "k": "d",
                "i": [encode_tuple(t) for t in inserted],
                "d": [encode_tuple(t) for t in deleted],
            },
            separators=(",", ":"),
        ).encode("utf-8")
        with self._lock:
            self._check_open()
            self._write_frame(payload, version)

    def append_bulk_marker(self, version: int) -> None:
        """Log that an unreplayable bulk load produced ``version``. The
        durable wrapper checkpoints right after, restoring recoverability."""
        payload = json.dumps(
            {"v": version, "k": "b"}, separators=(",", ":")
        ).encode("utf-8")
        with self._lock:
            self._check_open()
            self._write_frame(payload, version)

    def sync(self) -> None:
        with self._lock:
            if self._f is not None:
                self._sync_locked()

    def position(self) -> tuple[int, int]:
        """(active segment's first version, byte size of its valid
        prefix) — the durable cursor a snaptoken embeds. ``(0, 0)``
        before the first append creates a segment."""
        with self._lock:
            if self._f is None:
                return 0, 0
            return self._seg_first, self._seg_size

    def _check_open(self) -> None:
        if self.directory is None:
            raise WalError("write-ahead log is closed")

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.flush()
                os.fsync(self._f.fileno())
                self._f.close()
                self._f = None
            self.directory = self.directory  # path stays for introspection

    # -- maintenance -----------------------------------------------------------

    def prune_upto(self, version: int) -> int:
        """Delete segments made fully redundant by a checkpoint at
        ``version``: a segment may go when the NEXT segment starts at or
        before ``version + 1`` (so every record it holds is <= version).
        The active tail segment always stays. Returns segments removed."""
        removed = 0
        with self._lock:
            segs = _list_segments(self.directory)
            for (first, path), (nxt_first, _nxt) in zip(segs, segs[1:]):
                if nxt_first <= version + 1:
                    try:
                        os.unlink(path)
                        removed += 1
                    except OSError:
                        pass
                else:
                    break
            if removed:
                _fsync_dir(self.directory)
        return removed

    # -- replay ----------------------------------------------------------------

    @staticmethod
    def replay(directory: str) -> tuple[list[WalRecord], ReplayStats]:
        """Read every decodable record in version order. Read-only: safe
        from a process that never appends (the crash drill's verifier)."""
        stats = ReplayStats()
        records: list[WalRecord] = []
        segs = _list_segments(directory)
        stats.segments = len(segs)
        for i, (_first, path) in enumerate(segs):
            recs, _valid_end = _scan_segment(
                path, final=(i == len(segs) - 1), stats=stats
            )
            records.extend(recs)
        stats.records = len(records)
        return records, stats
