"""Binary codec for the id-native check wire (``BatchCheckEncoded``;
counterpart of ``keto_tpu/api/wirecodec.py``, byte for byte the same
frames).

The encoded tier exists to remove per-tuple Python work from the wire,
so the frame is deliberately *not* protobuf: packed int32 columns are
varint-encoded by proto (a per-element branch on both sides), while this
frame is a fixed header followed by raw little-endian arrays that numpy
views with ``frombuffer`` — zero per-tuple objects, zero copies on
decode. The frame is the REST ``application/octet-stream`` body of
``POST /check/batch-encoded`` (and, in the reference, the gRPC message
body as well).

Request frame (all integers little-endian)::

    magic      4s   b"KTE1"
    flags      u16  bit0: ns column present, bit1: depth column present
    reserved   u16
    n          u32  row count
    epoch      u64  client vocab epoch (len of the synced vocab)
    lineage    16s  client vocab lineage nonce (ascii, NUL-padded)
    min_ver    u64  snaptoken freshness floor (0 = none)
    tp_len     u16  traceparent byte length
    traceparent     utf-8, then NUL padding to a 4-byte boundary
    start      i32[n]
    target     i32[n]
    ns         i32[n]   iff flags bit0 (per-row namespace ids)
    depth      i32[n]   iff flags bit1

Response frame::

    magic      4s   b"KTR1"
    status     u16  0 = ok (errors travel as typed transport errors)
    reserved   u16
    n          u32
    tok_len    u16  snaptoken byte length
    snaptoken       utf-8
    verdicts        ceil(n/8) bytes, LSB-first bitset
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..utils.errors import ErrMalformedInput

REQ_MAGIC = b"KTE1"
RESP_MAGIC = b"KTR1"

FLAG_NS = 1 << 0
FLAG_DEPTH = 1 << 1

_REQ_HEAD = struct.Struct("<4sHHIQ16sQH")
_RESP_HEAD = struct.Struct("<4sHHIH")


@dataclass
class EncodedCheckRequest:
    """Decoded view of one request frame. Arrays are read-only views
    into the wire buffer — no copies were made."""

    start: np.ndarray
    target: np.ndarray
    ns: Optional[np.ndarray]
    depths: Optional[np.ndarray]
    lineage: str
    epoch: int
    min_version: int
    traceparent: Optional[str]


def encode_check_request(
    start,
    target,
    *,
    lineage: str,
    epoch: int,
    ns=None,
    depths=None,
    min_version: int = 0,
    traceparent: Optional[str] = None,
) -> bytes:
    start = np.ascontiguousarray(start, dtype=np.int32)
    target = np.ascontiguousarray(target, dtype=np.int32)
    n = start.shape[0]
    if target.shape[0] != n:
        raise ValueError("start/target length mismatch")
    flags = 0
    parts = [start.tobytes(), target.tobytes()]
    if ns is not None:
        ns = np.ascontiguousarray(ns, dtype=np.int32)
        if ns.shape[0] != n:
            raise ValueError("ns column length mismatch")
        flags |= FLAG_NS
        parts.append(ns.tobytes())
    if depths is not None:
        depths = np.ascontiguousarray(depths, dtype=np.int32)
        if depths.shape[0] != n:
            raise ValueError("depth column length mismatch")
        flags |= FLAG_DEPTH
        parts.append(depths.tobytes())
    tp = (traceparent or "").encode("utf-8")
    lin = lineage.encode("ascii")[:16].ljust(16, b"\0")
    head = _REQ_HEAD.pack(
        REQ_MAGIC, flags, 0, n, int(epoch), lin, int(min_version), len(tp)
    )
    pad = b"\0" * (-(len(head) + len(tp)) % 4)
    return b"".join([head, tp, pad, *parts])


def decode_check_request(buf: bytes) -> EncodedCheckRequest:
    try:
        magic, flags, _, n, epoch, lin, min_version, tp_len = (
            _REQ_HEAD.unpack_from(buf, 0)
        )
    except struct.error:
        raise ErrMalformedInput("encoded check frame truncated") from None
    if magic != REQ_MAGIC:
        raise ErrMalformedInput("encoded check frame: bad magic")
    off = _REQ_HEAD.size
    traceparent = (
        buf[off : off + tp_len].decode("utf-8", "replace") if tp_len else None
    )
    off += tp_len + (-(_REQ_HEAD.size + tp_len) % 4)
    n_cols = 2 + bool(flags & FLAG_NS) + bool(flags & FLAG_DEPTH)
    if len(buf) < off + 4 * n * n_cols:
        raise ErrMalformedInput("encoded check frame: columns truncated")

    def col():
        nonlocal off
        a = np.frombuffer(buf, dtype="<i4", count=n, offset=off)
        off += 4 * n
        return a

    start = col()
    target = col()
    ns = col() if flags & FLAG_NS else None
    depths = col() if flags & FLAG_DEPTH else None
    return EncodedCheckRequest(
        start=start,
        target=target,
        ns=ns,
        depths=depths,
        lineage=lin.rstrip(b"\0").decode("ascii", "replace"),
        epoch=int(epoch),
        min_version=int(min_version),
        traceparent=traceparent,
    )


def encode_check_response(allowed, snaptoken: str = "") -> bytes:
    allowed = np.asarray(allowed, dtype=bool)
    n = allowed.shape[0]
    tok = (snaptoken or "").encode("utf-8")
    bits = np.packbits(allowed, bitorder="little").tobytes()
    return b"".join(
        [_RESP_HEAD.pack(RESP_MAGIC, 0, 0, n, len(tok)), tok, bits]
    )


def decode_check_response(buf: bytes) -> tuple[np.ndarray, str]:
    try:
        magic, status, _, n, tok_len = _RESP_HEAD.unpack_from(buf, 0)
    except struct.error:
        raise ErrMalformedInput("encoded check response truncated") from None
    if magic != RESP_MAGIC or status != 0:
        raise ErrMalformedInput("encoded check response: bad magic/status")
    off = _RESP_HEAD.size
    snaptoken = buf[off : off + tok_len].decode("utf-8", "replace")
    off += tok_len
    n_bytes = (n + 7) // 8
    if len(buf) < off + n_bytes:
        raise ErrMalformedInput("encoded check response: bitset truncated")
    bits = np.frombuffer(buf, dtype=np.uint8, count=n_bytes, offset=off)
    return (
        np.unpackbits(bits, count=n, bitorder="little").astype(bool),
        snaptoken,
    )
