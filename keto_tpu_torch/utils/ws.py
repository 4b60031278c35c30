"""Minimal RFC 6455 WebSocket support, client and test-server halves
(counterpart of ``keto_tpu/utils/ws.py``).

The reference's namespace watcher accepts ``ws://`` URIs through watcherx
(internal/driver/config/namespace_watcher.go:48-89): a remote config
service pushes namespace updates over a websocket. The runtime image ships
no websocket library, so this module implements the slice the watcher
needs by hand: the HTTP/1.1 upgrade handshake, unfragmented text/close
frames with client-side masking, ping/pong keepalive. No extensions, no
fragmentation (a namespace document fits one frame), no TLS (front a
terminator for wss, as for the API's own TLS story).

The server half exists so tests can push updates through a real socket;
it is deliberately tiny and not a production endpoint.
"""

from __future__ import annotations

import base64
import hashlib
import os
import socket
import struct
from urllib.parse import urlparse

_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_TEXT = 0x1
OP_CLOSE = 0x8
OP_PING = 0x9
OP_PONG = 0xA


class WSError(Exception):
    pass


def _encode_frame(opcode: int, payload: bytes, mask: bool) -> bytes:
    head = bytearray([0x80 | opcode])
    n = len(payload)
    mask_bit = 0x80 if mask else 0
    if n < 126:
        head.append(mask_bit | n)
    elif n < (1 << 16):
        head.append(mask_bit | 126)
        head += struct.pack("!H", n)
    else:
        head.append(mask_bit | 127)
        head += struct.pack("!Q", n)
    if mask:
        key = os.urandom(4)
        head += key
        payload = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
    return bytes(head) + payload


class WSConn:
    """One websocket endpoint; ``client`` controls frame masking.
    ``leftover`` carries any bytes the handshake read past the HTTP
    response — a frame sent immediately after the 101 can land in the
    same TCP segment and must not be swallowed."""

    def __init__(
        self, sock: socket.socket, client: bool, leftover: bytes = b""
    ):
        self._sock = sock
        self._client = client
        self._buf = bytearray(leftover)

    def _try_parse(self):
        """Parse one complete frame from the buffer WITHOUT consuming a
        partial one — a recv timeout mid-frame must leave the stream
        resumable at the same byte offset, or the next read desyncs into
        payload bytes parsed as headers."""
        buf = self._buf
        if len(buf) < 2:
            return None
        opcode = buf[0] & 0x0F
        masked = bool(buf[1] & 0x80)
        n = buf[1] & 0x7F
        pos = 2
        if n == 126:
            if len(buf) < 4:
                return None
            (n,) = struct.unpack("!H", buf[2:4])
            pos = 4
        elif n == 127:
            if len(buf) < 10:
                return None
            (n,) = struct.unpack("!Q", buf[2:10])
            pos = 10
        key = None
        if masked:
            if len(buf) < pos + 4:
                return None
            key = bytes(buf[pos : pos + 4])
            pos += 4
        if len(buf) < pos + n:
            return None
        payload = bytes(buf[pos : pos + n])
        del buf[: pos + n]
        if key:
            payload = bytes(
                b ^ key[i % 4] for i, b in enumerate(payload)
            )
        return opcode, payload

    def _read_frame(self) -> tuple[int, bytes]:
        while True:
            frame = self._try_parse()
            if frame is not None:
                return frame
            chunk = self._sock.recv(65536)
            if not chunk:
                raise WSError("peer closed")
            self._buf += chunk

    def send_text(self, text: str) -> None:
        self._sock.sendall(
            _encode_frame(OP_TEXT, text.encode(), mask=self._client)
        )

    def recv_text(self, timeout: float | None = None):
        """Next text payload; None on clean close. Control frames are
        answered inline."""
        self._sock.settimeout(timeout)
        while True:
            opcode, payload = self._read_frame()
            if opcode == OP_TEXT:
                return payload.decode()
            if opcode == OP_PING:
                self._sock.sendall(
                    _encode_frame(OP_PONG, payload, mask=self._client)
                )
            elif opcode == OP_CLOSE:
                try:
                    self._sock.sendall(
                        _encode_frame(OP_CLOSE, b"", mask=self._client)
                    )
                except OSError:
                    pass
                return None
            # pongs / unknown: skip

    def ping(self, payload: bytes = b"ka") -> None:
        self._sock.sendall(
            _encode_frame(OP_PING, payload, mask=self._client)
        )

    def close(self) -> None:
        try:
            self._sock.sendall(
                _encode_frame(OP_CLOSE, b"", mask=self._client)
            )
        except OSError:
            pass
        try:
            # close() alone does NOT wake a thread blocked in recv on the
            # same socket (the fd just dangles until reuse); shutdown does
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()


def connect(url: str, timeout: float = 10.0) -> WSConn:
    """Open a ws:// connection (client handshake)."""
    u = urlparse(url)
    if u.scheme != "ws":
        raise WSError(f"unsupported scheme {u.scheme!r} (ws only)")
    host = u.hostname or "127.0.0.1"
    port = u.port or 80
    path = u.path or "/"
    if u.query:
        path += "?" + u.query
    sock = socket.create_connection((host, port), timeout=timeout)
    key = base64.b64encode(os.urandom(16)).decode()
    req = (
        f"GET {path} HTTP/1.1\r\n"
        f"Host: {host}:{port}\r\n"
        "Upgrade: websocket\r\n"
        "Connection: Upgrade\r\n"
        f"Sec-WebSocket-Key: {key}\r\n"
        "Sec-WebSocket-Version: 13\r\n\r\n"
    )
    sock.sendall(req.encode())
    resp = b""
    while b"\r\n\r\n" not in resp:
        chunk = sock.recv(4096)
        if not chunk:
            raise WSError("server closed during handshake")
        resp += chunk
    head, _sep, leftover = resp.partition(b"\r\n\r\n")
    status = head.split(b"\r\n", 1)[0]
    if b"101" not in status:
        sock.close()
        raise WSError(f"handshake rejected: {status.decode(errors='replace')}")
    want = base64.b64encode(
        hashlib.sha1((key + _GUID).encode()).digest()
    ).decode()
    accept = None
    for line in head.split(b"\r\n"):
        if line.lower().startswith(b"sec-websocket-accept:"):
            accept = line.split(b":", 1)[1].strip().decode()
    if accept != want:
        sock.close()
        raise WSError("bad Sec-WebSocket-Accept")
    return WSConn(sock, client=True, leftover=leftover)


def accept(sock: socket.socket) -> WSConn:
    """Server-side upgrade of an accepted TCP connection (test helper)."""
    req = b""
    while b"\r\n\r\n" not in req:
        chunk = sock.recv(4096)
        if not chunk:
            raise WSError("client closed during handshake")
        req += chunk
    req_head, _sep, req_leftover = req.partition(b"\r\n\r\n")
    key = None
    for line in req_head.split(b"\r\n"):
        if line.lower().startswith(b"sec-websocket-key:"):
            key = line.split(b":", 1)[1].strip().decode()
    if key is None:
        raise WSError("missing Sec-WebSocket-Key")
    accept_val = base64.b64encode(
        hashlib.sha1((key + _GUID).encode()).digest()
    ).decode()
    sock.sendall(
        (
            "HTTP/1.1 101 Switching Protocols\r\n"
            "Upgrade: websocket\r\n"
            "Connection: Upgrade\r\n"
            f"Sec-WebSocket-Accept: {accept_val}\r\n\r\n"
        ).encode()
    )
    return WSConn(sock, client=False, leftover=req_leftover)
