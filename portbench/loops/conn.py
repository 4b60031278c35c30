"""One keep-alive HTTP/1.1 connection (standard library ``http.client``),
the transport every loop speaks: no client SDK of the program."""

from __future__ import annotations

import http.client
import json
import socket
import time

JSON = {"Content-Type": "application/json"}


class Conn:
    def __init__(self, host: str, port: int, timeout: float = 120.0):
        self.host, self.port, self.timeout = host, port, timeout
        self._c = None

    def _open(self) -> http.client.HTTPConnection:
        if self._c is None:
            self._c = http.client.HTTPConnection(self.host, self.port, timeout=self.timeout)
            self._c.connect()
            self._c.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return self._c

    def request(self, method: str, path: str, body: bytes = None,
                headers: dict = None) -> tuple[int, bytes]:
        """(status, body); status 0 when the server never answered. A
        dropped keep-alive connection is reopened once: every request the
        loops send is idempotent."""
        for attempt in (0, 1):
            try:
                c = self._open()
                c.request(method, path, body=body, headers=headers or {})
                r = c.getresponse()
                return r.status, r.read()
            except (http.client.HTTPException, OSError):
                self.close()
                if attempt:
                    return 0, b""
        return 0, b""

    def close(self) -> None:
        if self._c is not None:
            self._c.close()
            self._c = None


def check_answer(status: int, body: bytes) -> int:
    """1 allowed, 0 denied, -1 no answer (an error status or body)."""
    if status not in (200, 403):
        return -1
    try:
        allowed = json.loads(body)["allowed"]
    except (ValueError, KeyError, TypeError):
        return -1
    if allowed is not (status == 200):
        return -1
    return int(allowed)


def sleep_until(t: float) -> None:
    d = t - time.monotonic()
    if d > 0:
        time.sleep(d)
