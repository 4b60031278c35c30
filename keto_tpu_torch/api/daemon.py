"""Port serving (counterpart of ``keto_tpu/api/daemon.py``, REST only).

Each plane (read, write) is one ``ThreadingHTTPServer`` on its own thread,
one handler thread per connection, speaking HTTP/1.1 with keep-alive. A
port of 0 binds a free port, and ``start()`` reports the real one. The
reference multiplexes gRPC onto the same port; the gRPC plane is not
ported yet.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .rest import Request, Router


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    router: Router  # set on the per-server subclass

    def _serve(self) -> None:
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length > 0 else b""
        req = Request.parse(self.command, self.path, self.headers, body)
        resp = self.router.dispatch(req)
        self.send_response(resp.status)
        for name, value in resp.headers.items():
            self.send_header(name, value)
        if resp.status != 204:
            self.send_header("Content-Type", resp.content_type)
            self.send_header("Content-Length", str(len(resp.body)))
        self.end_headers()
        if resp.status != 204:
            self.wfile.write(resp.body)

    do_GET = do_POST = do_PUT = do_DELETE = do_PATCH = _serve

    def log_message(self, format, *args) -> None:
        pass  # request logging is not ported yet


class _Server(ThreadingHTTPServer):
    daemon_threads = True  # a parked keep-alive connection never blocks stop
    allow_reuse_address = True
    # listen backlog: the socketserver default of 5 drops the SYNs of a
    # burst of concurrent clients, which then retry after a second
    request_queue_size = 1024


class PlaneServer:
    """One REST plane: bind, serve on a thread, stop."""

    def __init__(self, router: Router, host: str, port: int):
        self.router = router
        self.host = host
        self.port = port
        self._server: Optional[_Server] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> int:
        handler = type("PlaneHandler", (_Handler,), {"router": self.router})
        self._server = _Server((self.host, self.port), handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name=f"rest-plane-{self.port}",
            daemon=True,
        )
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._server is None:
            return
        self._server.shutdown()  # returns once serve_forever has exited
        self._server.server_close()
        self._thread.join(timeout=5)
        self._server = None
