"""Port serving (counterpart of ``keto_tpu/api/daemon.py``): one public
port per plane that speaks REST and gRPC alike, as the reference's cmux.

Each plane (read, write) is one ``ThreadingHTTPServer`` on its own thread,
one handler thread per connection, speaking HTTP/1.1 with keep-alive. With
a gRPC server, the connection thread first peeks at the opening bytes:
every HTTP/2 connection opens with the client preface ``PRI * HTTP/2.0``,
every HTTP/1 request with a method token. An HTTP/1 connection goes
straight to the REST handler on the socket the client opened, with no
relay (the REST plane is already bound by the interpreter). An HTTP/2
connection is piped to the gRPC server, which listens on loopback only;
its direct port is exposed as ``grpc_port`` for clients that want to skip
the pipe. A port of 0 binds a free port, and ``start()`` reports the real
one.

The read-replica pool (``driver/replicas.py``) runs one read plane per
process, every one bound to the same fixed public and gRPC ports with
``SO_REUSEPORT`` (``reuse_port``), so the kernel spreads accepted
connections over the processes; the HTTP/2 pipe reaches whichever
process's gRPC listener the kernel picks, and any replica may answer.

The gRPC server is any object with ``add_insecure_port``, ``start`` and
``stop`` (``api/grpc_servers.py`` builds them); this module imports no
grpc. TLS on the public port is not ported.
"""

from __future__ import annotations

import select
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .rest import Request, Router

_H2_PREFACE_HEAD = b"PRI "
_PEEK_TIMEOUT_S = 10.0  # a client that opens a connection and says nothing


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # TCP_NODELAY: a response leaves in two writes (headers, then body), and
    # with Nagle on, the body waits for the ACK of the headers, which a
    # keep-alive client delays by up to 40 ms
    disable_nagle_algorithm = True
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
        pass  # request logging is not ported yet (ROADMAP 14.5)


def _opens_http2(conn: socket.socket) -> bool:
    """Peek (without consuming) at the connection's first bytes: True for
    the HTTP/2 client preface. A short or silent connection is HTTP/1's to
    answer."""
    conn.settimeout(_PEEK_TIMEOUT_S)
    try:
        head = conn.recv(4, socket.MSG_PEEK)
        if 0 < len(head) < 4 and _H2_PREFACE_HEAD.startswith(head):
            head = conn.recv(4, socket.MSG_PEEK | socket.MSG_WAITALL)
    except OSError:
        return False
    finally:
        conn.settimeout(None)
    return head == _H2_PREFACE_HEAD


def _pipe(client: socket.socket, backend_port: int) -> None:
    """Relay one connection to the loopback backend until both directions
    have closed; a half-close on one side is passed on to the other."""
    try:
        backend = socket.create_connection(("127.0.0.1", backend_port))
    except OSError:
        return
    by_fd = {client.fileno(): (client, backend), backend.fileno(): (backend, client)}
    poller = select.poll()  # not select(): descriptors may pass FD_SETSIZE
    for fd in by_fd:
        poller.register(fd, select.POLLIN)
    live = len(by_fd)
    try:
        while live:
            for fd, _ in poller.poll():
                src, dst = by_fd[fd]
                try:
                    chunk = src.recv(65536)
                except OSError:
                    chunk = b""
                if chunk:
                    dst.sendall(chunk)
                    continue
                poller.unregister(fd)
                live -= 1
                try:
                    dst.shutdown(socket.SHUT_WR)
                except OSError:
                    pass
    except OSError:
        pass  # either side reset: the relay ends
    finally:
        backend.close()


class _Server(ThreadingHTTPServer):
    daemon_threads = True  # a parked keep-alive connection never blocks stop
    allow_reuse_address = True
    # listen backlog: the socketserver default of 5 drops the SYNs of a
    # burst of concurrent clients, which then retry after a second
    request_queue_size = 1024
    grpc_port = 0  # the loopback gRPC backend; 0 = REST only

    def finish_request(self, request, client_address) -> None:
        # runs on the connection's own thread
        if self.grpc_port and _opens_http2(request):
            _pipe(request, self.grpc_port)
            return
        super().finish_request(request, client_address)


class _ReusePortServer(_Server):
    allow_reuse_port = True  # one listener per replica process, one port


class PlaneServer:
    """One plane: bind, serve on a thread, stop. With ``grpc_server`` the
    public port answers gRPC too."""

    def __init__(
        self,
        router: Router,
        host: str,
        port: int,
        grpc_server=None,
        grpc_port: int = 0,
        reuse_port: bool = False,
    ):
        self.router = router
        self.host = host
        self.port = port
        self.grpc_server = grpc_server
        # the direct (loopback) gRPC port: fixed for a replica pool, else
        # bound free at start
        self.grpc_port = grpc_port
        self.reuse_port = reuse_port
        self._server: Optional[_Server] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> int:
        if self.grpc_server is not None:
            # grpcio sets SO_REUSEPORT on its listeners by default, so a
            # fixed port is all a replica needs to share it
            self.grpc_port = self.grpc_server.add_insecure_port(
                f"127.0.0.1:{self.grpc_port}"
            )
            if self.grpc_port == 0:
                raise OSError("gRPC backend port bind failed")
            self.grpc_server.start()
        handler = type("PlaneHandler", (_Handler,), {"router": self.router})
        server_cls = _ReusePortServer if self.reuse_port else _Server
        self._server = server_cls((self.host, self.port), handler)
        self._server.grpc_port = self.grpc_port
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name=f"rest-plane-{self.port}",
            daemon=True,
        )
        self._thread.start()
        return self.port

    def stop(self, grace: float = 2.0) -> None:
        if self._server is not None:
            self._server.shutdown()  # returns once serve_forever has exited
            self._server.server_close()
            self._thread.join(timeout=5)
            self._server = None
        if self.grpc_server is not None and self.grpc_port:
            # in-flight RPCs get the grace window; the relays end when the
            # backend closes their connections
            self.grpc_server.stop(grace).wait(grace + 3)
            executor = getattr(self.grpc_server, "_keto_executor", None)
            if executor is not None:
                executor.shutdown(wait=False, cancel_futures=True)
            self.grpc_port = 0
