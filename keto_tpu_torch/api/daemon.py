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

With an ``ssl_context`` (``serve.<plane>.tls``) the public port is the TLS
terminator for both protocols, as the reference's mux is: the handshake
runs on the connection's own thread (a client that stalls its handshake
holds that thread alone, never the accept loop), the sniff reads the
decrypted opening bytes (a TLS socket cannot peek), and those bytes are
replayed: into the pipe to the gRPC backend, or ahead of the REST handler's
``rfile``. The loopback gRPC backend stays plaintext. ``expose_backends``
(``serve.<plane>.expose_backend_ports``) binds the gRPC backend on the
public host instead of loopback, for protocol-aware balancers; never under
TLS, which that would bypass.

The gRPC server is any object with ``add_insecure_port``, ``start`` and
``stop`` (``api/grpc_servers.py`` builds them); this module imports no
grpc.

Each REST request runs under a ``TransportLedger``
(``telemetry/attribution.py``) opened before its body is read: a check
record adopts it, and it is folded into the attribution ledger after the
reply's last byte is written, so ``/debug/attribution`` times a check from
the body read to the socket write.
"""

from __future__ import annotations

import io
import logging
import select
import socket
import ssl
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..telemetry.attribution import (
    TransportLedger,
    reset_current_ledger,
    set_current_ledger,
)
from .rest import Request, Router

_H2_PREFACE_HEAD = b"PRI "
_PEEK_TIMEOUT_S = 10.0  # a client that opens a connection and says nothing

_http_log = logging.getLogger("keto_tpu_torch.http")


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # TCP_NODELAY: a response leaves in two writes (headers, then body), and
    # with Nagle on, the body waits for the ACK of the headers, which a
    # keep-alive client delays by up to 40 ms
    disable_nagle_algorithm = True
    router: Router  # set on the per-server subclass

    def setup(self) -> None:
        super().setup()
        head = getattr(self.request, "_keto_head", b"")
        if head:
            # the bytes the TLS sniff consumed come first; the stock reader
            # is closed so it holds no reference that defers the close
            self.rfile.close()
            self.rfile = io.BufferedReader(_Replay(head, self.connection))

    def _serve(self) -> None:
        ledger = TransportLedger()
        token = set_current_ledger(ledger)
        try:
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
        finally:
            reset_current_ledger(token)
            ledger.close()

    do_GET = do_POST = do_PUT = do_DELETE = do_PATCH = do_OPTIONS = _serve

    def log_request(self, code="-", size="-") -> None:
        pass  # the router logs each request it dispatched, with its route

    def log_message(self, format, *args) -> None:
        # what http.server reports on its own (a malformed request line, a
        # timed-out read): onto the package logger, not stderr
        _http_log.info("http: %s %s", self.address_string(), format % args)


class _Replay(io.RawIOBase):
    """A connection's bytes with ``head`` put back in front."""

    def __init__(self, head: bytes, conn):
        self._head = head
        self._conn = conn

    def readable(self) -> bool:
        return True

    def readinto(self, buf) -> int:
        if self._head:
            n = min(len(buf), len(self._head))
            buf[:n] = self._head[:n]
            self._head = self._head[n:]
            return n
        return self._conn.recv_into(buf)


def _tls_accept(conn: socket.socket, context: ssl.SSLContext):
    """The server side of the handshake, then the decrypted opening bytes
    (up to four, fewer when they cannot open an HTTP/2 preface): (the TLS
    socket, head), or None when the handshake or the read fails."""
    try:
        tls = context.wrap_socket(conn, server_side=True, do_handshake_on_connect=False)
    except (OSError, ValueError):
        return None
    try:
        tls.settimeout(_PEEK_TIMEOUT_S)
        tls.do_handshake()
        head = b""
        while len(head) < 4 and _H2_PREFACE_HEAD.startswith(head):
            chunk = tls.recv(4 - len(head))
            if not chunk:
                break
            head += chunk
        tls.settimeout(None)
    except (OSError, ValueError):
        tls.close()
        return None
    return tls, head


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


def _pipe(client: socket.socket, backend_port: int, head: bytes = b"") -> None:
    """Relay one connection to the loopback backend until both directions
    have closed; a half-close on one side is passed on to the other. ``head``
    (bytes already read from the client) goes to the backend first. A TLS
    client cannot be half-closed without losing its session, so the
    backend's close ends a TLS relay."""
    try:
        backend = socket.create_connection(("127.0.0.1", backend_port))
    except OSError:
        return
    tls = isinstance(client, ssl.SSLSocket)
    by_fd = {client.fileno(): (client, backend), backend.fileno(): (backend, client)}
    poller = select.poll()  # not select(): descriptors may pass FD_SETSIZE
    for fd in by_fd:
        poller.register(fd, select.POLLIN)
    live = len(by_fd)
    try:
        if tls and client.pending():
            # the rest of the record the sniff read from: poll cannot see it
            head += client.recv(client.pending())
        if head:
            backend.sendall(head)
        while live:
            for fd, _ in poller.poll():
                src, dst = by_fd[fd]
                try:
                    chunk = src.recv(65536)
                    # a TLS record decrypted past the read stays buffered
                    # where poll cannot see it
                    while src is client and tls and client.pending():
                        chunk += client.recv(client.pending())
                except OSError:
                    chunk = b""
                if chunk:
                    dst.sendall(chunk)
                    continue
                if tls and src is backend:
                    return
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
    ssl_context: Optional[ssl.SSLContext] = None

    def finish_request(self, request, client_address) -> None:
        # runs on the connection's own thread
        if self.ssl_context is not None:
            self._finish_tls(request, client_address)
        elif self.grpc_port and _opens_http2(request):
            _pipe(request, self.grpc_port)
        else:
            super().finish_request(request, client_address)

    def _finish_tls(self, request, client_address) -> None:
        accepted = _tls_accept(request, self.ssl_context)
        if accepted is None:
            return  # a failed handshake (plaintext to a TLS port) ends here
        tls, head = accepted
        try:
            if not head:
                return
            if self.grpc_port and head == _H2_PREFACE_HEAD:
                _pipe(tls, self.grpc_port, head)
                return
            tls._keto_head = head
            super().finish_request(tls, client_address)
        finally:
            tls.close()


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
        ssl_context: Optional[ssl.SSLContext] = None,
        expose_backends: bool = False,
    ):
        self.router = router
        self.host = host
        self.port = port
        self.ssl_context = ssl_context
        self.expose_backends = expose_backends
        self.grpc_server = grpc_server
        # the direct (loopback) gRPC port: fixed for a replica pool, else
        # bound free at start
        self.grpc_port = grpc_port
        self.reuse_port = reuse_port
        self._server: Optional[_Server] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> int:
        if self.grpc_server is not None:
            # the plaintext backend stays on loopback unless exposed, and is
            # never exposed under TLS
            backend_host = (
                self.host or "0.0.0.0"
                if self.expose_backends and self.ssl_context is None
                else "127.0.0.1"
            )
            # grpcio sets SO_REUSEPORT on its listeners by default, so a
            # fixed port is all a replica needs to share it
            self.grpc_port = self.grpc_server.add_insecure_port(
                f"{backend_host}:{self.grpc_port}"
            )
            if self.grpc_port == 0:
                raise OSError("gRPC backend port bind failed")
            self.grpc_server.start()
        handler = type("PlaneHandler", (_Handler,), {"router": self.router})
        server_cls = _ReusePortServer if self.reuse_port else _Server
        self._server = server_cls((self.host, self.port), handler)
        self._server.grpc_port = self.grpc_port
        self._server.ssl_context = self.ssl_context
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
