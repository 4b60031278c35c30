"""In-tree fake PostgreSQL server: the v3 wire protocol over sqlite
(counterpart of ``keto_tpu/persistence/pgfake.py``).

The tests' postgres and cockroach backends: the client (``pgwire.py``)
speaks the genuine protocol, and this server lets the dialect's SQL — %s
interpolation, ON CONFLICT forms, the postgres migration overlays — run end
to end over a real socket where no postgres binary is installed.

Scope: startup (trust auth; SSLRequest answered 'N'), simple query 'Q',
per-database isolation (each database name maps to its own sqlite file),
transactions passed through (BEGIN/COMMIT/ROLLBACK), text results with
type OIDs inferred from sqlite's python values. DDL is translated with a
small rewrite table (BIGSERIAL -> INTEGER AUTOINCREMENT, DOUBLE PRECISION
-> REAL); sqlite speaks the rest of the dialect's SQL natively.
"""

from __future__ import annotations

import os
import re
import socketserver
import sqlite3
import struct
import tempfile
import threading
from typing import Optional

_INT4 = struct.Struct("!i")
_INT2 = struct.Struct("!h")

_SSL_REQUEST_CODE = 80877103
_CANCEL_REQUEST_CODE = 80877102

_DDL_REWRITES = [
    (re.compile(r"\bBIGSERIAL\s+PRIMARY\s+KEY\b", re.I),
     "INTEGER PRIMARY KEY AUTOINCREMENT"),
    (re.compile(r"\bSERIAL\s+PRIMARY\s+KEY\b", re.I),
     "INTEGER PRIMARY KEY AUTOINCREMENT"),
    (re.compile(r"\bDOUBLE\s+PRECISION\b", re.I), "REAL"),
    (re.compile(r"\bBIGINT\b", re.I), "INTEGER"),
    (re.compile(r"::bytea\b", re.I), ""),
]


def _translate(sql: str) -> str:
    for pat, repl in _DDL_REWRITES:
        sql = pat.sub(repl, sql)
    return sql


def _oid_for(value) -> int:
    if isinstance(value, bool):
        return 16
    if isinstance(value, int):
        return 20  # int8
    if isinstance(value, float):
        return 701  # float8
    return 25  # text


def _to_text(value) -> Optional[str]:
    if value is None:
        return None
    if isinstance(value, bool):
        return "t" if value else "f"
    if isinstance(value, float):
        return repr(value)
    if isinstance(value, (bytes, memoryview)):
        return "\\x" + bytes(value).hex()
    return str(value)


class _Session(socketserver.BaseRequestHandler):
    def handle(self) -> None:
        try:
            if not self._startup():
                return
            self._serve()
        except (ConnectionError, struct.error, OSError):
            pass
        finally:
            conn = getattr(self, "_db", None)
            if conn is not None:
                try:
                    conn.rollback()
                    conn.close()
                except sqlite3.Error:
                    pass

    # -- protocol plumbing -----------------------------------------------------

    def _recv_exact(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = self.request.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("client closed")
            buf += chunk
        return bytes(buf)

    def _send(self, kind: bytes, payload: bytes = b"") -> None:
        # one write per reply, ending at ReadyForQuery: a reply sent as
        # several small writes stalls on Nagle and the client's delayed ACK
        # (~40 ms a query)
        out = getattr(self, "_out", None)
        if out is None:
            out = self._out = []
        out.append(kind + _INT4.pack(len(payload) + 4) + payload)
        if kind == b"Z":
            self.request.sendall(b"".join(out))
            out.clear()

    def _startup(self) -> bool:
        while True:
            (length,) = _INT4.unpack(self._recv_exact(4))
            body = self._recv_exact(length - 4)
            (code,) = _INT4.unpack(body[:4])
            if code == _SSL_REQUEST_CODE:
                self.request.sendall(b"N")  # no TLS; client retries plain
                continue
            if code == _CANCEL_REQUEST_CODE:
                return False
            break  # StartupMessage
        params = {}
        parts = body[4:].split(b"\x00")
        for k, v in zip(parts[0::2], parts[1::2]):
            if k:
                params[k.decode()] = v.decode()
        database = params.get("database") or params.get("user") or "postgres"
        self._db = self.server.open_database(database)
        self._send(b"R", _INT4.pack(0))  # AuthenticationOk (trust)
        for k, v in (
            ("server_version", "14.0 (keto-tpu pgfake)"),
            ("client_encoding", "UTF8"),
            ("standard_conforming_strings", "on"),
        ):
            self._send(b"S", k.encode() + b"\x00" + v.encode() + b"\x00")
        self._send(b"K", struct.pack("!ii", os.getpid(), 0))
        self._send(b"Z", b"I")
        return True

    # -- query serving ---------------------------------------------------------

    def _serve(self) -> None:
        while True:
            kind = self._recv_exact(1)
            (length,) = _INT4.unpack(self._recv_exact(4))
            body = self._recv_exact(length - 4)
            if kind == b"X":  # Terminate
                return
            if kind == b"p":  # stray password message
                continue
            if kind != b"Q":
                self._error(f"unsupported message {kind!r}")
                self._send(b"Z", b"I")
                continue
            sql = body.rstrip(b"\x00").decode()
            self._run_query(sql)

    _SET_RE = re.compile(
        r"^SET\s+(?:SESSION\s+|LOCAL\s+)?(\w+)\s*(?:=|\s+TO\s+)\s*(.+?)\s*;?\s*$",
        re.I | re.S,
    )

    def _run_query(self, sql: str) -> None:
        db = self._db
        # session SETs (the client pins standard_conforming_strings at
        # connect) never reach sqlite: acknowledge like postgres does —
        # ParameterStatus, then CommandComplete 'SET'
        m = self._SET_RE.match(sql.strip())
        if m:
            name = m.group(1).lower()
            value = m.group(2).strip().strip("'\"")
            self._send(
                b"S", name.encode() + b"\x00" + value.encode() + b"\x00"
            )
            self._send(b"C", b"SET\x00")
            self._send(b"Z", b"T" if db.in_transaction else b"I")
            return
        try:
            cur = db.execute(_translate(sql))
            rows = cur.fetchall() if cur.description else []
        except sqlite3.Error as e:
            self._error(str(e))
            self._send(b"Z", b"T" if db.in_transaction else b"I")
            return
        head = sql.lstrip()[:8].upper()
        if cur.description:
            names = [d[0] for d in cur.description]
            oids = _infer_oids(names, rows)
            self._send(b"T", _row_description(names, oids))
            for row in rows:
                self._send(b"D", _data_row(row))
            tag = f"SELECT {len(rows)}"
        elif head.startswith("INSERT"):
            tag = f"INSERT 0 {max(cur.rowcount, 0)}"
        elif head.startswith(("UPDATE", "DELETE")):
            verb = head.split()[0]
            tag = f"{verb} {max(cur.rowcount, 0)}"
        elif head.startswith("BEGIN"):
            tag = "BEGIN"
        elif head.startswith("COMMIT"):
            tag = "COMMIT"
        elif head.startswith("ROLLBACK"):
            tag = "ROLLBACK"
        else:
            tag = head.split()[0] if head else "OK"
        self._send(b"C", tag.encode() + b"\x00")
        self._send(b"Z", b"T" if db.in_transaction else b"I")

    def _error(self, message: str) -> None:
        payload = (
            b"SERROR\x00"
            b"C42601\x00"
            b"M" + message.encode() + b"\x00\x00"
        )
        self._send(b"E", payload)


def _infer_oids(names: list[str], rows: list) -> list[int]:
    oids = []
    for i in range(len(names)):
        oid = 25
        for row in rows:
            if row[i] is not None:
                oid = _oid_for(row[i])
                break
        oids.append(oid)
    return oids


def _row_description(names: list[str], oids: list[int]) -> bytes:
    out = [_INT2.pack(len(names))]
    for name, oid in zip(names, oids):
        out.append(
            name.encode() + b"\x00"
            + struct.pack("!ihihih", 0, 0, oid, -1, -1, 0)
        )
    return b"".join(out)


def _data_row(row) -> bytes:
    out = [_INT2.pack(len(row))]
    for value in row:
        text = _to_text(value)
        if text is None:
            out.append(_INT4.pack(-1))
        else:
            raw = text.encode()
            out.append(_INT4.pack(len(raw)) + raw)
    return b"".join(out)


class FakePostgresServer(socketserver.ThreadingTCPServer):
    """One server, many logical databases (name -> sqlite file)."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        super().__init__((host, port), _Session)
        self._dir = tempfile.mkdtemp(prefix="keto-pgfake-")
        self._db_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.server_address[1]

    def process_request(self, request, client_address):
        # named handler threads: the replica pool's fork-time thread
        # inventory must be able to recognize (and allow) fake-postgres
        # connections held open by unrelated fixtures
        t = threading.Thread(
            target=self.process_request_thread,
            args=(request, client_address),
            name="pgfake-conn",
            daemon=True,
        )
        t.start()

    def open_database(self, name: str) -> sqlite3.Connection:
        safe = re.sub(r"[^A-Za-z0-9_.-]", "_", name)
        path = os.path.join(self._dir, safe + ".db")
        conn = sqlite3.connect(
            path, check_same_thread=False, isolation_level=None
        )
        conn.execute("PRAGMA journal_mode=WAL")
        conn.execute("PRAGMA busy_timeout=10000")
        conn.execute("PRAGMA foreign_keys=ON")
        return conn

    def start(self) -> "FakePostgresServer":
        self._thread = threading.Thread(
            target=self.serve_forever, name="pgfake", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self.shutdown()
        self.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)


def start_server(host: str = "127.0.0.1", port: int = 0) -> FakePostgresServer:
    return FakePostgresServer(host, port).start()
