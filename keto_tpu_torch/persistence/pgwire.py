"""Minimal pure-Python PostgreSQL v3 wire-protocol driver, a DB-API subset
(counterpart of ``keto_tpu/persistence/pgwire.py``).

A real client speaking the real protocol: it connects to a PostgreSQL or
CockroachDB server as well as to the in-tree fake (``pgfake.py``). Scope:

- simple-query protocol only ('Q'): parameters are interpolated client-side
  with standard SQL quoting;
- auth: trust and cleartext password (md5 raises);
- text result format, converted per column type OID (ints, floats, bools,
  NULL; everything else str);
- DB-API surface: connect() -> Connection(cursor/commit/rollback/close),
  Cursor(execute/fetchone/fetchall/rowcount/description).

Transactions follow DB-API semantics: the first execute opens a
transaction (BEGIN), commit()/rollback() close it; both are no-ops when no
transaction is open (the store calls rollback() to release read
snapshots).
"""

from __future__ import annotations

import math
import socket
import struct
from typing import Optional
from urllib.parse import unquote, urlparse

_INT4 = struct.Struct("!i")
_INT2 = struct.Struct("!h")

# type OIDs we convert; everything else stays text
_OID_BOOL = 16
_OID_INT8 = 20
_OID_INT2 = 21
_OID_INT4 = 23
_OID_FLOAT4 = 700
_OID_FLOAT8 = 701
_OID_NUMERIC = 1700
_INT_OIDS = (_OID_INT8, _OID_INT2, _OID_INT4)
_FLOAT_OIDS = (_OID_FLOAT4, _OID_FLOAT8, _OID_NUMERIC)


class Error(Exception):
    """Driver/server error (DB-API base)."""

    def __init__(self, message: str, fields: Optional[dict] = None):
        super().__init__(message)
        self.fields = fields or {}


class OperationalError(Error):
    pass


def quote_literal(value) -> str:
    """SQL-literal spelling of one parameter (client-side interpolation)."""
    if value is None:
        return "NULL"
    if isinstance(value, bool):
        return "TRUE" if value else "FALSE"
    if isinstance(value, float) and not math.isfinite(value):
        # repr(inf/nan) would interpolate as a bare SQL identifier, not a
        # number — reject instead of shipping malformed (and injectable)
        # SQL to the server
        raise Error(f"non-finite float parameter: {value!r}")
    if isinstance(value, (int, float)):
        return repr(value)
    if isinstance(value, (bytes, bytearray)):
        return "'\\x" + bytes(value).hex() + "'::bytea"
    s = str(value)
    if "\x00" in s:
        raise Error("NUL byte in string parameter")
    return "'" + s.replace("'", "''") + "'"


def _interpolate(sql: str, params) -> str:
    """Substitute %s placeholders outside string literals."""
    if not params:
        return sql
    out = []
    it = iter(params)
    i = 0
    n = len(sql)
    in_str = False
    while i < n:
        c = sql[i]
        if in_str:
            out.append(c)
            if c == "'":
                # '' escape stays inside the literal
                if i + 1 < n and sql[i + 1] == "'":
                    out.append("'")
                    i += 1
                else:
                    in_str = False
        elif c == "'":
            in_str = True
            out.append(c)
        elif c == "%" and i + 1 < n and sql[i + 1] == "s":
            out.append(quote_literal(next(it)))
            i += 1
        elif c == "%" and i + 1 < n and sql[i + 1] == "%":
            out.append("%")
            i += 1
        else:
            out.append(c)
        i += 1
    return "".join(out)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise OperationalError("server closed the connection")
        buf += chunk
    return bytes(buf)


class Cursor:
    def __init__(self, conn: "Connection"):
        self._conn = conn
        self.description = None
        self.rowcount = -1
        self._rows: list[tuple] = []
        self._pos = 0

    def execute(self, sql: str, params=()):
        self._conn._begin_if_needed(sql)
        desc, rows, rowcount = self._conn._simple_query(
            _interpolate(sql, tuple(params))
        )
        self.description = desc
        self._rows = rows
        self._pos = 0
        self.rowcount = rowcount
        return self

    def fetchone(self):
        if self._pos >= len(self._rows):
            return None
        row = self._rows[self._pos]
        self._pos += 1
        return row

    def fetchall(self):
        rows = self._rows[self._pos :]
        self._pos = len(self._rows)
        return rows

    def close(self):
        self._rows = []


class Connection:
    def __init__(
        self,
        host: str,
        port: int,
        user: str,
        database: str,
        password: str = "",
        connect_timeout: float = 10.0,
    ):
        self._sock = socket.create_connection(
            (host, port), timeout=connect_timeout
        )
        self._sock.settimeout(60.0)
        self._in_txn = False
        self._closed = False
        #: server-reported ParameterStatus values (server_version, ...)
        self.parameters: dict[str, str] = {}
        self._startup(user, database, password)
        # quote_literal escapes quotes by doubling only — that spelling is
        # safe iff the server treats backslashes in '...' literally. Pin
        # the setting instead of trusting the server default; a server
        # that refuses it cannot be spoken to safely.
        try:
            self._simple_query("SET standard_conforming_strings = on")
        except Error as e:
            self.close()
            raise OperationalError(
                f"server refused SET standard_conforming_strings = on: {e}"
            ) from e

    # -- protocol --------------------------------------------------------------

    def _send(self, kind: Optional[bytes], payload: bytes) -> None:
        msg = _INT4.pack(len(payload) + 4) + payload
        if kind:
            msg = kind + msg
        self._sock.sendall(msg)

    def _read_message(self) -> tuple[bytes, bytes]:
        kind = _recv_exact(self._sock, 1)
        (length,) = _INT4.unpack(_recv_exact(self._sock, 4))
        return kind, _recv_exact(self._sock, length - 4)

    def _startup(self, user: str, database: str, password: str) -> None:
        params = (
            b"user\x00" + user.encode() + b"\x00"
            b"database\x00" + database.encode() + b"\x00"
            b"client_encoding\x00UTF8\x00\x00"
        )
        self._send(None, _INT4.pack(196608) + params)  # protocol 3.0
        while True:
            kind, body = self._read_message()
            if kind == b"R":
                (code,) = _INT4.unpack(body[:4])
                if code == 0:
                    continue  # AuthenticationOk
                if code == 3:  # cleartext password
                    self._send(b"p", password.encode() + b"\x00")
                    continue
                raise OperationalError(
                    f"unsupported auth method {code} (trust/cleartext only)"
                )
            if kind == b"S":
                self._parameter_status(body)
                continue
            if kind in (b"K", b"N"):  # key data / notice
                continue
            if kind == b"Z":
                return
            if kind == b"E":
                raise OperationalError(_error_text(body))
            raise OperationalError(f"unexpected startup message {kind!r}")

    def _parameter_status(self, body: bytes) -> None:
        try:
            name, value = body.rstrip(b"\x00").split(b"\x00", 1)
        except ValueError:
            return
        self.parameters[name.decode()] = value.decode()

    def _simple_query(self, sql: str):
        self._send(b"Q", sql.encode() + b"\x00")
        desc = None
        oids: list[int] = []
        rows: list[tuple] = []
        rowcount = -1
        error: Optional[str] = None
        while True:
            kind, body = self._read_message()
            if kind == b"T":  # RowDescription
                desc, oids = _parse_row_description(body)
            elif kind == b"D":  # DataRow
                rows.append(_parse_data_row(body, oids))
            elif kind == b"C":  # CommandComplete
                rowcount = _rowcount_from_tag(body)
            elif kind == b"E":
                error = _error_text(body)
            elif kind == b"S":  # ParameterStatus (e.g. after SET)
                self._parameter_status(body)
            elif kind in (b"N", b"I"):  # notice / empty query
                continue
            elif kind == b"Z":
                status = body[:1]
                if error is not None:
                    if status == b"E":
                        # server left the txn aborted: our _in_txn stays
                        # True; the store's rollback() will clear it
                        pass
                    raise Error(error)
                return desc, rows, rowcount
            else:
                raise OperationalError(f"unexpected message {kind!r}")

    # -- DB-API surface --------------------------------------------------------

    def cursor(self) -> Cursor:
        return Cursor(self)

    def get_transaction_status(self) -> int:
        """psycopg2-compatible probe (0 = idle) for the migrator's
        open-transaction guard."""
        return 1 if self._in_txn else 0

    def _begin_if_needed(self, sql: str) -> None:
        head = sql.lstrip()[:6].upper()
        if head.startswith(("BEGIN", "COMMIT", "ROLLBA")):
            return
        if not self._in_txn:
            self._simple_query("BEGIN")
            self._in_txn = True

    def commit(self) -> None:
        if self._in_txn:
            self._simple_query("COMMIT")
            self._in_txn = False

    def rollback(self) -> None:
        if self._in_txn:
            self._simple_query("ROLLBACK")
            self._in_txn = False

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            try:
                self._send(b"X", b"")  # Terminate
            except OSError:
                pass
            self._sock.close()


def _parse_row_description(body: bytes):
    (nfields,) = _INT2.unpack(body[:2])
    pos = 2
    desc = []
    oids = []
    for _ in range(nfields):
        end = body.index(b"\x00", pos)
        name = body[pos:end].decode()
        pos = end + 1
        _tableoid, _attnum = struct.unpack("!ih", body[pos : pos + 6])
        (typoid,) = _INT4.unpack(body[pos + 6 : pos + 10])
        pos += 18  # tableoid(4) attnum(2) typoid(4) typlen(2) typmod(4) fmt(2)
        desc.append((name, typoid, None, None, None, None, None))
        oids.append(typoid)
    return desc, oids


def _parse_data_row(body: bytes, oids: list[int]) -> tuple:
    (ncols,) = _INT2.unpack(body[:2])
    pos = 2
    row = []
    for i in range(ncols):
        (length,) = _INT4.unpack(body[pos : pos + 4])
        pos += 4
        if length == -1:
            row.append(None)
            continue
        text = body[pos : pos + length].decode()
        pos += length
        oid = oids[i] if i < len(oids) else 25
        if oid in _INT_OIDS:
            row.append(int(text))
        elif oid in _FLOAT_OIDS:
            row.append(float(text))
        elif oid == _OID_BOOL:
            row.append(text == "t")
        else:
            row.append(text)
    return tuple(row)


def _rowcount_from_tag(body: bytes) -> int:
    tag = body.rstrip(b"\x00").decode()
    parts = tag.split()
    try:
        return int(parts[-1])
    except (ValueError, IndexError):
        return -1


def _error_text(body: bytes) -> str:
    fields = {}
    pos = 0
    while pos < len(body) and body[pos : pos + 1] != b"\x00":
        code = body[pos : pos + 1].decode()
        end = body.index(b"\x00", pos + 1)
        fields[code] = body[pos + 1 : end].decode()
        pos = end + 1
    return fields.get("M", "unknown server error") + (
        f" (code {fields['C']})" if "C" in fields else ""
    )


def connect(dsn: str, connect_timeout: float = 10.0) -> Connection:
    """Open a connection from a postgres:// / cockroach:// URL DSN."""
    u = urlparse(dsn)
    return Connection(
        host=u.hostname or "127.0.0.1",
        port=u.port or 5432,
        user=unquote(u.username or "postgres"),
        database=(u.path or "/postgres").lstrip("/") or "postgres",
        password=unquote(u.password or ""),
        connect_timeout=connect_timeout,
    )
