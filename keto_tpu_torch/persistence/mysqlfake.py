"""In-tree MySQL DB-API shim: MySQL-dialect SQL over sqlite, for the tests
(counterpart of ``keto_tpu/persistence/mysqlfake.py``).

No MySQL driver or server is installed here, so this shim validates the
MySQL *dialect layer* at the DB-API seam: everything ``MySQLDialect``
emits — %s placeholders, INSERT IGNORE, ON DUPLICATE KEY UPDATE, the
*.mysql.* migration overlays with their AUTO_INCREMENT / VARCHAR /
prefix-index forms — is translated to sqlite and executed. Against a real
server, ``MySQLDialect`` uses pymysql or MySQLdb and this module is never
imported.

DSN form: ``mysql+fake://<anything>/<database>`` — each database name maps
to its own sqlite file in a process-wide temp dir. The functional index
key parts of the unique dedup index (``(coalesce(col, ''))``) land as
sqlite expression indexes, which enforce the same uniqueness.
"""

from __future__ import annotations

import os
import re
import sqlite3
import tempfile
import threading
from urllib.parse import urlparse

_DIR_LOCK = threading.Lock()
_DIR: str | None = None

_REWRITES = [
    (re.compile(r"\bINSERT\s+IGNORE\s+INTO\b", re.I), "INSERT OR IGNORE INTO"),
    (re.compile(r"\bBIGINT\s+(UNSIGNED\s+)?AUTO_INCREMENT\s+PRIMARY\s+KEY",
                re.I),
     "INTEGER PRIMARY KEY AUTOINCREMENT"),
    (re.compile(r"\bAUTO_INCREMENT\b", re.I), "AUTOINCREMENT"),
    (re.compile(r"\bVARCHAR\(\d+\)", re.I), "TEXT"),
    (re.compile(r"\bDOUBLE\b", re.I), "REAL"),
    (re.compile(r"\bENGINE\s*=\s*\w+", re.I), ""),
    # prefix index lengths (col(191)) are a MySQL-ism sqlite rejects
    (re.compile(r"(\w+)\(\d+\)(\s*[,)])"), r"\1\2"),
]

_ON_DUP = re.compile(
    r"ON\s+DUPLICATE\s+KEY\s+UPDATE\s+version\s*=\s*version\s*\+\s*1",
    re.I,
)


def _translate(sql: str) -> str:
    # the store's one ON DUPLICATE KEY user is the version upsert; map it
    # to the sqlite upsert with the same semantics
    sql = _ON_DUP.sub(
        "ON CONFLICT(nid) DO UPDATE SET version = "
        "keto_store_version.version + 1",
        sql,
    )
    for pat, repl in _REWRITES:
        sql = pat.sub(repl, sql)
    return sql


class Cursor:
    def __init__(self, conn: sqlite3.Connection):
        self._cur = conn.cursor()

    def execute(self, sql: str, params=()):
        self._cur.execute(_translate(sql), tuple(params))
        return self

    def fetchone(self):
        return self._cur.fetchone()

    def fetchall(self):
        return self._cur.fetchall()

    @property
    def description(self):
        return self._cur.description

    @property
    def rowcount(self):
        return self._cur.rowcount

    def close(self):
        self._cur.close()


class Connection:
    """qmark-free DB-API facade: MySQLDialect emits %s placeholders, the
    underlying sqlite3 wants qmark — rewrite at execute time."""

    def __init__(self, path: str):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute("PRAGMA foreign_keys=ON")

    def cursor(self) -> Cursor:
        return _ParamCursor(self._conn)

    def commit(self):
        self._conn.commit()

    def rollback(self):
        self._conn.rollback()

    def close(self):
        self._conn.close()


class _ParamCursor(Cursor):
    def execute(self, sql: str, params=()):
        sql = _translate(sql)
        # %s -> ? outside string literals
        out = []
        in_str = False
        i, n = 0, len(sql)
        while i < n:
            c = sql[i]
            if in_str:
                out.append(c)
                if c == "'":
                    if i + 1 < n and sql[i + 1] == "'":
                        out.append("'")
                        i += 1
                    else:
                        in_str = False
            elif c == "'":
                in_str = True
                out.append(c)
            elif c == "%" and i + 1 < n and sql[i + 1] == "s":
                out.append("?")
                i += 1
            else:
                out.append(c)
            i += 1
        self._cur.execute("".join(out), tuple(params))
        return self


def connect(dsn: str) -> Connection:
    global _DIR
    u = urlparse(dsn)
    name = (u.path or "/default").lstrip("/") or "default"
    safe = re.sub(r"[^A-Za-z0-9_.-]", "_", name)
    with _DIR_LOCK:
        if _DIR is None:
            _DIR = tempfile.mkdtemp(prefix="keto-mysqlfake-")
    return Connection(os.path.join(_DIR, safe + ".db"))
