"""Versioned SQL migrations (counterpart of
``keto_tpu/persistence/migrator.py``; the reference's popx.MigrationBox).

Migration sources are ``<version>_<name>.up.sql`` / ``.down.sql`` files in a
directory; applied versions are recorded in ``keto_migrations``. ``up``
applies pending migrations in version order inside one transaction each;
``down`` rolls back the most recent N; ``status`` lists every known
migration with its applied state.
"""

from __future__ import annotations

import os
import re
import sqlite3
import time
from dataclasses import dataclass

_FILE_RE = re.compile(r"^(?P<version>\d+)_(?P<name>.+)\.(?P<dir>up|down)\.sql$")

# bare transaction-control statements inside a migration script (we run the
# whole script in one transaction ourselves)
_TXN_CONTROL_RE = re.compile(
    r"(?:BEGIN|COMMIT|END|ROLLBACK)(?:\s+(?:TRANSACTION|DEFERRED|IMMEDIATE|"
    r"EXCLUSIVE))?\s*;?",
    re.IGNORECASE,
)
_LEADING_SQL_COMMENTS_RE = re.compile(r"(?s)^(?:\s*(?:--[^\n]*\n?|/\*.*?\*/))*")


def _is_txn_control(stmt: str) -> bool:
    """True for a bare BEGIN/COMMIT/END/ROLLBACK statement, ignoring any
    leading SQL comments attached to it by the statement splitter."""
    bare = _LEADING_SQL_COMMENTS_RE.sub("", stmt, count=1).strip()
    return _TXN_CONTROL_RE.fullmatch(bare) is not None


def _generic_in_transaction(conn) -> bool:
    """Best-effort open-transaction probe for non-sqlite DB-API drivers:
    psycopg3 (conn.info.transaction_status), psycopg2
    (conn.get_transaction_status()) — 0 is IDLE for both. Unknown drivers
    report False (no guard possible)."""
    info = getattr(conn, "info", None)
    status = getattr(info, "transaction_status", None)
    if status is not None:
        return int(status) != 0
    get_status = getattr(conn, "get_transaction_status", None)
    if callable(get_status):
        try:
            return int(get_status()) != 0
        except Exception:
            return False
    return False


@dataclass(frozen=True)
class Migration:
    version: str
    name: str
    up_sql: str
    down_sql: str


@dataclass(frozen=True)
class MigrationStatus:
    version: str
    name: str
    applied: bool


def load_migrations(directory: str, dialect=None) -> list[Migration]:
    """Migrations for one dialect: generic files, with per-dialect overlays
    (<ver>_<name>.<dialect>.{up,down}.sql) replacing the generic file of the
    same version/direction — the reference's per-dialect migration scheme
    (internal/persistence/sql/migrations/sql/*.postgres.up.sql etc.)."""
    if dialect is not None:
        files = dialect.migration_files(directory)
    else:
        # no dialect: generic files only — an overlay file's extra dot
        # (<ver>_<name>.<dialect>.up.sql) must not leak into the ladder,
        # where sort order would decide which engine's SQL wins
        files = {
            f: os.path.join(directory, f)
            for f in sorted(os.listdir(directory))
            if f.endswith(".sql") and f.count(".") == 2
        }
    found: dict[str, dict] = {}
    for fname, path in sorted(files.items()):
        m = _FILE_RE.match(fname)
        if not m:
            continue
        entry = found.setdefault(
            m.group("version"), {"name": m.group("name"), "up": "", "down": ""}
        )
        with open(path) as f:
            entry[m.group("dir")] = f.read()
    return [
        Migration(
            version=v,
            name=e["name"],
            up_sql=e["up"],
            down_sql=e["down"],
        )
        for v, e in sorted(found.items())
    ]


class Migrator:
    TABLE = "keto_migrations"

    def __init__(self, conn, directory: str, dialect=None):
        self.conn = conn
        self.dialect = dialect
        self.migrations = load_migrations(directory, dialect=dialect)
        self._exec(
            f"CREATE TABLE IF NOT EXISTS {self.TABLE} ("
            "version TEXT PRIMARY KEY, name TEXT NOT NULL, "
            "applied_at REAL NOT NULL)"
        )
        conn.commit()

    def _exec(self, sql: str, params: tuple = ()):
        """Cursor-based execute: sqlite3 allows conn.execute, generic
        DB-API drivers (psycopg2) do not. Placeholders stay qmark for
        sqlite, rewritten by the dialect otherwise."""
        if self.dialect is not None:
            sql = self.dialect.sql(sql)
        cur = self.conn.cursor()
        cur.execute(sql, params)
        return cur

    def applied_versions(self) -> set[str]:
        rows = self._exec(f"SELECT version FROM {self.TABLE}").fetchall()
        if not isinstance(self.conn, sqlite3.Connection):
            # generic DB-API drivers open a transaction on ANY statement,
            # SELECTs included; release the read snapshot or the
            # open-transaction guard in _run_in_transaction trips on the
            # migrator's own bookkeeping read (latent against psycopg2
            # too — first exercised by the in-tree wire driver)
            self.conn.rollback()
        return {r[0] for r in rows}

    def status(self) -> list[MigrationStatus]:
        applied = self.applied_versions()
        return [
            MigrationStatus(m.version, m.name, m.version in applied)
            for m in self.migrations
        ]

    def has_pending(self) -> bool:
        return any(not s.applied for s in self.status())

    def _run_in_transaction(self, script: str, record_sql: str, params) -> None:
        """Execute a migration script statement-by-statement plus its version
        bookkeeping row in ONE explicit transaction. ``executescript`` is
        unusable here: it issues an implicit COMMIT before running, so a
        failing multi-statement migration would leave partial DDL applied
        with no version row recorded."""
        if not isinstance(self.conn, sqlite3.Connection):
            # generic DB-API path (postgres, ...): the driver opens the
            # transaction implicitly; commit/rollback close it. Transactional
            # DDL is a postgres strength, so the one-txn-per-migration
            # contract holds there too.
            if _generic_in_transaction(self.conn):
                # same guard as the sqlite branch: our commit()/rollback()
                # below must not absorb the caller's uncommitted work
                raise RuntimeError(
                    "cannot run migrations: connection has an open "
                    "transaction"
                )
            try:
                for stmt in _split_statements(script):
                    if _is_txn_control(stmt):
                        continue
                    self._exec(stmt)
                self._exec(record_sql, tuple(params))
                self.conn.commit()
            except BaseException:
                self.conn.rollback()
                raise
            return
        if self.conn.in_transaction:
            # assigning isolation_level below would silently COMMIT the
            # caller's pending writes; refuse instead of surprising them
            raise RuntimeError(
                "cannot run migrations: connection has an open transaction"
            )
        old_isolation = self.conn.isolation_level
        self.conn.isolation_level = None  # autocommit: we manage the txn
        try:
            self.conn.execute("BEGIN")
            try:
                for stmt in _split_statements(script):
                    # scripts written defensively with their own txn control
                    # (BEGIN; ...; COMMIT;) run inside OUR transaction
                    if _is_txn_control(stmt):
                        continue
                    self.conn.execute(stmt)
                self.conn.execute(record_sql, params)
                self.conn.execute("COMMIT")
            except BaseException:
                # a statement may have auto-rolled-back already (e.g. INSERT
                # OR ROLLBACK, RAISE(ROLLBACK)); rolling back a closed txn
                # would mask the original error
                if self.conn.in_transaction:
                    self.conn.execute("ROLLBACK")
                raise
        finally:
            self.conn.isolation_level = old_isolation

    def up(self, steps: int = -1) -> list[str]:
        """Apply pending migrations (all by default); returns versions run."""
        applied = self.applied_versions()
        ran = []
        for m in self.migrations:
            if m.version in applied:
                continue
            if steps >= 0 and len(ran) >= steps:
                break
            # one transaction per migration, like popx
            self._run_in_transaction(
                m.up_sql,
                f"INSERT INTO {self.TABLE} (version, name, applied_at) "
                "VALUES (?, ?, ?)",
                (m.version, m.name, time.time()),
            )
            ran.append(m.version)
        return ran

    def down(self, steps: int = 1) -> list[str]:
        """Roll back the most recent `steps` applied migrations."""
        applied = self.applied_versions()
        ran = []
        for m in reversed(self.migrations):
            if m.version not in applied:
                continue
            if len(ran) >= steps:
                break
            self._run_in_transaction(
                m.down_sql,
                f"DELETE FROM {self.TABLE} WHERE version = ?",
                (m.version,),
            )
            ran.append(m.version)
        return ran


def _split_statements(script: str):
    """Split a SQL script into complete statements using sqlite's own
    statement-completeness test (handles BEGIN..END trigger bodies and
    semicolons inside string literals; multiple statements per line are
    split correctly because candidates grow semicolon-by-semicolon)."""
    buf = ""
    for piece in script.split(";"):
        buf += piece + ";"
        if sqlite3.complete_statement(buf):
            stmt = buf.strip()
            if stmt and stmt != ";":
                yield stmt
            buf = ""
    tail = buf.strip().rstrip(";").strip()
    if tail:
        yield tail + ";"
