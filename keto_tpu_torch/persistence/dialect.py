"""SQL dialect adapters (counterpart of ``keto_tpu/persistence/dialect.py``).

The store (``sqlstore.SQLTupleStore``) builds queries in a neutral form
(qmark placeholders, ANSI column lists) and leaves everything
engine-specific to a ``SQLDialect``, one per engine of the reference's four
(sqlite, mysql, postgres, cockroach):

- placeholder spelling      (``?`` vs ``%s``)
- conflict-ignoring insert  (INSERT OR IGNORE vs ON CONFLICT DO NOTHING)
- version bump              (portable upsert + read-back; mysql overrides it)
- connection setup          (PRAGMAs vs server settings)
- per-dialect migration overlays (``<ver>_<name>.<dialect>.up.sql`` preferred
  over the generic ``<ver>_<name>.up.sql``)

sqlite uses the standard library's driver; postgres and cockroach use
psycopg or psycopg2 where installed, else the in-tree wire driver
(``pgwire.py``); mysql uses pymysql or MySQLdb, or for ``mysql+fake://``
DSNs the in-tree shim (``mysqlfake.py``).
"""

from __future__ import annotations

import os
from typing import Iterable


class SQLDialect:
    """Neutral base: qmark placeholders, ANSI SQL."""

    name = "ansi"
    paramstyle = "qmark"

    def sql(self, text: str) -> str:
        """Rewrite neutral qmark placeholders for this engine. The store's
        SQL contains no literal '?' outside placeholders."""
        if self.paramstyle == "qmark":
            return text
        return text.replace("?", "%s")

    def connect(self, dsn: str):
        raise NotImplementedError

    def on_connect(self, conn) -> None:
        """Engine-specific session setup (PRAGMAs, search_path, ...)."""

    def insert_ignore(self, table: str, columns: Iterable[str]) -> str:
        cols = list(columns)
        ph = ", ".join("?" * len(cols))
        return (
            f"INSERT INTO {table} ({', '.join(cols)}) VALUES ({ph}) "
            "ON CONFLICT DO NOTHING"
        )

    def bump_version(self, exec_fn, nid: str) -> int:
        """Run the version bump through the store's executor and return
        the new value: ON CONFLICT upsert, then read back in the same
        transaction. Deliberately not ``RETURNING`` — sqlite only grew it
        in 3.35 and deployed runtimes still ship older libraries; the
        read-back sees this transaction's own increment, and the row lock
        the upsert takes serializes concurrent bumpers, so the two forms
        are equivalent. Engines with a different upsert spelling (mysql)
        override this whole hook."""
        exec_fn(
            "INSERT INTO keto_store_version (nid, version) VALUES (?, 1) "
            "ON CONFLICT(nid) DO UPDATE SET version = "
            "keto_store_version.version + 1",
            (nid,),
        )
        row = exec_fn(
            "SELECT version FROM keto_store_version WHERE nid = ?", (nid,)
        ).fetchone()
        return int(row[0])

    def migration_files(self, directory: str) -> dict[str, str]:
        """filename -> path, with <ver>_<name>.<dialect>.{up,down}.sql
        overlays replacing the generic file of the same version/direction."""
        generic: dict[str, str] = {}
        overlay: dict[str, str] = {}
        marker = f".{self.name}."
        for fname in sorted(os.listdir(directory)):
            if not fname.endswith(".sql"):
                continue
            path = os.path.join(directory, fname)
            if marker in fname:
                overlay[fname.replace(marker, ".")] = path
            elif fname.count(".") == 2:  # <ver>_<name>.<up|down>.sql
                generic[fname] = path
        generic.update(overlay)
        return generic


class SQLiteDialect(SQLDialect):
    name = "sqlite"
    paramstyle = "qmark"

    def connect(self, dsn: str):
        import sqlite3

        conn = sqlite3.connect(dsn or ":memory:", check_same_thread=False)
        self.on_connect(conn)
        return conn

    def on_connect(self, conn) -> None:
        conn.execute("PRAGMA journal_mode=WAL")
        conn.execute("PRAGMA foreign_keys=ON")
        # a 64 MiB page cache (sqlite's default is 2 MiB): at a million
        # tuples the unique index's pages no longer fit the default, and
        # every load and full read pays for it; memory only, the
        # durability settings are the reference's
        conn.execute("PRAGMA cache_size=-65536")

    def insert_ignore(self, table: str, columns: Iterable[str]) -> str:
        cols = list(columns)
        ph = ", ".join("?" * len(cols))
        return (
            f"INSERT OR IGNORE INTO {table} "
            f"({', '.join(cols)}) VALUES ({ph})"
        )


class PostgresDialect(SQLDialect):
    """Postgres adapter. Driver resolution order: psycopg (3), psycopg2,
    then the in-tree pure-Python wire driver (`pgwire.py`) — so the
    dialect connects in every environment, including the bare runtime
    image, against any server speaking the v3 protocol (a real postgres,
    CockroachDB, or the CI fake `pgfake.py`).

    DSN form: postgres:// URL.
    """

    name = "postgres"
    paramstyle = "format"

    def connect(self, dsn: str):
        try:
            import psycopg  # psycopg 3

            conn = psycopg.connect(dsn, autocommit=False)
        except ImportError:
            try:
                import psycopg2

                conn = psycopg2.connect(dsn)
            except ImportError:
                from . import pgwire

                conn = pgwire.connect(dsn)
        self.on_connect(conn)
        return conn


class CockroachDialect(PostgresDialect):
    """CockroachDB speaks the postgres wire protocol and (for this store's
    SQL surface) the postgres dialect; what differs is the migration
    overlay set (reference ships *.cockroach.up.sql files — e.g. UNIQUE
    constraints instead of expression indexes) and the DSN scheme
    (reference internal/x/dbx/dsn_testutils.go:54-61)."""

    name = "cockroach"


class MySQLDialect(SQLDialect):
    """MySQL adapter: %s placeholders, INSERT IGNORE, the ON DUPLICATE
    KEY UPDATE spelling of the two-statement version bump, and the
    *.mysql.* migration overlays (reference persister.go:50-51 serves
    mysql through pop the same way).

    Driver resolution: pymysql, MySQLdb; without either, the in-tree
    DB-API translation shim (`mysqlfake.py`) serves DSNs flagged
    ``mysql+fake://`` so CI exercises this dialect's SQL end-to-end.
    """

    name = "mysql"
    paramstyle = "format"

    def insert_ignore(self, table: str, columns: Iterable[str]) -> str:
        cols = list(columns)
        ph = ", ".join("?" * len(cols))
        return (
            f"INSERT IGNORE INTO {table} "
            f"({', '.join(cols)}) VALUES ({ph})"
        )

    def bump_version(self, exec_fn, nid: str) -> int:
        exec_fn(
            "INSERT INTO keto_store_version (nid, version) VALUES (?, 1) "
            "ON DUPLICATE KEY UPDATE version = version + 1",
            (nid,),
        )
        row = exec_fn(
            "SELECT version FROM keto_store_version WHERE nid = ?", (nid,)
        ).fetchone()
        return int(row[0])

    def connect(self, dsn: str):
        if dsn.startswith("mysql+fake://"):
            from . import mysqlfake

            conn = mysqlfake.connect(dsn)
            self.on_connect(conn)
            return conn
        try:
            import pymysql as driver
        except ImportError:
            try:
                import MySQLdb as driver
            except ImportError as e:
                raise RuntimeError(
                    "no mysql driver available (pymysql/MySQLdb not in the "
                    "runtime image); use a mysql+fake:// DSN for CI or "
                    "install a driver"
                ) from e
        from urllib.parse import unquote, urlparse

        u = urlparse(dsn)
        conn = driver.connect(
            host=u.hostname or "127.0.0.1",
            port=u.port or 3306,
            user=unquote(u.username or "root"),
            password=unquote(u.password or ""),
            database=(u.path or "/").lstrip("/"),
        )
        self.on_connect(conn)
        return conn


DIALECTS = {
    d.name: d
    for d in (
        SQLiteDialect(),
        PostgresDialect(),
        CockroachDialect(),
        MySQLDialect(),
    )
}


def dialect_for_dsn(dsn: str) -> tuple[SQLDialect, str]:
    """(dialect, engine-native dsn) from a keto-style DSN. Mirrors the
    reference's scheme dispatch (sqlite://, postgres://, mysql://,
    cockroach://, internal/x/dbx/dsn.go)."""
    if not dsn or dsn == "memory" or dsn.startswith("sqlite://"):
        path = dsn[len("sqlite://") :] if dsn.startswith("sqlite://") else ""
        if path in ("", ":memory:", "/:memory:"):
            path = ":memory:"
        return DIALECTS["sqlite"], path
    if dsn.startswith(("postgres://", "postgresql://")):
        return DIALECTS["postgres"], dsn
    if dsn.startswith("cockroach://"):
        return DIALECTS["cockroach"], "postgres://" + dsn[len("cockroach://"):]
    if dsn.startswith(("mysql://", "mysql+fake://")):
        return DIALECTS["mysql"], dsn
    raise ValueError(f"unsupported DSN scheme: {dsn!r}")
