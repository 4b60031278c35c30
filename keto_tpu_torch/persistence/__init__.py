"""SQL persistence backends (counterpart of ``keto_tpu/persistence``).

The reference persists to sqlite, MySQL, Postgres or CockroachDB with
embedded migrations. The port keeps the same split: a dialect-neutral store
(``sqlstore.py``) over four dialects (``dialect.py``), the sqlite binding on
the standard library's driver, the postgres binding with an in-tree wire
driver (``pgwire.py``), the in-tree fakes the tests run the other engines
through (``pgfake.py``, ``mysqlfake.py``), the migrator with a copy of the
reference's migration files, and the legacy single-table migrator.

The snapshot layer is persistence-agnostic: any store with the Manager
contract and the version/delta feed sits under it.
"""

from .dialect import (
    DIALECTS,
    CockroachDialect,
    MySQLDialect,
    PostgresDialect,
    SQLDialect,
    SQLiteDialect,
    dialect_for_dsn,
)
from .migrator import MigrationStatus, Migrator
from .postgres import PostgresTupleStore
from .sqlite import SQLiteTupleStore
from .sqlstore import SQLTupleStore

__all__ = [
    "DIALECTS",
    "CockroachDialect",
    "Migrator",
    "MigrationStatus",
    "MySQLDialect",
    "PostgresDialect",
    "PostgresTupleStore",
    "SQLDialect",
    "SQLTupleStore",
    "SQLiteDialect",
    "SQLiteTupleStore",
    "dialect_for_dsn",
]
