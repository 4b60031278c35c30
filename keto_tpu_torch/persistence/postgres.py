"""Postgres tuple store (counterpart of ``keto_tpu/persistence/postgres.py``):
the dialect-neutral SQL store bound to the postgres dialect, which connects
through psycopg or psycopg2 where installed and through the in-tree wire
driver (``pgwire.py``) otherwise, and migrates with the postgres overlays
(``migrations/sql/*.postgres.*.sql``).
"""

from __future__ import annotations

from typing import Optional

from ..namespace.definitions import NamespaceManager
from .dialect import PostgresDialect
from .sqlstore import SQLTupleStore


class PostgresTupleStore(SQLTupleStore):
    def __init__(
        self,
        dsn: str,
        namespace_manager: Optional[NamespaceManager] = None,
        network_id: Optional[str] = None,
        auto_migrate: bool = True,
    ):
        super().__init__(
            PostgresDialect(),
            dsn,
            namespace_manager=namespace_manager,
            network_id=network_id,
            auto_migrate=auto_migrate,
        )
