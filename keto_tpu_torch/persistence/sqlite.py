"""SQLite tuple store (counterpart of ``keto_tpu/persistence/sqlite.py``):
the dialect-neutral SQL store bound to the standard library's driver. All
persister logic lives in ``persistence.sqlstore.SQLTupleStore``; this
binding only picks the dialect.
"""

from __future__ import annotations

from typing import Optional

from ..namespace.definitions import NamespaceManager
from .dialect import SQLiteDialect
from .sqlstore import SQLTupleStore


class SQLiteTupleStore(SQLTupleStore):
    def __init__(
        self,
        path: str,
        namespace_manager: Optional[NamespaceManager] = None,
        network_id: Optional[str] = None,
        auto_migrate: bool = True,
    ):
        self.path = path or ":memory:"
        super().__init__(
            SQLiteDialect(),
            self.path,
            namespace_manager=namespace_manager,
            network_id=network_id,
            auto_migrate=auto_migrate,
        )
