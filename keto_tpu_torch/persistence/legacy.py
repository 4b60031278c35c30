"""Legacy single-table data migration, v0.6 -> v0.7 layout (counterpart of
``keto_tpu/persistence/legacy.py``; the reference's
migrations/single_table.go).

The reference's v0.6 schema kept one table per namespace
(``keto_<10-digit-id>_relation_tuples`` with string-encoded subjects);
v0.7 moved to the single ``keto_relation_tuples`` table. Over the sqlite
store:

- ``legacy_namespaces()`` discovers per-namespace tables and resolves them
  against the configured namespace manager;
- ``migrate_namespace(ns)`` copies every legacy row into the current store
  (subject strings re-parsed through the tuple grammar); rows whose subject
  fails to parse are skipped and reported through ``ErrInvalidTuples`` after
  the good rows commit;
- ``migrate_down(ns)`` drops the legacy table.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional

from ..namespace.definitions import Namespace
from ..relationtuple.definitions import RelationTuple, subject_from_string
from ..utils.errors import ErrMalformedInput

_TABLE_RE = re.compile(r"^keto_(\d{10})_relation_tuples$")


def legacy_table_name(ns: Namespace) -> str:
    return f"keto_{ns.id:010d}_relation_tuples"


@dataclass
class InvalidLegacyTuple:
    object: str
    relation: str
    subject: str
    error: str


class ErrInvalidTuples(ErrMalformedInput):
    """Some legacy rows could not be deserialized; they were skipped and
    must be recreated manually (reference ErrInvalidTuples,
    single_table.go:52-98)."""

    def __init__(self, invalid: list[InvalidLegacyTuple]):
        self.invalid = invalid
        listing = "; ".join(
            f"{t.object}#{t.relation}@{t.subject!r}: {t.error}"
            for t in invalid[:10]
        )
        more = "" if len(invalid) <= 10 else f" (+{len(invalid) - 10} more)"
        super().__init__(
            f"found {len(invalid)} non-deserializable relation "
            f"tuples: {listing}{more}"
        )


class SingleTableMigrator:
    """Data migration from per-namespace legacy tables into a
    SQLiteTupleStore (the current single-table layout)."""

    def __init__(self, store, namespace_manager=None, page_size: int = 1000):
        self.store = store  # SQLiteTupleStore
        self.namespace_manager = (
            namespace_manager
            if namespace_manager is not None
            else store.namespace_manager
        )
        self.page_size = page_size

    # -- discovery -------------------------------------------------------------

    def legacy_tables(self) -> list[tuple[int, str]]:
        """[(namespace id, table name)] for every legacy table in the DB."""
        rows = self.store._conn.execute(
            "SELECT name FROM sqlite_master WHERE type='table' "
            "AND name LIKE 'keto_%_relation_tuples'"
        ).fetchall()
        out = []
        for (name,) in rows:
            m = _TABLE_RE.match(name)
            if m:
                out.append((int(m.group(1)), name))
        return sorted(out)

    def legacy_namespaces(self) -> list[Namespace]:
        """Legacy tables resolved to configured namespaces (reference
        LegacyNamespaces). Tables whose id is not in the namespace config
        are returned with a synthesized name so the operator can see them;
        migrating one of those fails until the namespace is configured."""
        out = []
        for ns_id, _table in self.legacy_tables():
            ns = self._ns_by_id(ns_id)
            if ns is None:
                ns = Namespace(name=f"<unconfigured:{ns_id}>", id=ns_id)
            out.append(ns)
        return out

    def _ns_by_id(self, ns_id: int) -> Optional[Namespace]:
        if self.namespace_manager is None:
            return None
        for ns in self.namespace_manager.namespaces():
            if ns.id == ns_id:
                return ns
        return None

    # -- migration -------------------------------------------------------------

    def migrate_namespace(self, ns: Namespace) -> tuple[int, list]:
        """Copy all rows of ns's legacy table into the current store.

        Returns (migrated_count, invalid_rows). Raises ErrInvalidTuples
        after committing the good rows when any row failed to parse."""
        if ns.name.startswith("<unconfigured:"):
            raise ErrMalformedInput(
                f"namespace id {ns.id} has a legacy table but no entry in "
                "the namespace config; add it before migrating"
            )
        table = legacy_table_name(ns)
        conn = self.store._conn
        exists = conn.execute(
            "SELECT 1 FROM sqlite_master WHERE type='table' AND name=?",
            (table,),
        ).fetchone()
        if not exists:
            return 0, []
        invalid: list[InvalidLegacyTuple] = []
        migrated = 0
        offset = 0
        while True:
            rows = conn.execute(
                f'SELECT object, relation, subject FROM "{table}" '
                "ORDER BY object, relation, subject LIMIT ? OFFSET ?",
                (self.page_size, offset),
            ).fetchall()
            if not rows:
                break
            offset += len(rows)
            batch = []
            for obj, rel, sub in rows:
                try:
                    subject = subject_from_string(sub)
                    batch.append(
                        RelationTuple(
                            namespace=ns.name,
                            object=obj,
                            relation=rel,
                            subject=subject,
                        )
                    )
                except Exception as e:
                    # skip + surface at the end (single_table.go:205-209)
                    invalid.append(
                        InvalidLegacyTuple(
                            object=obj, relation=rel, subject=sub,
                            error=str(e),
                        )
                    )
            if batch:
                self.store.write_relation_tuples(*batch)
                migrated += len(batch)
        if invalid:
            raise ErrInvalidTuples(invalid)
        return migrated, invalid

    def migrate_down(self, ns: Namespace) -> None:
        """Drop the namespace's legacy table (reference MigrateDown — the
        down-migration deletes the legacy data)."""
        table = legacy_table_name(ns)
        with self.store._lock:
            self.store._conn.execute(f'DROP TABLE IF EXISTS "{table}"')
            self.store._conn.commit()

    def create_legacy_table(self, ns: Namespace) -> None:
        """Create an empty v0.6-layout table (test fixtures + the
        down-only path)."""
        table = legacy_table_name(ns)
        with self.store._lock:
            self.store._conn.execute(
                f'CREATE TABLE IF NOT EXISTS "{table}" ('
                "  shard_id TEXT NOT NULL,"
                "  object TEXT NOT NULL,"
                "  relation TEXT NOT NULL,"
                "  subject TEXT NOT NULL,"
                "  commit_time TIMESTAMP NOT NULL"
                ")"
            )
            self.store._conn.commit()
