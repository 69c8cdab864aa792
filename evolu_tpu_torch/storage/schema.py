"""The `__message` log table and add-only app-table evolution.

App columns get BLOB affinity on purpose — no storage-class coercion —
which is what makes end states comparable byte for byte. Only the LWW
part of the reference schema is here: no owner, mnemonic, clock or
typed-CRDT tables.
"""

from __future__ import annotations

from typing import Iterable, Set

from evolu_tpu_torch.core.types import TableDefinition
from evolu_tpu_torch.storage.sqlite import PySqliteDatabase, quote_ident


def init_db_model(db: PySqliteDatabase) -> None:
    """Idempotent bootstrap of `__message` and its covering index."""
    if db.exec_sql_query("PRAGMA table_info (__message)"):
        return
    with db.transaction():
        db.exec(
            'CREATE TABLE __message ('
            '"timestamp" BLOB PRIMARY KEY, "table" BLOB, "row" BLOB, '
            '"column" BLOB, "value" BLOB)'
        )
        db.exec(
            'CREATE INDEX index__message ON __message '
            '("table", "row", "column", "timestamp")'
        )


def get_existing_tables(db: PySqliteDatabase) -> Set[str]:
    """Non-system app tables."""
    rows = db.exec_sql_query("SELECT \"name\" FROM sqlite_schema WHERE type='table'")
    return {r["name"] for r in rows if not r["name"].startswith("__")}


def update_db_schema(db: PySqliteDatabase, table_definitions: Iterable[TableDefinition]) -> None:
    """Add-only migration: CREATE missing tables (id TEXT PRIMARY KEY +
    BLOB columns) or ALTER ... ADD COLUMN. Plain LWW columns only."""
    existing = get_existing_tables(db)
    for td in table_definitions:
        if td.name in existing:
            have = {r["name"] for r in db.exec_sql_query(
                f"PRAGMA table_info ({quote_ident(td.name)})")}
            for col in td.columns:
                if col not in have:
                    db.run(f"ALTER TABLE {quote_ident(td.name)} ADD COLUMN {quote_ident(col)} BLOB")
        else:
            cols = ", ".join(f"{quote_ident(c)} BLOB" for c in td.columns)
            db.exec(f'CREATE TABLE {quote_ident(td.name)} ("id" TEXT PRIMARY KEY, {cols})')
