"""System tables and add-only app-table evolution.

`init_db_model` bootstraps the `__message` log and its covering index,
the `__clock` row (initial timestamp, empty Merkle tree) and the
`__owner` row (the mnemonic identity).

App columns get BLOB affinity on purpose — no storage-class coercion —
which is what makes end states comparable byte for byte. A column may
carry a CRDT type suffix (`"votes:counter"`, `"tags:awset"`,
`"body:list"`, `"w:tensor:sum:f32:8"`), which is stripped for the DDL
and declared in `__crdt_schema` (`core/crdt_types.py`).
"""

from __future__ import annotations

from typing import Iterable, Optional, Set

from evolu_tpu_torch.core.ids import mnemonic_to_owner_id
from evolu_tpu_torch.core.merkle import create_initial_merkle_tree, merkle_tree_to_string
from evolu_tpu_torch.core.mnemonic import generate_mnemonic
from evolu_tpu_torch.core.timestamp import create_initial_timestamp, timestamp_to_string
from evolu_tpu_torch.core.types import Owner, TableDefinition
from evolu_tpu_torch.storage.sqlite import PySqliteDatabase, quote_ident


def init_db_model(db: PySqliteDatabase, mnemonic: Optional[str] = None) -> Owner:
    """Idempotent bootstrap: `__message` and its covering index, `__clock`
    seeded with the initial timestamp and the empty tree, `__owner`
    seeded with the (possibly generated) mnemonic identity."""
    if not db.exec_sql_query("PRAGMA table_info (__message)"):
        if mnemonic is None:
            mnemonic = generate_mnemonic()
        timestamp = timestamp_to_string(create_initial_timestamp())
        merkle = merkle_tree_to_string(create_initial_merkle_tree())
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
            db.exec('CREATE TABLE __clock ("timestamp" BLOB, "merkleTree" BLOB)')
            db.run('INSERT INTO __clock ("timestamp", "merkleTree") VALUES (?, ?)',
                   (timestamp, merkle))
            db.exec('CREATE TABLE __owner ("id" BLOB, "mnemonic" BLOB)')
            db.run('INSERT INTO __owner ("id", "mnemonic") VALUES (?, ?)',
                   (mnemonic_to_owner_id(mnemonic), mnemonic))
    row = db.exec_sql_query('SELECT "id", "mnemonic" FROM __owner LIMIT 1')[0]
    return Owner(id=row["id"], mnemonic=row["mnemonic"])


def get_existing_tables(db: PySqliteDatabase) -> Set[str]:
    """Non-system app tables."""
    rows = db.exec_sql_query("SELECT \"name\" FROM sqlite_schema WHERE type='table'")
    return {r["name"] for r in rows if not r["name"].startswith("__")}


def update_db_schema(db: PySqliteDatabase, table_definitions: Iterable[TableDefinition],
                     device=None) -> None:
    """Add-only migration: CREATE missing tables (id TEXT PRIMARY KEY +
    BLOB columns) or ALTER ... ADD COLUMN, then declare the typed
    columns (`device` serves the fold of ops logged before a
    declaration)."""
    from evolu_tpu_torch.core.crdt_types import declare_column_types, parse_column_spec

    existing = get_existing_tables(db)
    declarations = []
    for td in table_definitions:
        parsed = [parse_column_spec(c) for c in td.columns]
        declarations.extend((td.name, name, ctype) for name, ctype in parsed if ctype != "lww")
        names = [name for name, _ in parsed]
        if td.name in existing:
            have = {r["name"] for r in db.exec_sql_query(
                f"PRAGMA table_info ({quote_ident(td.name)})")}
            for col in names:
                if col not in have:
                    db.run(f"ALTER TABLE {quote_ident(td.name)} ADD COLUMN {quote_ident(col)} BLOB")
        else:
            cols = ", ".join(f"{quote_ident(c)} BLOB" for c in names)
            db.exec(f'CREATE TABLE {quote_ident(td.name)} ("id" TEXT PRIMARY KEY, {cols})')
    if declarations:
        declare_column_types(db, declarations, device)


def delete_all_tables(db: PySqliteDatabase) -> None:
    """DROP every table, the `__crdt_*` ones included, and drop the
    connection's typed-schema cache with them."""
    from evolu_tpu_torch.core.crdt_types import invalidate_schema_cache

    rows = db.exec_sql_query("SELECT \"name\" FROM sqlite_schema WHERE type='table'")
    for r in rows:
        db.exec(f"DROP TABLE {quote_ident(r['name'])}")
    invalidate_schema_cache(db)
