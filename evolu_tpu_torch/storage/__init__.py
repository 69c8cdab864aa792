"""SQLite storage for the LWW apply path: real SQLite, the reference's
`__message` table and add-only app-table DDL. Two backends:
`sqlite.PySqliteDatabase` (the stdlib sqlite3 module) and
`native.CppSqliteDatabase` (the reference's C++ host layer, built at
first use, with the batched apply hot paths); `open_database` picks."""

from evolu_tpu_torch.storage.apply import apply_messages, apply_messages_sequential
from evolu_tpu_torch.storage.clock import read_clock, update_clock
from evolu_tpu_torch.storage.native import CppSqliteDatabase, native_available, open_database
from evolu_tpu_torch.storage.schema import (
    delete_all_tables,
    get_existing_tables,
    init_db_model,
    update_db_schema,
)
from evolu_tpu_torch.storage.sqlite import PySqliteDatabase

__all__ = [
    "CppSqliteDatabase",
    "PySqliteDatabase",
    "apply_messages",
    "apply_messages_sequential",
    "delete_all_tables",
    "get_existing_tables",
    "init_db_model",
    "native_available",
    "open_database",
    "read_clock",
    "update_clock",
    "update_db_schema",
]
