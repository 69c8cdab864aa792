"""SQLite storage for the LWW apply path: real SQLite, the reference's
`__message` table and add-only app-table DDL. Two backends:
`sqlite.PySqliteDatabase` (the stdlib sqlite3 module) and
`native.CppSqliteDatabase` (the reference's C++ host layer, built at
first use, with the batched apply hot paths); `open_database` picks."""

from evolu_tpu_torch.storage.apply import apply_messages, apply_messages_sequential
from evolu_tpu_torch.storage.native import CppSqliteDatabase, native_available, open_database
from evolu_tpu_torch.storage.schema import init_db_model, update_db_schema
from evolu_tpu_torch.storage.sqlite import PySqliteDatabase

__all__ = [
    "CppSqliteDatabase",
    "PySqliteDatabase",
    "apply_messages",
    "apply_messages_sequential",
    "init_db_model",
    "native_available",
    "open_database",
    "update_db_schema",
]
