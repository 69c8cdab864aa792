"""SQLite storage for the LWW apply path: real SQLite (stdlib sqlite3),
the reference's `__message` table and add-only app-table DDL."""

from evolu_tpu_torch.storage.apply import apply_messages, apply_messages_sequential
from evolu_tpu_torch.storage.schema import init_db_model, update_db_schema
from evolu_tpu_torch.storage.sqlite import PySqliteDatabase

__all__ = [
    "PySqliteDatabase",
    "apply_messages",
    "apply_messages_sequential",
    "init_db_model",
    "update_db_schema",
]
