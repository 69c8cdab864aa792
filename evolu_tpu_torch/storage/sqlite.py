"""SQLite `Database` over the stdlib sqlite3 module — real SQLite, which
is what makes the end state comparable byte for byte. One writer,
transaction-at-a-time, like the reference's dbTransaction."""

from __future__ import annotations

import sqlite3
import threading
from contextlib import contextmanager
from typing import Iterable, List, Sequence, Tuple

from evolu_tpu_torch.core.types import UnknownError


def quote_ident(name: str) -> str:
    """SQL identifier quoting with embedded quotes doubled."""
    return '"' + str(name).replace('"', '""') + '"'


class PySqliteDatabase:
    """Single-writer SQLite handle; all access is serialized through an RLock."""

    def __init__(self, path: str = ":memory:"):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.isolation_level = None  # explicit BEGIN/COMMIT
        self._lock = threading.RLock()
        self.path = path
        self._begin_sql = "BEGIN"

    def exec(self, sql: str) -> List[Tuple]:
        """Execute a single statement; returns its rows (if any)."""
        with self._lock:
            try:
                return self._conn.execute(sql).fetchall()
            except sqlite3.Error as e:
                raise UnknownError(e) from e

    def exec_script(self, sql: str) -> None:
        """Execute a multi-statement script (DDL bootstrap); returns no
        rows. Refused inside an open transaction: sqlite3's executescript
        would COMMIT it first."""
        with self._lock:
            if self._conn.in_transaction:
                raise UnknownError("exec_script inside an open transaction")
            try:
                self._conn.executescript(sql)
            except sqlite3.Error as e:
                raise UnknownError(e) from e

    def exec_sql_query(self, sql: str, parameters: Sequence = ()) -> List[dict]:
        """Parameterized query; rows as column->value dicts."""
        with self._lock:
            try:
                cur = self._conn.execute(sql, tuple(parameters))
                cols = [d[0] for d in cur.description] if cur.description else []
                return [dict(zip(cols, row)) for row in cur.fetchall()]
            except sqlite3.Error as e:
                raise UnknownError(e) from e

    def run(self, sql: str, parameters: Sequence = ()) -> int:
        """Execute a write; returns rowcount."""
        with self._lock:
            try:
                return self._conn.execute(sql, tuple(parameters)).rowcount
            except sqlite3.Error as e:
                raise UnknownError(e) from e

    def run_many(self, sql: str, rows: Iterable[Sequence]) -> int:
        with self._lock:
            try:
                return self._conn.executemany(sql, rows).rowcount
            except sqlite3.Error as e:
                raise UnknownError(e) from e

    def changes(self) -> int:
        """Rows changed since the connection opened (SQLite's total_changes)."""
        with self._lock:
            return self._conn.total_changes

    @contextmanager
    def transaction(self):
        """BEGIN/COMMIT/ROLLBACK; nested use joins the outer transaction."""
        with self._lock:
            if self._conn.in_transaction:
                yield self
                return
            self._conn.execute(self._begin_sql)
            try:
                yield self
            except BaseException:
                self._conn.execute("ROLLBACK")
                raise
            else:
                self._conn.execute("COMMIT")

    def set_begin_immediate(self) -> None:
        """Writers sharing the database FILE with other processes must
        take the write lock at BEGIN: a deferred transaction that
        upgrades to write after a concurrent commit gets SQLITE_BUSY
        immediately — busy_timeout does not apply to that upgrade."""
        self._begin_sql = "BEGIN IMMEDIATE"

    def close(self) -> None:
        with self._lock:
            self._conn.close()


def configure_shared_file_db(db) -> None:
    """Make a FILE-BACKED database safe for concurrent writers across
    processes. busy_timeout first, so the WAL switch (a write) waits out
    a concurrent writer; WAL + synchronous=NORMAL; BEGIN IMMEDIATE. No-op
    for :memory: databases — nothing shares those."""
    if getattr(db, "path", None) in (None, ":memory:"):
        return
    for pragma in ("busy_timeout=5000", "journal_mode=WAL",
                   "synchronous=NORMAL"):
        db.exec_sql_query(f"PRAGMA {pragma}", ())
    db.set_begin_immediate()
