"""Sync mutual exclusion — the Web Locks `"evolu_sync"` analog.

Reference: packages/evolu/src/syncLock.ts. In the browser, one lock
per origin makes sync mutually exclusive across tabs; here the analog
is a per-database lock shared by every client in the process plus an
optional OS-level file lock (fcntl) for cross-process exclusion when
the database lives on disk.

`is_pending_or_held` mirrors `syncIsPendingOrHeld` (syncLock.ts:21-29):
the DbWorker uses it to skip redundant sync rounds (receive.ts:186-193,
sync.ts:33-40).
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from typing import Dict, Optional

try:
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX
    fcntl = None

_registry_guard = threading.Lock()
_registry: Dict[str, "SyncLock"] = {}


class SyncLock:
    """One sync at a time per database, with pending-detection."""

    def __init__(self, db_path: str = ":memory:"):
        self._lock = threading.Lock()
        self._pending = 0
        self._guard = threading.Lock()
        self._file: Optional[int] = None
        if fcntl is not None and db_path not in ("", ":memory:"):
            try:
                self._file = os.open(db_path + ".synclock", os.O_CREAT | os.O_RDWR, 0o644)
            except OSError:
                self._file = None

    @contextmanager
    def hold(self):
        """Run a sync round exclusively (syncLock.ts:8-12)."""
        with self._guard:
            self._pending += 1
        self._lock.acquire()
        if self._file is not None:
            fcntl.flock(self._file, fcntl.LOCK_EX)
        try:
            yield
        finally:
            if self._file is not None:
                fcntl.flock(self._file, fcntl.LOCK_UN)
            self._lock.release()
            with self._guard:
                self._pending -= 1

    def is_pending_or_held(self) -> bool:
        """syncLock.ts:21-29 — True if a sync is running or queued."""
        with self._guard:
            if self._pending > 0:
                return True
        if self._lock.locked():
            return True
        if self._file is not None:
            try:
                fcntl.flock(self._file, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                return True
            fcntl.flock(self._file, fcntl.LOCK_UN)
        return False


def get_sync_lock(db_path: str) -> SyncLock:
    """Process-wide lock registry keyed by db path (one lock per "origin")."""
    with _registry_guard:
        lock = _registry.get(db_path)
        if lock is None or db_path == ":memory:":
            lock = SyncLock(db_path)
            _registry[db_path] = lock
        return lock
