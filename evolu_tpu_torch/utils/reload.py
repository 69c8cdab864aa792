"""Cross-process reload signal (reference: src/reloadAllTabs.ts).

The reference coordinates same-device browser tabs with a localStorage
write + storage event: resetOwner/restoreOwner in one tab makes every
other tab reload (reloadAllTabs.ts:6-14, db.ts:183-186). The analog
here is processes sharing one database file: a nonce file next to the
DB is bumped by the signalling process; watchers poll its mtime+nonce
and fire their callback, after which the embedder is expected to
reopen its Evolu handle (the "reload").

In-process listeners still use `Evolu.on_reload`; this adds the
cross-process leg. Polling is cheap (one stat per interval) and has no
platform dependencies — the durability story does not rest on it, it
is purely a UX signal, exactly like the reference's.
"""

from __future__ import annotations

import os
import threading
import uuid
from typing import Callable, Optional


def _signal_path(db_path: str) -> str:
    return db_path + ".reload"


def notify_reload(db_path: str) -> Optional[str]:
    """Bump the signal file (the localStorage setItem analog).

    Returns the written nonce so the originating process can tell its
    own watcher to ignore it (a browser tab never receives the storage
    event for its own setItem)."""
    if db_path == ":memory:":
        return None
    path = _signal_path(db_path)
    nonce = uuid.uuid4().hex
    tmp = f"{path}.{uuid.uuid4().hex}"
    with open(tmp, "w") as f:
        f.write(nonce)
    os.replace(tmp, path)  # atomic on POSIX
    return nonce


class ReloadWatcher:
    """Polls the signal file; fires `callback` on each bump."""

    def __init__(self, db_path: str, callback: Callable[[], None], interval: float = 0.5):
        self._path = _signal_path(db_path)
        self._callback = callback
        self._interval = interval
        self._stop = threading.Event()
        self._own_lock = threading.Lock()
        self._own: set = set()  # self-originated nonces to skip
        self._last = self._read()
        self._thread: Optional[threading.Thread] = None
        if db_path != ":memory:":
            self._thread = threading.Thread(target=self._loop, daemon=True, name="evolu-reload")
            self._thread.start()

    def _read(self) -> Optional[str]:
        try:
            with open(self._path) as f:
                return f.read()
        except OSError:
            return None

    def ignore(self, nonce: Optional[str]) -> None:
        """Mark a nonce as self-originated: observing it updates state
        without firing the callback (no storage event for your own
        setItem)."""
        if nonce is not None:
            with self._own_lock:
                self._own.add(nonce)

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            cur = self._read()
            if cur is not None and cur != self._last:
                self._last = cur
                with self._own_lock:
                    own = cur in self._own
                    self._own.discard(cur)
                if not own:
                    self._callback()

    def stop(self) -> None:
        self._stop.set()
        # Callbacks run on the watcher thread; a callback that tears the
        # client down (dispose -> stop) must not self-join.
        if self._thread is not None and self._thread is not threading.current_thread():
            self._thread.join()
