"""Flight recorder: a bounded structured-event ring for post-mortems.

The port's copy of `evolu_tpu.obs.flight`. A fault used to surface as a
bare traceback; this ring keeps the last N structured events (reusing
`utils.log.LogEvent`) from EVERY target — independent of the logger's
console gating — and `attach` hangs the dump off any exception crossing
the worker/relay boundary, so an OnError arrives with the runtime's
recent history instead of just a stack.

Fed from two directions:
- `utils.log.Logger` mirrors every `log()`/`span()` event here even
  when the target's console output is disabled (the recorder exists
  precisely for events nobody was watching);
- hot paths may `record()` directly for events that are not log lines.

Host-side only (no torch, no jax — same constraint as obs.metrics); every write
is one deque append under a lock.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, List, Optional

from evolu_tpu_torch.utils.log import LogEvent


class FlightRecorder:
    def __init__(self, capacity: int = 256):
        self._lock = threading.Lock()
        self._ring: Deque[LogEvent] = deque(maxlen=capacity)
        self.enabled = True

    def record(self, target: str, message: str = "", *,
               duration_ms: Optional[float] = None, **fields) -> None:
        if not self.enabled:
            return
        ev = LogEvent(target=target, message=message, t=time.time(),
                      duration_ms=duration_ms, fields=fields)
        with self._lock:
            self._ring.append(ev)

    def record_event(self, ev: LogEvent) -> None:
        """Append an already-built LogEvent (the Logger mirror path)."""
        if not self.enabled:
            return
        with self._lock:
            self._ring.append(ev)

    def dump(self) -> List[LogEvent]:
        with self._lock:
            return list(self._ring)

    def format_dump(self, limit: Optional[int] = None) -> str:
        evs = self.dump()
        if limit is not None:
            evs = evs[-limit:]
        lines = []
        for e in evs:
            dur = f" {e.duration_ms:.3f}ms" if e.duration_ms is not None else ""
            extra = (
                " " + " ".join(f"{k}={v}" for k, v in e.fields.items())
            ) if e.fields else ""
            lines.append(f"{e.t:.3f} [{e.target}] {e.message}{dur}{extra}")
        return "\n".join(lines)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def attach(self, exc: BaseException, limit: int = 64) -> BaseException:
        """Attach the dump to an exception about to cross a boundary:
        `exc.flight_records` gets the event list (idempotent — a nested
        boundary keeps the innermost, most complete dump) and, where
        supported, an `add_note` makes the tail visible in the printed
        traceback. Must never raise — this runs inside error paths."""
        try:
            if getattr(exc, "flight_records", None) is not None:
                return exc
            exc.flight_records = self.dump()
            if exc.flight_records and hasattr(exc, "add_note"):
                tail = self.format_dump(limit=limit)
                exc.add_note(
                    f"flight recorder (last {min(limit, len(exc.flight_records))} "
                    f"of {len(exc.flight_records)} events):\n{tail}"
                )
        except Exception:  # noqa: BLE001,S110 - never mask the original error
            pass
        return exc


# Module-level default, like utils.log.logger.
recorder = FlightRecorder()

record = recorder.record
dump = recorder.dump
attach = recorder.attach
clear = recorder.clear
