"""Shared span arithmetic of the relay's per-layer readers (no metric of
its own: the harness loads only files named after a metric)."""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional


def requests(spans) -> List[dict]:
    """Per request of the window: its `relay.sync` span's duration, the
    `sched.queue` span under it and the `engine.batch` pass that linked it,
    in ms (a part is None where no such span was recorded)."""
    syncs = {s.span_id: s for s in spans if s.name == "relay.sync"}
    queue: Dict[str, float] = {s.parent_id: s.duration_ms for s in spans if s.name == "sched.queue"}
    passes: Dict[str, float] = {}
    for s in spans:
        if s.name == "engine.batch":
            for _trace, span_id in s.links:
                passes[span_id] = s.duration_ms
    return [{"sync": s.duration_ms, "queue": queue.get(i), "pass": passes.get(i)} for i, s in syncs.items()]


def median(values) -> Optional[float]:
    values = [v for v in values if v is not None]
    return float(statistics.median(values)) if values else None
