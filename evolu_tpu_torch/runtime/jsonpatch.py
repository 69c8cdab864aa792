"""Row-array JSON patches for reactive queries.

The reference diffs each subscribed query's fresh rows against a cache
with rfc6902 `createPatch` (query.ts:43-57) and applies patches on the
main thread with `immutableJSONPatch` (db.ts:96-115) so unchanged row
objects keep their identity (React referential equality). This module
is the Python equivalent: `create_patch` emits row-granular RFC-6902
ops, `apply_patch` builds the next rows list reusing unchanged row
objects from the previous one.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence


def create_patch(prev: Sequence[Dict[str, Any]], next_: Sequence[Dict[str, Any]]) -> List[dict]:
    """RFC-6902 ops transforming `prev` into `next_` (row granularity).

    Empty list ⇔ no change — the worker posts only non-empty patches
    (query.ts:59-66).
    """
    ops: List[dict] = []
    common = min(len(prev), len(next_))
    for i in range(common):
        # Identity first: the row-granular unpack reuses unchanged row
        # dicts, so most rows shortcut without a key-by-key compare.
        if prev[i] is not next_[i] and prev[i] != next_[i]:
            ops.append({"op": "replace", "path": f"/{i}", "value": next_[i]})
    # Removals are emitted back-to-front so paths stay valid while applying.
    for i in range(len(prev) - 1, common - 1, -1):
        ops.append({"op": "remove", "path": f"/{i}"})
    for i in range(common, len(next_)):
        ops.append({"op": "add", "path": f"/{i}", "value": next_[i]})
    return ops


def apply_patch(prev: Sequence[Dict[str, Any]], ops: Sequence[dict]) -> List[Dict[str, Any]]:
    """Apply `create_patch`-shaped ops, reusing unchanged row objects.

    Like immutableJSONPatch (db.ts:103-113): returns a new list; rows
    not named by any op are the same objects as in `prev`.
    """
    rows: List[Dict[str, Any]] = list(prev)
    for op in ops:
        if op["path"] == "":
            # Root replace: the worker had no cached baseline for this
            # query (first run, or its cache entry was LRU-evicted), so
            # it emits the whole result — correct against ANY client
            # state, unlike index ops diffed from an empty baseline.
            if op["op"] != "replace":  # pragma: no cover - never emitted
                raise ValueError(f"unsupported root op: {op['op']}")
            rows = list(op["value"])
            continue
        idx = int(op["path"].lstrip("/"))
        kind = op["op"]
        if kind == "replace":
            rows[idx] = op["value"]
        elif kind == "remove":
            del rows[idx]
        elif kind == "add":
            rows.insert(idx, op["value"])
        else:  # pragma: no cover - create_patch never emits others
            raise ValueError(f"unsupported op: {kind}")
    return rows
