"""RGA sequence CRDT, the `"col:list"` column type.

- **insert op** `["i", origin, value]` places a new element after the
  element `origin` (an element's identity is its insert op's own
  timestamp); `origin == ""` inserts at the head.
- **delete op** `["d", tag]` tombstones element `tag`. A dead element
  keeps its position, so inserts anchored on it still land; a delete
  that arrives before its insert is tombstoned in `__crdt_list_kill`.

The one ordering rule: replay the distinct inserts in ascending
raw-string timestamp order, each placed right after its origin (head
for ""). Siblings on one origin end up in descending timestamp order.
An origin that is not delivered or not smaller than the op's own tag
roots the element at the head group, so materialization is a function
of the delivered op set alone.

`linearize` / `fold_cell` are the host oracle; `_materialize_device`
batches every touched cell into one `ops.crdt_list_merge.rga_order`
dispatch when the element count reaches `DEVICE_FOLD_MIN` and fits the
packed-key bounds.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from evolu_tpu_torch.core.types import CrdtMessage
from evolu_tpu_torch.obs import metrics

ROOT_ORIGIN = ""

# An origin/target tag is a timestamp string (46 chars canonical);
# anything longer is hostile framing and drops at the codec.
_MAX_TAG_LEN = 256

# The device linearization packs (cell, parent, rank) into one int64
# key; larger batches stay on the host oracle.
DEVICE_MAX_ELEMS = (1 << 20) - 2
DEVICE_MAX_CELLS = (1 << 22) - 2

LIST_STATE_TABLES_SQL = (
    # One row per insert op; alive=0 marks a tombstoned element (the row
    # stays: it anchors positions).
    'CREATE TABLE IF NOT EXISTS "__crdt_list" ('
    '"tag" BLOB PRIMARY KEY, "table" BLOB, "row" BLOB, "column" BLOB, '
    '"origin" BLOB, "value" BLOB, "alive" INTEGER NOT NULL)',
    'CREATE INDEX IF NOT EXISTS "index__crdt_list_cell" ON "__crdt_list" '
    '("table", "row", "column")',
    # Delete tombstones for elements not (yet) inserted.
    'CREATE TABLE IF NOT EXISTS "__crdt_list_kill" ("tag" BLOB PRIMARY KEY)',
)

Cell = Tuple[str, str, str]


# --- op codecs (ValueError only) ---


def _check_tag(tag, what: str) -> str:
    if not isinstance(tag, str):
        raise ValueError(f"list op {what} must be a timestamp string: {tag!r}")
    if len(tag) > _MAX_TAG_LEN:
        raise ValueError(f"list op {what} exceeds {_MAX_TAG_LEN} chars")
    return tag


def list_insert_value(value, after: Optional[str] = None) -> str:
    """Encode an insert op value; `after` is the origin element's tag
    (None or "" = head)."""
    from evolu_tpu_torch.core.crdt_types import elem_key

    origin = _check_tag(after if after is not None else ROOT_ORIGIN, "origin")
    return json.dumps(["i", origin, json.loads(elem_key(value))], separators=(",", ":"))


def list_delete_value(tag: str) -> str:
    """Encode a delete op tombstoning element `tag`."""
    return json.dumps(["d", _check_tag(tag, "target")], separators=(",", ":"))


def decode_list_op(value) -> Tuple[str, str, str]:
    """Decode a list op value → ("i", origin, elem_json) or
    ("d", target, "")."""
    from evolu_tpu_torch.core.crdt_types import elem_key

    if not isinstance(value, str):
        raise ValueError(f"list op value must be a JSON string: {value!r}")
    try:
        op = json.loads(value)
    except json.JSONDecodeError as e:
        raise ValueError(f"malformed list op JSON: {e}") from e
    if not isinstance(op, list) or not op or op[0] not in ("i", "d"):
        raise ValueError(f"malformed list op shape: {value!r}")
    if op[0] == "i":
        if len(op) != 3:
            raise ValueError(f"insert op must be ['i', origin, value]: {value!r}")
        return "i", _check_tag(op[1], "origin"), elem_key(op[2])
    if len(op) != 2:
        raise ValueError(f"delete op must be ['d', tag]: {value!r}")
    return "d", _check_tag(op[1], "target"), ""


def decode_list_batch(
    msgs: Sequence[CrdtMessage],
) -> Tuple[List[Tuple[CrdtMessage, str, str]], List[Tuple[CrdtMessage, str]], int]:
    """→ (inserts [(msg, origin, elem_json)], deletes [(msg, target)],
    malformed_count). Malformed ops drop here."""
    inserts: List[Tuple[CrdtMessage, str, str]] = []
    deletes: List[Tuple[CrdtMessage, str]] = []
    bad = 0
    for m in msgs:
        try:
            kind, a, b = decode_list_op(m.value)
        except ValueError:
            bad += 1
            continue
        if kind == "i":
            inserts.append((m, a, b))
        else:
            deletes.append((m, a))
    return inserts, deletes, bad


# --- the host-oracle linearization ---


def linearize(tags: Sequence[str], origins: Sequence[str]) -> List[int]:
    """Document position (0-based, tombstones included) per element of
    one cell; `tags` distinct, input order irrelevant. Builds the
    sibling tree (parent = origin iff delivered and smaller than the
    tag, else the head group), then a DFS with children in descending
    tag order."""
    n = len(tags)
    order = sorted(range(n), key=lambda i: tags[i])
    present = set(tags)
    if len(present) != n:
        raise ValueError("duplicate element tags in linearize input")
    children: Dict[str, List[int]] = {}
    for i in order:
        o = origins[i]
        parent = o if (o != ROOT_ORIGIN and o in present and o < tags[i]) else ROOT_ORIGIN
        children.setdefault(parent, []).append(i)  # ascending append
    pos = [0] * n
    stack = list(children.get(ROOT_ORIGIN, ()))  # pop() → highest tag first
    c = 0
    while stack:
        i = stack.pop()
        pos[i] = c
        c += 1
        stack.extend(children.get(tags[i], ()))
    return pos


def materialize_list_value(values_in_doc_order: Iterable[str]) -> str:
    """JSON array over alive element values in document order."""
    return "[" + ",".join(values_in_doc_order) + "]"


def fold_cell(elems: Sequence[Tuple[str, str, str, bool]]) -> Tuple[List[int], str]:
    """Per-cell fold: [(tag, origin, elem_json, alive)] → (positions,
    materialized value)."""
    pos = linearize([e[0] for e in elems], [e[1] for e in elems])
    by_pos = sorted(range(len(elems)), key=lambda i: pos[i])
    return pos, materialize_list_value(elems[i][2] for i in by_pos if elems[i][3])


def replay_log(msgs: Sequence[CrdtMessage]) -> Dict[Cell, str]:
    """Host-oracle replay of a full op log (any order, duplicates fine)
    → {cell: materialized value}."""
    seen: Set[str] = set()
    per_cell: Dict[Cell, List[Tuple[CrdtMessage, str, str]]] = {}
    kills: Set[str] = set()
    for m in msgs:
        if m.timestamp in seen:
            continue
        seen.add(m.timestamp)
        try:
            kind, a, b = decode_list_op(m.value)
        except ValueError:
            continue
        if kind == "d":
            kills.add(a)
            per_cell.setdefault((m.table, m.row, m.column), [])
        else:
            per_cell.setdefault((m.table, m.row, m.column), []).append((m, a, b))
    out: Dict[Cell, str] = {}
    for cell, inserts in per_cell.items():
        elems = [(m.timestamp, origin, val, m.timestamp not in kills) for m, origin, val in inserts]
        out[cell] = fold_cell(elems)[1] if elems else "[]"
    return out


# --- SQL state fold (runs inside the caller's apply transaction) ---


def apply_list_ops(db, new_msgs: Sequence[CrdtMessage]) -> Set[Cell]:
    """Fold new list ops (already screened against `__message`) into
    `__crdt_list` / `__crdt_list_kill`. Returns touched cells."""
    from evolu_tpu_torch.core.crdt_types import LIST as _LT, _chunked_in, alive_add_flags

    inserts, deletes, bad = decode_list_batch(new_msgs)
    if bad:
        metrics.inc("evolu_crdt_malformed_ops_total", bad, type=_LT)
    if not inserts and not deletes:
        return set()
    metrics.inc("evolu_crdt_ops_total", len(inserts) + len(deletes), type=_LT)
    if inserts:
        metrics.inc("evolu_crdt_list_ops_total", len(inserts), kind="insert")
    if deletes:
        metrics.inc("evolu_crdt_list_ops_total", len(deletes), kind="delete")
    kills: Set[str] = {t for _m, t in deletes}
    insert_tags = [m.timestamp for m, _o, _v in inserts]
    state_killed: Set[str] = set()
    if insert_tags:
        state_killed = {
            r["tag"]
            for r in _chunked_in(db, 'SELECT "tag" FROM "__crdt_list_kill" WHERE "tag" IN ({})',
                                 insert_tags)
        }
    alive = alive_add_flags(insert_tags, kills, state_killed)

    touched: Set[Cell] = set()
    if kills:
        # Tombstone first, then kill matching existing alive elements
        # (their rows stay as position anchors; only `alive` flips).
        db.run_many('INSERT OR IGNORE INTO "__crdt_list_kill" ("tag") VALUES (?)',
                    [(t,) for t in sorted(kills)])
        killed_rows = _chunked_in(
            db,
            'SELECT "tag", "table", "row", "column" FROM "__crdt_list" '
            'WHERE "alive" = 1 AND "tag" IN ({})',
            sorted(kills),
        )
        if killed_rows:
            db.run_many('UPDATE "__crdt_list" SET "alive" = 0 WHERE "tag" = ?',
                        [(r["tag"],) for r in killed_rows])
            touched.update((r["table"], r["row"], r["column"]) for r in killed_rows)
    if inserts:
        db.run_many(
            'INSERT OR IGNORE INTO "__crdt_list" '
            '("tag", "table", "row", "column", "origin", "value", "alive") '
            "VALUES (?, ?, ?, ?, ?, ?, ?)",
            [(m.timestamp, m.table, m.row, m.column, origin, val, int(a))
             for (m, origin, val), a in zip(inserts, alive)],
        )
        touched.update((m.table, m.row, m.column) for m, _o, _v in inserts)
    # Every valid op touches its cell (a delete on an empty cell still
    # materializes it as "[]").
    touched.update((m.table, m.row, m.column) for m, _t in deletes)
    return touched


def _cell_rows(db, table: str, column: str, rows: Sequence[str]) -> Dict[str, list]:
    """All stored elements (alive and dead) of the touched cells, per row."""
    out: Dict[str, list] = {}
    for i in range(0, len(rows), 500):
        part = rows[i : i + 500]
        q = ('SELECT "row", "tag", "origin", "value", "alive" FROM "__crdt_list" '
             'WHERE "table" = ? AND "column" = ? AND "row" IN ({})').format(",".join("?" * len(part)))
        for r in db.exec_sql_query(q, (table, column, *part)):
            out.setdefault(r["row"], []).append((r["tag"], r["origin"], r["value"], bool(r["alive"])))
    return out


def materialize_list_values(db, table: str, column: str, rows: Sequence[str],
                            device=None) -> Dict[str, str]:
    """→ {row: JSON array} for the touched cells of one (table, column):
    on the device when the combined element count reaches
    `DEVICE_FOLD_MIN` and fits the packed-key bounds, else the host
    oracle."""
    from evolu_tpu_torch.core.crdt_types import DEVICE_FOLD_MIN

    per_row = _cell_rows(db, table, column, rows)
    total = sum(len(v) for v in per_row.values())
    oversized = total > DEVICE_MAX_ELEMS or len(per_row) > DEVICE_MAX_CELLS
    use_device = DEVICE_FOLD_MIN <= total and not oversized
    if oversized:
        metrics.inc("evolu_crdt_list_oversized_host_routes_total")
    metrics.inc("evolu_crdt_list_linearize_total", path="device" if use_device else "host")
    metrics.inc("evolu_crdt_list_linearized_elements_total", total)
    if use_device:
        return _materialize_device(per_row, device)
    return {row: fold_cell(elems)[1] for row, elems in per_row.items()}


def _materialize_device(per_row: Dict[str, list], device=None) -> Dict[str, str]:
    """Every touched cell in one `rga_order` dispatch; alive values are
    placed by the kernel's alive-slot output."""
    import numpy as np

    from evolu_tpu_torch.ops.crdt_list_merge import rga_order

    cell_id: List[int] = []
    parent_ix: List[int] = []
    alive: List[int] = []
    vals: List[str] = []
    spans: List[Tuple[str, int, int]] = []  # (row, start, count)
    orphans = 0
    for ci, row in enumerate(sorted(per_row)):
        elems = sorted(per_row[row])  # ascending tag: the rank order
        base = len(cell_id)
        ix = {tag: j for j, (tag, _o, _v, _a) in enumerate(elems)}
        for tag, origin, val, a in elems:
            ok = origin != ROOT_ORIGIN and origin in ix and origin < tag
            if not ok and origin != ROOT_ORIGIN:
                orphans += 1
            cell_id.append(ci)
            parent_ix.append(base + ix[origin] if ok else -1)
            alive.append(int(a))
            vals.append(val)
        spans.append((row, base, len(elems)))
    if orphans:
        metrics.inc("evolu_crdt_list_orphan_inserts_total", orphans)
    pos, slot = rga_order(np.asarray(cell_id, np.int32), np.asarray(parent_ix, np.int32),
                          np.asarray(alive, np.int32), device=device)
    out: Dict[str, str] = {}
    for row, base, count in spans:
        parts: List[str] = [""] * sum(alive[base : base + count])
        for j in range(base, base + count):
            if alive[j]:
                parts[int(slot[j])] = vals[j]
        out[row] = materialize_list_value(parts)
    return out


# --- reads for the client API ---


def list_state(db, table: str, row: str, column: str) -> List[Tuple[str, str]]:
    """Alive (tag, elem_json) pairs of one cell in document order."""
    rows = db.exec_sql_query(
        'SELECT "tag", "origin", "value", "alive" FROM "__crdt_list" '
        'WHERE "table" = ? AND "row" = ? AND "column" = ?',
        (table, row, column),
    )
    if not rows:
        return []
    elems = [(r["tag"], r["origin"], r["value"], bool(r["alive"])) for r in rows]
    pos = linearize([e[0] for e in elems], [e[1] for e in elems])
    by_pos = sorted(range(len(elems)), key=lambda i: pos[i])
    return [(elems[i][0], elems[i][2]) for i in by_pos if elems[i][3]]
