"""CRDT column types beyond the LWW register: the typed-apply leg.

Ops are ordinary `CrdtMessage`s whose timestamps feed the unchanged
Merkle machinery; only the app-table materialization differs.

- **PN-counter** (`"counter"`): each op's value is a signed int32
  delta; the cell value is Σ deltas over the distinct op set, kept as
  (pos, neg) partial sums in `__crdt_counter`.
- **Add-wins set** (`"awset"`, observed-remove): an add op carries
  `["a", elem]` and is tagged by its own timestamp; a remove carries
  `["r", elem, [observed add tags...]]` and kills exactly those adds.
  alive(tag) = added(tag) ∧ tag ∉ kills, in any arrival order (kills
  are tombstoned in `__crdt_kill`).
- **RGA list** (`"list"`, `core/crdt_list.py`) and the **tensor
  family** (`"tensor:<monoid>:<dtype>:<shape>"`, `core/crdt_tensor.py`)
  fold through the same dispatch, `_fold_by_type`.

Typed cells never take the LWW app-table upsert (`storage.apply`
strips them through `ops.merge.strip_typed_upserts`); new ops fold
into the `__crdt_*` state tables inside the apply transaction, and the
touched cells' merged values are materialized into the app table.
Op decoding raises ValueError only; the fold layer drops malformed ops.

Batches of at least `DEVICE_FOLD_MIN` ops fold on the device
(`ops/crdt_merge.py`, `ops/crdt_list_merge.py`,
`ops/crdt_tensor_merge.py`). Every fold takes `device=None`, which
means CUDA and is resolved only when a fold takes the device route:
without a card such a fold raises unless the caller passes
`device="cpu"`, which runs the kernels' plain versions. The typed plane
counts into the `evolu_crdt_*` families as the reference does: ops and
malformed ops by type, folds by route, materialized cells, and
pre-declaration folds.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from evolu_tpu_torch.core.types import CrdtMessage
from evolu_tpu_torch.obs import metrics

LWW = "lww"
COUNTER = "counter"
AWSET = "awset"
LIST = "list"
COLUMN_TYPES = (LWW, COUNTER, AWSET, LIST)

# Counter deltas are bounded to int32 so 2^31 ops never overflow the
# int64 pos/neg accumulators.
_DELTA_MIN, _DELTA_MAX = -(2**31) + 1, 2**31 - 1

# Batches of at least this many new typed ops fold on the device.
DEVICE_FOLD_MIN = 4096

Cell = Tuple[str, str, str]

_SCHEMA_TABLE_SQL = (
    'CREATE TABLE IF NOT EXISTS "__crdt_schema" ('
    '"table" BLOB, "column" BLOB, "type" BLOB, '
    'PRIMARY KEY ("table", "column"))'
)
_STATE_TABLES_SQL = (
    'CREATE TABLE IF NOT EXISTS "__crdt_counter" ('
    '"table" BLOB, "row" BLOB, "column" BLOB, '
    '"pos" INTEGER NOT NULL, "neg" INTEGER NOT NULL, '
    'PRIMARY KEY ("table", "row", "column"))',
    # One row per add op; "tag" is the add's op timestamp, "elem" the
    # canonical JSON element key; alive=0 marks an observed-removed add.
    'CREATE TABLE IF NOT EXISTS "__crdt_set" ('
    '"tag" BLOB PRIMARY KEY, "table" BLOB, "row" BLOB, "column" BLOB, '
    '"elem" BLOB, "alive" INTEGER NOT NULL)',
    'CREATE INDEX IF NOT EXISTS "index__crdt_set_cell" ON "__crdt_set" '
    '("table", "row", "column", "alive")',
    # Kill tombstones: a remove may arrive before the add it observed.
    'CREATE TABLE IF NOT EXISTS "__crdt_kill" ("tag" BLOB PRIMARY KEY)',
)


# --- column specs & schema registry ---


def parse_column_spec(spec: str) -> Tuple[str, str]:
    """`"votes:counter"` → ("votes", "counter"); a bare name is LWW.
    Unknown type suffixes raise ValueError."""
    if ":" not in spec:
        return spec, LWW
    name, _, ctype = spec.partition(":")
    if not name:
        raise ValueError(f"empty column name in spec {spec!r}")
    if ctype.startswith("tensor"):
        # The full "tensor:monoid:dtype:shape" string is the column type.
        from evolu_tpu_torch.core.crdt_tensor import parse_tensor_type

        parse_tensor_type(ctype)
        return name, ctype
    if ctype not in COLUMN_TYPES:
        raise ValueError(f"unknown CRDT column type {ctype!r} in {spec!r}")
    return name, ctype


class CrdtSchema:
    """Per-database column-type registry. Empty means pure LWW."""

    __slots__ = ("types",)

    def __init__(self, types: Optional[Dict[Tuple[str, str], str]] = None):
        self.types: Dict[Tuple[str, str], str] = dict(types or {})

    def column_type(self, table: str, column: str) -> str:
        return self.types.get((table, column), LWW)

    def is_typed(self, table: str, column: str) -> bool:
        return (table, column) in self.types

    def has_typed(self, cells: Iterable[Cell]) -> bool:
        if not self.types:
            return False
        return any((t, c) in self.types for t, _r, c in cells)

    def __bool__(self) -> bool:
        return bool(self.types)


def ensure_schema_table(db) -> None:
    db.exec(_SCHEMA_TABLE_SQL)


def ensure_state_tables(db) -> None:
    from evolu_tpu_torch.core.crdt_list import LIST_STATE_TABLES_SQL
    from evolu_tpu_torch.core.crdt_tensor import TENSOR_STATE_TABLES_SQL

    for sql in _STATE_TABLES_SQL + LIST_STATE_TABLES_SQL + TENSOR_STATE_TABLES_SQL:
        db.exec(sql)


def declare_column_types(db, declarations: Iterable[Tuple[str, str, str]], device=None) -> None:
    """Persist (table, column, type) declarations (add-only, idempotent;
    re-declaring a column with a different type raises). Ops already in
    `__message` for a newly declared column fold now."""
    decls = [(t, c, ct) for t, c, ct in declarations if ct != LWW]
    if not decls:
        return
    ensure_schema_table(db)
    ensure_state_tables(db)
    existing = {
        (r["table"], r["column"]): r["type"]
        for r in db.exec_sql_query('SELECT "table", "column", "type" FROM "__crdt_schema"')
    }
    for t, c, ct in decls:
        have = existing.get((t, c))
        if have is not None and have != ct:
            raise ValueError(f"column {t}.{c} already declared {have!r}, cannot become {ct!r}")
    new_decls = [d for d in decls if (d[0], d[1]) not in existing]
    db.run_many(
        'INSERT OR IGNORE INTO "__crdt_schema" ("table", "column", "type") VALUES (?, ?, ?)',
        decls,
    )
    invalidate_schema_cache(db)
    if new_decls:
        _fold_predeclaration_ops(db, new_decls, device)


def _fold_predeclaration_ops(db, decls: Sequence[Tuple[str, str, str]], device=None) -> None:
    """Fold the full log of newly declared columns: ops that reached
    `__message` before the declaration were applied as LWW and would
    otherwise never fold, so materialization would depend on when the
    column was declared. State for a new column is empty, so this is
    exact."""
    schema = CrdtSchema({(t, c): ct for t, c, ct in decls})
    msgs: List[CrdtMessage] = []
    for t, c, _ct in decls:
        try:
            rows = db.exec_sql_query(
                'SELECT "timestamp", "table", "row", "column", "value" '
                'FROM "__message" WHERE "table" = ? AND "column" = ? '
                'ORDER BY "timestamp"',
                (t, c),
            )
        except Exception as e:  # noqa: BLE001
            if _is_missing_table(e):  # declared before init_db_model: no log yet
                return
            raise
        msgs.extend(
            CrdtMessage(r["timestamp"], r["table"], r["row"], r["column"], r["value"])
            for r in rows
        )
    if not msgs:
        return
    metrics.inc("evolu_crdt_predeclaration_folds_total", len(msgs))
    touched = _fold_by_type(db, partition_typed(schema, msgs), device)
    if touched:
        materialize_cells(db, schema, touched, device)


def invalidate_schema_cache(db) -> None:
    try:
        db._crdt_schema_cache = None
    except AttributeError:  # a backend with __slots__: reload per apply
        pass


def _is_missing_table(e: BaseException) -> bool:
    return "no such table" in str(e)


def load_schema(db) -> CrdtSchema:
    """The per-connection schema cache, valid until
    `declare_column_types` or `delete_all_tables` invalidates it. A
    missing `__crdt_schema` table means a pure-LWW database; any other
    load error re-raises (an empty schema cached by mistake would route
    typed cells through LWW forever)."""
    cached = getattr(db, "_crdt_schema_cache", None)
    if cached is not None:
        return cached
    try:
        rows = db.exec_sql_query('SELECT "table", "column", "type" FROM "__crdt_schema"')
        types = {(r["table"], r["column"]): r["type"] for r in rows}
    except Exception as e:  # noqa: BLE001
        if not _is_missing_table(e):
            raise
        types = {}
    schema = CrdtSchema(types)
    try:
        db._crdt_schema_cache = schema
    except AttributeError:
        pass
    return schema


# --- op codecs (ValueError only) ---


def counter_delta(value) -> int:
    """Decode a counter op value → signed int delta."""
    if isinstance(value, bool) or not isinstance(value, int):
        raise ValueError(f"counter op value must be an int delta: {value!r}")
    if not _DELTA_MIN <= value <= _DELTA_MAX:
        raise ValueError(f"counter delta exceeds int32: {value!r}")
    return value


def elem_key(elem) -> str:
    """Canonical JSON encoding of a set element: the one encoding used
    for kill matching, state storage and materialization order."""
    if isinstance(elem, bool) or not isinstance(elem, (str, int)):
        raise ValueError(f"set element must be str or int: {elem!r}")
    return json.dumps(elem, separators=(",", ":"))


def set_add_value(elem) -> str:
    """Encode an add op value. The op's own timestamp becomes its tag."""
    return f'["a",{elem_key(elem)}]'


def set_remove_value(elem, observed: Iterable[str]) -> str:
    """Encode a remove op value killing the `observed` add tags."""
    tags = sorted(set(observed))
    for t in tags:
        if not isinstance(t, str):
            raise ValueError(f"observed tag must be a timestamp string: {t!r}")
    return json.dumps(["r", json.loads(elem_key(elem)), tags], separators=(",", ":"))


def decode_set_op(value) -> Tuple[str, str, Tuple[str, ...]]:
    """Decode a set op value → (kind, elem_key, kill_tags)."""
    if not isinstance(value, str):
        raise ValueError(f"set op value must be a JSON string: {value!r}")
    try:
        op = json.loads(value)
    except json.JSONDecodeError as e:
        raise ValueError(f"malformed set op JSON: {e}") from e
    if not isinstance(op, list) or not op or op[0] not in ("a", "r"):
        raise ValueError(f"malformed set op shape: {value!r}")
    if op[0] == "a":
        if len(op) != 2:
            raise ValueError(f"add op must be ['a', elem]: {value!r}")
        return "a", elem_key(op[1]), ()
    if len(op) != 3 or not isinstance(op[2], list):
        raise ValueError(f"remove op must be ['r', elem, [tags]]: {value!r}")
    tags = []
    for t in op[2]:
        if not isinstance(t, str):
            raise ValueError(f"remove op tag must be a string: {t!r}")
        tags.append(t)
    return "r", elem_key(op[1]), tuple(tags)


def materialize_set_value(alive_elem_keys: Iterable[str]) -> str:
    """Canonical sorted JSON array over distinct alive element keys."""
    return "[" + ",".join(sorted(set(alive_elem_keys))) + "]"


# --- host-oracle folds ---


def fold_counter_ops(deltas: Iterable[int]) -> Tuple[int, int]:
    """Σ over a batch → (pos, neg) non-negative partial sums."""
    pos = neg = 0
    for d in deltas:
        if d > 0:
            pos += d
        else:
            neg -= d
    return pos, neg


def decode_counter_batch(msgs: Sequence[CrdtMessage]) -> Tuple[List[Tuple[CrdtMessage, int]], int]:
    """→ ([(msg, delta)], malformed_count); malformed ops are dropped."""
    out, bad = [], 0
    for m in msgs:
        try:
            out.append((m, counter_delta(m.value)))
        except ValueError:
            bad += 1
    return out, bad


def decode_set_batch(
    msgs: Sequence[CrdtMessage],
) -> Tuple[List[Tuple[CrdtMessage, str]], List[Tuple[CrdtMessage, Tuple[str, ...]]], int]:
    """→ (adds [(msg, elem_key)], removes [(msg, kill_tags)],
    malformed_count). Malformed ops drop here, so whether a cell
    materializes depends on the valid op set only."""
    adds: List[Tuple[CrdtMessage, str]] = []
    removes: List[Tuple[CrdtMessage, Tuple[str, ...]]] = []
    bad = 0
    for m in msgs:
        try:
            kind, ek, tags = decode_set_op(m.value)
        except ValueError:
            bad += 1
            continue
        if kind == "a":
            adds.append((m, ek))
        else:
            removes.append((m, tags))
    return adds, removes, bad


def alive_add_flags(add_tags: Sequence[str], kills: Set[str], state_killed: Set[str]) -> List[bool]:
    """An add survives iff its tag is in neither the batch kills nor the
    tombstoned state kills."""
    return [t not in kills and t not in state_killed for t in add_tags]


# --- SQL state integration (runs inside the caller's transaction) ---


def _chunked_in(db, sql_prefix: str, keys: Sequence, chunk: int = 500) -> List[dict]:
    rows: List[dict] = []
    for i in range(0, len(keys), chunk):
        part = keys[i : i + chunk]
        placeholders = ",".join("?" * len(part))
        rows.extend(db.exec_sql_query(sql_prefix.format(placeholders), tuple(part)))
    return rows


def screen_new_ops(db, msgs: Sequence[CrdtMessage]) -> List[CrdtMessage]:
    """Ops whose timestamps are not yet in `__message`, first occurrence
    per timestamp (INSERT OR NOTHING keeps the first): the dedup gate
    that makes the state fold redelivery-safe."""
    seen: Set[str] = set()
    candidates: List[CrdtMessage] = []
    for m in msgs:
        if m.timestamp not in seen:
            seen.add(m.timestamp)
            candidates.append(m)
    if not candidates:
        return []
    existing = {
        r["timestamp"]
        for r in _chunked_in(
            db, 'SELECT "timestamp" FROM "__message" WHERE "timestamp" IN ({})',
            [m.timestamp for m in candidates],
        )
    }
    return [m for m in candidates if m.timestamp not in existing]


def partition_typed(schema: CrdtSchema, msgs: Sequence[CrdtMessage]) -> Dict[str, List[CrdtMessage]]:
    """{column type: [typed messages]} for a batch, order preserved."""
    out: Dict[str, List[CrdtMessage]] = {}
    for m in msgs:
        ct = schema.column_type(m.table, m.column)
        if ct != LWW:
            out.setdefault(ct, []).append(m)
    return out


def _fold_counters_device(pairs: Sequence[Tuple[CrdtMessage, int]], device=None):
    """Per-cell (pos, neg) through kernel S (`pn_counter_sums`)."""
    import numpy as np

    from evolu_tpu_torch.ops.crdt_merge import pn_counter_sums
    from evolu_tpu_torch.ops.host_parse import intern_cells

    msgs = [m for m, _ in pairs]
    cell_id, cells = intern_cells([m.table for m in msgs], [m.row for m in msgs],
                                  [m.column for m in msgs])
    deltas = np.fromiter((d for _, d in pairs), np.int64, len(pairs))
    pos, neg = pn_counter_sums(cell_id, deltas, len(cells), device=device)
    return {cells[i]: (int(pos[i]), int(neg[i])) for i in range(len(cells))}


def _fold_counters_host(pairs: Sequence[Tuple[CrdtMessage, int]]):
    per_cell: Dict[Cell, List[int]] = {}
    for m, d in pairs:
        per_cell.setdefault((m.table, m.row, m.column), []).append(d)
    return {cell: fold_counter_ops(ds) for cell, ds in per_cell.items()}


def apply_counter_ops(db, new_msgs: Sequence[CrdtMessage], device=None) -> Set[Cell]:
    """Fold new counter ops into `__crdt_counter`. Returns touched cells."""
    pairs, bad = decode_counter_batch(new_msgs)
    if bad:
        metrics.inc("evolu_crdt_malformed_ops_total", bad, type=COUNTER)
    if not pairs:
        return set()
    metrics.inc("evolu_crdt_ops_total", len(pairs), type=COUNTER)
    if len(pairs) >= DEVICE_FOLD_MIN:
        metrics.inc("evolu_crdt_plan_total", type=COUNTER, path="device")
        sums = _fold_counters_device(pairs, device)
    else:
        metrics.inc("evolu_crdt_plan_total", type=COUNTER, path="host")
        sums = _fold_counters_host(pairs)
    db.run_many(
        'INSERT INTO "__crdt_counter" ("table", "row", "column", "pos", "neg") '
        "VALUES (?, ?, ?, ?, ?) "
        'ON CONFLICT ("table", "row", "column") DO UPDATE SET '
        '"pos" = "pos" + excluded."pos", "neg" = "neg" + excluded."neg"',
        [(t, r, c, p, n) for (t, r, c), (p, n) in sums.items()],
    )
    return set(sums)


def apply_set_ops(db, new_msgs: Sequence[CrdtMessage], device=None) -> Set[Cell]:
    """Fold new set ops into `__crdt_set` / `__crdt_kill`. Returns
    touched cells (adds and removes: a remove changes the value too)."""
    adds, removes, bad = decode_set_batch(new_msgs)
    if bad:
        metrics.inc("evolu_crdt_malformed_ops_total", bad, type=AWSET)
    if not adds and not removes:
        return set()
    metrics.inc("evolu_crdt_ops_total", len(adds) + len(removes), type=AWSET)
    kills: Set[str] = set()
    for _m, tags in removes:
        kills.update(tags)

    # Tombstoned kills relevant to this batch's adds (a kill from an
    # earlier batch must still kill this add on arrival).
    add_tags = [m.timestamp for m, _ in adds]
    state_killed: Set[str] = set()
    if add_tags:
        state_killed = {
            r["tag"]
            for r in _chunked_in(db, 'SELECT "tag" FROM "__crdt_kill" WHERE "tag" IN ({})', add_tags)
        }
    if len(adds) + len(kills) >= DEVICE_FOLD_MIN:
        from evolu_tpu_torch.ops.crdt_merge import awset_alive_flags

        metrics.inc("evolu_crdt_plan_total", type=AWSET, path="device")
        alive = awset_alive_flags(add_tags, kills, state_killed, device=device)
    else:
        metrics.inc("evolu_crdt_plan_total", type=AWSET, path="host")
        alive = alive_add_flags(add_tags, kills, state_killed)

    touched: Set[Cell] = set()
    if kills:
        # Tombstone first, then kill matching existing alive adds.
        db.run_many('INSERT OR IGNORE INTO "__crdt_kill" ("tag") VALUES (?)',
                    [(t,) for t in sorted(kills)])
        killed_rows = _chunked_in(
            db,
            'SELECT "tag", "table", "row", "column" FROM "__crdt_set" '
            'WHERE "alive" = 1 AND "tag" IN ({})',
            sorted(kills),
        )
        if killed_rows:
            db.run_many('UPDATE "__crdt_set" SET "alive" = 0 WHERE "tag" = ?',
                        [(r["tag"],) for r in killed_rows])
            touched.update((r["table"], r["row"], r["column"]) for r in killed_rows)
    if adds:
        db.run_many(
            'INSERT OR IGNORE INTO "__crdt_set" '
            '("tag", "table", "row", "column", "elem", "alive") VALUES (?, ?, ?, ?, ?, ?)',
            [(m.timestamp, m.table, m.row, m.column, ek, int(a)) for (m, ek), a in zip(adds, alive)],
        )
        touched.update((m.table, m.row, m.column) for m, _ in adds)
    # Every valid op touches its cell: a remove on a cell with no stored
    # adds still materializes it (as "[]").
    touched.update((m.table, m.row, m.column) for m, _ in removes)
    return touched


def materialize_cells(db, schema: CrdtSchema, cells: Iterable[Cell], device=None) -> None:
    """Upsert the merged value of each touched typed cell into its app
    row: counter = pos − neg, set = canonical sorted JSON, list and
    tensor through their modules. Batched per (table, column)."""
    from evolu_tpu_torch.storage.apply import _upsert_sql

    groups: Dict[Tuple[str, str], Set[str]] = {}
    for table, row, column in cells:
        groups.setdefault((table, column), set()).add(row)
    for (table, column), row_set in sorted(groups.items()):
        ct = schema.column_type(table, column)
        rows = sorted(row_set)
        values: Dict[str, object] = {}
        if ct == COUNTER:
            default: object = 0
            for i in range(0, len(rows), 500):
                part = rows[i : i + 500]
                q = ('SELECT "row", "pos", "neg" FROM "__crdt_counter" '
                     'WHERE "table" = ? AND "column" = ? AND "row" IN ({})').format(",".join("?" * len(part)))
                for r in db.exec_sql_query(q, (table, column, *part)):
                    values[r["row"]] = r["pos"] - r["neg"]
        elif ct == AWSET:
            default = materialize_set_value(())
            elems: Dict[str, Set[str]] = {}
            for i in range(0, len(rows), 500):
                part = rows[i : i + 500]
                q = ('SELECT "row", "elem" FROM "__crdt_set" '
                     'WHERE "table" = ? AND "column" = ? AND "alive" = 1 '
                     'AND "row" IN ({})').format(",".join("?" * len(part)))
                for r in db.exec_sql_query(q, (table, column, *part)):
                    elems.setdefault(r["row"], set()).add(r["elem"])
            values = {row: materialize_set_value(e) for row, e in elems.items()}
        elif ct == LIST:
            from evolu_tpu_torch.core.crdt_list import materialize_list_values

            default = "[]"
            values = materialize_list_values(db, table, column, rows, device)
        else:
            from evolu_tpu_torch.core.crdt_tensor import (
                is_tensor_type, materialize_tensor_values, parse_tensor_type, zeros_value,
            )

            if not is_tensor_type(ct):  # pragma: no cover - never routed here
                continue
            default = zeros_value(parse_tensor_type(ct))
            values = materialize_tensor_values(db, ct, table, column, rows, device)
        db.run_many(
            _upsert_sql(table, column),
            [(row, values.get(row, default), values.get(row, default)) for row in rows],
        )
        metrics.inc("evolu_crdt_materialized_cells_total", len(rows), type=ct)


def _fold_by_type(db, by_type: Dict[str, List[CrdtMessage]], device=None) -> Set[Cell]:
    """The one per-type fold dispatch (incremental apply, pre-declaration
    fold and full rebuild all route through it)."""
    touched: Set[Cell] = set()
    touched |= apply_counter_ops(db, by_type.get(COUNTER, ()), device)
    touched |= apply_set_ops(db, by_type.get(AWSET, ()), device)
    list_msgs = by_type.get(LIST)
    if list_msgs:
        from evolu_tpu_torch.core.crdt_list import apply_list_ops

        touched |= apply_list_ops(db, list_msgs)
    for ct, tensor_msgs in by_type.items():
        # One bucket per full tensor type string (it carries the config).
        if tensor_msgs and ct.startswith("tensor:"):
            from evolu_tpu_torch.core.crdt_tensor import apply_tensor_ops

            touched |= apply_tensor_ops(db, ct, tensor_msgs)
    return touched


def apply_typed_ops(db, schema: CrdtSchema, typed_msgs: Sequence[CrdtMessage], device=None) -> None:
    """The whole typed apply leg: dedup against `__message`, fold per
    type, materialize touched cells. Must run inside the apply
    transaction before the batch's `__message` insert (the dedup screen
    reads pre-batch state)."""
    new_ops = screen_new_ops(db, typed_msgs)
    touched = _fold_by_type(db, partition_typed(schema, new_ops), device)
    if touched:
        materialize_cells(db, schema, touched, device)


def observed_tags(db, table: str, row: str, column: str, elem) -> List[str]:
    """Alive add tags for (cell, elem): what a remove op must observe."""
    rows = db.exec_sql_query(
        'SELECT "tag" FROM "__crdt_set" WHERE "table" = ? AND "row" = ? '
        'AND "column" = ? AND "elem" = ? AND "alive" = 1 ORDER BY "tag"',
        (table, row, column, elem_key(elem)),
    )
    return [r["tag"] for r in rows]


def rebuild_state(db, schema: CrdtSchema, device=None) -> None:
    """Recompute `__crdt_*` state and every typed app value from the full
    `__message` log (the fold is order-free, so one pass is exact)."""
    if not schema:
        return
    ensure_state_tables(db)
    for t in ("__crdt_counter", "__crdt_set", "__crdt_kill",
              "__crdt_list", "__crdt_list_kill", "__crdt_tensor"):
        db.run(f'DELETE FROM "{t}"')
    rows = db.exec_sql_query(
        'SELECT "timestamp", "table", "row", "column", "value" FROM "__message" ORDER BY "timestamp"'
    )
    msgs = [
        CrdtMessage(r["timestamp"], r["table"], r["row"], r["column"], r["value"])
        for r in rows
        if schema.is_typed(r["table"], r["column"])
    ]
    touched = _fold_by_type(db, partition_typed(schema, msgs), device)
    if touched:
        materialize_cells(db, schema, touched, device)
