"""Message application — the merge hot path.

`apply_messages_sequential` reproduces the reference's per-message loop
exactly and is the correctness oracle:

1. winner lookup: latest __message timestamp for the (table, row,
   column) cell;
2. if absent or older than the message ⇒ upsert the app table;
3. if the winner differs from the message timestamp ⇒ INSERT OR NOTHING
   into __message and XOR the timestamp hash into the Merkle tree. The
   XOR is NOT gated on the insert inserting: a re-received non-winning
   duplicate XORs again (client semantics).

`apply_messages` is the batched path with the same end state: one
winner query for all touched cells, masks from a planner (the host
`plan_batch`, or `ops.merge.plan_batch_device_full` on the card), then
bulk SQL, all in one transaction.

Typed CRDT cells (counter, awset, list, tensor) ride the same
transaction: `crdt_types.apply_typed_ops` folds their new ops into the
`__crdt_*` state and materializes the app values before the batch's
`__message` insert, and `ops.merge.strip_typed_upserts` removes their
LWW upserts from the plan. `device` (None = CUDA) is where the typed
folds run once a batch reaches `crdt_types.DEVICE_FOLD_MIN`; LWW-only
batches never read it.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from evolu_tpu_torch.core.crdt_types import apply_typed_ops, load_schema
from evolu_tpu_torch.core.merkle import apply_prefix_xors, insert_into_merkle_tree, minute_deltas_host
from evolu_tpu_torch.core.timestamp import timestamp_from_string
from evolu_tpu_torch.core.types import CrdtMessage
from evolu_tpu_torch.storage.sqlite import PySqliteDatabase, quote_ident

_SELECT_WINNER = (
    'SELECT "timestamp" FROM "__message" '
    'WHERE "table" = ? AND "row" = ? AND "column" = ? '
    'ORDER BY "timestamp" DESC LIMIT 1'
)
_INSERT_MESSAGE = (
    'INSERT INTO "__message" ("timestamp", "table", "row", "column", "value") '
    "VALUES (?, ?, ?, ?, ?) ON CONFLICT DO NOTHING"
)


def _upsert_sql(table: str, column: str) -> str:
    """Identifiers from the wire are quote-doubled, never spliced raw."""
    t, c = quote_ident(table), quote_ident(column)
    return f"INSERT INTO {t} (\"id\", {c}) VALUES (?, ?) ON CONFLICT(\"id\") DO UPDATE SET {c} = ?"


def _typed_messages(db, messages):
    schema = load_schema(db)
    return schema, ([m for m in messages if schema.is_typed(m.table, m.column)] if schema else [])


def apply_messages_sequential(
    db: PySqliteDatabase, merkle_tree: dict, messages: Sequence[CrdtMessage], device=None
) -> dict:
    """The reference loop, message by message (O(n) SQL round trips).
    Typed ops fold and materialize first, before the loop inserts any
    `__message` row (the dedup screen reads pre-batch state)."""
    schema, typed = _typed_messages(db, messages)
    if typed:
        apply_typed_ops(db, schema, typed, device)
    for m in messages:
        rows = db.exec_sql_query(_SELECT_WINNER, (m.table, m.row, m.column))
        t = rows[0]["timestamp"] if rows else None
        if (t is None or t < m.timestamp) and not (typed and schema.is_typed(m.table, m.column)):
            db.run(_upsert_sql(m.table, m.column), (m.row, m.value, m.value))
        if t is None or t != m.timestamp:
            db.run(_INSERT_MESSAGE, (m.timestamp, m.table, m.row, m.column, m.value))
            merkle_tree = insert_into_merkle_tree(timestamp_from_string(m.timestamp), merkle_tree)
    return merkle_tree


def fetch_existing_winners(
    db: PySqliteDatabase, cells: Iterable[Tuple[str, str, str]]
) -> Dict[Tuple[str, str, str], str]:
    """Current winner timestamp per cell, one indexed query per batch via
    a temp-table join on the (table, row, column, timestamp) index."""
    cells = list(cells)
    if not cells:
        return {}
    with db.transaction():
        db.exec('CREATE TEMP TABLE IF NOT EXISTS "__cells" ("t" BLOB, "r" BLOB, "c" BLOB)')
        db.run('DELETE FROM "__cells"')
        db.run_many('INSERT INTO "__cells" VALUES (?, ?, ?)', cells)
        rows = db.exec_sql_query(
            'SELECT m."table" AS t, m."row" AS r, m."column" AS c, '
            'MAX(m."timestamp") AS w FROM "__message" m '
            'JOIN "__cells" x ON m."table" = x."t" AND m."row" = x."r" AND m."column" = x."c" '
            'GROUP BY m."table", m."row", m."column"'
        )
        db.run('DELETE FROM "__cells"')
    return {(r["t"], r["r"], r["c"]): r["w"] for r in rows}


def plan_batch(
    messages: Sequence[CrdtMessage],
    existing_winners: Dict[Tuple[str, str, str], str],
):
    """Merge decisions for a batch on the host (pure, no SQL): →
    (xor_mask, upserts), with the sequential running-max semantics."""
    xor_mask: List[bool] = [False] * len(messages)
    running: Dict[Tuple[str, str, str], Optional[str]] = {}
    final: Dict[Tuple[str, str, str], CrdtMessage] = {}
    for i, m in enumerate(messages):
        cell = (m.table, m.row, m.column)
        w = running.get(cell, existing_winners.get(cell))
        xor_mask[i] = w is None or w != m.timestamp
        if w is None or w < m.timestamp:
            running[cell] = m.timestamp
            final[cell] = m
        else:
            running[cell] = w
    upserts = [
        m for cell, m in final.items()
        if existing_winners.get(cell) is None or existing_winners[cell] < m.timestamp
    ]
    return xor_mask, upserts


def apply_messages(
    db: PySqliteDatabase,
    merkle_tree: dict,
    messages: Sequence[CrdtMessage],
    planner=None,
    device=None,
) -> dict:
    """Batched apply, end state identical to the sequential oracle.

    `planner(messages, existing_winners)` defaults to the host
    `plan_batch` (→ 2-tuple; the Merkle deltas are then folded on the
    host); a device planner returns (xor_mask, upserts, deltas)."""
    if not len(messages):
        return merkle_tree
    planner = planner or plan_batch
    with db.transaction():  # whole-batch atomicity
        existing = fetch_existing_winners(db, {(m.table, m.row, m.column) for m in messages})
        plan = planner(messages, existing)
        schema, typed = _typed_messages(db, messages)
        if typed:
            from evolu_tpu_torch.ops.merge import strip_typed_upserts

            apply_typed_ops(db, schema, typed, device)
            plan = strip_typed_upserts(plan, messages, schema)
        if len(plan) == 3:
            xor_mask, upserts, deltas = plan
        else:
            xor_mask, upserts = plan
            # Folded BEFORE any write, so a malformed timestamp rolls the
            # whole batch back.
            deltas, _ = minute_deltas_host(
                m.timestamp for i, m in enumerate(messages) if xor_mask[i]
            )
        for m in upserts:  # only the final winner per cell touches the row
            db.run(_upsert_sql(m.table, m.column), (m.row, m.value, m.value))
        db.run_many(
            _INSERT_MESSAGE,
            [(m.timestamp, m.table, m.row, m.column, m.value) for m in messages],
        )
    return apply_prefix_xors(merkle_tree, deltas)
