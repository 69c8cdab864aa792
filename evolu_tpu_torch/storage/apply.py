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
`plan_batch`, `ops.merge.plan_batch_device_full` on the card, or the
device-resident winner cache `ops.winner_cache.DeviceWinnerCache`, which
sources stored winners itself), then bulk SQL, all in one transaction.
`apply_messages_chunked` folds a huge batch chunk by chunk, each chunk
its own transaction. `changes` (a `storage.changes.ChangedSet`) collects
the rows each apply touches, for the worker's query invalidation.

Typed CRDT cells (counter, awset, list, tensor) ride the same
transaction: `crdt_types.apply_typed_ops` folds their new ops into the
`__crdt_*` state and materializes the app values before the batch's
`__message` insert, and `ops.merge.strip_typed_upserts` removes their
LWW upserts from the plan. `device` (None = CUDA) is where the typed
folds run once a batch reaches `crdt_types.DEVICE_FOLD_MIN`; LWW-only
batches never read it.

On the C++ backend (`storage.native.CppSqliteDatabase`) the sequential
loop, the winner lookup and the planned apply each run as one native
call. A `PackedReceive` batch (the fused receive leg) plans with the
planner's `plan_packed` and applies with `apply_planned_cells`, with no
per-row objects; a packed batch that holds a typed cell, or that the
planner or the backend cannot take, is materialized and takes the
object path before any side effect. `counts` says which route each
batch took, in place of the reference's metrics.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from evolu_tpu_torch.core.crdt_types import apply_typed_ops, load_schema
from evolu_tpu_torch.core.merkle import apply_prefix_xors, insert_into_merkle_tree, minute_deltas_host
from evolu_tpu_torch.core.packed import PackedReceive
from evolu_tpu_torch.core.timestamp import timestamp_from_string
from evolu_tpu_torch.core.types import CrdtMessage
from evolu_tpu_torch.storage.changes import record_batch, record_typed_tables
from evolu_tpu_torch.storage.sqlite import PySqliteDatabase, quote_ident

# Batches by route: `packed` planned and applied columnar, `object` on
# the object path, `packed_bounces` packed batches materialized for the
# object path (of them `typed_bounces` for a typed cell), `sequential`
# and `native_sequential` the two sequential loops, `log_only` the
# out-of-scope batches of a scoped client; `deferred_mat` counts their
# messages (the reference's `apply.deferred_mat` ledger terminal).
counts = {"packed": 0, "object": 0, "packed_bounces": 0, "typed_bounces": 0,
          "sequential": 0, "native_sequential": 0, "log_only": 0, "deferred_mat": 0}

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
    db: PySqliteDatabase, merkle_tree: dict, messages: Sequence[CrdtMessage],
    changes=None, device=None,
) -> dict:
    """The reference loop, message by message. On the C++ backend the
    whole loop (winner check, upsert, insert) runs as one native call
    returning the XOR mask; elsewhere it is O(n) SQL round trips. Typed
    ops fold and materialize first, before the loop inserts any
    `__message` row (the dedup screen reads pre-batch state)."""
    record_batch(changes, messages)
    schema, typed = _typed_messages(db, messages)
    # The C loop's char* ABI is NUL-terminated (binds and winner
    # compares), so NUL-bearing fields take the Python loop, which binds
    # full bytes; typed batches too, or the C loop would upsert raw op
    # values into app tables.
    if hasattr(db, "apply_sequential") and not typed and not any(
        "\x00" in m.timestamp or "\x00" in m.table or "\x00" in m.row or "\x00" in m.column
        for m in messages
    ):
        counts["native_sequential"] += 1
        for m, flagged in zip(messages, db.apply_sequential(messages)):
            if flagged:
                merkle_tree = insert_into_merkle_tree(timestamp_from_string(m.timestamp), merkle_tree)
        return merkle_tree
    counts["sequential"] += 1
    if typed:
        record_typed_tables(changes)
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
    a temp-table join on the (table, row, column, timestamp) index. On
    the C++ backend, below 4096 cells, per-cell indexed lookups in one
    native call (above that the single join wins)."""
    cells = list(cells)
    if not cells:
        return {}
    if hasattr(db, "fetch_winners") and len(cells) < 4096:
        return {c: w for c, w in zip(cells, db.fetch_winners(cells)) if w is not None}
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
    changes=None,
    device=None,
) -> dict:
    """Batched apply, end state identical to the sequential oracle.

    `planner(messages, existing_winners)` defaults to the host
    `plan_batch` (→ 2-tuple; the Merkle deltas are then folded on the
    host); a device planner returns (xor_mask, upserts, deltas). A
    planner whose `fetches_winners` is False (on the function, or on
    the instance of a bound method) sources stored winners itself and
    gets `{}`. If the transaction fails, the planner's
    `on_transaction_failed` hook runs: a planner that advanced its own
    state at plan time (the winner cache) is then ahead of SQLite."""
    if not len(messages):
        return merkle_tree
    planner = planner or plan_batch
    try:
        with db.transaction():  # whole-batch atomicity
            return _apply_in_txn(db, merkle_tree, messages, planner, changes, device)
    except BaseException:
        _notify_plan_failure(planner)
        raise


def _notify_plan_failure(planner) -> None:
    """Fire the planner's transaction-failure hook, if any. The hook may
    sit on the planner function (the worker's planner) or on a bound
    method's instance (`DeviceWinnerCache.plan_batch`)."""
    on_failed = getattr(planner, "on_transaction_failed", None)
    if on_failed is None:
        on_failed = getattr(getattr(planner, "__self__", None), "on_transaction_failed", None)
    if on_failed is not None:
        on_failed()


def _apply_in_txn(db, merkle_tree, messages, planner, changes, device):
    # Recorded before planning: a route that fails half-way still leaves
    # a superset in the changed-set.
    record_batch(changes, messages)
    if isinstance(messages, PackedReceive):
        schema = load_schema(db)
        if schema and schema.has_typed(messages.cells):
            # The packed cell apply would LWW-upsert raw op values, and
            # the typed fold needs message objects: bounce before any
            # side effect.
            counts["typed_bounces"] += 1
        else:
            plan_packed = getattr(planner, "plan_packed", None)
            plan = (plan_packed(messages)
                    if plan_packed is not None and hasattr(db, "apply_planned_cells") else None)
            if plan is not None:
                counts["packed"] += 1
                xor_mask, upsert_mask, deltas = plan
                db.apply_planned_cells(messages, upsert_mask)
                return apply_prefix_xors(merkle_tree, deltas)
        # Bounced (a typed cell, non-canonical hex case, a small batch,
        # or a backend without the cell apply): materialize exactly.
        counts["packed_bounces"] += 1
        messages = messages.to_messages()
    counts["object"] += 1
    owner = getattr(planner, "__self__", None)
    fetches = getattr(planner, "fetches_winners", getattr(owner, "fetches_winners", True))
    if fetches:
        existing = fetch_existing_winners(db, {(m.table, m.row, m.column) for m in messages})
    else:
        existing = {}  # the planner owns its winner source (the device cache)
    plan = planner(messages, existing)
    schema, typed = _typed_messages(db, messages)
    if typed:
        from evolu_tpu_torch.ops.merge import strip_typed_upserts

        record_typed_tables(changes)
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
    if hasattr(db, "apply_planned"):
        # C++ backend: upserts and the bulk __message insert in one call.
        mask = getattr(plan, "upsert_mask", None)
        if mask is None:
            # Host planners return upserts only: rebuild the positional
            # mask keyed by cell and timestamp, flagging only the FIRST
            # occurrence of each winner key, so a duplicate timestamp
            # with another value cannot upsert twice (the Python path
            # applies the planner's single chosen winner).
            pending = {(m.table, m.row, m.column, m.timestamp) for m in upserts}
            mask = []
            for m in messages:
                key = (m.table, m.row, m.column, m.timestamp)
                mask.append(key in pending)
                pending.discard(key)
        db.apply_planned(messages, mask)
    else:
        for m in upserts:  # only the final winner per cell touches the row
            db.run(_upsert_sql(m.table, m.column), (m.row, m.value, m.value))
        db.run_many(
            _INSERT_MESSAGE,
            [(m.timestamp, m.table, m.row, m.column, m.value) for m in messages],
        )
    return apply_prefix_xors(merkle_tree, deltas)


def apply_messages_log_only(
    db: PySqliteDatabase,
    merkle_tree: dict,
    messages: Sequence[CrdtMessage],
    changes=None,
) -> dict:
    """Partial replication (`sync/scope.py`): land a batch in the
    __message log and the Merkle tree WITHOUT materializing app-table rows,
    the apply route of out-of-scope tables on a scoped client. The log rows
    and tree deltas are a full apply's; only the upsert is skipped, and the
    skipped messages are counted (`counts["deferred_mat"]`). A later widen
    re-materializes them from the log in LWW order (`runtime/worker.py`).
    The fold is the host fold: out-of-scope batches launch nothing."""
    if not len(messages):
        return merkle_tree
    with db.transaction():
        # Recorded although nothing materializes: a query that reads a
        # deferred table must re-run and meet the typed deferral.
        record_batch(changes, messages)
        existing = fetch_existing_winners(db, {(m.table, m.row, m.column) for m in messages})
        xor_mask, _upserts = plan_batch(messages, existing)
        deltas, _ = minute_deltas_host(m.timestamp for i, m in enumerate(messages) if xor_mask[i])
        db.run_many(_INSERT_MESSAGE, [(m.timestamp, m.table, m.row, m.column, m.value) for m in messages])
        tree = apply_prefix_xors(merkle_tree, deltas)
    counts["log_only"] += 1
    counts["deferred_mat"] += len(messages)
    return tree


class ChunkedApplyError(Exception):
    """A chunk failed after earlier chunks committed. `partial_tree`
    covers every committed chunk and `applied` counts their messages;
    the caller must persist `partial_tree` (e.g. to the clock) or the
    digest diverges from the stored rows for good."""

    def __init__(self, partial_tree: dict, applied: int, cause: BaseException):
        super().__init__(f"chunked apply failed after {applied} messages: {cause}")
        self.partial_tree = partial_tree
        self.applied = applied
        self.__cause__ = cause


def apply_messages_chunked(
    db: PySqliteDatabase,
    merkle_tree: dict,
    messages: Sequence[CrdtMessage],
    chunk_size: int = 1 << 20,
    planner=None,
    on_chunk=None,
    changes=None,
    device=None,
) -> dict:
    """Blockwise apply of a batch too large for one transaction.

    The LWW contraction is associative: each chunk's winners are the
    next chunk's stored winners, so folding chunks left to right equals
    one giant batch, with bounded device and transaction memory.
    `on_chunk(tree, applied_count)` runs inside the chunk's transaction,
    so the chunk's rows and what the callback persists (the clock)
    commit together. If a chunk or its callback fails, that chunk rolls
    back and `ChunkedApplyError` carries the tree and count of the
    chunks that did commit."""
    applied = 0
    for i in range(0, len(messages), chunk_size):
        chunk = messages[i:i + chunk_size]
        try:
            with db.transaction():
                next_tree = apply_messages(db, merkle_tree, chunk, planner,
                                           changes=changes, device=device)
                if on_chunk is not None:
                    on_chunk(next_tree, applied + len(chunk))
        except Exception as e:
            # The inner apply fires the planner's failure hook only for
            # its own exceptions; an `on_chunk` failure rolls the chunk
            # back here, after the planner advanced. The hook is an
            # idempotent reset, so firing twice is harmless.
            _notify_plan_failure(planner or plan_batch)
            raise ChunkedApplyError(merkle_tree, applied, e) from e
        merkle_tree = next_tree
        applied += len(chunk)
    return merkle_tree
