"""The changed-set contract for incremental query invalidation.

Every apply reports the (table, rowId) pairs it touched into a
`ChangedSet`; the worker gates subscribed-query re-execution on it
(`runtime/worker.py::_query` with `storage/deps.py`). The fast path may
only ever over-approximate: "don't know" escalates (`mark_unknown`, or a
per-table row set overflowing to all rows), so correctness never depends
on precision. Recording happens at the apply level (`storage/apply.py`),
the same whichever planner produced the plan, for object batches
(`CrdtMessage` sequences) and packed columnar ones (`PackedReceive`).
"""

from __future__ import annotations

from typing import Dict, Optional, Set

# A per-table row set larger than this degrades to "all rows of the
# table" (None): bounds gate-time set intersections and memory for huge
# receive batches, at worst costing re-execution of row-filtered queries.
ROW_SET_CAP = 4096

_MISSING = object()


class ChangedSet:
    """Tables and rows touched by one or more applies.

    `rows[table]` is a set of rowIds, or None = "any/unknown rows in
    this table". `conservative=True` means the whole write is
    unattributable: every gated query must re-execute.
    """

    __slots__ = ("tables", "rows", "conservative")

    def __init__(self):
        self.tables: Set[str] = set()
        self.rows: Dict[str, Optional[set]] = {}
        self.conservative = False

    def __bool__(self) -> bool:
        return self.conservative or bool(self.tables)

    def add_cell(self, table: str, row: str) -> None:
        # Lower-cased key: SQLite resolves identifiers case-insensitively,
        # so a wire message's "Todo" writes the table deps.py knows as
        # "todo"; both sides of the contract fold to one key.
        table = table.lower()
        self.tables.add(table)
        s = self.rows.get(table, _MISSING)
        if s is None:
            return
        if s is _MISSING:
            self.rows[table] = {row}
        elif len(s) >= ROW_SET_CAP:
            self.rows[table] = None
        else:
            s.add(row)

    def add_table(self, table: str) -> None:
        """Table touched with unknown rows."""
        table = table.lower()
        self.tables.add(table)
        self.rows[table] = None

    def mark_unknown(self) -> None:
        """Escalate to conservative full invalidation."""
        self.conservative = True

    def merge(self, other: "ChangedSet") -> None:
        self.conservative = self.conservative or other.conservative
        self.tables |= other.tables
        for t, s in other.rows.items():
            if s is None:
                self.rows[t] = None
                continue
            mine = self.rows.get(t, _MISSING)
            if mine is None:
                continue
            if mine is _MISSING:
                self.rows[t] = set(s)
            else:
                mine |= s
                if len(mine) > ROW_SET_CAP:
                    self.rows[t] = None


def record_batch(changes: Optional[ChangedSet], messages) -> None:
    """Record one apply batch's touched rows: the (table, row) of every
    message, plus `__message` (row-unknown: its rowids are timestamps,
    not app ids). Takes CrdtMessage sequences and PackedReceive batches
    (their touched cells); any failure escalates to conservative."""
    if changes is None:
        return
    try:
        changes.add_table("__message")
        from evolu_tpu_torch.core.packed import PackedReceive

        if isinstance(messages, PackedReceive):
            for table, row, _col in messages.touched_cells()[1]:
                changes.add_cell(table, row)
        else:
            for m in messages:
                changes.add_cell(m.table, m.row)
    except Exception:  # noqa: BLE001 - don't know ⇒ full invalidation
        changes.mark_unknown()


def record_typed_tables(changes: Optional[ChangedSet]) -> None:
    """A batch carried typed CRDT ops: their materializers also write
    the `__crdt_*` merge-state tables (rows unknowable here)."""
    if changes is None:
        return
    for table in ("__crdt_counter", "__crdt_set", "__crdt_kill", "__crdt_list", "__crdt_list_kill"):
        changes.add_table(table)
