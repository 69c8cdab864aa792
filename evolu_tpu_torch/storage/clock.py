"""The replica's `CrdtClock` in the one-row `__clock` table: its
timestamp is the HLC high-water mark, its merkleTree the digest of every
stored message, together the resumable sync cursor."""

from __future__ import annotations

from evolu_tpu_torch.core.merkle import merkle_tree_from_string, merkle_tree_to_string
from evolu_tpu_torch.core.timestamp import timestamp_from_string, timestamp_to_string
from evolu_tpu_torch.core.types import CrdtClock
from evolu_tpu_torch.storage.sqlite import PySqliteDatabase
from evolu_tpu_torch.utils.log import log


def read_clock(db: PySqliteDatabase) -> CrdtClock:
    """readClock.ts:15-27 (logged under clock:read, readClock.ts:26)."""
    row = db.exec_sql_query('SELECT "timestamp", "merkleTree" FROM "__clock" LIMIT 1')[0]
    clock = CrdtClock(
        timestamp=timestamp_from_string(row["timestamp"]),
        merkle_tree=merkle_tree_from_string(row["merkleTree"]),
    )
    log("clock:read", timestamp=row["timestamp"])
    return clock


def update_clock(db: PySqliteDatabase, clock: CrdtClock) -> None:
    """updateClock.ts:8-26 (logged under clock:update, updateClock.ts:24)."""
    ts = timestamp_to_string(clock.timestamp)
    db.run(
        'UPDATE "__clock" SET "timestamp" = ?, "merkleTree" = ?',
        (ts, merkle_tree_to_string(clock.merkle_tree)),
    )
    log("clock:update", timestamp=ts)
