"""The relay's snapshot install state, as far as `GET /health` reads it.

The port's copy of `install_phase` and `_shards_of` from
`evolu_tpu.server.snapshot`. The rest of that module (snapshot capture,
the chunked transfer, the crash-consistent installer and checkpoints)
comes with the relay tier.
"""

from __future__ import annotations

from typing import Optional, Sequence


def _shards_of(store) -> Sequence:
    return getattr(store, "shards", None) or [store]


def install_phase(store) -> Optional[str]:
    """The persisted install state machine's phase marker ("fetch" |
    "swap"), or None when no install is in progress. Probes
    `sqlite_master` without creating anything: a store that never
    bootstrapped must not grow a state table from being health-checked."""
    shard0 = _shards_of(store)[0]
    have = shard0.db.exec_sql_query(
        "SELECT name FROM sqlite_master WHERE type='table' "
        "AND name='snapshotBootstrapState'"
    )
    if not have:
        return None
    rows = shard0.db.exec_sql_query(
        'SELECT "value" FROM "snapshotBootstrapState" WHERE "key" = ?',
        ("phase",),
    )
    return rows[0]["value"] if rows else None
