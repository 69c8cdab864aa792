"""Partial replication, relay side: scoped Merkle subtrees and lane
tracking.

The port's copy of `evolu_tpu.server.scope`. A scoped SyncRequest
(`sync/protocol.py` `ScopeClause`, negotiated through `sync-scope-v1`) is
answered from a **scoped Merkle subtree**: a masked minute-fold over
exactly the rows the filter matches. The owner's FULL tree stays the one
source of truth: ingest is unchanged, and scoped trees are derived on
demand and cached against the full tree's text (any ingest changes that
text, so a cached entry never serves stale state).

The membership rule of the scoped row set:

    row in slice  iff  (timestamp >= watermark AND lane served)
                       OR author(row) == requesting node

where a lane is served when its tag is requested, is the overflow lane,
or is UNKNOWN (rows pushed by unscoped clients carry no tag): the relay
may serve more than the slice, never less. The requester's own rows stay
in the TREE whatever the filter (they XOR-cancel against its local
copies; responses exclude them anyway), so a client whose own writes
fall outside its scope never livelocks on a tree diff.

The fold runs on `device` for canonical batches of at least
`SCOPE_DEVICE_FOLD_MIN` rows (`ops.merkle_ops.merkle_minute_deltas`,
kernels H and X; the slice mask is the kernels' xor_mask) and through the
host fold `core.merkle.minute_deltas_host` for smaller batches and for
non-canonical hex case. Nothing else takes the host route: a device
fault raises `KernelError`.

Lanes live in a relay-local side table `scopeLane(userId, timestamp,
tag)`, written only when a scoped push assigns tags. Distinct lanes an
owner are capped at `MAX_OWNER_LANES`; past it, new tags collapse into
the `~overflow` lane, served to every scope.

Observability as the reference's: the `evolu_scope_*` families (serves,
served and filtered rows, folds by route, tree-cache hits, misses and
evictions, overflowed lanes, lanes an owner) and the conservation
ledger's `serve.scoped_rows` / `serve.scope_filtered` tallies (outside the
flow equations: a scoped serve classifies response rows, never where an
ingressed message ends). `counts` keeps the same tallies process-wide.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

import numpy as np

from evolu_tpu_torch.core.merkle import (
    apply_prefix_xors,
    diff_merkle_trees,
    merkle_tree_from_string,
    merkle_tree_to_string,
    minute_deltas_host,
)
from evolu_tpu_torch.core.timestamp import create_sync_timestamp, timestamp_to_string
from evolu_tpu_torch.obs import ledger, metrics
from evolu_tpu_torch.ops import resolve_device
from evolu_tpu_torch.ops.cuda_lib import device_work
from evolu_tpu_torch.ops.host_parse import parse_timestamp_strings
from evolu_tpu_torch.ops.merkle_ops import merkle_minute_deltas, minute_deltas_to_dict
from evolu_tpu_torch.sync import protocol

# The conservative overflow lane. Not a tag shape `sync/scope.py` makes
# (those are hex); a client sending this literal only lands its rows in the
# always-served lane.
OVERFLOW_TAG = "~overflow"
# Distinct lanes an owner.
MAX_OWNER_LANES = 64
# Below this row count the host fold serves; module-level so tests can
# drive the device route with small batches.
SCOPE_DEVICE_FOLD_MIN = 1024
# Derived-tree cache entries (process-wide). Each pins its owner's
# full-tree text for the exact-match check.
TREE_CACHE_CAP = 256

# Each count's metric family and labels.
_FAMILIES = {
    "serves": ("evolu_scope_serves_total", {}),
    "served_rows": ("evolu_scope_served_rows_total", {}),
    "filtered_rows": ("evolu_scope_filtered_rows_total", {}),
    "fold_device": ("evolu_scope_fold_total", {"route": "device"}),
    "fold_host": ("evolu_scope_fold_total", {"route": "host"}),
    "tree_cache_hits": ("evolu_scope_tree_cache_hits_total", {}),
    "tree_cache_misses": ("evolu_scope_tree_cache_misses_total", {}),
    "tree_cache_evictions": ("evolu_scope_tree_cache_evictions_total", {}),
    "overflow": ("evolu_scope_overflow_total", {}),
}
counts = dict.fromkeys(_FAMILIES, 0)
_counts_lock = threading.Lock()


def _count(key: str, n: int = 1) -> None:
    with _counts_lock:
        counts[key] += n
    name, labels = _FAMILIES[key]
    metrics.inc(name, n, **labels)


_LANE_TABLE_SQL = (
    'CREATE TABLE IF NOT EXISTS "scopeLane" ('
    '"userId" TEXT, "timestamp" TEXT, "tag" TEXT, '
    'PRIMARY KEY ("userId", "timestamp")) WITHOUT ROWID'
)


def _ensure_lane_table(db) -> None:
    db.exec(_LANE_TABLE_SQL)


def record_push_lanes(db, user_id: str, timestamps: Sequence[str],
                      push_tags: Sequence[str], node_id: Optional[str] = None) -> None:
    """Record a push's lane assignment (timestamp → tag), folding tags past
    the owner's lane cap into the overflow lane. INSERT OR IGNORE: a
    redelivered row keeps its first lane.

    With `node_id`, only rows the pushing node authored get a lane: a
    resend relays foreign rows too, and tagging those later would let one
    device hide another's rows from scoped views, and could exclude a row
    from a scoped tree after it was served with an unknown lane, which
    diverges that client's tree for good."""
    pairs = [(t, tag) for t, tag in zip(timestamps, push_tags)
             if tag and (node_id is None or t.endswith(node_id))]
    if not pairs:
        return
    _ensure_lane_table(db)
    rows = db.exec_sql_query('SELECT DISTINCT "tag" FROM "scopeLane" WHERE "userId" = ?', (user_id,))
    lanes: Set[str] = {r["tag"] for r in rows}
    overflowed = 0
    out = []
    for ts, tag in pairs:
        if tag not in lanes:
            if len(lanes) >= MAX_OWNER_LANES:
                overflowed += 1
                tag = OVERFLOW_TAG
                if tag not in lanes and len(lanes) < MAX_OWNER_LANES + 1:
                    lanes.add(tag)
            else:
                lanes.add(tag)
        out.append((user_id, ts, tag))
    with db.transaction():
        db.run_many('INSERT OR IGNORE INTO "scopeLane" ("userId", "timestamp", "tag") VALUES (?, ?, ?)', out)
    if overflowed:
        _count("overflow", overflowed)
    metrics.observe("evolu_scope_owner_lanes", len(lanes), buckets=metrics.COUNT_BUCKETS)


def excluded_timestamps(db, user_id: str, tags: FrozenSet[str]) -> Set[str]:
    """Timestamps whose lane is KNOWN and not requested: the only rows a
    tag filter may withhold (unknown and overflow lanes are served). Empty
    without a tag filter."""
    if not tags:
        return set()
    _ensure_lane_table(db)
    served = tuple(tags) + (OVERFLOW_TAG,)
    ph = ",".join("?" * len(served))
    rows = db.exec_sql_query(
        f'SELECT "timestamp" FROM "scopeLane" WHERE "userId" = ? AND "tag" NOT IN ({ph})',
        (user_id, *served),
    )
    return {r["timestamp"] for r in rows}


def scoped_minute_deltas(timestamps: Sequence[str], xor_mask, device=None) -> Dict[str, int]:
    """The masked minute-fold: per-minute XOR deltas over the rows the mask
    keeps. A canonical batch of at least `SCOPE_DEVICE_FOLD_MIN` rows runs
    kernels H and X on `device` (None = the card), the mask consumed there
    as the kernels' xor_mask; a smaller batch, or one with non-canonical
    hex case, takes the host fold. A device fault raises KernelError."""
    if len(timestamps) >= SCOPE_DEVICE_FOLD_MIN:
        millis, counter, node, case_ok = parse_timestamp_strings(timestamps, with_case=True)
        if bool(case_ok.all()):
            dev = resolve_device(device)
            with device_work("a scoped fold"):
                outs = merkle_minute_deltas(millis, counter, node, np.asarray(xor_mask, dtype=bool), device=dev)
            _count("fold_device")
            return minute_deltas_to_dict(*outs)
    _count("fold_host")
    deltas, _digest = minute_deltas_host(t for t, keep in zip(timestamps, xor_mask) if keep)
    return deltas


def _watermark_string(watermark_millis: int) -> str:
    """The raw-string lower bound for a watermark: the sync timestamp of
    that millis (counter 0000, node all zeros) sorts at or before every
    real timestamp of the same millis, and raw-string order is the
    reference's timestamp order."""
    if not watermark_millis:
        return ""
    return timestamp_to_string(create_sync_timestamp(watermark_millis))


class _ScopedTreeCache:
    """Derived scoped trees keyed by (owner, watermark, tags, node), valid
    only while the owner's full-tree text is exactly the one they were
    derived from (every ingest rewrites that text). LRU past
    TREE_CACHE_CAP."""

    def __init__(self, cap: int = TREE_CACHE_CAP):
        self._lock = threading.Lock()
        self._cap = cap
        self._entries: "OrderedDict[tuple, Tuple[str, dict, str]]" = OrderedDict()

    def get(self, key: tuple, full_raw: str) -> Optional[Tuple[dict, str]]:
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None and hit[0] == full_raw:
                self._entries.move_to_end(key)
                _count("tree_cache_hits")
                return hit[1], hit[2]
        _count("tree_cache_misses")
        return None

    def put(self, key: tuple, full_raw: str, tree: dict, raw: str) -> None:
        with self._lock:
            self._entries[key] = (full_raw, tree, raw)
            self._entries.move_to_end(key)
            while len(self._entries) > self._cap:
                self._entries.popitem(last=False)
                _count("tree_cache_evictions")

    def reset(self) -> None:
        with self._lock:
            self._entries.clear()


tree_cache = _ScopedTreeCache()


def _candidates(db, user_id: str, node_id: str, wm: str) -> List[str]:
    """The rows a scoped tree can hold: past the watermark, plus the
    requester's own rows whatever the watermark (the LIKE arm matches the
    author-node suffix, the screen the serve paths use)."""
    rows = db.exec_sql_query(
        'SELECT "timestamp" FROM "message" WHERE "userId" = ? AND '
        '("timestamp" >= ? OR "timestamp" LIKE \'%\' || ?) '
        'ORDER BY "timestamp"',
        (user_id, wm, node_id),
    )
    return [r["timestamp"] for r in rows]


def _slice_mask(candidates: Sequence[str], node_id: str, wm: str, excluded: Set[str]) -> List[bool]:
    return [ts.endswith(node_id) or (ts >= wm and ts not in excluded) for ts in candidates]


def scoped_tree_for(shard, user_id: str, node_id: str, scope: protocol.ScopeClause,
                    full_raw: str, device=None) -> Tuple[dict, str]:
    """The scoped Merkle subtree for one (owner, scope, node): from the
    cache while the full tree has not moved, else the masked minute-fold
    over the candidate rows on `device`. `shard` is a RelayStore (anything
    with `.db`). The cache key holds no device: a tree does not depend on
    where it was folded."""
    tags = frozenset(scope.tags)
    key = (user_id, scope.watermark_millis, tags, node_id)
    hit = tree_cache.get(key, full_raw)
    if hit is not None:
        return hit
    db = shard.db
    wm = _watermark_string(scope.watermark_millis)
    candidates = _candidates(db, user_id, node_id, wm)
    mask = _slice_mask(candidates, node_id, wm, excluded_timestamps(db, user_id, tags))
    deltas = scoped_minute_deltas(candidates, mask, device=device)
    tree = apply_prefix_xors({}, deltas)
    raw = merkle_tree_to_string(tree)
    tree_cache.put(key, full_raw, tree, raw)
    return tree, raw


def _shard_of(store, user_id: str):
    return store.shard_of(user_id) if hasattr(store, "shard_of") else store


def _rows_since(db, user_id: str, node_id: str, since: str):
    return db.exec_sql_query(
        'SELECT "timestamp", "content" FROM "message" '
        'WHERE "userId" = ? AND "timestamp" > ? AND '
        '"timestamp" NOT LIKE \'%\' || ? ORDER BY "timestamp"',
        (user_id, since, node_id),
    )


def _filter_rows(rows, wm: str, excluded: Set[str]) -> Tuple[List[protocol.EncryptedCrdtMessage], int]:
    kept: List[protocol.EncryptedCrdtMessage] = []
    n_filtered = 0
    for r in rows:
        ts = r["timestamp"]
        if ts >= wm and ts not in excluded:
            kept.append(protocol.EncryptedCrdtMessage(ts, r["content"]))
        else:
            n_filtered += 1
    return kept, n_filtered


def scoped_response(store, request: protocol.SyncRequest, device=None) -> protocol.SyncResponse:
    """Answer one scoped request, RESPOND ONLY: the caller has ingested
    `request.messages` through its normal path already (the full tree is
    untouched by scoping). Records the push's lanes, derives the scoped
    subtree on `device`, diffs it against the client tree, and serves the
    in-slice rows after the diff minute, counting what the filter
    withheld."""
    scope = request.scope
    assert scope is not None
    user_id, node_id = request.user_id, request.node_id
    shard = _shard_of(store, user_id)
    if scope.push_tags:
        record_push_lanes(shard.db, user_id, [m.timestamp for m in request.messages], scope.push_tags,
                          node_id=node_id)
    _count("serves")
    full_raw = shard.get_merkle_tree_string(user_id)
    tree, raw = scoped_tree_for(shard, user_id, node_id, scope, full_raw, device=device)
    client_tree = merkle_tree_from_string(request.merkle_tree)
    diff = diff_merkle_trees(tree, client_tree)
    if diff is None:
        return protocol.SyncResponse((), raw)
    since = timestamp_to_string(create_sync_timestamp(diff))
    rows = _rows_since(shard.db, user_id, node_id, since)
    wm = _watermark_string(scope.watermark_millis)
    excluded = excluded_timestamps(shard.db, user_id, frozenset(scope.tags))
    kept, n_filtered = _filter_rows(rows, wm, excluded)
    ledger.count(ledger.SERVE_SCOPED, len(kept), owner=user_id)
    ledger.count(ledger.SERVE_SCOPE_FILTERED, n_filtered, owner=user_id)
    _count("served_rows", len(kept))
    _count("filtered_rows", n_filtered)
    return protocol.SyncResponse(tuple(kept), raw)


def serve_scoped(store, request: protocol.SyncRequest, device=None) -> bytes:
    """The whole scoped serve of the per-request path
    (`relay.serve_single_request`): the normal ingest through
    `store.add_messages`, then the scoped respond. The batched engine
    calls `scoped_response` itself: its ingest has run already."""
    store.add_messages(request.user_id, request.messages)
    return protocol.encode_sync_response(scoped_response(store, request, device=device))


def scoped_snapshot_filter(db, owners: Optional[Sequence[str]], watermark_millis: int,
                           tags: Sequence[str]):
    """The record filter of a SCOPED snapshot capture: keep a (userId,
    timestamp) row iff it is in the slice, past the watermark and not in an
    excluded lane. → a predicate; each owner's excluded set loads once,
    lazily."""
    wm = _watermark_string(watermark_millis)
    tag_set = frozenset(tags)
    cache: Dict[str, Set[str]] = {}

    def keep(user_id: str, ts: str) -> bool:
        if ts < wm:
            return False
        if not tag_set:
            return True
        if user_id not in cache:
            cache[user_id] = excluded_timestamps(db, user_id, tag_set)
        return ts not in cache[user_id]

    return keep
