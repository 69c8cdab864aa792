"""Snapshot checkpoint and peer bootstrap: O(state) relay cold-start.

The port's copy of `evolu_tpu.server.snapshot`. A fresh relay (or one
restored after disk loss) is diverged by the whole history, and capped
anti-entropy pulls would crawl it in O(history) round trips. This module
ships a state snapshot instead and hands off to gossip at its watermark:

* **Consistent capture**: per shard, inside one SQLite transaction of its
  own (`_exclusive_txn`), every `message` and `merkleTree` row streams
  into a framed byte format with explicit lengths. The native leg
  `CppSqliteDatabase.snapshot_rows` packs a shard in one C call;
  `_capture_shard_py` is its byte-identical oracle. The stream splits into
  crc32-checked chunks at record boundaries, described by a
  `protocol.SnapshotManifest` with per-owner watermarks (the Merkle root
  hash and a crc32 of the tree text).
* **Shipping**: `POST /replicate/snapshot` answers the manifest (the
  capture is cached, `SnapshotCache`, so resumed fetches see the same
  bytes) and `POST /replicate/snapshot/chunk` one chunk. An expired
  snapshot id answers 400; the puller drops its install and restarts.
* **Crash-consistent install** (`SnapshotInstaller`): chunks land in side
  tables (`messageBsnap`, `merkleTreeBsnap`) of the live store, the chunk
  watermark persisted in `snapshotBootstrapState` after each chunk
  commits. `verify` recomputes every owner's tree from the shipped rows on
  the host (`minute_deltas_host`) and demands byte-identity with the
  shipped text and the manifest digests; `swap` then, per shard in one
  transaction, folds every live row the snapshot lacks into the side
  tables through the changes==1 XOR gate and renames them in. An
  acknowledged write never vanishes in the swap.
* **Local checkpoints**: `write_checkpoint` (tmp + fsync + rename) and
  `restore_checkpoint` reuse the capture and the install;
  `CheckpointWriter` runs them periodically.

A scoped snapshot (a `SnapshotRequest` watermark or lane tags, for a
thin client's bootstrap) keeps only the slice's rows and ships each
owner's tree recomputed from them on the host (`_scope_stream`): its
trees describe the slice, never the owner's full history, so it must
never seed a full replica.

Observability as the reference's: the `evolu_snap_*` families (donor
captures and serves, checkpoints, verify failures, merged live rows, the
install time), beside the plain process-wide `counts`; and the
conservation ledger: a swap posts, in one pending entry committed after
every shard of the run swapped, `ingress.snapshot` for the installed rows
and their terminals, `store.duplicate` for the rows the store already
held and `store.inserted` for the rest.
"""

from __future__ import annotations

import os
import struct
import threading
import time
import uuid
import zlib
from contextlib import contextmanager
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from evolu_tpu_torch.core.merkle import (
    apply_prefix_xors,
    merkle_tree_from_string,
    merkle_tree_to_string,
    minute_deltas_host,
)
from evolu_tpu_torch.obs import ledger, metrics
from evolu_tpu_torch.sync import protocol
from evolu_tpu_torch.utils.log import log

# Chunk sizing: the default rides well under the relay's 20 MB body cap;
# donors clamp puller-requested sizes into [64 KiB, 8 MiB].
SNAPSHOT_CHUNK_BYTES = 4 << 20
SNAPSHOT_MIN_CHUNK_BYTES = 64 << 10
SNAPSHOT_MAX_CHUNK_BYTES = 8 << 20
# How long a donor keeps a captured snapshot servable; an expired id
# answers 400 and the puller restarts fresh.
SNAPSHOT_TTL_S = 600.0

_REC_MESSAGE = 0x4D  # 'M': u32 ts_len‖ts ‖ u32 uid_len‖uid ‖ u32 len‖content
_REC_TREE = 0x54  # 'T': u32 uid_len‖uid ‖ u32 tree_len‖tree

_U32 = struct.Struct("<I")

_MESSAGE_SCHEMA = (
    'CREATE TABLE "messageBsnap" ('
    '"timestamp" TEXT, "userId" TEXT, "content" BLOB, '
    'PRIMARY KEY ("userId", "timestamp")) WITHOUT ROWID'
)
_TREE_SCHEMA = (
    'CREATE TABLE "merkleTreeBsnap" ('
    '"userId" TEXT PRIMARY KEY, "merkleTree" TEXT)'
)

# The process's snapshot counts, each with its unlabeled evolu_snap_*
# counter: the donor side (captures, manifests and chunks served) and the
# checkpoints written and failed. `_count` takes the lock.
_FAMILIES = {
    "captures": "evolu_snap_captures_total",
    "scoped_captures": "evolu_snap_scoped_captures_total",
    "capture_rows": "evolu_snap_capture_rows_total",
    "capture_bytes": "evolu_snap_capture_bytes_total",
    "manifests_served": "evolu_snap_manifests_served_total",
    "chunks_served": "evolu_snap_chunks_served_total",
    "chunk_bytes_served": "evolu_snap_chunk_bytes_served_total",
    "checkpoints": "evolu_snap_checkpoints_total",
    "checkpoint_failures": "evolu_snap_checkpoint_failures_total",
}
counts = dict.fromkeys(_FAMILIES, 0)
_counts_lock = threading.Lock()


def _count(key: str, n: int = 1) -> None:
    with _counts_lock:
        counts[key] += n
    metrics.inc(_FAMILIES[key], n)


class SnapshotInstallError(Exception):
    """A snapshot failed integrity or parity verification (crc mismatch,
    recomputed tree != shipped tree, owner or count drift). The install
    aborted; the live tables were never touched."""


@contextmanager
def _exclusive_txn(db):
    """A transaction that is our own. The store's `transaction()` joins an
    open one, and the batch engine's explicit begin/commit releases the db
    lock between statements: joining it would read uncommitted rows into a
    snapshot or commit half a swap with someone else's batch. Hold the db
    lock, wait out any open transaction, then BEGIN."""
    while True:
        with db._lock:
            conn = getattr(db, "_conn", None)  # PySqliteDatabase
            open_txn = getattr(db, "_in_txn", False) or bool(conn is not None and conn.in_transaction)
            if not open_txn:
                with db.transaction():
                    yield db
                return
        time.sleep(0.002)


# --- framing ---


def _frame_message(ts: str, uid: str, content: bytes) -> bytes:
    t, u = ts.encode("utf-8"), uid.encode("utf-8")
    return b"".join(
        (bytes((_REC_MESSAGE,)), _U32.pack(len(t)), t, _U32.pack(len(u)), u,
         _U32.pack(len(content)), content)
    )


def _frame_tree(uid: str, tree: str) -> bytes:
    u, tr = uid.encode("utf-8"), tree.encode("utf-8")
    return b"".join((bytes((_REC_TREE,)), _U32.pack(len(u)), u, _U32.pack(len(tr)), tr))


def _take(data: bytes, pos: int) -> Tuple[bytes, int]:
    if pos + 4 > len(data):
        raise ValueError("truncated snapshot record length")
    (n,) = _U32.unpack_from(data, pos)
    pos += 4
    field = data[pos : pos + n]
    if len(field) != n:
        raise ValueError("truncated snapshot record field")
    return field, pos + n


def _next_record(data: bytes, pos: int) -> Tuple[tuple, int]:
    """One framed record at `pos` → (("M", ts, uid, content) | ("T", uid,
    tree), next_pos). ValueError on malformed framing."""
    t = data[pos]
    if t == _REC_MESSAGE:
        ts, pos = _take(data, pos + 1)
        uid, pos = _take(data, pos)
        content, pos = _take(data, pos)
        return ("M", ts.decode("utf-8"), uid.decode("utf-8"), bytes(content)), pos
    if t == _REC_TREE:
        uid, pos = _take(data, pos + 1)
        tree, pos = _take(data, pos)
        return ("T", uid.decode("utf-8"), tree.decode("utf-8")), pos
    raise ValueError(f"unknown snapshot record type {t:#x}")


def iter_records(data: bytes, pos: int = 0):
    """Yield every framed record in `data`; ValueError on malformed framing
    (the installer treats that like a crc failure)."""
    end = len(data)
    while pos < end:
        rec, pos = _next_record(data, pos)
        yield rec


def _scan_stream(stream: bytes, chunk_bytes: int):
    """One pass over the framed stream: chunks split at record boundaries
    (every chunk parses alone; an oversized record ships as its own chunk),
    the message count and the tree records. → (chunks, message_count,
    [(uid, tree_text), ...])."""
    chunks: List[bytes] = []
    trees: List[Tuple[str, str]] = []
    message_count = 0
    pos = start = 0
    end = len(stream)
    while pos < end:
        rec, nxt = _next_record(stream, pos)
        if rec[0] == "M":
            message_count += 1
        else:
            trees.append((rec[1], rec[2]))
        if pos != start and nxt - start > chunk_bytes:
            chunks.append(stream[start:pos])
            start = pos
        pos = nxt
    if pos > start:
        chunks.append(stream[start:pos])
    return chunks, message_count, trees


# --- capture ---


def _capture_shard_py(db) -> bytes:
    """The stdlib oracle: both SELECTs inside the caller's transaction,
    ordered as the native leg orders them (the message table's primary
    key), so the two are byte-identical."""
    out: List[bytes] = []
    for r in db.exec_sql_query(
        'SELECT "timestamp", "userId", "content" FROM "message" ORDER BY "userId", "timestamp"'
    ):
        content = r["content"]
        out.append(_frame_message(r["timestamp"], r["userId"], content if content is not None else b""))
    for r in db.exec_sql_query('SELECT "userId", "merkleTree" FROM "merkleTree" ORDER BY "userId"'):
        out.append(_frame_tree(r["userId"], r["merkleTree"]))
    return b"".join(out)


def capture_shard(db) -> bytes:
    """One shard's framed rows: the native one-call leg where the backend
    has it, else the stdlib oracle. The caller holds the transaction."""
    if hasattr(db, "snapshot_rows"):
        return db.snapshot_rows()
    return _capture_shard_py(db)


def _shards_of(store) -> Sequence:
    return getattr(store, "shards", None) or [store]


def _filter_stream(stream: bytes, owners) -> bytes:
    """Keep only `owners`' records (the fleet's O(moved owners) transfer:
    the capture stays O(store), but nothing else is chunked or shipped)."""
    wanted = set(owners)
    out: List[bytes] = []
    pos = 0
    end = len(stream)
    while pos < end:
        rec, nxt = _next_record(stream, pos)
        uid = rec[2] if rec[0] == "M" else rec[1]
        if uid in wanted:
            out.append(stream[pos:nxt])
        pos = nxt
    return b"".join(out)


def _scope_stream(store, stream: bytes, watermark_millis: int, tags: Tuple[str, ...]) -> bytes:
    """Re-frame a captured stream down to a SLICE: keep the message rows
    the scope filter matches (`server/scope.py`'s membership: past the
    watermark, lane not provably excluded) and REGENERATE every shipped
    owner's tree record from exactly the kept rows with the host fold, so
    the installer's recompute-from-rows check passes unchanged."""
    from evolu_tpu_torch.server import scope

    filters: Dict[str, Callable[[str, str], bool]] = {}  # an owner's slice filter, on its shard
    out: List[bytes] = []
    kept_ts: Dict[str, List[str]] = {}
    pos, end = 0, len(stream)
    while pos < end:
        rec, nxt = _next_record(stream, pos)
        if rec[0] == "M":
            _kind, ts, uid, _content = rec
            keep = filters.get(uid)
            if keep is None:
                shard = store.shard_of(uid) if hasattr(store, "shard_of") else _shards_of(store)[0]
                keep = filters[uid] = scope.scoped_snapshot_filter(shard.db, None, watermark_millis, tags)
            if keep(uid, ts):
                out.append(stream[pos:nxt])
                kept_ts.setdefault(uid, []).append(ts)
        # "T" records are dropped: regenerated from the kept rows below.
        pos = nxt
    for uid in sorted(kept_ts):
        deltas, _digest = minute_deltas_host(kept_ts[uid])
        out.append(_frame_tree(uid, merkle_tree_to_string(apply_prefix_xors({}, deltas))))
    return b"".join(out)


def capture_snapshot(
    store, chunk_bytes: int = SNAPSHOT_CHUNK_BYTES,
    snapshot_id: Optional[str] = None,
    owners=None,
    watermark_millis: int = 0,
    tags: Tuple[str, ...] = (),
) -> Tuple[protocol.SnapshotManifest, List[bytes]]:
    """→ (manifest, chunks). Consistent per shard (one transaction each):
    an owner lives wholly in one shard, so its rows and tree agree, which
    is what the install verifies. `owners` scopes the snapshot to those
    owners (fleet rebalance); None = the whole store. `watermark_millis` /
    `tags` scope it to a slice (`_scope_stream`): its trees ship recomputed
    over the slice."""
    parts: List[bytes] = []
    for shard in _shards_of(store):
        db = shard.db
        with _exclusive_txn(db):
            parts.append(capture_shard(db))
    stream = b"".join(parts)
    if owners is not None:
        stream = _filter_stream(stream, owners)
    if watermark_millis or tags:
        stream = _scope_stream(store, stream, watermark_millis, tuple(tags))
        _count("scoped_captures")
    chunks, message_count, tree_recs = _scan_stream(stream, chunk_bytes)
    owner_digests: List[Tuple[str, int, int]] = []
    for uid, tree in tree_recs:
        root = merkle_tree_from_string(tree).get("hash") or 0
        owner_digests.append((uid, int(root), zlib.crc32(tree.encode("utf-8"))))
    owner_digests.sort()
    manifest = protocol.SnapshotManifest(
        snapshot_id or uuid.uuid4().hex,
        tuple(len(c) for c in chunks),
        tuple(zlib.crc32(c) for c in chunks),
        tuple(owner_digests),
        message_count,
        len(stream),
    )
    _count("captures")
    _count("capture_rows", message_count)
    _count("capture_bytes", len(stream))
    return manifest, chunks


# --- donor-side snapshot cache + endpoint bodies ---


class SnapshotCache:
    """Keeps recent captures servable for resumable chunk fetches. An
    unexpired capture with the same chunk size and scope is reused;
    entries expire after `ttl_s` and at most `max_entries` are kept
    (oldest evicted). Post-capture writes reach peers by gossip from the
    watermark."""

    def __init__(self, store, chunk_bytes: int = SNAPSHOT_CHUNK_BYTES,
                 ttl_s: float = SNAPSHOT_TTL_S, max_entries: int = 2,
                 clock=time.monotonic):
        self._store = store
        self.chunk_bytes = int(chunk_bytes)
        self._ttl_s = float(ttl_s)
        self._max_entries = int(max_entries)
        self._clock = clock
        self._lock = threading.Lock()
        # id -> (expires_at, chunk_bytes, owners_key, scope_key, manifest, chunks)
        self._entries: Dict[str, tuple] = {}

    def _clamp(self, requested: int) -> int:
        cb = requested or self.chunk_bytes
        return max(SNAPSHOT_MIN_CHUNK_BYTES, min(int(cb), SNAPSHOT_MAX_CHUNK_BYTES))

    def manifest(self, requested_chunk_bytes: int = 0, owners=None, watermark_millis: int = 0,
                 tags: Tuple[str, ...] = ()) -> protocol.SnapshotManifest:
        """Entries are keyed by chunk size, owner set and scope, so
        differently scoped snapshots never serve each other's chunks."""
        cb = self._clamp(requested_chunk_bytes)
        owners_key = None if owners is None else frozenset(owners)
        scope_key = (int(watermark_millis), frozenset(tags))
        with self._lock:
            now = self._clock()
            self._entries = {k: v for k, v in self._entries.items() if v[0] > now}
            for _exp, entry_cb, entry_ok, entry_sk, manifest, _chunks in self._entries.values():
                if entry_cb == cb and entry_ok == owners_key and entry_sk == scope_key:
                    return manifest
        # Capture outside the lock: chunk() stays servable while a capture
        # runs. Two racing first misses may both capture; both are served.
        manifest, chunks = capture_snapshot(self._store, cb, owners=owners,
                                            watermark_millis=watermark_millis, tags=tags)
        with self._lock:
            while len(self._entries) >= self._max_entries:
                oldest = min(self._entries, key=lambda k: self._entries[k][0])
                del self._entries[oldest]
            self._entries[manifest.snapshot_id] = (
                self._clock() + self._ttl_s, cb, owners_key, scope_key, manifest, chunks)
        return manifest

    def chunk(self, snapshot_id: str, index: int) -> protocol.SnapshotChunk:
        with self._lock:
            entry = self._entries.get(snapshot_id)
            if entry is not None and entry[0] <= self._clock():
                del self._entries[snapshot_id]
                entry = None
            if entry is None:
                # ValueError → 400: the puller drops its install and restarts.
                raise ValueError(f"unknown or expired snapshot {snapshot_id!r}")
            _exp, _cb, _ok, _sk, manifest, chunks = entry
        if not 0 <= index < len(chunks):
            raise ValueError(f"snapshot chunk index {index} out of range 0..{len(chunks) - 1}")
        return protocol.SnapshotChunk(snapshot_id, index, manifest.chunk_crcs[index], chunks[index])


def serve_snapshot(store, body: bytes, manager) -> bytes:
    """Handler body for `POST /replicate/snapshot`: capture (or reuse a
    cached capture) and answer the manifest. ValueError only on malformed
    input (→ 400)."""
    req = protocol.decode_snapshot_request(body)
    manifest = manager.snapshot_cache.manifest(
        req.chunk_bytes, owners=req.owners or None,
        watermark_millis=req.watermark_millis, tags=req.tags,
    )
    _count("manifests_served")
    return protocol.encode_snapshot_manifest(manifest)


def serve_snapshot_chunk(store, body: bytes, manager) -> bytes:
    """Handler body for `POST /replicate/snapshot/chunk`: one resumable
    chunk. Unknown or expired ids and out-of-range indices raise
    ValueError (→ 400, the puller's restart signal)."""
    req = protocol.decode_snapshot_chunk_request(body)
    chunk = manager.snapshot_cache.chunk(req.snapshot_id, req.index)
    _count("chunks_served")
    _count("chunk_bytes_served", len(chunk.payload))
    return protocol.encode_snapshot_chunk(chunk)


# --- crash-consistent install ---


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


class SnapshotInstaller:
    """Installs a snapshot into side tables of the live store with a
    persisted chunk watermark, then verifies and swaps. All state (side
    tables and the `snapshotBootstrapState` table on shard 0) lives in the
    store's own SQLite files, so a killed process resumes from the last
    committed watermark."""

    def __init__(self, store):
        self.store = store
        self.shards = _shards_of(store)
        self._state_db = self.shards[0].db
        self._state_db.exec(
            'CREATE TABLE IF NOT EXISTS "snapshotBootstrapState" '
            '("key" TEXT PRIMARY KEY, "value" TEXT)'
        )

    # -- persisted state --

    def _state_get(self) -> Dict[str, str]:
        rows = self._state_db.exec_sql_query('SELECT "key", "value" FROM "snapshotBootstrapState"')
        return {r["key"]: r["value"] for r in rows}

    def _state_set(self, **kv) -> None:
        db = self._state_db
        with _exclusive_txn(db):
            for k, v in kv.items():
                db.run('INSERT OR REPLACE INTO "snapshotBootstrapState" ("key", "value") VALUES (?, ?)',
                       (k, str(v)))

    def _state_clear(self) -> None:
        self._state_db.run('DELETE FROM "snapshotBootstrapState"')

    def pending(self) -> Optional[dict]:
        """The persisted install in progress, if any: {snapshot_id, peer,
        manifest, next_chunk, phase}. Undecodable state clears itself."""
        st = self._state_get()
        if not st or "manifest" not in st:
            return None
        try:
            manifest = protocol.decode_snapshot_manifest(bytes.fromhex(st["manifest"]))
            return {
                "snapshot_id": st["snapshot_id"],
                "peer": st.get("peer", ""),
                "manifest": manifest,
                "next_chunk": int(st.get("next_chunk", 0)),
                "phase": st.get("phase", "fetch"),
            }
        except (ValueError, KeyError):
            self._state_clear()
            return None

    # -- install steps --

    def begin(self, manifest: protocol.SnapshotManifest, peer: str) -> None:
        for shard in self.shards:
            db = shard.db
            with _exclusive_txn(db):
                db.run('DROP TABLE IF EXISTS "messageBsnap"')
                db.run('DROP TABLE IF EXISTS "merkleTreeBsnap"')
                db.run(_MESSAGE_SCHEMA)
                db.run(_TREE_SCHEMA)
        self._state_set(
            snapshot_id=manifest.snapshot_id,
            peer=peer,
            manifest=protocol.encode_snapshot_manifest(manifest).hex(),
            next_chunk=0,
            phase="fetch",
        )

    def _shard_db(self, uid: str):
        if hasattr(self.store, "shard_of"):
            return self.store.shard_of(uid).db
        return self.shards[0].db

    def install_chunk(self, index: int, payload: bytes, expected_crc: Optional[int] = None) -> int:
        """Parse one chunk and commit its rows into the side tables, one
        transaction a destination shard, then the watermark. Re-applying a
        chunk is idempotent (same keys, INSERT OR IGNORE / OR REPLACE).
        Returns the number of message rows."""
        if expected_crc is not None and zlib.crc32(payload) != expected_crc:
            raise SnapshotInstallError(
                f"snapshot chunk {index}: crc mismatch ({zlib.crc32(payload):08x} != {expected_crc:08x})")
        by_shard: Dict[int, Tuple[list, list]] = {}
        n_msgs = 0
        try:
            for rec in iter_records(payload):
                uid = rec[2] if rec[0] == "M" else rec[1]
                si = self.store.shard_index(uid) if hasattr(self.store, "shard_index") else 0
                msgs, trees = by_shard.setdefault(si, ([], []))
                if rec[0] == "M":
                    msgs.append((rec[1], rec[2], rec[3]))
                    n_msgs += 1
                else:
                    trees.append((rec[1], rec[2]))
        except ValueError as e:
            raise SnapshotInstallError(f"snapshot chunk {index}: {e}") from e
        for si, (msgs, trees) in sorted(by_shard.items()):
            db = self.shards[si].db
            with _exclusive_txn(db):
                if msgs:
                    db.run_many('INSERT OR IGNORE INTO "messageBsnap" ("timestamp", "userId", "content") '
                                "VALUES (?, ?, ?)", msgs)
                if trees:
                    db.run_many('INSERT OR REPLACE INTO "merkleTreeBsnap" ("userId", "merkleTree") '
                                "VALUES (?, ?)", trees)
        self._state_set(next_chunk=index + 1)
        return n_msgs

    def verify(self, manifest: protocol.SnapshotManifest) -> None:
        """Golden-parity gate: recompute every owner's Merkle tree from the
        installed rows on the host and demand byte-identity with the
        shipped tree text and the manifest's watermarks, and exact owner
        set and row count. Any mismatch raises before the live tables are
        touched."""
        shipped: Dict[str, str] = {}
        total = 0
        for shard in self.shards:
            for r in shard.db.exec_sql_query('SELECT "userId", "merkleTree" FROM "merkleTreeBsnap"'):
                shipped[r["userId"]] = r["merkleTree"]
            total += shard.db.exec_sql_query('SELECT COUNT(*) AS n FROM "messageBsnap"')[0]["n"]
        by_owner = {uid: (root, crc) for uid, root, crc in manifest.owners}
        if set(shipped) != set(by_owner):
            raise SnapshotInstallError(
                f"snapshot owner set mismatch: manifest has {len(by_owner)} owners, "
                f"stream delivered {len(shipped)}")
        if total != manifest.message_count:
            raise SnapshotInstallError(
                f"snapshot row count mismatch: manifest says {manifest.message_count}, installed {total}")
        for uid, tree_text in shipped.items():
            db = self._shard_db(uid)
            ts = [r["timestamp"] for r in db.exec_sql_query(
                'SELECT "timestamp" FROM "messageBsnap" WHERE "userId" = ?', (uid,))]
            deltas, _digest = minute_deltas_host(ts)
            recomputed = merkle_tree_to_string(apply_prefix_xors({}, deltas))
            root, crc = by_owner[uid]
            if (
                recomputed != tree_text
                or zlib.crc32(recomputed.encode("utf-8")) != crc
                or (merkle_tree_from_string(recomputed).get("hash") or 0) != root
            ):
                metrics.inc("evolu_snap_verify_failures_total")
                raise SnapshotInstallError(
                    f"snapshot tree verification failed for owner {uid!r}: recomputed tree is not "
                    "byte-identical to the manifest watermark")

    def _merge_live_rows_locked(self, db) -> int:
        """Inside an exclusive transaction already held on `db`: fold every
        live row the snapshot lacks into the side tables through the
        changes==1 XOR gate, so a lagging peer keeps rows the donor never
        had and a client write accepted during the install survives the
        swap. The swapped-in trees stay exact unions."""
        merged = 0
        owners = [r["userId"] for r in db.exec_sql_query('SELECT DISTINCT "userId" FROM "message"')]
        for uid in owners:
            # One anti-join names exactly the rows the snapshot lacks (both
            # tables are unique on (userId, timestamp)), then one insert.
            fresh_rows = db.exec_sql_query(
                'SELECT "timestamp", "content" FROM "message" AS m '
                'WHERE "userId" = ? AND NOT EXISTS ('
                'SELECT 1 FROM "messageBsnap" AS b '
                'WHERE b."userId" = m."userId" AND b."timestamp" = m."timestamp")',
                (uid,),
            )
            if not fresh_rows:
                continue
            db.run_many('INSERT OR IGNORE INTO "messageBsnap" ("timestamp", "userId", "content") '
                        "VALUES (?, ?, ?)", [(r["timestamp"], uid, r["content"]) for r in fresh_rows])
            got = db.exec_sql_query('SELECT "merkleTree" FROM "merkleTreeBsnap" WHERE "userId" = ?', (uid,))
            tree = merkle_tree_from_string(got[0]["merkleTree"] if got else "{}")
            deltas, _d = minute_deltas_host([r["timestamp"] for r in fresh_rows])
            db.run('INSERT OR REPLACE INTO "merkleTreeBsnap" ("userId", "merkleTree") VALUES (?, ?)',
                   (uid, merkle_tree_to_string(apply_prefix_xors(tree, deltas))))
            merged += len(fresh_rows)
        return merged

    def swap(self) -> None:
        """Mark phase=swap, then swap every shard. The marker makes a crash
        between shard swaps resumable (`finish_swap` skips shards already
        swapped)."""
        self._state_set(phase="swap")
        self.finish_swap()

    def finish_swap(self) -> None:
        """Per shard, in one exclusive transaction: merge the live rows the
        snapshot lacks, then DROP + RENAME. Everything a client wrote up to
        the rename's commit is in the snapshot or merged here.

        The ledger: snapshot rows enter this process when they go live (the
        swap's commit), and the live-vs-snapshot overlap classifies them, a
        row the store already held as store.duplicate and the rest as
        store.inserted. One pending entry, posted after every shard of THIS
        run swapped (a resumed run posts only the shards it swaps)."""
        merged = 0
        entry = ledger.pending()
        for shard in self.shards:
            db = shard.db
            with _exclusive_txn(db):
                have = db.exec_sql_query(
                    "SELECT name FROM sqlite_master WHERE type='table' AND name='messageBsnap'")
                if not have:
                    continue  # this shard already swapped (resume)
                snap_total = db.exec_sql_query('SELECT COUNT(*) AS n FROM "messageBsnap"')[0]["n"]
                overlap = db.exec_sql_query(
                    'SELECT COUNT(*) AS n FROM "message" AS m WHERE EXISTS (SELECT 1 FROM "messageBsnap" '
                    'AS b WHERE b."userId" = m."userId" AND b."timestamp" = m."timestamp")')[0]["n"]
                entry.count(ledger.INGRESS_SNAPSHOT, snap_total)
                entry.count(ledger.STORE_INSERTED, snap_total - overlap)
                entry.count(ledger.STORE_DUPLICATE, overlap)
                merged += self._merge_live_rows_locked(db)
                db.run('DROP TABLE "message"')
                db.run('ALTER TABLE "messageBsnap" RENAME TO "message"')
                db.run('DROP TABLE "merkleTree"')
                db.run('ALTER TABLE "merkleTreeBsnap" RENAME TO "merkleTree"')
        entry.commit()
        if merged:
            metrics.inc("evolu_snap_local_rows_merged_total", merged)
        self._state_clear()

    def abort(self) -> None:
        for shard in self.shards:
            db = shard.db
            with _exclusive_txn(db):
                db.run('DROP TABLE IF EXISTS "messageBsnap"')
                db.run('DROP TABLE IF EXISTS "merkleTreeBsnap"')
        self._state_clear()


def install_stream(store, manifest: protocol.SnapshotManifest, chunks: Iterable[bytes],
                   source: str = "<local>") -> None:
    """Install a fully materialized snapshot (the checkpoint restore; the
    network bootstrap drives `SnapshotInstaller` itself so it can persist
    the watermark between fetches)."""
    inst = SnapshotInstaller(store)
    inst.begin(manifest, source)
    t0 = time.perf_counter()
    try:
        for i, payload in enumerate(chunks):
            inst.install_chunk(i, payload, expected_crc=manifest.chunk_crcs[i])
        inst.verify(manifest)
    except BaseException:
        inst.abort()
        raise
    inst.swap()
    metrics.observe("evolu_snap_install_ms", (time.perf_counter() - t0) * 1e3)
    metrics.inc("evolu_snap_installs_total", result="ok")


# --- local checkpoints ---

CHECKPOINT_MAGIC = b"EVOLUSNAP1\n"


def write_checkpoint(store, path: str, chunk_bytes: int = SNAPSHOT_CHUNK_BYTES,
                     barrier=None) -> protocol.SnapshotManifest:
    """Capture the store and atomically replace the checkpoint file (tmp +
    fsync + rename, then fsync the directory): the file is always a
    complete, crc-covered snapshot or absent. `barrier` is an optional
    context-manager factory held across the capture."""
    if barrier is not None:
        with barrier():
            manifest, chunks = capture_snapshot(store, chunk_bytes)
    else:
        manifest, chunks = capture_snapshot(store, chunk_bytes)
    blob = protocol.encode_snapshot_manifest(manifest)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(CHECKPOINT_MAGIC)
        f.write(_U32.pack(len(blob)))
        f.write(blob)
        for c in chunks:
            f.write(c)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    dir_fd = os.open(os.path.dirname(os.path.abspath(path)) or ".", os.O_RDONLY)
    try:
        os.fsync(dir_fd)
    finally:
        os.close(dir_fd)
    _count("checkpoints")
    metrics.set_gauge("evolu_snap_checkpoint_bytes", manifest.total_bytes)
    return manifest


def read_checkpoint(path: str) -> Tuple[protocol.SnapshotManifest, List[bytes]]:
    """→ (manifest, chunks), crc-verified. ValueError on any corruption: a
    torn or tampered checkpoint never half-installs."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(CHECKPOINT_MAGIC):
        raise ValueError(f"not an evolu snapshot checkpoint: {path!r}")
    pos = len(CHECKPOINT_MAGIC)
    if pos + 4 > len(data):
        raise ValueError("truncated checkpoint header")
    (n,) = _U32.unpack_from(data, pos)
    pos += 4
    manifest = protocol.decode_snapshot_manifest(data[pos : pos + n])
    pos += n
    chunks: List[bytes] = []
    for i, size in enumerate(manifest.chunk_sizes):
        payload = data[pos : pos + size]
        if len(payload) != size:
            raise ValueError(f"truncated checkpoint chunk {i}")
        if zlib.crc32(payload) != manifest.chunk_crcs[i]:
            raise ValueError(f"checkpoint chunk {i} crc mismatch")
        chunks.append(payload)
        pos += size
    if pos != len(data):
        raise ValueError("trailing bytes after the last checkpoint chunk")
    return manifest, chunks


def restore_checkpoint(store, path: str) -> protocol.SnapshotManifest:
    """Rebuild a store from a checkpoint through the same install and
    verify a peer bootstrap uses. Rows already in the store merge through
    the XOR gate."""
    manifest, chunks = read_checkpoint(path)
    install_stream(store, manifest, chunks, source=f"checkpoint:{path}")
    return manifest


class CheckpointWriter:
    """Periodic local checkpoints (`RelayServer(checkpoint_interval_s=...)`).
    Failures are counted, never fatal: the previous checkpoint stays
    valid."""

    def __init__(self, store, path: str, interval_s: float,
                 chunk_bytes: int = SNAPSHOT_CHUNK_BYTES, barrier=None):
        self.store = store
        self.path = path
        self.interval_s = float(interval_s)
        self.chunk_bytes = int(chunk_bytes)
        self.barrier = barrier
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "CheckpointWriter":
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, daemon=True, name="evolu-checkpoint")
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                write_checkpoint(self.store, self.path, self.chunk_bytes, barrier=self.barrier)
            except Exception as e:  # noqa: BLE001 - keep checkpointing
                _count("checkpoint_failures")
                log("server", "checkpoint write failed", path=self.path, error=repr(e))

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None
