"""The relay's store: messages and per-owner Merkle trees in SQLite.

The port's copy of the store half of `evolu_tpu.server.relay`. Same
storage shape and sync pipeline as the reference relay
(apps/server/src/index.ts:64-75, :204-216), same own-message exclusion
(`timestamp NOT LIKE '%' || nodeId`, index.ts:100). The relay is
E2EE-blind: rows are (timestamp, userId, ciphertext).

`add_messages` inserts with per-row was-new flags (the changes==1
Merkle gate) and hashes on the host; the batched many-owner path is
`evolu_tpu_torch.server.engine.BatchReconciler`, which hashes on the
card.

The store opens `storage.native.open_database(path, backend)`: the C++
host layer for "native" (and for "auto" when it builds), whose one-call
insert, reads and response stream the engine's packed ingest uses, or
`PySqliteDatabase` for "python". A scoped request is refused until
scoped sync is ported: it is never served unscoped.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from evolu_tpu_torch.core.merkle import (
    apply_prefix_xors,
    diff_merkle_trees,
    merkle_tree_from_string,
    merkle_tree_to_string,
    minutes_base3,
)
from evolu_tpu_torch.core.murmur import to_int32
from evolu_tpu_torch.core.timestamp import (
    create_sync_timestamp,
    timestamp_from_string,
    timestamp_to_hash,
    timestamp_to_string,
)
from evolu_tpu_torch.core.types import NonCanonicalStoreError
from evolu_tpu_torch.storage.native import open_database
from evolu_tpu_torch.storage.sqlite import configure_shared_file_db
from evolu_tpu_torch.sync import protocol


def refuse_scoped(request: protocol.SyncRequest) -> None:
    """Raise for a scoped request: scoped sync is not ported yet, and a
    scoped request must never be served unscoped."""
    if request.scope is not None:
        raise NotImplementedError(
            "evolu_tpu_torch: scoped sync (sync-scope-v1) is not ported yet")


def fetch_response_stream(db, user_id, node_id, server_tree, client_tree) -> bytes:
    """The encoded SyncResponse `messages` stream for one request from a
    database that serves it in one call: tree diff → since timestamp →
    `db.fetch_relay_messages_wire`. b"" when the trees agree; raises
    NonCanonicalStoreError for a malformed stored row (callers degrade
    that request to the object path)."""
    diff = diff_merkle_trees(server_tree, client_tree)
    if diff is None:
        return b""
    since = timestamp_to_string(create_sync_timestamp(diff))
    stream, _n = db.fetch_relay_messages_wire(user_id, since, node_id)
    return stream


def serve_single_request(store, request: protocol.SyncRequest) -> bytes:
    """The per-request serve: the store's fused wire path where it has
    one, else the object pipeline and the encoder. The batched engine's
    responses are byte-identical to this."""
    refuse_scoped(request)
    out = store.sync_wire(request) if hasattr(store, "sync_wire") else None
    if out is None:
        out = protocol.encode_sync_response(store.sync(request))
    return out


class RelayStore:
    """Message + Merkle storage for many users (index.ts:60-105)."""

    def __init__(self, path: str = ":memory:", backend: str = "auto"):
        self.db = open_database(path, backend)
        # File-backed stores may be shared across processes.
        configure_shared_file_db(self.db)
        # The reference's uniqueness pair (timestamp, userId), keyed
        # userId first and WITHOUT ROWID, so get_messages is a primary-key
        # range read; INSERT OR IGNORE dedups on the same pair.
        self.db.exec(
            'CREATE TABLE IF NOT EXISTS "message" ('
            '"timestamp" TEXT, "userId" TEXT, "content" BLOB, '
            'PRIMARY KEY ("userId", "timestamp")) WITHOUT ROWID'
        )
        self.db.exec(
            'CREATE TABLE IF NOT EXISTS "merkleTree" ('
            '"userId" TEXT PRIMARY KEY, "merkleTree" TEXT)'
        )

    def get_merkle_tree(self, user_id: str) -> dict:
        """index.ts:121-136 — a user's tree, empty if unseen."""
        return merkle_tree_from_string(self.get_merkle_tree_string(user_id))

    def add_messages(
        self, user_id: str, messages: Sequence[protocol.EncryptedCrdtMessage]
    ) -> dict:
        """index.ts:138-171 — INSERT OR IGNORE each message; XOR only
        *newly inserted* timestamps into the tree (the server gates on
        changes==1, unlike the client's always-XOR). One transaction;
        returns the updated tree."""
        with self.db.transaction():
            tree = self.get_merkle_tree(user_id)
            deltas: Dict[str, int] = {}
            if hasattr(self.db, "relay_insert"):
                # C++ backend: one bulk insert with per-row was-new flags.
                new_flags = self.db.relay_insert(
                    [(m.timestamp, user_id, m.content) for m in messages]
                )
            else:
                new_flags = [
                    self.db.run(
                        'INSERT OR IGNORE INTO "message" ("timestamp", "userId", "content") '
                        "VALUES (?, ?, ?)",
                        (m.timestamp, user_id, m.content),
                    ) == 1
                    for m in messages
                ]
            for m, was_new in zip(messages, new_flags):
                if was_new:
                    t = timestamp_from_string(m.timestamp)
                    key = minutes_base3(t.millis)
                    deltas[key] = to_int32(deltas.get(key, 0) ^ timestamp_to_hash(t))
            tree = apply_prefix_xors(tree, deltas)
            self.db.run(
                'INSERT OR REPLACE INTO "merkleTree" ("userId", "merkleTree") VALUES (?, ?)',
                (user_id, merkle_tree_to_string(tree)),
            )
        return tree

    def get_messages(
        self, user_id: str, node_id: str, server_tree: dict, client_tree: dict
    ) -> Tuple[protocol.EncryptedCrdtMessage, ...]:
        """index.ts:173-202 — if the trees diverge, everything after the
        diff minute except the requester's own messages."""
        diff = diff_merkle_trees(server_tree, client_tree)
        if diff is None:
            return ()
        since = timestamp_to_string(create_sync_timestamp(diff))
        if hasattr(self.db, "fetch_relay_messages"):
            # C++ backend: one packed call. The query text lives in
            # native/evolu_host.cpp::eh_get_messages and below too.
            try:
                rows = self.db.fetch_relay_messages(user_id, since, node_id)
                return tuple(protocol.EncryptedCrdtMessage(t, c) for t, c in rows)
            except NonCanonicalStoreError:
                pass  # a malformed stored width degrades to the SQL path
        rows = self.db.exec_sql_query(
            'SELECT "timestamp", "content" FROM "message" '
            'WHERE "userId" = ? AND "timestamp" > ? AND "timestamp" NOT LIKE \'%\' || ? '
            'ORDER BY "timestamp"',
            (user_id, since, node_id),
        )
        return tuple(
            protocol.EncryptedCrdtMessage(r["timestamp"], r["content"]) for r in rows
        )

    def get_merkle_tree_string(self, user_id: str) -> str:
        """The stored tree TEXT verbatim (response paths reuse it instead
        of a parse and a re-dump)."""
        rows = self.db.exec_sql_query(
            'SELECT "merkleTree" FROM "merkleTree" WHERE "userId" = ?', (user_id,)
        )
        return rows[0]["merkleTree"] if rows else "{}"

    def owner_trees(self) -> List[Tuple[str, str]]:
        """Every (owner, stored tree TEXT) pair in one query."""
        rows = self.db.exec_sql_query('SELECT "userId", "merkleTree" FROM "merkleTree"')
        return [(r["userId"], r["merkleTree"]) for r in rows]

    def replica_messages(
        self, user_id: str, since: str, limit: Optional[int] = None
    ) -> Tuple[protocol.EncryptedCrdtMessage, ...]:
        """Stored messages strictly after `since` in timestamp order (the
        earliest `limit` of them when capped), WITHOUT the own-node
        exclusion of `get_messages`: the read a peer relay replicates."""
        rows = self.db.exec_sql_query(
            'SELECT "timestamp", "content" FROM "message" '
            'WHERE "userId" = ? AND "timestamp" > ? ORDER BY "timestamp" LIMIT ?',
            (user_id, since, -1 if limit is None else int(limit)),
        )
        return tuple(
            protocol.EncryptedCrdtMessage(r["timestamp"], r["content"]) for r in rows
        )

    def sync(self, request: protocol.SyncRequest) -> protocol.SyncResponse:
        """The pure pipeline (index.ts:204-216)."""
        tree = self.add_messages(request.user_id, request.messages)
        client_tree = merkle_tree_from_string(request.merkle_tree)
        messages = self.get_messages(request.user_id, request.node_id, tree, client_tree)
        return protocol.SyncResponse(messages, merkle_tree_to_string(tree))

    def sync_wire(self, request: protocol.SyncRequest) -> Optional[bytes]:
        """`sync` + `encode_sync_response` fused, where the database serves
        the messages stream in one call (the C++ backend); byte-identical
        to the pure pipeline. None → the caller takes the object path
        (always, on `PySqliteDatabase`)."""
        if not hasattr(self.db, "fetch_relay_messages_wire"):
            return None
        tree = self.add_messages(request.user_id, request.messages)
        client_tree = merkle_tree_from_string(request.merkle_tree)
        try:
            stream = fetch_response_stream(
                self.db, request.user_id, request.node_id, tree, client_tree
            )
        except NonCanonicalStoreError:
            # add_messages above was idempotent, so the caller's sync()
            # re-run is safe.
            return None
        return stream + protocol._string(2, self.get_merkle_tree_string(request.user_id))

    def user_ids(self) -> List[str]:
        return [r["userId"] for r in self.db.exec_sql_query('SELECT "userId" FROM "merkleTree"')]

    def stats(self) -> List[dict]:
        """Row counts (one entry; ShardedRelayStore gives one a shard)."""
        messages = self.db.exec_sql_query('SELECT COUNT(*) AS n FROM "message"')
        users = self.db.exec_sql_query('SELECT COUNT(*) AS n FROM "merkleTree"')
        return [{"index": 0, "messages": messages[0]["n"], "users": users[0]["n"]}]

    def close(self) -> None:
        self.db.close()


class ShardedRelayStore:
    """Owner-sharded relay storage: N independent SQLite stores, userId
    routed to a shard by a stable hash. Same public surface as
    RelayStore; a request only ever touches its owner's shard."""

    def __init__(self, path: str = ":memory:", backend: str = "auto", shards: int = 8):
        paths = (
            [":memory:"] * shards
            if path == ":memory:"
            else [f"{path}.s{i:02d}" for i in range(shards)]
        )
        self.shards = [RelayStore(p, backend) for p in paths]

    def shard_index(self, user_id: str) -> int:
        import zlib

        return zlib.crc32(user_id.encode("utf-8")) % len(self.shards)

    def shard_of(self, user_id: str) -> RelayStore:
        return self.shards[self.shard_index(user_id)]

    def get_merkle_tree(self, user_id: str) -> dict:
        return self.shard_of(user_id).get_merkle_tree(user_id)

    def get_merkle_tree_string(self, user_id: str) -> str:
        return self.shard_of(user_id).get_merkle_tree_string(user_id)

    def add_messages(self, user_id, messages) -> dict:
        return self.shard_of(user_id).add_messages(user_id, messages)

    def get_messages(self, user_id, node_id, server_tree, client_tree):
        return self.shard_of(user_id).get_messages(user_id, node_id, server_tree, client_tree)

    def sync(self, request: protocol.SyncRequest) -> protocol.SyncResponse:
        return self.shard_of(request.user_id).sync(request)

    def sync_wire(self, request: protocol.SyncRequest) -> Optional[bytes]:
        return self.shard_of(request.user_id).sync_wire(request)

    def owner_trees(self) -> List[Tuple[str, str]]:
        return [p for s in self.shards for p in s.owner_trees()]

    def replica_messages(self, user_id: str, since: str, limit: Optional[int] = None):
        return self.shard_of(user_id).replica_messages(user_id, since, limit)

    def user_ids(self) -> List[str]:
        return [u for s in self.shards for u in s.user_ids()]

    def stats(self) -> List[dict]:
        return [{**s.stats()[0], "index": i} for i, s in enumerate(self.shards)]

    def close(self) -> None:
        for s in self.shards:
            s.close()
