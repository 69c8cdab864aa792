"""The relay: store, sync pipeline and HTTP endpoint.

The port's copy of `evolu_tpu.server.relay`. Same storage shape and sync
pipeline as the reference relay (apps/server/src/index.ts:64-75,
:204-216), same own-message exclusion (`timestamp NOT LIKE '%' ||
nodeId`, index.ts:100), same 20 MB body limit (index.ts:222) and `GET
/ping` (index.ts:250-252). The relay is E2EE-blind: rows are (timestamp,
userId, ciphertext).

`RelayServer` serves POST `/`, GET `/ping`, `/health`, `/stats` and the
push long-poll GET `/push/poll` (`server/push.py`, on by default), on a
ThreadingHTTPServer or on the event-loop tier (`server/conn.py`,
`connection_tier="eventloop"`); `batching=True` routes sync POSTs through
the continuous-batching `server.scheduler.SyncScheduler`, whose engine
passes run on `device` (None = the card). `peers` turns on relay↔relay
Merkle anti-entropy (`server/replicate.py`, POST `/replicate/*`, with
snapshot bootstrap and checkpoints from `server/snapshot.py`), and
`enable_fleet` joins an owner-sharded fleet (`server/fleet.py`: GET
`/fleet`, POST `/fleet/forward` and `/fleet/reload`, 307 / forward
routing). `write_behind=True` turns on the write-behind storage inversion
(`storage/write_behind.py`: batches answer from in-memory trees, ACK into
an fsync'd record log, and drain workers materialize SQLite later).
`MultiprocessRelay` pre-forks worker processes (`python -m
evolu_tpu_torch.server.relay_worker`) that serve the per-request host path
over one shared file-backed store. `/replicate/*`, `/fleet*` and
`/push/poll` answer 404 on a relay without replication, a fleet or a push
hub.

Observability (`evolu_tpu_torch.obs`): GET `/metrics` (Prometheus v0.0.4
text from the process registry), `/stats` (with `latency_ms` and the stage
anatomy's `stages`), `/trace` and `/trace/<id>` (the span tree of one
trace; `?format=chrome` for the Chrome-trace export) and `/profile?ms=N`
(a torch.profiler capture of live traffic, with a CUDA device lane once
the process has initialised CUDA and called `prepare_device_profiler()`
on its main thread, merged with the logger's and the trace's spans into
one Chrome-trace document; a second concurrent capture answers 429). With `EVOLU_OBS_TOKEN` set they answer 403 unless the
`X-Evolu-Obs-Token` header matches. `/ledger` answers 404: no module of
the port counts into the conservation ledger yet.

`add_messages` inserts with per-row was-new flags (the changes==1
Merkle gate) and hashes on the host; the batched many-owner path is
`evolu_tpu_torch.server.engine.BatchReconciler`, which hashes on the
card.

The store opens `storage.native.open_database(path, backend)`: the C++
host layer for "native" (and for "auto" when it builds), whose one-call
insert, reads and response stream the engine's packed ingest uses, or
`PySqliteDatabase` for "python". A scoped request (a `ScopeClause`,
negotiated through `sync-scope-v1`) ingests as any other and is answered
from its scoped Merkle subtree (`server/scope.py`), whose fold runs on the
relay's `device`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from contextlib import nullcontext
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
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
from evolu_tpu_torch.obs import anatomy, flight, ledger, metrics, trace
from evolu_tpu_torch.storage.native import open_database
from evolu_tpu_torch.storage.sqlite import configure_shared_file_db
from evolu_tpu_torch.sync import aead, protocol
from evolu_tpu_torch.utils.log import log

MAX_BODY_BYTES = 20 * 1024 * 1024  # index.ts:222

# The capabilities a port relay echoes by default: the reference's.
DEFAULT_CAPABILITIES = protocol.KNOWN_CAPABILITIES

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _count_ingest_mix(messages) -> None:
    """The relay's ingest by wire format (the relay stays E2EE-blind: the
    3-byte version magic is framing, not content). Called on the SERVING
    relay after a successful serve, so each message counts once."""
    if not messages:
        return
    n_v2 = aead.count_v2(messages)
    if n_v2:
        metrics.inc("evolu_crypto_v2_relay_messages_total", n_v2)
    if n_v2 < len(messages):
        metrics.inc("evolu_crypto_v1_relay_messages_total", len(messages) - n_v2)


# Per-thread serve scope (see serve_single_request): one pending ledger
# entry a request, committed only when the serve answers, so a serve that
# commits the store and then fails posts nothing, and the object-path
# fallback's second ingest cannot classify the same messages twice.
_SERVE_SCOPE = threading.local()


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


def _notify_tags(request: protocol.SyncRequest):
    """Lane tags for a push wakeup: the scope clause's per-message lane
    assignment, when the pushing client sent one. None (= wake every
    waiter) whenever lanes are unknown: v1 pushes, scoped pulls with no
    pushed rows, untagged rows mixed in."""
    s = getattr(request, "scope", None)
    if s is None or not s.push_tags:
        return None
    tags = frozenset(s.push_tags)
    return None if "" in tags else tags


def serve_single_request(store, request: protocol.SyncRequest, device=None) -> bytes:
    """The per-request serve: the store's fused wire path where it has
    one, else the object pipeline and the encoder. The batched engine's
    responses are byte-identical to this. A scoped request ingests through
    `store.add_messages` and is answered by `scope.serve_scoped`, never on
    the fused wire path (its per-row lane filter cannot ride it); its fold
    runs on `device` (None = the card). The whole serve runs under one
    ledger scope (`_SERVE_SCOPE`), committed when it answers."""
    scope_state = {"entry": ledger.pending(), "classified": False}
    _SERVE_SCOPE.scope = scope_state
    try:
        if request.scope is not None:
            from evolu_tpu_torch.server import scope

            out = scope.serve_scoped(store, request, device=device)
        else:
            out = store.sync_wire(request) if hasattr(store, "sync_wire") else None
            if out is None:
                out = protocol.encode_sync_response(store.sync(request))
    except BaseException:
        scope_state["entry"].abort()
        raise
    finally:
        _SERVE_SCOPE.scope = None
    scope_state["entry"].commit()
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


# ---- the HTTP relay ------------------------------------------------------------------


class _Counts:
    """The relay's request counts, each also counted in the metrics
    registry (`evolu_relay_requests_total{endpoint="/"}`,
    `evolu_relay_shard_requests_total`, `evolu_relay_errors_total`): sync
    POSTs in all and by storage shard, and error answers (400, 403, 413,
    500). One a server or worker process."""

    def __init__(self):
        self._lock = threading.Lock()
        self.requests = 0
        self.errors = 0
        self.shard_requests: Dict[int, int] = {}

    def request(self) -> None:
        with self._lock:
            self.requests += 1
        metrics.inc("evolu_relay_requests_total", endpoint="/")

    def error(self) -> None:
        with self._lock:
            self.errors += 1
        metrics.inc("evolu_relay_errors_total")

    def shard(self, index: int) -> None:
        with self._lock:
            self.shard_requests[index] = self.shard_requests.get(index, 0) + 1
        metrics.inc("evolu_relay_shard_requests_total", shard=str(index))


def mesh_stats_payload(ctx=None) -> dict:
    """The `mesh` section of GET /stats, read from a
    `parallel.mesh.MeshContext`'s counts (the JAX package reads its
    `evolu_mesh_*` metrics): shards, sharded dispatches, cross-shard
    reduces by kind, and the number of per-shard occupancy and padding
    observations, with their quantiles from the `evolu_mesh_*`
    histograms of the metrics registry. Without a context (the mesh
    engine has not run a batch yet) the counts are zero and `devices` is
    null."""
    from evolu_tpu_torch.parallel.mesh import XDEV_KINDS

    c = ctx.counts if ctx is not None else None

    def dist(name: str) -> dict:
        return {
            "count": c[name] if c else 0,
            "p50": metrics.quantile(f"evolu_mesh_{name}", 0.50),
            "p99": metrics.quantile(f"evolu_mesh_{name}", 0.99),
        }

    return {
        "devices": ctx.n_shards if ctx is not None else None,
        "dispatches_total": c["dispatches"] if c else 0,
        "xdev_reduce_total": {k: (c["xdev_reduce"][k] if c else 0) for k in XDEV_KINDS},
        "shard_rows": dist("shard_rows"),
        "padding_waste_rows": dist("padding_waste_rows"),
    }


def relay_stats_payload(store, counts: _Counts, replication=None, fleet=None,
                        push_hub=None, conn_tier=None, write_behind=None,
                        mesh_engine: bool = False, mesh_ctx=None) -> dict:
    """The GET /stats JSON: the store's row counts a shard (shared truth in
    a MultiprocessRelay) with this process's sync requests a shard, its
    request and error totals, the request-latency histogram's count and
    quantiles (`latency_ms`) and the stage anatomy (`stages`); with
    replication, a fleet, a push hub, the event-loop tier, a write-behind
    queue or the mesh engine attached, their `replication`, `fleet`,
    `push`, `conn`, `write_behind` and `mesh` sections."""
    shards = store.stats() if hasattr(store, "stats") else []
    for s in shards:
        s["requests"] = counts.shard_requests.get(s["index"], 0)
    payload = {
        "shards": shards,
        "messages": sum(s["messages"] for s in shards),
        "users": sum(s["users"] for s in shards),
        "requests_total": counts.requests,
        "errors_total": counts.errors,
        "latency_ms": {
            "count": (metrics.registry.get_histogram("evolu_relay_request_ms")
                      or (None, None, 0.0, 0))[3],
            "p50": metrics.quantile("evolu_relay_request_ms", 0.50),
            "p99": metrics.quantile("evolu_relay_request_ms", 0.99),
        },
    }
    if replication is not None:
        payload["replication"] = replication.stats_payload()
    if fleet is not None:
        payload["fleet"] = fleet.stats_payload()
    if push_hub is not None:
        payload["push"] = push_hub.stats_payload()
    if conn_tier is not None:
        payload["conn"] = conn_tier.stats_payload()
    if write_behind is not None:
        payload["write_behind"] = write_behind.stats_payload()
    if mesh_engine:
        payload["mesh"] = mesh_stats_payload(mesh_ctx)
    payload["stages"] = anatomy.stages_payload()
    return payload


# GET /profile single-flight: one profiler capture a process; a second
# concurrent request answers 429 instead of racing the first.
_PROFILE_LOCK = threading.Lock()
_PROFILER_READY = False


def prepare_device_profiler() -> bool:
    """Initialise torch.profiler's CUDA tracing (kineto and CUPTI) once a
    process, on the calling thread, which must be the thread that loaded
    torch (the main thread): kineto runs its one-time client init only
    there, and a first CUDA capture on an HTTP handler thread records no
    kernel events. A program that serves GET /profile calls this on its
    main thread before it serves; without it `capture_live_profile` takes
    the device lane only when it runs on the main thread itself. Costs a
    few seconds once (CUPTI's init), so relays do not call it on their
    own. → whether the device lane is ready."""
    global _PROFILER_READY
    if _PROFILER_READY:
        return True
    import torch

    if not torch.cuda.is_available():
        return False
    from torch.profiler import ProfilerActivity, profile

    with _PROFILE_LOCK, profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        pass
    _PROFILER_READY = True
    return True


def _profiler_events(prof, pid: int) -> List[dict]:
    """A finished torch.profiler capture's Chrome-trace events."""
    import tempfile

    fd, path = tempfile.mkstemp(prefix="evolu-profile-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    finally:
        os.unlink(path)
    events = []
    for ev in doc.get("traceEvents", []) if isinstance(doc, dict) else doc:
        # Keep the merged document uniformly loadable: skip bare {} rows,
        # give metadata rows a pid.
        if not isinstance(ev, dict) or not ev.get("ph"):
            continue
        ev.setdefault("pid", pid)
        events.append(ev)
    return events


def capture_live_profile(duration_ms: float) -> dict:
    """Capture `duration_ms` of live traffic as one loadable Chrome-trace
    JSON document (perfetto and chrome://tracing open it). Three lanes
    share the timebase:

    - a torch.profiler capture, taken only when torch is ALREADY loaded
      in this process (a relay that never touched torch stays torch-free),
      with CUDA activity when the process has initialised CUDA and the
      profiler can trace it from this thread (`prepare_device_profiler`):
      the device lane of the kernels every thread launched in the window.
      Span
      annotations (`utils.log.enable_trace_annotations`) are on for the
      window, so `kernel:*` names appear in the profiler timeline too;
    - the logger's span ring, as host-lane complete events;
    - the sampled obs.trace spans of the window (`trace.export_chrome`).

    The capture starts and stops on the calling thread (the caller holds
    `_PROFILE_LOCK`). Never raises on profiler trouble: a failed capture
    degrades to the host lanes with the error in the metadata
    (`torch_error`); `metadata.device_lane` says whether the CUDA lane was
    captured."""
    import sys

    from evolu_tpu_torch.utils import log as log_mod

    t_start = time.time()
    pid = os.getpid()
    events: List[dict] = []
    meta: Dict[str, object] = {"requested_ms": duration_ms}
    prof = None
    cuda_lane = False
    annotations_were_on = log_mod._trace_annotation_cls is not None
    torch_mod = sys.modules.get("torch")
    if torch_mod is not None:
        try:
            from torch.profiler import ProfilerActivity, profile

            cuda_lane = bool(torch_mod.cuda.is_initialized())
            if cuda_lane and not _PROFILER_READY and threading.current_thread() is not threading.main_thread():
                cuda_lane = False
                meta["device_lane_note"] = "call prepare_device_profiler() on the main thread first"
            activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda_lane else [])
            log_mod.enable_trace_annotations(True)
            t0 = time.perf_counter()
            prof = profile(activities=activities)
            prof.start()
            meta["start_ms"] = (time.perf_counter() - t0) * 1e3
        except Exception as e:  # noqa: BLE001 - degrade to the host lanes
            meta["torch_error"] = f"{type(e).__name__}: {e}"
            prof = None
    time.sleep(max(float(duration_ms), 0.0) / 1e3)
    if prof is not None:
        try:
            t0 = time.perf_counter()
            prof.stop()
            t1 = time.perf_counter()
            events.extend(_profiler_events(prof, pid))
            meta.update(stop_ms=(t1 - t0) * 1e3, export_ms=(time.perf_counter() - t1) * 1e3)
        except Exception as e:  # noqa: BLE001
            meta["torch_error"] = f"{type(e).__name__}: {e}"
            prof = None
    if not annotations_were_on:
        log_mod.enable_trace_annotations(False)
    meta["torch_profiler"] = prof is not None
    meta["device_lane"] = prof is not None and cuda_lane
    t_end = time.time()

    # Host lane 1: the logger's span events overlapping the window.
    n_host = 0
    for ev in log_mod.logger.recent_events():
        if ev.duration_ms is None:
            continue
        s0 = ev.t - ev.duration_ms / 1e3
        if ev.t < t_start or s0 > t_end:
            continue
        n_host += 1
        events.append({
            "name": f"{ev.target}|{ev.message}" if ev.message else ev.target,
            "cat": "evolu-host",
            "ph": "X",
            "ts": s0 * 1e6,
            "dur": ev.duration_ms * 1e3,
            "pid": pid,
            "tid": 0,
            "args": {k: str(v) for k, v in ev.fields.items()},
        })
    # Host lane 2: the sampled trace spans of the window.
    win_spans = [
        s for s in trace.recorder.dump()
        if s.t_start <= t_end and s.t_start + s.duration_ms / 1e3 >= t_start
    ]
    events.extend(trace.export_chrome(win_spans)["traceEvents"])
    meta.update(captured_at=t_start, wall_ms=(t_end - t_start) * 1e3,
                host_span_events=n_host, trace_span_events=len(win_spans),
                platform=anatomy.get_platform())
    return {"displayTimeUnit": "ms", "traceEvents": events, "metadata": meta}


class _Handler(BaseHTTPRequestHandler):
    store: RelayStore  # injected by RelayServer
    scheduler = None  # SyncScheduler when the relay batches
    mesh_engine = False  # the mesh-sharded engine: adds the /stats mesh section
    replication = None  # ReplicationManager when the relay has peers
    fleet = None  # FleetManager once the relay joined a fleet
    push_hub = None  # PushHub when push subscriptions are on (server/push.py)
    conn_tier = None  # EventLoopHTTPServer when that tier serves this relay
    write_behind = None  # WriteBehindQueue when the storage inversion is on
    device = None  # where the per-request path folds scoped trees (None = the card)
    counts: _Counts
    # The capabilities this relay echoes (intersected with the request's
    # advertised set). A request with none gets the v1 wire, byte for byte.
    capabilities = DEFAULT_CAPABILITIES

    def _negotiate_caps(self, request: protocol.SyncRequest, out: bytes) -> bytes:
        """Append the negotiated capability fields to an encoded response,
        after the serve path (proto3 field order is free). Only when the
        client advertised, so capability-less peers round-trip byte for
        byte."""
        caps = tuple(c for c in request.capabilities if c in self.capabilities)
        if not caps:
            return out
        return out + protocol.encode_response_capabilities(caps)

    def log_message(self, format: str, *args) -> None:
        # Target-gated like every other runtime signal (config.log): quiet
        # by default, switchable with the `dev` target. The is_enabled
        # check keeps the default path allocation-free (this fires per
        # request); _flight=False because access lines would evict the
        # sparse events the flight ring keeps.
        from evolu_tpu_torch.utils.log import logger

        if logger.is_enabled("dev"):
            log("dev", f"relay {self.address_string()} {format % args}", _flight=False)

    def _obs_authorized(self) -> bool:
        """The token gate of the observability reads (`/metrics`, `/stats`,
        `/trace*`, `/profile`): with EVOLU_OBS_TOKEN set, demand the
        matching X-Evolu-Obs-Token header (constant-time compare). Unset =
        open. False → 403 already answered."""
        token = os.environ.get("EVOLU_OBS_TOKEN")
        if not token:
            return True
        import hmac

        got = self.headers.get("X-Evolu-Obs-Token", "")
        # Compare bytes: compare_digest raises on non-ASCII str inputs,
        # and a hostile header must answer 403, not crash the handler.
        if hmac.compare_digest(got.encode("utf-8", "replace"), token.encode("utf-8")):
            return True
        self.counts.error()
        self.send_error(403, "observability token mismatch")
        return False

    def _do_trace(self) -> None:
        """GET /trace → recent trace ids; GET /trace/<id> → the span tree
        of one trace (fan-in spans included through their links);
        `?format=chrome` → the Chrome-trace export of those spans. An id
        that is not 32 lower-case hex digits answers 404, never a 500."""
        import urllib.parse

        parts = urllib.parse.urlsplit(self.path)
        fmt = urllib.parse.parse_qs(parts.query).get("format", [""])[0]
        tail = parts.path[len("/trace"):].strip("/")
        if not tail:
            body = json.dumps({
                "recent": trace.recorder.recent_trace_ids(),
                "span_ring": trace.recorder.size(),
            }).encode("utf-8")
        elif len(tail) != 32 or not all(c in "0123456789abcdef" for c in tail):
            self.send_error(404, "not a trace id")
            return
        elif fmt == "chrome":
            body = json.dumps(trace.export_chrome(trace.recorder.spans_for(tail))).encode("utf-8")
        else:
            body = json.dumps(trace.serve_trace(tail)).encode("utf-8")
        self._respond(200, body, "application/json")

    def _do_profile(self) -> None:
        """GET /profile?ms=N: capture N ms (clamped to 10–30,000) of live
        traffic (`capture_live_profile`); 400 for a bad ms, 429 while
        another capture runs."""
        import urllib.parse

        q = urllib.parse.parse_qs(urllib.parse.urlsplit(self.path).query)
        try:
            ms = float(q.get("ms", ["250"])[0])
        except ValueError:
            self.send_error(400, "ms must be a number")
            return
        ms = min(max(ms, 10.0), 30_000.0)
        if not _PROFILE_LOCK.acquire(blocking=False):
            metrics.inc("evolu_relay_profile_busy_total")
            self.send_error(429, "a profile capture is already running")
            return
        try:
            body = json.dumps(capture_live_profile(ms)).encode("utf-8")
        except Exception as e:  # noqa: BLE001 - the reader gets a clean 500
            self.counts.error()
            self.send_error(500, str(e))
            return
        finally:
            _PROFILE_LOCK.release()
        self._respond(200, body, "application/json")

    def _body_length(self) -> Optional[int]:
        """Content-Length, or None after answering 400 for one that is not
        a non-negative integer (a negative one would read unbounded)."""
        raw = self.headers.get("Content-Length", "0")
        try:
            length = int(raw)
        except (TypeError, ValueError):
            length = -1
        if length < 0:
            self.counts.error()
            self.send_error(400, "invalid Content-Length")
            return None
        return length

    def _respond(self, code: int, body: bytes, content_type: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _respond_retry_after(self, retry_after: float) -> None:
        """503 with Retry-After: the flow-control answer to scheduler
        backpressure. Clients back off and retry; not an error."""
        from evolu_tpu_torch.server.scheduler import format_retry_after

        self.send_response(503)
        self.send_header("Retry-After", format_retry_after(retry_after))
        self.send_header("Content-Length", "0")
        self.end_headers()

    def _serve_request(self, request: protocol.SyncRequest) -> Optional[bytes]:
        """Serve one sync request through the scheduler or the per-request
        path. → response bytes, or None after answering 503 itself."""
        if request.scope is not None and protocol.CAP_SYNC_SCOPE not in (self.capabilities or ()):
            # A relay without the scope capability strips the clause and
            # answers the full serve, never an error.
            request = dataclasses.replace(request, scope=None)
        if self.scheduler is not None:
            from evolu_tpu_torch.server.scheduler import SchedulerQueueFull

            try:
                return self.scheduler.submit(request)
            except SchedulerQueueFull as e:
                self._respond_retry_after(e.retry_after)
                return None
        return serve_single_request(self.store, request, device=self.device)

    def do_GET(self) -> None:  # /ping (index.ts:250-252), /health, /push/poll and the obs reads
        if self.path == "/ping":
            body = b"ok"
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path == "/metrics":
            metrics.inc("evolu_relay_requests_total", endpoint="/metrics")
            if not self._obs_authorized():
                return
            try:
                # Refresh the process gauges at scrape time (uptime, RSS).
                metrics.update_process_gauges()
                body = metrics.render_prometheus().encode("utf-8")
            except Exception as e:  # noqa: BLE001 - the scraper gets a clean 500
                self.counts.error()
                self.send_error(500, str(e))
                return
            self._respond(200, body, metrics.PROMETHEUS_CONTENT_TYPE)
        elif self.path == "/trace" or self.path.startswith(("/trace/", "/trace?")):
            # One fixed endpoint label: raw paths must never mint series.
            metrics.inc("evolu_relay_requests_total", endpoint="/trace")
            if not self._obs_authorized():
                return
            try:
                self._do_trace()
            except Exception as e:  # noqa: BLE001 - the reader gets a clean 500
                self.counts.error()
                self.send_error(500, str(e))
        elif self.path == "/profile" or self.path.startswith("/profile?"):
            metrics.inc("evolu_relay_requests_total", endpoint="/profile")
            if self._obs_authorized():
                self._do_profile()
        elif self.path == "/stats":
            metrics.inc("evolu_relay_requests_total", endpoint="/stats")
            if not self._obs_authorized():
                return
            try:
                mesh_ctx = None
                if self.mesh_engine:
                    from evolu_tpu_torch.parallel.mesh import current_mesh_context

                    mesh_ctx = self.scheduler.mesh_ctx or current_mesh_context()
                body = json.dumps(relay_stats_payload(self.store, self.counts, self.replication,
                                                      self.fleet, self.push_hub,
                                                      self.conn_tier, self.write_behind,
                                                      self.mesh_engine, mesh_ctx)).encode("utf-8")
            except Exception as e:  # noqa: BLE001 - a clean 500, not a dropped connection
                self.counts.error()
                self.send_error(500, str(e))
                return
            self._respond(200, body, "application/json")
        elif self.path == "/health":
            # Readiness (/ping is liveness): 503 while a snapshot install is
            # in progress, or, in a fleet, any owner is mid-rebalance.
            metrics.inc("evolu_relay_requests_total", endpoint="/health")
            try:
                if self.fleet is not None:
                    serving, detail = self.fleet.health_payload()
                else:
                    from evolu_tpu_torch.server.snapshot import install_phase

                    phase = install_phase(self.store)
                    serving = phase is None
                    detail = {"status": "serving" if serving else "installing", "install_phase": phase}
                if self.scheduler is not None:
                    detail["queue_depth"] = self.scheduler.depth()
                if self.write_behind is not None:
                    # A queue at its admission bound, or a drain failing
                    # again and again (every flush-needing serve would hang
                    # on it), is not ready: failover should route elsewhere.
                    wbd = self.write_behind.health_payload()
                    detail["write_behind"] = wbd
                    if wbd["saturated"] or wbd["failing"]:
                        serving = False
                        detail["status"] = "backlogged" if wbd["saturated"] else "drain-failing"
            except Exception as e:  # noqa: BLE001 - the probe gets a clean 500
                self.counts.error()
                self.send_error(500, str(e))
                return
            self._respond(200 if serving else 503, json.dumps(detail).encode("utf-8"), "application/json")
        elif self.path == "/fleet" and self.fleet is not None:
            try:
                body = json.dumps(self.fleet.stats_payload()).encode("utf-8")
            except Exception as e:  # noqa: BLE001
                self.counts.error()
                self.send_error(500, str(e))
                return
            self._respond(200, body, "application/json")
        elif self.path.startswith("/push/poll"):
            self._do_push_poll()
        else:
            self.send_error(404)

    def _do_push_poll(self) -> None:
        """GET /push/poll: the long-poll subscription leg (server/push.py).
        On THIS tier the poll parks the handler thread on an Event; the
        event-loop tier (server/conn.py) intercepts the same path before
        its handler pool and parks the bare connection instead. This
        branch is also that tier's byte-identical answer for the shapes it
        won't answer itself (no hub → 404, malformed query → 400), so its
        framing and `conn.frame_response` must stay aligned."""
        import urllib.parse

        from evolu_tpu_torch.server import push as push_mod

        if self.push_hub is None:
            self.send_error(404)
            return
        try:
            owner, node, cursor, timeout, tags = push_mod.parse_poll_query(
                urllib.parse.urlsplit(self.path).query)
        except ValueError as e:
            self.counts.error()
            self.send_error(400, str(e))
            return
        if self.fleet is not None:
            # A subscription lives at the owner's PLACED relay, where its
            # mutations are served and hub-notified. 307 even in forward
            # mode: proxying a long-poll would pin a handler for the park.
            from evolu_tpu_torch.server.fleet import FleetNotReady

            try:
                action, peer = self.fleet.route(owner)
            except FleetNotReady as e:
                self._respond_retry_after(e.retry_after)
                return
            if action != "local":
                self.push_hub._count("redirects")
                self.send_response(307)
                self.send_header("Location", peer + self.path)
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
        try:
            body = self.push_hub.poll_blocking(owner, node, cursor, timeout, tags=tags)
        except push_mod.HubFull as e:
            self._respond_retry_after(e.retry_after)
            return
        self._respond(200, body, "application/json")

    def _notify_push(self, request: protocol.SyncRequest) -> None:
        """Wake parked subscriptions AFTER the serve committed (a woken
        client's sync round must observe the rows); the timestamps carry
        the author-node metadata of the hub's own-write exclusion."""
        if self.push_hub is not None and request.messages:
            self.push_hub.notify(request.user_id, [m.timestamp for m in request.messages],
                                 tags=_notify_tags(request))

    def _read_body(self) -> Optional[bytes]:
        """The request body, or None after answering 400 or 413."""
        length = self._body_length()
        if length is None:
            return None
        if length > MAX_BODY_BYTES:
            self.counts.error()
            self.send_error(413)
            return None
        return self.rfile.read(length)

    def do_POST(self) -> None:  # POST / (index.ts:224-248)
        if self.path.startswith("/replicate/"):
            self._do_replicate()
            return
        if self.path.startswith("/fleet/"):
            self._do_fleet()
            return
        t0 = time.perf_counter()
        # Counted before any reject, so errors never outnumber requests.
        self.counts.request()
        body = self._read_body()
        if body is None:
            return
        metrics.observe("evolu_relay_request_bytes", len(body), buckets=metrics.SIZE_BUCKETS)
        # A malformed or oversized traceparent parses to None and the
        # request proceeds untraced, never a 4xx/5xx.
        tctx = trace.parse_traceparent(self.headers.get(trace.TRACEPARENT_HEADER))
        srv_span = trace.start_span("relay.sync", parent=tctx, attrs={"endpoint": "/"})
        tok = trace.activate(srv_span.context)
        try:
            request = protocol.decode_sync_request(body)
            srv_span.set_attr("owner", request.user_id)
            if self.fleet is not None and not self._route_fleet(request, body):
                return  # answered: 307, forwarded or 503 not ready
            self.counts.shard(
                self.store.shard_index(request.user_id) if hasattr(self.store, "shard_index") else 0)
            out = self._serve_request(request)
            if out is None:
                return  # 503 backpressure already answered
            # After routing and a successful serve: each message counts
            # once, at the relay that ingested it.
            _count_ingest_mix(request.messages)
            self._notify_push(request)
        except Exception as e:  # noqa: BLE001 - index.ts:231-233
            # The flight dump rides the exception (server side only: the
            # wire answer stays a bare 500).
            flight.attach(e)
            srv_span.set_attr("error", repr(e))
            self.counts.error()
            log("dev", "relay sync request failed", error=repr(e))
            self.send_error(500, str(e))
            return
        finally:
            trace.deactivate(tok)
            srv_span.end()
            metrics.observe("evolu_relay_request_ms", (time.perf_counter() - t0) * 1e3,
                            exemplar=srv_span.trace_id)
        if self.replication is not None and request.messages:
            # Fresh rows reach peer relays at gossip-debounce latency.
            self.replication.hint()
        # The respond leg's own span, parented explicitly (the server span
        # closed above, with the latency exemplar).
        rspan = trace.start_span("relay.respond", parent=srv_span.context)
        out = self._negotiate_caps(request, out)
        metrics.observe("evolu_relay_response_bytes", len(out), buckets=metrics.SIZE_BUCKETS)
        rspan.set_attr("bytes", len(out))
        # End BEFORE the socket write: the client may ask GET /trace/<id>
        # the moment it reads the answer.
        rspan.end()
        self._respond(200, out, "application/octet-stream")

    def _do_replicate(self) -> None:
        """POST /replicate/{summary,pull,snapshot,snapshot/chunk}: the peer
        gossip and bootstrap surface. 404 without replication; a malformed
        body (and an unknown or expired snapshot id) answers 400, anything
        else 500."""
        from evolu_tpu_torch.server import replicate, snapshot

        if self.replication is None or self.path not in (
                "/replicate/summary", "/replicate/pull", "/replicate/snapshot", "/replicate/snapshot/chunk"):
            self.send_error(404)
            return
        body = self._read_body()
        if body is None:
            return
        # Every /replicate serve reads the store: with write-behind on it
        # drains first and holds the drain lock, so peers and snapshot
        # pullers only ever see committed state.
        barrier = self.write_behind.drain_barrier() if self.write_behind is not None else nullcontext()
        try:
            with barrier:
                if self.path == "/replicate/summary":
                    out = replicate.serve_summary(self.store, body, self.replication)
                elif self.path == "/replicate/pull":
                    out = replicate.serve_pull(self.store, body,
                                               per_owner=self.replication.pull_messages_per_owner,
                                               per_response=self.replication.pull_messages_per_response)
                elif self.path == "/replicate/snapshot":
                    out = snapshot.serve_snapshot(self.store, body, self.replication)
                else:
                    out = snapshot.serve_snapshot_chunk(self.store, body, self.replication)
        except ValueError as e:
            self.counts.error()
            self.send_error(400, str(e))
            return
        except Exception as e:  # noqa: BLE001 - the peer gets a clean 500
            self.counts.error()
            self.send_error(500, str(e))
            return
        self._respond(200, out, "application/octet-stream")

    # -- fleet routing (server/fleet.py) --

    def _route_fleet(self, request: protocol.SyncRequest, body: bytes) -> bool:
        """The placement check for one sync POST. True: this relay is placed
        for the owner and ready, the caller serves. False: already answered
        with 307 and the authoritative relay's URL, the peer's proxied
        response, or 503 + Retry-After (owner mid-install, target briefly
        unreachable)."""
        import urllib.error

        from evolu_tpu_torch.server.fleet import FleetNotReady
        from evolu_tpu_torch.sync.client import _http_post

        try:
            action, target = self.fleet.route(request.user_id)
        except FleetNotReady as e:
            self._respond_retry_after(e.retry_after)
            return False
        if action == "local":
            return True
        if action == "redirect":
            self.fleet._count("redirects")
            self.send_response(307)
            self.send_header("Location", target + "/")
            self.send_header("Content-Length", "0")
            self.end_headers()
            return False
        # Forward: the untouched client body in the hop-guarded envelope,
        # the peer's raw response relayed back.
        self.fleet._count("forwards")
        env = protocol.encode_fleet_forward(protocol.FleetForward(body, self.fleet.self_url, 1))
        try:
            out = _http_post(target + "/fleet/forward", env, retries=1)
        except urllib.error.HTTPError as e:
            self.fleet._count("forward_failures")
            if e.code in (429, 503):
                self._respond_retry_after(0.25)  # the peer sheds load: relayed
                return False
            # A definitive answer (404: no fleet there, 400, 500) is not
            # transient: 502, never a retry-forever 503.
            self.counts.error()
            self.send_error(502, f"fleet forward target answered {e.code}")
            return False
        except Exception:  # noqa: BLE001 - target down mid-window: flow control;
            self.fleet._count("forward_failures")  # the next route() re-probes
            self._respond_retry_after(0.25)
            return False
        self._respond(200, out, "application/octet-stream")
        return False

    def _do_fleet(self) -> None:
        """POST /fleet/{forward,reload}: the hop-guarded peer envelope
        (ValueError → 400) and the static config push (JSON
        `FleetConfig.to_json`; a stale version answers 400; with
        EVOLU_FLEET_RELOAD_TOKEN set, a request without the matching
        X-Evolu-Fleet-Token header answers 403)."""
        if self.fleet is None or self.path not in ("/fleet/forward", "/fleet/reload"):
            self.send_error(404)
            return
        body = self._read_body()
        if body is None:
            return
        try:
            if self.path == "/fleet/forward":
                env = protocol.decode_fleet_forward(body)
                if env.hops != 1:
                    raise ValueError(f"fleet forward from {env.origin!r} carries hops={env.hops}; "
                                     "only single-hop envelopes are served")
                request = protocol.decode_sync_request(env.payload)
                # No route() here: a forwarded request is served where it
                # lands, even if the rings disagree mid-reload.
                self.fleet._count("forwarded_served")
                out = self._serve_request(request)
                if out is None:
                    return  # 503 backpressure already answered
                # The forward SERVE is where the owner's rows land, and
                # where its subscriptions are parked (polls 307 to
                # placement): notify here, never at the forwarding hop.
                self._notify_push(request)
                if self.replication is not None and request.messages:
                    self.replication.hint()
                self._respond(200, self._negotiate_caps(request, out), "application/octet-stream")
                return
            token = os.environ.get("EVOLU_FLEET_RELOAD_TOKEN")
            if token:
                import hmac

                if not hmac.compare_digest(self.headers.get("X-Evolu-Fleet-Token", ""), token):
                    self.counts.error()
                    self.send_error(403, "fleet reload token mismatch")
                    return
            from evolu_tpu_torch.utils.config import FleetConfig

            cfg = FleetConfig.from_json(json.loads(body.decode("utf-8")))
            rebalancing = self.fleet.apply_config(cfg)
            out = json.dumps({"ring_version": self.fleet.config.version,
                              "rebalancing": rebalancing}).encode("utf-8")
            self._respond(200, out, "application/json")
        except ValueError as e:
            self.counts.error()
            self.send_error(400, str(e))
        except Exception as e:  # noqa: BLE001 - a clean 500, like sync
            self.counts.error()
            self.send_error(500, str(e))


class _RelayHTTPServer(ThreadingHTTPServer):
    # The reference's deploy allows 25 concurrent connections
    # (examples/server-nodejs/fly.toml); socketserver's default listen
    # backlog of 5 resets simultaneous connects well below that.
    request_queue_size = 128


def _env_on(name: str) -> Optional[bool]:
    """A set environment switch, in both directions; None when unset."""
    env = os.environ.get(name, "")
    return env.lower() not in ("0", "false", "no", "off") if env else None


def _write_behind_queue(store, log_path: Optional[str], cfg):
    """The relay's write-behind queue: its log at `log_path`, else beside
    the (first shard's) store file; the drain workers and process mode from
    EVOLU_WB_DRAIN_WORKERS / EVOLU_WB_DRAIN_PROCESS (a set variable wins in
    both directions), else the Config."""
    from evolu_tpu_torch.storage.write_behind import WriteBehindQueue

    if log_path is None:
        shards = getattr(store, "shards", None)
        base = getattr(getattr(shards[0] if shards else store, "db", None), "path", None)
        if base and base != ":memory:":
            log_path = base + ".wblog"
    env_workers = os.environ.get("EVOLU_WB_DRAIN_WORKERS", "")
    drain_process = _env_on("EVOLU_WB_DRAIN_PROCESS")
    return WriteBehindQueue(
        store, log_path=log_path, max_rows=cfg.write_behind_max_rows,
        drain_batch_rows=cfg.write_behind_drain_rows,
        drain_workers=int(env_workers) if env_workers else cfg.wb_drain_workers,
        drain_process=cfg.wb_drain_process if drain_process is None else drain_process,
    )


class RelayServer:
    """ThreadingHTTPServer wrapper; `url` once started.

    `batching=True` (or an explicit `scheduler`) routes sync POSTs through
    the continuous-batching `SyncScheduler`, whose engine passes run on
    `device` (None = the card: without one the constructor raises;
    "cpu" = the plain versions of the kernels). Queue-full answers 503
    with Retry-After, and `stop()` drains the scheduler before the store
    closes. Default off: the per-request path, hashed on the host, is the
    reference relay's shape.

    `peers=[url, ...]` (or an explicit `replication` manager) turns on
    relay↔relay Merkle anti-entropy (`server/replicate.py`), gossiping
    every `replication_interval_s` and earlier after writes;
    on a batching relay the pulled messages go through the scheduler, so
    they share the card's engine passes with client traffic. `peers=[]` is
    a listener: it serves `/replicate/*` and polls nobody. A relay without
    replication answers 404 there. `bootstrap_lag_owners` arms the snapshot
    bootstrap (`server/snapshot.py`). `checkpoint_interval_s` writes
    periodic checkpoints to `checkpoint_path` (default `<store
    path>.checkpoint`; a `:memory:` store needs one, else ValueError).
    `bootstrap_lag_owners` and `checkpoint_interval_s` left at None resolve
    from `utils.config.default_config`. `enable_fleet` joins an
    owner-sharded fleet (`server/fleet.py`).

    `push` turns on the push hub (`server/push.py`: GET `/push/poll`, woken
    by every committed sync POST, forward serve and replication ingest);
    None resolves from `default_config.push_subscriptions`, on by default.
    `connection_tier` is "threaded" (a ThreadingHTTPServer) or "eventloop"
    (`server/conn.py`: one loop owns every socket, requests run on a
    bounded handler pool, long-polls park the bare connection); None
    resolves from `EVOLU_CONN_TIER`, then `default_config.connection_tier`.

    `write_behind` turns on the write-behind storage inversion (a
    `storage.write_behind.WriteBehindQueue` as `self.write_behind`); None
    resolves from `EVOLU_WRITE_BEHIND` (a set variable wins in both
    directions), then `default_config.write_behind`. It implies batching.
    Its log is `write_behind_log`, by default `<store path>.wblog` (none for
    a `:memory:` store); `EVOLU_WB_DRAIN_WORKERS` and
    `EVOLU_WB_DRAIN_PROCESS`, else the Config, set the drain workers and
    the process drain. /health answers 503 "backlogged" or "drain-failing",
    and `stop()` drains the queue before the store closes.

    `capabilities` (default: the reference's `protocol.KNOWN_CAPABILITIES`)
    is what the relay echoes; with `sync-scope-v1` among them a scoped
    request is served its slice (`server/scope.py`, the fold on `device`),
    without it the clause is stripped and the full serve answers.

    `mesh_engine` (or an explicit `mesh_ctx`, a `parallel.mesh.MeshContext`)
    turns on the mesh-sharded engine: every engine pass lays its owners
    out over the mesh's shards by stable placement; None resolves from
    `EVOLU_MESH_ENGINE` (a set variable wins in both directions), then
    `default_config.mesh_engine`. It implies batching, and `/stats` gains
    a `mesh` section."""

    def __init__(self, store: Optional[RelayStore] = None, host: str = "127.0.0.1",
                 port: int = 0, batching: bool = False, scheduler=None,
                 peers: Optional[Sequence[str]] = None, replication=None,
                 replication_interval_s: float = 30.0,
                 bootstrap_lag_owners: Optional[int] = None,
                 checkpoint_interval_s: Optional[float] = None,
                 checkpoint_path: Optional[str] = None,
                 capabilities: Optional[Sequence[str]] = None,
                 write_behind: Optional[bool] = None,
                 write_behind_log: Optional[str] = None,
                 mesh_engine: Optional[bool] = None,
                 mesh_ctx=None,
                 connection_tier: Optional[str] = None,
                 push: Optional[bool] = None,
                 device=None):
        from evolu_tpu_torch.utils.config import default_config

        # Constructor argument, then EVOLU_CONN_TIER, then the Config.
        if connection_tier is None:
            connection_tier = os.environ.get("EVOLU_CONN_TIER") or default_config.connection_tier
        if connection_tier not in ("threaded", "eventloop"):
            raise ValueError(
                f"connection_tier must be 'threaded' or 'eventloop', got {connection_tier!r}")
        # Constructor argument, then EVOLU_MESH_ENGINE (a set variable wins
        # in both directions), then the Config. The mesh engine is a
        # property of the engine pass, so it implies batching; its context
        # is resolved on the scheduler's dispatcher thread.
        if mesh_engine is None and mesh_ctx is None:
            mesh_engine = _env_on("EVOLU_MESH_ENGINE")
            if mesh_engine is None:
                mesh_engine = default_config.mesh_engine
        self.mesh_engine = bool(mesh_engine) or mesh_ctx is not None
        if self.mesh_engine:
            batching = True
        self.capabilities = DEFAULT_CAPABILITIES if capabilities is None else tuple(capabilities)
        self.connection_tier = connection_tier
        if checkpoint_interval_s is None:
            checkpoint_interval_s = default_config.checkpoint_interval_s
        self.store = store or RelayStore()
        if checkpoint_interval_s is not None and checkpoint_path is None:
            store_path = getattr(getattr(self.store, "db", None), "path", None)
            if not store_path or store_path == ":memory:":
                raise ValueError("checkpoint_interval_s needs checkpoint_path for non-file-backed stores")
            checkpoint_path = store_path + ".checkpoint"
        # Constructor argument, then EVOLU_WRITE_BEHIND, then the Config.
        if write_behind is None:
            write_behind = _env_on("EVOLU_WRITE_BEHIND")
        if write_behind is None:
            write_behind = default_config.write_behind
        self.write_behind = None
        if write_behind:
            self.write_behind = _write_behind_queue(self.store, write_behind_log, default_config)
            batching = True
        self.scheduler = scheduler
        if batching and scheduler is None:
            from evolu_tpu_torch.server.scheduler import SyncScheduler

            try:
                self.scheduler = SyncScheduler(self.store, device=device, write_behind=self.write_behind,
                                               mesh_ctx=mesh_ctx, mesh_engine=self.mesh_engine)
            except BaseException:
                if self.write_behind is not None:
                    self.write_behind.close()
                raise
        self.replication = replication
        if peers is not None and replication is None:
            from evolu_tpu_torch.server.replicate import ReplicationManager

            self.replication = ReplicationManager(
                self.store, peers, scheduler=self.scheduler,
                interval_s=replication_interval_s,
                bootstrap_lag_owners=bootstrap_lag_owners,
                write_behind=self.write_behind,
            )
        self.checkpointer = None
        if checkpoint_interval_s is not None:
            from evolu_tpu_torch.server.snapshot import CheckpointWriter

            self.checkpointer = CheckpointWriter(
                self.store, checkpoint_path, checkpoint_interval_s,
                barrier=self.write_behind.drain_barrier if self.write_behind is not None else None)
        self.fleet = None
        # Push subscriptions: a new GET endpoint, no effect on any other
        # response. Both connection tiers serve the same hub.
        if push is None:
            push = default_config.push_subscriptions
        self.push_hub = None
        if push:
            from evolu_tpu_torch.server.push import PushHub

            self.push_hub = PushHub(max_subscriptions=default_config.push_max_subscriptions,
                                    default_timeout_s=default_config.push_poll_timeout_s)
            if self.replication is not None and self.replication.push_hub is None:
                # Rows a gossip round lands (a partition healing) wake this
                # relay's subscribers: they never arrive as a sync POST.
                self.replication.push_hub = self.push_hub
        self.counts = _Counts()
        self._handler_cls = type(
            "BoundHandler", (_Handler,),
            {"store": self.store, "scheduler": self.scheduler, "replication": self.replication,
             "capabilities": self.capabilities, "counts": self.counts, "push_hub": self.push_hub,
             "write_behind": self.write_behind, "device": device, "mesh_engine": self.mesh_engine},
        )
        try:
            if connection_tier == "eventloop":
                from evolu_tpu_torch.server.conn import EventLoopHTTPServer

                self._httpd = EventLoopHTTPServer(
                    (host, port), self._handler_cls, push_hub=self.push_hub,
                    handler_threads=default_config.conn_handler_threads,
                    max_pending=default_config.conn_max_pending,
                    read_timeout_s=default_config.conn_read_timeout_s,
                    write_timeout_s=default_config.conn_write_timeout_s,
                    max_header_bytes=default_config.conn_max_header_bytes,
                )
                self._handler_cls.conn_tier = self._httpd
            else:
                self._httpd = _RelayHTTPServer((host, port), self._handler_cls)
        except BaseException:
            if self.scheduler is not None and scheduler is None:
                self.scheduler.stop()
            if self.write_behind is not None:
                self.write_behind.close()
            raise
        self._thread: Optional[threading.Thread] = None

    def enable_fleet(self, config, self_url: Optional[str] = None):
        """Join an owner-sharded fleet (server/fleet.py): install the ring,
        answer non-placed sync POSTs with 307 or a forward, scope this
        relay's gossip to placement, and serve `/fleet/reload` and the
        fleet's `/health` detail. Call it before `start()` when the relay
        has peers: the loop's first round fires on start and must already
        be placement-scoped. Every member must hold the same FleetConfig."""
        from evolu_tpu_torch.server.fleet import FleetManager

        self.fleet = FleetManager(self.store, config, self_url or self.url, replication=self.replication,
                                  write_behind=self.write_behind)
        self._handler_cls.fleet = self.fleet
        if self.replication is not None:
            self.replication.fleet = self.fleet
        return self.fleet

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def _publish_build_info(self) -> None:
        """`evolu_build_info` (constant 1, facts in labels): which build and
        topology this relay process runs. Never raises: identity labels
        are not worth a failed start."""
        try:
            from evolu_tpu_torch import __version__
            from evolu_tpu_torch.utils.config import default_config

            shards = getattr(self.store, "shards", None)
            db = getattr((shards[0] if shards else self.store), "db", None)
            mesh_devices = default_config.mesh_devices
            metrics.set_build_info(
                version=__version__,
                backend="native" if hasattr(db, "relay_insert_packed") else "python",
                shards=len(shards) if shards else 1,
                batching=int(self.scheduler is not None),
                write_behind=int(self.write_behind is not None),
                mesh_engine=int(self.mesh_engine),
                mesh_devices="auto" if mesh_devices is None else mesh_devices,
                connection_tier=self.connection_tier,
                push=int(self.push_hub is not None),
            )
        except Exception:  # noqa: BLE001,S110 - telemetry must not fail a start
            pass

    def start(self) -> "RelayServer":
        self._publish_build_info()
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True, name="evolu-relay")
        self._thread.start()
        if self.replication is not None:
            self.replication.start()
        if self.checkpointer is not None:
            self.checkpointer.start()
        return self

    def stop(self) -> None:
        if self.push_hub is not None:
            # BEFORE the HTTP server stops: resolve every parked long-poll
            # (wake=false) so threaded-tier handler threads unblock and the
            # event tier flushes the responses in its shutdown window.
            self.push_hub.close()
        self._httpd.shutdown()
        if self._thread:
            self._thread.join()
        if self.fleet is not None:
            # Before replication and the store: a rebalance thread may still
            # be ingesting through the store (stop joins it).
            self.fleet.stop()
        if self.checkpointer is not None:
            self.checkpointer.stop()  # before the store closes
        if self.replication is not None:
            # Before the scheduler drains: an in-flight round may still be
            # submitting pulled messages.
            self.replication.stop()
        if self.scheduler is not None:
            # Drain BEFORE the store closes, injected or owned alike (stop
            # is idempotent): queued requests get their responses first.
            self.scheduler.stop()
        if self.write_behind is not None:
            # After the scheduler's last batches appended their records,
            # before the store closes: a clean shutdown drains everything
            # and leaves an empty log.
            self.write_behind.close()
        self._httpd.server_close()
        self.store.close()


def serve(path: str = ":memory:", host: str = "0.0.0.0", port: int = 4000) -> RelayServer:
    """The `examples/server-nodejs` entry point analog."""
    server = RelayServer(RelayStore(path), host, port)
    return server.start()


# -- the pre-forked multiprocess relay --


def _open_store(path: str, backend: str, shards: int):
    """The one store-construction rule shared by the relay parent (schema
    pre-creation) and its workers: they must agree on the layout."""
    if shards > 1:
        return ShardedRelayStore(path, backend, shards=shards)
    return RelayStore(path, backend)


def _mp_worker_main(host: str, port: int, path: str, shards: int, backend: str, device=None) -> None:
    """One relay worker process: its own SO_REUSEPORT listening socket on
    the shared port (the kernel spreads connections over the workers) over
    the SHARED file-backed store, on the per-request host path (SQLite WAL
    and busy_timeout make the processes safe). Only a scoped fold touches
    `device` (None = the card), resolved when the fold runs."""
    import socket

    store = _open_store(path, backend, shards)
    handler = type("BoundHandler", (_Handler,), {"store": store, "counts": _Counts(), "device": device})

    class _ReuseportServer(_RelayHTTPServer):
        def server_bind(self):
            self.socket.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
            super().server_bind()

    httpd = _ReuseportServer((host, port), handler)
    print("READY", flush=True)  # the parent waits for every worker's listen()
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:  # pragma: no cover - the parent terminates us
        pass


class MultiprocessRelay:
    """Pre-forked relay: N worker PROCESSES accept on one SO_REUSEPORT port
    and share one file-backed (sharded) store, serving the per-request
    path on the host; a worker's scoped folds run on `device` (None = the
    card). Needs a file path (processes cannot share :memory:)."""

    def __init__(self, path: str, workers: int = 2, shards: int = 8,
                 backend: str = "auto", host: str = "127.0.0.1", port: int = 0, device=None):
        import socket

        if path == ":memory:":
            raise ValueError("MultiprocessRelay needs a file-backed store")
        self.host = host
        self._path, self._workers, self._shards, self._backend = path, workers, shards, backend
        self._device = device
        self._procs: list = []
        # Reserve the port in the REUSEPORT group (bound, not listening, so
        # no connection lands here); workers start in start().
        self._anchor = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._anchor.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        try:
            self._anchor.bind((host, port))
            self.port = self._anchor.getsockname()[1]
            # One store open here creates the schema before any worker serves.
            _open_store(path, backend, shards).close()
        except BaseException:
            self._anchor.close()
            raise

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "MultiprocessRelay":
        # Plain subprocesses: no fork of this process's state, and no
        # multiprocessing-spawn re-import of __main__.
        import select
        import subprocess
        import sys
        import time
        import urllib.request

        env = dict(os.environ)
        env["PYTHONPATH"] = _REPO_ROOT + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        try:
            self._procs = [
                subprocess.Popen(
                    [sys.executable, "-m", "evolu_tpu_torch.server.relay_worker",
                     self.host, str(self.port), self._path, str(self._shards), self._backend,
                     *(() if self._device is None else (str(self._device),))],
                    env=env, stdout=subprocess.PIPE, text=True,
                )
                for _ in range(self._workers)
            ]
            # EVERY worker must report READY (after listen()).
            waiting = {p.stdout.fileno(): p for p in self._procs}
            deadline = time.time() + 30
            while waiting and time.time() < deadline:
                dead = [p for p in self._procs if p.poll() is not None]
                if dead:
                    raise RuntimeError(
                        f"{len(dead)}/{len(self._procs)} relay workers exited at startup "
                        f"(rc={[p.returncode for p in dead]})")
                ready, _, _ = select.select(list(waiting), [], [], 0.1)
                for fd in ready:
                    if "READY" in waiting[fd].stdout.readline():
                        del waiting[fd]
            if waiting:
                raise RuntimeError(f"{len(waiting)}/{len(self._procs)} relay workers did not come up")
            with urllib.request.urlopen(self.url + "/ping", timeout=5):
                pass
            return self
        except BaseException:
            self.stop()
            raise

    def stop(self) -> None:
        for p in self._procs:
            if p.poll() is None:
                p.terminate()
        for p in self._procs:
            try:
                p.wait(timeout=5)
            except Exception:  # noqa: BLE001 - wedged: escalate and reap
                p.kill()
                try:
                    p.wait(timeout=5)
                except Exception:  # noqa: BLE001,S110 - unreapable; the parent's exit collects it
                    pass
        self._procs = []
        self._anchor.close()
