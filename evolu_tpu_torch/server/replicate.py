"""Relay↔relay replication: Merkle anti-entropy between relay peers.

The port's copy of `evolu_tpu.server.replicate`. N relays converge by
gossiping per-owner Merkle tree digests and pulling only from the diverged
minute, so bandwidth follows divergence, not database size. One round
against one peer:

1. `POST /replicate/summary` with my owner→tree map; the answer is the
   peer's map (the peer also arms its own debounced hint when my map
   diverges from its store, so healing flows both ways).
2. `diff_merkle_trees` per owner whose tree strings differ → the earliest
   diverged minute → a sync timestamp.
3. `POST /replicate/pull` with the (owner, since) list, at most
   `PULL_OWNERS_PER_REQUEST` owners a POST; the peer answers every stored
   message after `since` (capped) and its tree at fetch time.
4. Ingest as ordinary `SyncRequest`s through the relay's own serving path:
   submitted concurrently into the relay's `SyncScheduler` when it has one,
   so one round becomes fused `run_batch_wire` passes that hash and fold on
   the card (kernels H and X, once a pass), else through
   `serve_single_request`. Each request carries the peer's tree, so a
   healed owner's (discarded) response is empty. The store's INSERT OR
   IGNORE and changes==1 XOR gate make re-pulling a range idempotent.

Offline peers get bounded exponential backoff with jitter; a successful
round resets it. With `bootstrap_lag_owners` set, an empty (or far
lagging) relay installs a peer's snapshot instead (server/snapshot.py) and
then gossips from its watermark.

Departures from the reference: plain `counts` (per peer in `peer_counts`,
HTTP legs in `round_trips`) in place of the `evolu_repl_*` / `evolu_snap_*`
metrics, so `stats_payload` answers the reference's keys with
`convergence_lag_p99_ms` and `install_p99_ms` null until the observability
item is ported; no trace spans, freshness gauges, ledger terminals or
logs. With a `write_behind` queue (storage/write_behind.py) a round
flushes it before it advertises (a drain failure is the round's failure),
and a snapshot bootstrap runs behind its `drain_barrier()`. With a `push_hub`, every ingest wakes the owner's parked push
subscriptions (reason "replication"), and a snapshot install wakes them
all (reason "conservative").
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from evolu_tpu_torch.core.merkle import diff_merkle_trees, merkle_tree_from_string
from evolu_tpu_torch.core.timestamp import SYNC_NODE_ID, create_sync_timestamp, timestamp_to_string
from evolu_tpu_torch.sync import protocol

# One pull POST covers at most this many owners: bounds request bodies
# (the relay's 20 MB cap applies to peers too), not a round's coverage.
PULL_OWNERS_PER_REQUEST = 256

# serve_pull bounds one response: at most this many messages an owner (the
# earliest of the range, so the next round resumes where this one stopped)
# and a response (owners past the budget are left out). A truncated pull
# leaves the trees differing, which re-arms the post-pull hint: deep
# catch-ups proceed incrementally. Read at serve time.
PULL_MESSAGES_PER_OWNER = 8192
PULL_MESSAGES_PER_RESPONSE = 65536

# A peer's counts (`ReplicationManager.peer_counts[url]`).
PEER_COUNTS = ("rounds_ok", "rounds_error", "owners_diffed", "messages_pulled",
               "snapshot_bootstraps", "snapshot_errors", "snapshot_expired", "snapshot_resumes",
               "snapshot_chunks_fetched", "snapshot_bytes_fetched")


def owner_tree_map(store) -> List[Tuple[str, str]]:
    """Every owner the store knows, with its stored tree text verbatim
    (both sides write trees with `merkle_tree_to_string`, so string
    equality is tree equality). One bulk query where the store has it."""
    if hasattr(store, "owner_trees"):
        return store.owner_trees()
    return [(u, store.get_merkle_tree_string(u)) for u in store.user_ids()]


def serve_summary(store, body: bytes, manager: Optional["ReplicationManager"]) -> bytes:
    """Handler body for `POST /replicate/summary`: decode the caller's
    summary, arm the local manager's hint if the caller advertises anything
    we diverge from, and answer with our summary (scoped to the caller's
    placement in a fleet). ValueError only on malformed input (→ 400)."""
    incoming = protocol.decode_replica_summary(body)
    mine = owner_tree_map(store)
    if manager is not None:
        by_owner = dict(mine)
        # "{}" is what an unseen owner's tree reads: lacking it is divergence.
        if any(by_owner.get(uid, "{}") != tree for uid, tree in incoming.trees):
            manager.hint()
    fleet = getattr(manager, "fleet", None) if manager is not None else None
    if fleet is not None and incoming.peer_url:
        # Advertise only owners placed on the caller: O(R) gossip. Owners
        # we store that belong to the caller are included even if we are
        # not placed for them, which is how a stray owner drains. An empty
        # peer_url (a pre-fleet peer) still gets everything.
        mine = [(uid, t) for uid, t in mine if fleet.placed_on(uid, incoming.peer_url)]
    return protocol.encode_replica_summary(
        protocol.ReplicaSummary(
            tuple(mine), manager.replica_id if manager is not None else "",
            fleet.self_url if fleet is not None else "",
        )
    )


def serve_pull(store, body: bytes, per_owner: Optional[int] = None,
               per_response: Optional[int] = None) -> bytes:
    """Handler body for `POST /replicate/pull`: ranged reads (strictly after
    `since`, every node's messages, earliest first and capped) with the
    tree at fetch time. Owners past the response budget are left out; the
    puller treats them as still diverged. The caps default to the module
    constants, read at serve time. ValueError only on malformed input."""
    cap_owner = PULL_MESSAGES_PER_OWNER if per_owner is None else int(per_owner)
    cap_resp = PULL_MESSAGES_PER_RESPONSE if per_response is None else int(per_response)
    req = protocol.decode_replica_pull(body)
    chunks = []
    served = 0
    for uid, since in req.pulls:
        if served >= cap_resp:
            break
        msgs = store.replica_messages(uid, since, min(cap_owner, cap_resp - served))
        served += len(msgs)
        chunks.append(protocol.OwnerMessages(uid, msgs, store.get_merkle_tree_string(uid)))
    return protocol.encode_replica_pull_response(protocol.ReplicaPullResponse(tuple(chunks)))


class _ManagerStopping(Exception):
    """Raised between a round's HTTP legs once stop() is underway: the round
    aborts (a half-ingested round is safe) instead of holding the loop
    thread through more socket timeouts."""


class _Peer:
    """A peer's gossip state: due time and the consecutive-failure count
    that drives the bounded backoff."""

    __slots__ = ("url", "failures", "next_due")

    def __init__(self, url: str, now: float):
        self.url = url.rstrip("/")
        self.failures = 0
        self.next_due = now  # gossip immediately on start


class ReplicationManager:
    """The gossip loop of one relay: a background thread runs a round
    against each peer when due (every `interval_s`, earlier after `hint()`,
    later under backoff). `run_once()` runs one synchronous round against
    every peer on the calling thread.

    `http_post` is injectable (fault-injection tests partition the cluster
    by raising from it); the default is `sync.client._http_post` with
    `retries=0`: the round-level backoff owns retry pacing. Any argument
    left at None among the pull caps and `bootstrap_lag_owners` resolves
    from `utils.config.default_config`."""

    def __init__(
        self,
        store,
        peers: Sequence[str],
        replica_id: Optional[str] = None,
        scheduler=None,
        interval_s: float = 30.0,
        debounce_s: float = 0.05,
        backoff_base_s: Optional[float] = None,
        backoff_max_s: float = 30.0,
        http_post: Optional[Callable[[str, bytes], bytes]] = None,
        rng=None,
        pull_chunk: int = PULL_OWNERS_PER_REQUEST,
        pull_messages_per_owner: Optional[int] = None,
        pull_messages_per_response: Optional[int] = None,
        bootstrap_lag_owners: Optional[int] = None,
        snapshot_chunk_bytes: Optional[int] = None,
        write_behind=None,
        push_hub=None,
    ):
        import functools
        import random

        from evolu_tpu_torch.sync.client import BACKOFF_BASE_S, _http_post
        from evolu_tpu_torch.utils import config

        cfg = config.default_config
        if pull_messages_per_owner is None:
            pull_messages_per_owner = cfg.pull_messages_per_owner
        if pull_messages_per_response is None:
            pull_messages_per_response = cfg.pull_messages_per_response
        if bootstrap_lag_owners is None:
            bootstrap_lag_owners = cfg.bootstrap_lag_owners

        self.store = store
        self.scheduler = scheduler
        self.write_behind = write_behind
        self.push_hub = push_hub
        self.replica_id = replica_id or f"relay-{random.getrandbits(48):012x}"
        self.interval_s = float(interval_s)
        self.debounce_s = float(debounce_s)
        self.backoff_base_s = BACKOFF_BASE_S if backoff_base_s is None else float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.pull_chunk = int(pull_chunk)
        # The serve_pull caps this relay answers with (None = the module
        # constants at serve time).
        self.pull_messages_per_owner = pull_messages_per_owner
        self.pull_messages_per_response = pull_messages_per_response
        # Snapshot bootstrap: None disables the trigger; an int N arms it
        # (see `_should_bootstrap`).
        self.bootstrap_lag_owners = bootstrap_lag_owners
        self.snapshot_chunk_bytes = snapshot_chunk_bytes
        self._snapshot_cache = None
        self._snapshot_cache_lock = threading.Lock()
        self._post = http_post or functools.partial(_http_post, retries=0)
        self._rng = rng or random.random
        # The owner-sharded fleet (server/fleet.py), attached by
        # RelayServer.enable_fleet: scopes summaries and pulls to placement
        # and turns the whole-store bootstrap off.
        self.fleet = None
        now = time.monotonic()
        self._peers = [_Peer(u, now) for u in peers]
        self._counts_lock = threading.Lock()
        self.peer_counts: Dict[str, Dict[str, int]] = {}
        self.round_trips = dict.fromkeys(("summary", "pull", "snapshot", "snapshot/chunk"), 0)
        self._swap_checked = False
        self._cv = threading.Condition()
        self._hint_at: Optional[float] = None
        self._stopping = False
        self._thread: Optional[threading.Thread] = None
        self._pool = None

    def _count(self, url: str, key: str, n: int = 1) -> None:
        with self._counts_lock:
            c = self.peer_counts.setdefault(url, dict.fromkeys(PEER_COUNTS, 0))
            c[key] += n

    # -- lifecycle --

    def start(self) -> "ReplicationManager":
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, daemon=True, name="evolu-replicate")
            self._thread.start()
        return self

    def stop(self) -> None:
        """Idempotent; joins the loop thread. `_post_checked` aborts an
        in-flight round at its next HTTP leg. A leg still blocked past the
        join's timeout leaves the daemon thread to finish on its own (the
        pool is not torn from under it)."""
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=35.0)
            if self._thread.is_alive():
                return
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def add_peer(self, url: str) -> None:
        """Register a peer after construction (mutual peering, fleet
        reloads). Idempotent under the manager's lock. Gossips it at once."""
        with self._cv:
            if any(p.url == url.rstrip("/") for p in self._peers):
                return
            self._peers.append(_Peer(url, time.monotonic()))
            self._cv.notify()

    def hint(self) -> None:
        """Debounced write hint: a burst of local writes (or a peer summary
        showing divergence) coalesces into one early sweep `debounce_s`
        after the first hint. Peers in backoff are not pulled forward."""
        with self._cv:
            if self._stopping:
                return
            if self._hint_at is None:
                self._hint_at = time.monotonic() + self.debounce_s
                self._cv.notify()

    # -- the loop --

    def _loop(self) -> None:
        while True:
            with self._cv:
                due: List[_Peer] = []
                while not self._stopping:
                    now = time.monotonic()
                    if self._hint_at is not None and now >= self._hint_at:
                        self._hint_at = None
                        for p in self._peers:
                            if p.failures == 0:
                                p.next_due = now
                    due = [p for p in self._peers if p.next_due <= now]
                    if due:
                        break
                    wakes = [p.next_due for p in self._peers]
                    if self._hint_at is not None:
                        wakes.append(self._hint_at)
                    # Capped so stop() is noticed even without a notify.
                    wake_in = (min(wakes) - now) if wakes else 5.0
                    self._cv.wait(timeout=max(0.0, min(wake_in, 5.0)))
                if self._stopping:
                    return
            for p in due:
                with self._cv:
                    if self._stopping:
                        return
                self._round(p)

    def run_once(self) -> None:
        """One synchronous round against every peer on the calling thread
        (ignores due times)."""
        for p in self._peers:
            self._round(p)

    @property
    def snapshot_cache(self):
        """The donor-side snapshot cache, built lazily. Lock-guarded so two
        peers' first concurrent requests share one capture."""
        with self._snapshot_cache_lock:
            if self._snapshot_cache is None:
                from evolu_tpu_torch.server.snapshot import SNAPSHOT_CHUNK_BYTES, SnapshotCache

                self._snapshot_cache = SnapshotCache(
                    self.store, chunk_bytes=self.snapshot_chunk_bytes or SNAPSHOT_CHUNK_BYTES)
            return self._snapshot_cache

    def _post_checked(self, url: str, body: bytes) -> bytes:
        """The round's transport: a stop check before each leg, and one
        round trip counted a leg."""
        if self._stopping:
            raise _ManagerStopping()
        leg = url.rsplit("/replicate/", 1)[-1]
        with self._counts_lock:
            self.round_trips[leg] = self.round_trips.get(leg, 0) + 1
        return self._post(url, body)

    def _finish_pending_swap_once(self) -> None:
        """A crash between shard swaps leaves a verified install half
        swapped in (phase=swap), and the half-swapped tables may advertise
        enough owners that the bootstrap trigger never fires again: the
        first round of any manager finishes it. Probes `sqlite_master`
        first, so a store that never bootstrapped grows no state table."""
        if self._swap_checked:
            return
        self._swap_checked = True
        try:
            shard0 = (getattr(self.store, "shards", None) or [self.store])[0]
            have = shard0.db.exec_sql_query(
                "SELECT name FROM sqlite_master WHERE type='table' AND name='snapshotBootstrapState'")
            if not have:
                return
            from evolu_tpu_torch.server import snapshot as snap

            inst = snap.SnapshotInstaller(self.store)
            st = inst.pending()
            if st is not None and st["phase"] == "swap":
                inst.finish_swap()
                self._count(st["peer"], "snapshot_bootstraps")
        except Exception:  # noqa: BLE001 - recovery never blocks gossip;
            self._swap_checked = False  # the pending state stays for the next try

    def _round(self, peer: _Peer) -> None:
        self._finish_pending_swap_once()
        try:
            if self.write_behind is not None:
                # Advertise only committed state.
                self.write_behind.flush()
            pulled = self._gossip(peer)
        except _ManagerStopping:
            return  # tearing down, not a peer failure
        except Exception:  # noqa: BLE001 - a peer failure never kills the loop
            peer.failures += 1
            self._count(peer.url, "rounds_error")
            # Bounded exponential backoff with jitter: delay in [0.5, 1.0] x
            # min(max, base * 2^failures), never zero.
            delay = min(self.backoff_max_s, self.backoff_base_s * (2 ** min(peer.failures, 20))) \
                * (0.5 + 0.5 * self._rng())
            peer.next_due = time.monotonic() + delay
            return
        peer.failures = 0
        self._count(peer.url, "rounds_ok")
        peer.next_due = time.monotonic() + self.interval_s
        if pulled:
            # Freshly pulled rows may need to travel further (chain
            # topologies): the next hop leaves at debounce latency. A
            # converged mesh pulls nothing, so the chain ends.
            self.hint()

    # -- one gossip round --

    def _gossip(self, peer: _Peer) -> int:
        """Summary exchange → per-owner diff → ranged pull → ingest. →
        the number of messages pulled (or installed by a bootstrap)."""
        local = dict(owner_tree_map(self.store))  # one bulk read
        send = local
        if self.fleet is not None:
            # Advertise to this peer only the owners placed on it (strays
            # included) and carry our URL so it scopes its answer alike.
            send = {uid: t for uid, t in local.items() if self.fleet.placed_on(uid, peer.url)}
        mine = protocol.ReplicaSummary(
            tuple(send.items()), self.replica_id,
            self.fleet.self_url if self.fleet is not None else "",
        )
        resp = protocol.decode_replica_summary(
            self._post_checked(peer.url + "/replicate/summary", protocol.encode_replica_summary(mine)))
        if self._should_bootstrap(local, resp.trees):
            # The donor may have written past the snapshot's watermark: the
            # nonzero return arms the hint, and the next round pulls the tail.
            return self._bootstrap(peer)
        diverged: List[Tuple[str, str]] = []  # (owner, since)
        for uid, peer_tree_s in resp.trees:
            if self.fleet is not None and not self.fleet.placed_on(uid, self.fleet.self_url):
                continue  # never pull an owner we are not placed for
            # Compare and diff the same bulk snapshot: no per-owner re-reads.
            local_s = local.get(uid, "{}")
            if local_s == peer_tree_s:
                continue
            diff = diff_merkle_trees(merkle_tree_from_string(local_s), merkle_tree_from_string(peer_tree_s))
            if diff is None:
                continue  # hash-equal roots
            diverged.append((uid, timestamp_to_string(create_sync_timestamp(diff))))
        if not diverged:
            return 0
        self._count(peer.url, "owners_diffed", len(diverged))
        requests: List[protocol.SyncRequest] = []
        pulled = 0
        for i in range(0, len(diverged), self.pull_chunk):
            pull = protocol.ReplicaPull(tuple(diverged[i : i + self.pull_chunk]), self.replica_id)
            pr = protocol.decode_replica_pull_response(
                self._post_checked(peer.url + "/replicate/pull", protocol.encode_replica_pull(pull)))
            for om in pr.chunks:
                pulled += len(om.messages)
                if om.messages:
                    # The peer's tree rides as the request's client tree: once
                    # the ingest makes ours equal, the response is empty.
                    requests.append(protocol.SyncRequest(om.messages, om.user_id, SYNC_NODE_ID, om.merkle_tree))
        self._count(peer.url, "messages_pulled", pulled)
        self._ingest(requests)
        return pulled

    # -- snapshot bootstrap (server/snapshot.py) --

    def _should_bootstrap(self, local: dict, advertised) -> bool:
        """Install a snapshot instead of crawling history when the local
        store is empty, or lacks both at least `bootstrap_lag_owners` of the
        advertised owners and the majority of them (one new owner on a
        converged mesh stays a ranged pull). None disables; a fleet member
        never whole-store bootstraps (its moves are owner-granular)."""
        if self.fleet is not None:
            return False
        if self.bootstrap_lag_owners is None or not advertised:
            return False
        if not local:
            return True
        unknown = sum(1 for uid, _t in advertised if uid not in local)
        return unknown >= max(1, self.bootstrap_lag_owners) and unknown * 2 > len(advertised)

    def bootstrap_from(self, peer_url: str) -> int:
        """One snapshot bootstrap against `peer_url` on the calling thread.
        Returns the number of message rows installed."""
        return self._bootstrap(_Peer(peer_url, time.monotonic()))

    def _bootstrap(self, peer: _Peer) -> int:
        """Manifest → resumable chunk fetches → crash-consistent install →
        verify → swap. The chunk watermark lives in the store, so an
        interrupted fetch resumes from the last committed chunk; a donor
        that no longer serves the snapshot (400 on the chunk leg) drops the
        install and the next round starts fresh.

        With a write-behind queue the whole bootstrap runs behind its
        `drain_barrier()`: the swap replaces shard contents, and a record
        ACKed against the pre-swap tree would later drain its stale tree
        over the installed one. The barrier also drops the serve-time
        trees, so a concurrent serve's base-tree read waits for the swap."""
        if self.write_behind is not None:
            with self.write_behind.drain_barrier():
                return self._bootstrap_locked(peer)
        return self._bootstrap_locked(peer)

    def _bootstrap_locked(self, peer: _Peer) -> int:
        import urllib.error

        from evolu_tpu_torch.server import snapshot as snap

        inst = snap.SnapshotInstaller(self.store)
        manifest, start = None, 0
        st = inst.pending()
        if st is not None and st["phase"] == "swap":
            # Died between shard swaps: the data was verified before the
            # swap began, and finishing is peer-independent.
            inst.finish_swap()
            self._count(peer.url, "snapshot_bootstraps")
            return 0
        if st is not None and st["peer"] != peer.url:
            with self._cv:
                known = any(p.url == st["peer"] for p in self._peers)
            if known:
                # The watermark belongs to another configured peer: resume
                # against it (only it serves this snapshot id).
                peer = _Peer(st["peer"], time.monotonic())
            else:
                inst.abort()  # an unconfigured peer's stale install
                st = None
        if st is not None:
            manifest, start = st["manifest"], st["next_chunk"]
            if start:
                self._count(peer.url, "snapshot_resumes")
        if manifest is None:
            body = protocol.encode_snapshot_request(
                protocol.SnapshotRequest(self.replica_id, self.snapshot_chunk_bytes or 0))
            manifest = protocol.decode_snapshot_manifest(
                self._post_checked(peer.url + "/replicate/snapshot", body))
            inst.begin(manifest, peer.url)
        try:
            for i in range(start, len(manifest.chunk_sizes)):
                req = protocol.encode_snapshot_chunk_request(
                    protocol.SnapshotChunkRequest(manifest.snapshot_id, i, self.replica_id))
                try:
                    raw = self._post_checked(peer.url + "/replicate/snapshot/chunk", req)
                except urllib.error.HTTPError as e:
                    if e.code == 400:
                        # The donor no longer serves this snapshot id.
                        inst.abort()
                        self._count(peer.url, "snapshot_expired")
                    raise
                chunk = protocol.decode_snapshot_chunk(raw)
                if (chunk.snapshot_id != manifest.snapshot_id or chunk.index != i
                        or len(chunk.payload) != manifest.chunk_sizes[i]
                        or chunk.crc != manifest.chunk_crcs[i]):
                    raise snap.SnapshotInstallError(
                        f"snapshot chunk {i}: response does not match the manifest (id/index/size/crc)")
                inst.install_chunk(i, chunk.payload, expected_crc=manifest.chunk_crcs[i])
                self._count(peer.url, "snapshot_chunks_fetched")
                self._count(peer.url, "snapshot_bytes_fetched", len(chunk.payload))
            inst.verify(manifest)
        except (_ManagerStopping, urllib.error.URLError, OSError):
            raise  # transport interruptions keep the watermark
        except snap.SnapshotInstallError:
            # The shipped bytes are not trustworthy: drop everything and
            # refetch. The live tables are untouched.
            inst.abort()
            self._count(peer.url, "snapshot_errors")
            raise
        inst.swap()
        self._count(peer.url, "snapshot_bootstraps")
        if self.push_hub is not None:
            # A whole-store install changed arbitrarily many owners at once:
            # per-row attribution is gone, so wake everything.
            self.push_hub.notify_all(reason="conservative")
        return manifest.message_count

    def _ingest(self, requests: List[protocol.SyncRequest]) -> None:
        """Apply pulled messages through the relay's own serving paths (the
        changes==1 Merkle gate and the non-canonical host route apply as to
        clients). With a scheduler the requests are submitted concurrently,
        so the dispatcher fuses them, with each other and with live client
        traffic, into engine passes on the card; without one they take the
        per-request path. The first failure is raised after every request
        has finished, and after the push subscribers of the requests that
        did commit were woken."""
        if not requests:
            return
        if self.scheduler is not None:
            futures = [self._ingest_pool().submit(self.scheduler.submit, r) for r in requests]
            first_err: Optional[BaseException] = None
            served = []
            for r, f in zip(requests, futures):
                e = f.exception()
                if e is None:
                    served.append(r)
                first_err = first_err or e
            self._notify_push(served)
            if first_err is not None:
                raise first_err
            return
        from evolu_tpu_torch.server.relay import serve_single_request

        served = []
        try:
            for r in requests:
                serve_single_request(self.store, r)
                served.append(r)
        finally:
            self._notify_push(served)

    def _notify_push(self, requests: List[protocol.SyncRequest]) -> None:
        """Wake parked push subscriptions for rows replication just landed
        (AFTER the serve committed them). The pulled messages' plaintext
        timestamps carry the ORIGINAL author nodes, so the hub's own-write
        exclusion holds across relays."""
        if self.push_hub is None:
            return
        for r in requests:
            if r.messages:
                self.push_hub.notify(r.user_id, [m.timestamp for m in r.messages], reason="replication")

    def _ingest_pool(self):
        if self._stopping:
            raise _ManagerStopping()  # never mint an executor during teardown
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=8, thread_name_prefix="evolu-repl-ingest")
        return self._pool

    # -- observability --

    def stats_payload(self) -> dict:
        """The `replication` section of GET /stats: each peer's health and
        counts, and this process's snapshot-donor counts. The two quantiles
        are null until the observability item is ported."""
        from evolu_tpu_torch.server import snapshot as snap

        peers = []
        for p in self._peers:
            with self._counts_lock:
                c = dict(self.peer_counts.get(p.url, dict.fromkeys(PEER_COUNTS, 0)))
            peers.append({
                "url": p.url,
                "healthy": p.failures == 0,
                "failures": p.failures,
                "rounds_ok": c["rounds_ok"],
                "rounds_error": c["rounds_error"],
                "owners_diffed": c["owners_diffed"],
                "messages_pulled": c["messages_pulled"],
                "convergence_lag_p99_ms": None,
                "snapshot_bootstraps": c["snapshot_bootstraps"],
                "snapshot_chunks_fetched": c["snapshot_chunks_fetched"],
                "snapshot_bytes_fetched": c["snapshot_bytes_fetched"],
            })
        with snap._counts_lock:
            donor = dict(snap.counts)
        return {
            "replica_id": self.replica_id,
            "peers": peers,
            "snapshot": {
                "captures": donor["captures"],
                "capture_rows": donor["capture_rows"],
                "capture_bytes": donor["capture_bytes"],
                "manifests_served": donor["manifests_served"],
                "chunks_served": donor["chunks_served"],
                "chunk_bytes_served": donor["chunk_bytes_served"],
                "checkpoints": donor["checkpoints"],
                "install_p99_ms": None,
            },
        }
