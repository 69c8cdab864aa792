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

Observability as the reference's: the `evolu_repl_*` families (rounds,
peer health, hints, round trips, diffs, pulls and serves, the convergence
lag) and the installer's `evolu_snap_*`; the `repl.round` span, which
joins the trace of the write whose `hint(origin=)` armed it (later origins
ride as links), with a `repl.<leg>` child span a HTTP leg whose context
rides the traceparent header to the peer's `repl.serve`, and
`repl.ingest`; `_gossip`'s per-owner freshness gauges and its
write-visible lag histogram; the conservation ledger's
`ingress.replication` for every pulled message the serve path landed; log
lines for divergence, failed rounds and bootstraps. Plain `counts` are
kept beside them (per peer in `peer_counts`, HTTP legs in `round_trips`);
`stats_payload` answers the reference's keys from them, with
`convergence_lag_p99_ms` and `install_p99_ms` from the registry. With a
`write_behind` queue (storage/write_behind.py) a round flushes it before
it advertises (a drain failure is the round's failure), and a snapshot
bootstrap runs behind its `drain_barrier()`. With a `push_hub`, every
ingest wakes the owner's parked push subscriptions (reason "replication"),
and a snapshot install wakes them all (reason "conservative").
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from evolu_tpu_torch.core.merkle import diff_merkle_trees, merkle_tree_from_string
from evolu_tpu_torch.core.timestamp import (
    SYNC_NODE_ID,
    create_sync_timestamp,
    iso_to_millis,
    timestamp_to_string,
)
from evolu_tpu_torch.core.types import TimestampParseError
from evolu_tpu_torch.obs import ledger, metrics, trace
from evolu_tpu_torch.sync import aead, protocol
from evolu_tpu_torch.utils.log import log

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


def serve_summary(store, body: bytes, manager: Optional["ReplicationManager"], origin=None) -> bytes:
    """Handler body for `POST /replicate/summary`: decode the caller's
    summary, arm the local manager's hint if the caller advertises anything
    we diverge from, and answer with our summary (scoped to the caller's
    placement in a fleet). `origin` is the caller's trace context (the
    relay parses it off the traceparent header): a divergence-armed hint
    carries it, so our next round records into the same convergence
    trace. ValueError only on malformed input (→ 400)."""
    incoming = protocol.decode_replica_summary(body)
    mine = owner_tree_map(store)
    if manager is not None:
        by_owner = dict(mine)
        # "{}" is what an unseen owner's tree reads: lacking it is divergence.
        if any(by_owner.get(uid, "{}") != tree for uid, tree in incoming.trees):
            manager.hint(origin=origin)
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
    # Unlabeled: the wire `replica_id` is untrusted input, and a label a
    # distinct value would grow the registry without bound.
    metrics.inc("evolu_repl_messages_served_total", served)
    return protocol.encode_replica_pull_response(protocol.ReplicaPullResponse(tuple(chunks)))


class _ManagerStopping(Exception):
    """Raised between a round's HTTP legs once stop() is underway: the round
    aborts (a half-ingested round is safe) instead of holding the loop
    thread through more socket timeouts."""


class _Peer:
    """A peer's gossip state: due time, the consecutive-failure count that
    drives the bounded backoff, and since when it has been diverged (the
    convergence lag's start)."""

    __slots__ = ("url", "failures", "next_due", "diverged_since")

    def __init__(self, url: str, now: float):
        self.url = url.rstrip("/")
        self.failures = 0
        self.next_due = now  # gossip immediately on start
        self.diverged_since: Optional[float] = None


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
        # The trace contexts of recent write hints (the origin traces of the
        # convergence trace), drained by the next round; bounded and
        # deduped, the newest 8 kept.
        self._hint_origins: List = []
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
        metrics.set_gauge("evolu_repl_peers", len(self._peers), replica=self.replica_id)
        for p in self._peers:
            metrics.set_gauge("evolu_repl_peer_healthy", 1, replica=self.replica_id, peer=p.url)

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
                log("server", "replication loop still blocked at stop; leaving the daemon thread",
                    replica=self.replica_id)
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
            p = _Peer(url, time.monotonic())
            self._peers.append(p)
            metrics.set_gauge("evolu_repl_peers", len(self._peers), replica=self.replica_id)
            metrics.set_gauge("evolu_repl_peer_healthy", 1, replica=self.replica_id, peer=p.url)
            self._cv.notify()

    def hint(self, origin=None) -> None:
        """Debounced write hint: a burst of local writes (or a peer summary
        showing divergence) coalesces into one early sweep `debounce_s`
        after the first hint. Peers in backoff are not pulled forward.
        `origin`, the hinting write's trace context, is remembered
        (bounded, deduped), so the round this hint arms records its spans
        into the trace the client's mutation started: the convergence
        trace."""
        with self._cv:
            if self._stopping:
                return
            if origin is not None and origin.sampled:
                if not any(o.trace_id == origin.trace_id for o in self._hint_origins):
                    self._hint_origins.append(origin)
                    del self._hint_origins[:-8]  # keep the newest 8
            if self._hint_at is None:
                self._hint_at = time.monotonic() + self.debounce_s
                metrics.inc("evolu_repl_hints_total", replica=self.replica_id)
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
        from evolu_tpu_torch.sync.client import _accepts_headers

        leg = url.rsplit("/replicate/", 1)[-1] if "/replicate/" in url else "other"
        with self._counts_lock:
            self.round_trips[leg] = self.round_trips.get(leg, 0) + 1
        metrics.inc("evolu_repl_round_trips_total", replica=self.replica_id, leg=leg)
        # Each HTTP leg is a child span of the ambient round span, and its
        # context rides the traceparent header (the wire bytes are
        # untouched): the serving peer's repl.serve joins the same trace.
        # Header support is probed at call time: `_post` is swappable, and
        # a 2-argument transport is served without the header.
        lspan = trace.start_span(f"repl.{leg}", parent=trace.current())
        with lspan:
            hdrs = trace.inject_headers(ctx=lspan.context)
            if hdrs and _accepts_headers(self._post):
                return self._post(url, body, headers=hdrs)
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
                metrics.inc("evolu_snap_installs_total", result="ok", replica=self.replica_id,
                            peer=st["peer"])
                log("server", "finished stranded snapshot swap", snapshot=st["snapshot_id"],
                    peer=st["peer"])
        except Exception as e:  # noqa: BLE001 - recovery never blocks gossip;
            self._swap_checked = False  # the pending state stays for the next try
            log("server", "pending snapshot swap check failed", error=repr(e))

    def _restore_origins(self, origins: List) -> None:
        with self._cv:
            self._hint_origins = origins + self._hint_origins
            del self._hint_origins[:-8]

    def _round(self, peer: _Peer) -> None:
        self._finish_pending_swap_once()
        labels = {"replica": self.replica_id, "peer": peer.url}
        # Drain the hint origins: the round span joins the FIRST origin's
        # trace (the convergence trace the client's mutation started) and
        # links the rest, as the scheduler's batch span does. They are
        # restored on a failure, so a retried round lands in the right
        # trace.
        with self._cv:
            origins, self._hint_origins = self._hint_origins, []
        rspan = trace.start_span("repl.round", parent=origins[0] if origins else None,
                                 links=origins[1:], attrs={"peer": peer.url})
        try:
            with rspan, trace.use(rspan.context):
                if self.write_behind is not None:
                    # Advertise only committed state.
                    self.write_behind.flush()
                converged, pulled = self._gossip(peer)
        except _ManagerStopping:
            self._restore_origins(origins)
            return  # tearing down, not a peer failure
        except Exception as e:  # noqa: BLE001 - a peer failure never kills the loop
            self._restore_origins(origins)
            peer.failures += 1
            self._count(peer.url, "rounds_error")
            metrics.inc("evolu_repl_peer_failures_total", **labels)
            metrics.inc("evolu_repl_rounds_total", result="error", **labels)
            metrics.set_gauge("evolu_repl_peer_healthy", 0, **labels)
            # Bounded exponential backoff with jitter: delay in [0.5, 1.0] x
            # min(max, base * 2^failures), never zero.
            delay = min(self.backoff_max_s, self.backoff_base_s * (2 ** min(peer.failures, 20))) \
                * (0.5 + 0.5 * self._rng())
            peer.next_due = time.monotonic() + delay
            log("server", "replication round failed", peer=peer.url, error=repr(e),
                failures=peer.failures, retry_s=round(delay, 3))
            return
        peer.failures = 0
        self._count(peer.url, "rounds_ok")
        metrics.inc("evolu_repl_rounds_total", result="ok", **labels)
        metrics.set_gauge("evolu_repl_peer_healthy", 1, **labels)
        if converged and peer.diverged_since is not None:
            metrics.observe("evolu_repl_convergence_lag_ms", (time.monotonic() - peer.diverged_since) * 1e3,
                            exemplar=rspan.trace_id, **labels)
            peer.diverged_since = None
        peer.next_due = time.monotonic() + self.interval_s
        if pulled:
            # Freshly pulled rows may need to travel further (chain
            # topologies): the next hop leaves at debounce latency, in the
            # same convergence trace. A converged mesh pulls nothing, so
            # the chain ends.
            self.hint(origin=rspan.context)

    # -- one gossip round --

    def _gossip(self, peer: _Peer) -> Tuple[bool, int]:
        """Summary exchange → per-owner diff → ranged pull → ingest. →
        (converged, messages pulled or installed by a bootstrap): converged
        when the round ends with every diverged owner's tree equal to the
        peer's at pull time (the convergence lag's end)."""
        labels = {"replica": self.replica_id, "peer": peer.url}
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
            if peer.diverged_since is None:
                peer.diverged_since = time.monotonic()
            # Not converged yet: the donor may have written past the
            # snapshot's watermark; the nonzero return arms the hint, and
            # the next round pulls the tail.
            return False, self._bootstrap(peer)
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
            return True, 0
        if peer.diverged_since is None:
            peer.diverged_since = time.monotonic()
        self._count(peer.url, "owners_diffed", len(diverged))
        metrics.inc("evolu_repl_owners_diffed_total", len(diverged), **labels)
        log("server", "replication divergence", peer=peer.url, owners=len(diverged))
        peer_tree_at_pull = {}
        requests: List[protocol.SyncRequest] = []
        freshness: Dict[str, int] = {}  # owner → the newest pulled HLC millis
        pulled = 0
        for i in range(0, len(diverged), self.pull_chunk):
            pull = protocol.ReplicaPull(tuple(diverged[i : i + self.pull_chunk]), self.replica_id)
            pr = protocol.decode_replica_pull_response(
                self._post_checked(peer.url + "/replicate/pull", protocol.encode_replica_pull(pull)))
            for om in pr.chunks:
                peer_tree_at_pull[om.user_id] = om.merkle_tree
                pulled += len(om.messages)
                if om.messages:
                    # The peer's tree rides as the request's client tree: once
                    # the ingest makes ours equal, the response is empty.
                    requests.append(protocol.SyncRequest(om.messages, om.user_id, SYNC_NODE_ID, om.merkle_tree))
                    try:
                        # Messages arrive in timestamp order: the last one's
                        # HLC millis is the owner's watermark. A
                        # non-canonical timestamp skips the gauge, never
                        # the round.
                        freshness[om.user_id] = max(freshness.get(om.user_id, 0),
                                                    iso_to_millis(om.messages[-1].timestamp[:24]))
                    except (ValueError, TimestampParseError):
                        pass
        self._count(peer.url, "messages_pulled", pulled)
        metrics.inc("evolu_repl_messages_pulled_total", pulled, **labels)
        ispan = trace.start_span("repl.ingest", parent=trace.current(),
                                 attrs={"peer": peer.url, "owners": len(requests), "messages": pulled})
        with ispan:
            self._ingest(requests)
        # The convergence plane: per (owner, peer) the newest HLC millis this
        # replica has seen from that peer, and the write-to-visible lag from
        # the millis the rows carry against this host's wall clock. The
        # registry's label-cardinality bound keeps the gauges finite.
        now_ms = time.time() * 1e3
        for uid, newest in freshness.items():
            metrics.set_gauge("evolu_conv_owner_freshness_millis", newest,
                              replica=self.replica_id, peer=peer.url, owner=uid)
            metrics.observe("evolu_conv_write_visible_ms", max(0.0, now_ms - newest),
                            exemplar=ispan.trace_id, replica=self.replica_id, peer=peer.url)
        converged = all(self.store.get_merkle_tree_string(uid) == peer_tree_at_pull.get(uid, object())
                        for uid, _since in diverged)
        return converged, pulled

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

        labels = {"replica": self.replica_id, "peer": peer.url}
        inst = snap.SnapshotInstaller(self.store)
        t0 = time.perf_counter()
        manifest, start = None, 0
        st = inst.pending()
        if st is not None and st["phase"] == "swap":
            # Died between shard swaps: the data was verified before the
            # swap began, and finishing is peer-independent.
            inst.finish_swap()
            self._count(peer.url, "snapshot_bootstraps")
            metrics.observe("evolu_snap_install_ms", (time.perf_counter() - t0) * 1e3)
            metrics.inc("evolu_snap_installs_total", result="ok", **labels)
            return 0
        if st is not None and st["peer"] != peer.url:
            with self._cv:
                known = any(p.url == st["peer"] for p in self._peers)
            if known:
                # The watermark belongs to another configured peer: resume
                # against it (only it serves this snapshot id).
                peer = _Peer(st["peer"], time.monotonic())
                labels = {"replica": self.replica_id, "peer": peer.url}
            else:
                inst.abort()  # an unconfigured peer's stale install
                st = None
        if st is not None:
            manifest, start = st["manifest"], st["next_chunk"]
            if start:
                self._count(peer.url, "snapshot_resumes")
                metrics.inc("evolu_snap_resumes_total", **labels)
                log("server", "snapshot bootstrap resuming", peer=peer.url, snapshot=manifest.snapshot_id,
                    next_chunk=start, chunks=len(manifest.chunk_sizes))
        if manifest is None:
            body = protocol.encode_snapshot_request(
                protocol.SnapshotRequest(self.replica_id, self.snapshot_chunk_bytes or 0))
            manifest = protocol.decode_snapshot_manifest(
                self._post_checked(peer.url + "/replicate/snapshot", body))
            inst.begin(manifest, peer.url)
            log("server", "snapshot bootstrap starting", peer=peer.url, snapshot=manifest.snapshot_id,
                owners=len(manifest.owners), rows=manifest.message_count, bytes=manifest.total_bytes,
                chunks=len(manifest.chunk_sizes))
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
                        metrics.inc("evolu_snap_installs_total", result="expired", **labels)
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
                metrics.inc("evolu_snap_chunks_fetched_total", **labels)
                metrics.inc("evolu_snap_bytes_fetched_total", len(chunk.payload), **labels)
            inst.verify(manifest)
        except (_ManagerStopping, urllib.error.URLError, OSError):
            raise  # transport interruptions keep the watermark
        except snap.SnapshotInstallError:
            # The shipped bytes are not trustworthy: drop everything and
            # refetch. The live tables are untouched.
            inst.abort()
            self._count(peer.url, "snapshot_errors")
            metrics.inc("evolu_snap_installs_total", result="error", **labels)
            raise
        inst.swap()
        self._count(peer.url, "snapshot_bootstraps")
        metrics.observe("evolu_snap_install_ms", (time.perf_counter() - t0) * 1e3)
        metrics.inc("evolu_snap_installs_total", result="ok", **labels)
        log("server", "snapshot bootstrap installed", peer=peer.url, snapshot=manifest.snapshot_id,
            rows=manifest.message_count, owners=len(manifest.owners))
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
        n_v2 = sum(aead.count_v2(r.messages) for r in requests)
        if n_v2:
            # Peer pulls carry stored ciphertext verbatim: v2 records cross
            # the replication surface as opaquely as v1 ones.
            metrics.inc("evolu_crypto_v2_replicated_messages_total", n_v2)
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
            self._ledger_ingress(served)
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
            self._ledger_ingress(served)

    @staticmethod
    def _ledger_ingress(served: List[protocol.SyncRequest]) -> None:
        """The ledger's ingress for the pulled messages the serve path
        landed: the serve posted their store terminals, so only requests
        that were served enter. A failed submit posted neither side, and
        the next round's re-pull is a fresh delivery."""
        for r in served:
            ledger.count(ledger.INGRESS_REPLICATION, len(r.messages), owner=r.user_id)

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
        counts, and this process's snapshot-donor counts; the convergence
        lag's and the install time's p99 from the registry (null before the
        first observation)."""
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
                "convergence_lag_p99_ms": metrics.quantile("evolu_repl_convergence_lag_ms", 0.99,
                                                           replica=self.replica_id, peer=p.url),
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
                "install_p99_ms": metrics.quantile("evolu_snap_install_ms", 0.99),
            },
        }
