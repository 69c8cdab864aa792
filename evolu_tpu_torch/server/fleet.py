"""Owner-sharded relay fleet: placement ring, routing, rebalancing.

The port's copy of `evolu_tpu.server.fleet`. It composes the relay tier
into a fleet that partitions owners across relays:

* **Placement ring** (`HashRing`): consistent hashing over owner ids with
  virtual nodes; every relay holding the same `FleetConfig` computes the
  same owner → (primary, replica, ...) placement, byte for byte the
  reference's (seeded blake2b, `_h64`).
* **Request routing** (`FleetManager.route`): a sync POST for an owner not
  placed here answers 307 with the authoritative relay's URL, or is
  proxy-forwarded through `POST /fleet/forward` (`FleetConfig.forward`; a
  forwarded request is never forwarded again). A down primary fails over
  to the next ring replica behind a cached `GET /health` probe.
* **Scoped replication**: a `ReplicationManager` with a fleet attached
  gossips each peer only the owners placed on it and pulls only owners
  placed on itself.
* **Snapshot-driven rebalancing**: after a ring change (`POST
  /fleet/reload`), the gaining relay installs the moved owners from the
  losing relay's owner-scoped snapshot through `store.add_messages` (the
  changes==1 XOR gate), serving an owner only once its tree matches the
  donor's watermark (503 + Retry-After until then). Writes the loser ACKed
  after the capture heal through scoped gossip.

Observability as the reference's: the `evolu_fleet_*` families (the
relay counts its redirects and forwards where it routes), the
conservation ledger's `ingress.snapshot` for every row a rebalance
installs (`store.add_messages` posts their store terminals), and log
lines for rebalances. Plain per-object `counts` are kept beside them.
With a `write_behind` queue an owner move installs behind its
`drain_barrier()`.

`python -m evolu_tpu_torch.server.fleet` runs one fleet relay process,
batching on the card with `--batching`.
"""

from __future__ import annotations

import bisect
import hashlib
import threading
import time
from contextlib import nullcontext
from typing import Dict, List, Optional, Sequence, Tuple

from evolu_tpu_torch.obs import ledger, metrics
from evolu_tpu_torch.sync import protocol
from evolu_tpu_torch.utils.config import FleetConfig
from evolu_tpu_torch.utils.log import log

# How long one readiness probe result is trusted.
PROBE_TTL_S = 1.0
# The Retry-After of a "not ready" answer (owner mid-install, no ready
# replica): the scheduler's backpressure contract.
NOT_READY_RETRY_S = 0.25

# A FleetManager's counts, the reference's evolu_fleet_* counters.
FLEET_COUNTS = ("redirects", "forwards", "forward_failures", "forwarded_served", "reloads",
                "not_ready", "rebalanced_owners", "rebalanced_messages", "cutovers_verified",
                "cutovers_superset", "failovers", "rebalance_failures")


def _h64(data: str, seed: int) -> int:
    """Stable 64-bit ring coordinate: seeded blake2b (seeded so disjoint
    fleets never agree on placement by accident)."""
    return int.from_bytes(hashlib.blake2b(f"{seed}|{data}".encode("utf-8"), digest_size=8).digest(), "big")


class HashRing:
    """Consistent-hash placement: owner id → an ordered tuple of R distinct
    relay URLs (primary first). A pure function of the FleetConfig; a
    membership change moves only the owners whose arc changed."""

    def __init__(self, config: FleetConfig):
        self.config = config
        relays: List[str] = []
        for u in config.relays:
            if u not in relays:  # dedupe, order-preserving
                relays.append(u)
        self.relays = tuple(relays)
        points: List[Tuple[int, str]] = []
        for url in self.relays:
            for v in range(max(1, config.virtual_nodes)):
                points.append((_h64(f"relay|{url}#{v}", config.seed), url))
        points.sort()
        self._points = [p for p, _u in points]
        self._urls = [u for _p, u in points]
        self._r = max(1, min(config.replication_factor, len(self.relays)))

    def placement(self, owner_id: str) -> Tuple[str, ...]:
        """The R distinct relays for `owner_id`, primary first: a clockwise
        walk from the owner's ring coordinate."""
        if not self._points:
            return ()
        h = _h64(f"owner|{owner_id}", self.config.seed)
        i = bisect.bisect_right(self._points, h)
        out: List[str] = []
        n = len(self._points)
        for k in range(n):
            url = self._urls[(i + k) % n]
            if url not in out:
                out.append(url)
                if len(out) == self._r:
                    break
        return tuple(out)

    def primary(self, owner_id: str) -> str:
        return self.placement(owner_id)[0]


class FleetNotReady(Exception):
    """The owner is placed here but mid-install (or no placed relay is
    ready): the relay answers 503 + Retry-After, flow control, not an
    error."""

    def __init__(self, retry_after: float = NOT_READY_RETRY_S):
        super().__init__(f"owner not ready; retry after {retry_after}s")
        self.retry_after = retry_after


class FleetManager:
    """One relay's view of the fleet: the ring, its own URL, the owners
    mid-install, the rebalance and the health-probe cache. Attached by
    `RelayServer.enable_fleet`; the handler calls `route()` for each sync
    POST, and the ReplicationManager reads `placed_on()`."""

    def __init__(self, store, config: FleetConfig, self_url: str, replication=None, http_post=None,
                 http_get=None, probe_ttl_s: float = PROBE_TTL_S, write_behind=None):
        import functools

        from evolu_tpu_torch.sync.client import _http_post

        self.store = store
        self.write_behind = write_behind
        self.self_url = self_url.rstrip("/")
        self.replication = replication
        self._post = http_post or functools.partial(_http_post, retries=0)
        self._get = http_get or _http_get_status
        self._probe_ttl_s = float(probe_ttl_s)
        self._lock = threading.RLock()
        self._installing: set = set()  # owners mid-rebalance (not served)
        self._probe_cache: Dict[str, Tuple[float, bool]] = {}
        self._rebalance_serial = threading.Lock()  # one rebalance at a time
        self._threads: List[threading.Thread] = []
        self._stopping = False
        self._manifest_owners: Optional[Tuple] = None  # the last install's watermarks
        self.counts = dict.fromkeys(FLEET_COUNTS, 0)
        self.config: Optional[FleetConfig] = None
        self.ring: Optional[HashRing] = None
        self.apply_config(config, rebalance=False)

    def _count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.counts[key] += n

    # -- placement queries --

    def placement(self, owner_id: str) -> Tuple[str, ...]:
        return self.ring.placement(owner_id)

    def placed_on(self, owner_id: str, url: str) -> bool:
        return url.rstrip("/") in self.ring.placement(owner_id)

    def is_primary(self, owner_id: str) -> bool:
        return self.ring.primary(owner_id) == self.self_url

    # -- request routing --

    def route(self, owner_id: str) -> Tuple[str, Optional[str]]:
        """→ ("local", None) | ("redirect" | "forward", peer_url). Raises
        FleetNotReady for an owner placed here but mid-install, or (forward
        mode) placed nowhere ready. A non-placed request goes to the first
        placed relay whose readiness probe passes; with none, redirect mode
        still names the primary (the client's backoff pays the retry)."""
        placement = self.ring.placement(owner_id)
        if self.self_url in placement:
            with self._lock:
                if owner_id in self._installing:
                    self.counts["not_ready"] += 1
                    metrics.inc("evolu_fleet_not_ready_total")
                    raise FleetNotReady()
            return ("local", None)
        mode = "forward" if self.config.forward else "redirect"
        for url in placement:
            if self._peer_serving(url):
                if url != placement[0]:
                    self._count("failovers")
                    metrics.inc("evolu_fleet_failovers_total")
                return (mode, url)
        if not placement:
            return ("local", None)
        if mode == "redirect":
            return (mode, placement[0])
        # Forwarding to a known-down peer would pin a handler thread through
        # the transport's timeouts: shed instead; the next route re-probes.
        self._count("not_ready")
        metrics.inc("evolu_fleet_not_ready_total")
        raise FleetNotReady()

    def _peer_serving(self, url: str) -> bool:
        now = time.monotonic()
        with self._lock:
            hit = self._probe_cache.get(url)
            if hit is not None and hit[0] > now:
                return hit[1]
        try:
            serving = self._get(url + "/health") == 200
        except Exception:  # noqa: BLE001 - an unreachable peer is not serving
            serving = False
        with self._lock:
            self._probe_cache[url] = (now + self._probe_ttl_s, serving)
        return serving

    # -- health / observability --

    def installing_owners(self) -> int:
        with self._lock:
            return len(self._installing)

    def health_payload(self) -> Tuple[bool, dict]:
        """→ (serving, detail). Not serving while a whole-store snapshot
        install is pending or any owner is mid-rebalance."""
        from evolu_tpu_torch.server.snapshot import install_phase

        phase = install_phase(self.store)
        n_inst = self.installing_owners()
        serving = phase is None and n_inst == 0
        return serving, {
            "status": "serving" if serving else "installing",
            "install_phase": phase,
            "installing_owners": n_inst,
            "ring_version": self.config.version,
            "members": len(self.ring.relays),
        }

    def stats_payload(self) -> dict:
        owners = self.store.user_ids()
        placed = [u for u in owners if self.placed_on(u, self.self_url)]
        primary = [u for u in placed if self.is_primary(u)]
        metrics.set_gauge("evolu_fleet_owners", len(placed))
        metrics.set_gauge("evolu_fleet_primary_owners", len(primary))
        with self._lock:
            c = dict(self.counts)
        return {
            "self_url": self.self_url,
            "ring_version": self.config.version,
            "members": list(self.ring.relays),
            "replication_factor": self.ring._r,
            "owners_stored": len(owners),
            "owners_placed": len(placed),
            "owners_primary": len(primary),
            "installing_owners": self.installing_owners(),
            **{k: c[k] for k in ("redirects", "forwards", "forwarded_served", "reloads",
                                 "rebalanced_owners", "rebalanced_messages", "cutovers_verified",
                                 "cutovers_superset", "failovers", "rebalance_failures")},
        }

    # -- config reload + rebalance --

    def apply_config(self, config: FleetConfig, rebalance: bool = True) -> bool:
        """Install a new fleet config (the `/fleet/reload` body). A stale
        version raises ValueError (→ 400), and so does a different config at
        the current version. Re-pushing the current config reconciles: no
        ring change, but the rebalance sweep runs, which is how a joining
        relay pulls its owners once the rest of the fleet has reloaded.
        Returns True when a rebalance was started."""
        with self._lock:
            changed = True
            if self.config is not None:
                if config.version < self.config.version:
                    raise ValueError(
                        f"stale fleet config version {config.version} < current {self.config.version}")
                if config == self.config:
                    changed = False
                elif config.version == self.config.version:
                    raise ValueError(
                        f"conflicting fleet config at version {config.version}: content changes need a "
                        "strictly newer version")
                else:
                    self.counts["reloads"] += 1
                    metrics.inc("evolu_fleet_reloads_total")
            if changed:
                self.config = config
                self.ring = HashRing(config)
                self._probe_cache.clear()
                metrics.set_gauge("evolu_fleet_ring_version", config.version)
                metrics.set_gauge("evolu_fleet_members", len(self.ring.relays))
        # New members become gossip peers (add_peer is idempotent); departed
        # members' scoped summaries go empty on their own.
        if changed and self.replication is not None:
            for url in self.ring.relays:
                if url != self.self_url:
                    self.replication.add_peer(url)
        if not rebalance:
            return False
        t = threading.Thread(target=self._rebalance, name="evolu-fleet-rebalance", daemon=True)
        with self._lock:
            if self._stopping:
                return False
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)
        t.start()
        return True

    def stop(self) -> None:
        with self._lock:
            self._stopping = True
            threads = list(self._threads)
        for t in threads:
            t.join(timeout=35.0)

    # -- snapshot-driven owner moves --

    def rebalance_once(self) -> int:
        """One synchronous rebalance sweep on the calling thread, serialized
        with any background sweep. Returns the number of owners installed."""
        with self._rebalance_serial:
            return self._sweep()

    def _rebalance(self) -> None:
        with self._rebalance_serial:
            try:
                self._sweep()
            except Exception as e:  # noqa: BLE001 - degrades to incremental anti-entropy
                self._count("rebalance_failures")
                metrics.inc("evolu_fleet_rebalance_failures_total")
                log("server", "fleet rebalance failed", error=repr(e))

    def _sweep(self) -> int:
        """For each peer: ask for the owners it stores that are placed on us
        (its scoped summary) and snapshot-install the ones we lack entirely.
        Owners we already store heal through scoped gossip."""
        moved_total = 0
        for peer_url in list(self.ring.relays):
            if peer_url == self.self_url or self._stopping:
                continue
            try:
                moved_total += self._pull_moved_owners(peer_url)
            except Exception as e:  # noqa: BLE001 - one unreachable loser must not
                self._count("rebalance_failures")  # block gains from the others
                metrics.inc("evolu_fleet_rebalance_failures_total")
                log("server", "fleet rebalance peer failed", peer=peer_url, error=repr(e))
        if self.replication is not None and moved_total:
            self.replication.hint()  # post-capture donor writes heal at debounce latency
        return moved_total

    def _pull_moved_owners(self, peer_url: str) -> int:
        # 1. An empty summary with our URL: the peer's scoped answer names
        # exactly the owners placed on us.
        body = protocol.encode_replica_summary(protocol.ReplicaSummary((), self._replica_id(), self.self_url))
        resp = protocol.decode_replica_summary(self._post(peer_url + "/replicate/summary", body))
        local = set(self.store.user_ids())
        gained = sorted(uid for uid, _tree in resp.trees
                        if uid not in local and self.placed_on(uid, self.self_url))
        if not gained:
            return 0
        with self._lock:
            if self._stopping:
                return 0
            self._installing.update(gained)
        t0 = time.perf_counter()
        try:
            # With write-behind on, the install sees and writes committed
            # state only, and no serve folds onto a pre-install tree.
            barrier = self.write_behind.drain_barrier() if self.write_behind is not None else nullcontext()
            with barrier:
                installed_msgs, shipped_trees = self._install_from_snapshot(peer_url, set(gained))
        except BaseException:
            # A prefix landed through the idempotent XOR gate: safe. Unmark;
            # scoped gossip pulls the rest.
            with self._lock:
                self._installing.difference_update(gained)
            raise
        # 2. Cut over at the per-owner Merkle watermark. A concurrent gossip
        # ingest can only add rows, so a mismatch means a superset: served,
        # but counted apart.
        import zlib

        by_owner = {uid: (root, crc) for uid, root, crc in self._manifest_owners or []}
        for uid in gained:
            shipped = shipped_trees.get(uid, "")
            root_crc = by_owner.get(uid)
            exact = (shipped and self.store.get_merkle_tree_string(uid) == shipped and root_crc is not None
                     and zlib.crc32(shipped.encode("utf-8")) == root_crc[1])
            metrics.inc("evolu_fleet_cutover_verified_total" if exact else "evolu_fleet_cutover_superset_total")
            with self._lock:
                self.counts["cutovers_verified" if exact else "cutovers_superset"] += 1
                self._installing.discard(uid)
        self._count("rebalanced_owners", len(gained))
        self._count("rebalanced_messages", installed_msgs)
        metrics.inc("evolu_fleet_rebalanced_owners_total", len(gained))
        metrics.inc("evolu_fleet_rebalanced_messages_total", installed_msgs)
        metrics.observe("evolu_fleet_rebalance_ms", (time.perf_counter() - t0) * 1e3)
        log("server", "fleet rebalance installed owners", peer=peer_url, owners=len(gained),
            messages=installed_msgs)
        return len(gained)

    def _install_from_snapshot(self, peer_url: str, wanted: set):
        """Owner-scoped manifest → chunk fetches → owner-filtered ingest
        through `store.add_messages` (the changes==1 XOR gate). The record
        filter also holds against a donor that ships everything. →
        (message_count, {owner: shipped tree text})."""
        from evolu_tpu_torch.server import snapshot as snap

        manifest = protocol.decode_snapshot_manifest(self._post(
            peer_url + "/replicate/snapshot",
            protocol.encode_snapshot_request(
                protocol.SnapshotRequest(self._replica_id(), 0, tuple(sorted(wanted)))),
        ))
        self._manifest_owners = manifest.owners
        shipped_trees: Dict[str, str] = {}
        installed = 0
        for i in range(len(manifest.chunk_sizes)):
            if self._stopping:
                raise RuntimeError("fleet manager stopping mid-rebalance")
            raw = self._post(
                peer_url + "/replicate/snapshot/chunk",
                protocol.encode_snapshot_chunk_request(
                    protocol.SnapshotChunkRequest(manifest.snapshot_id, i, self._replica_id())),
            )
            chunk = protocol.decode_snapshot_chunk(raw)
            if (chunk.snapshot_id != manifest.snapshot_id or chunk.index != i
                    or len(chunk.payload) != manifest.chunk_sizes[i]
                    or chunk.crc != manifest.chunk_crcs[i]):
                raise snap.SnapshotInstallError(
                    f"fleet rebalance chunk {i}: response does not match the manifest (id/index/size/crc)")
            by_owner: Dict[str, List[protocol.EncryptedCrdtMessage]] = {}
            for rec in snap.iter_records(chunk.payload):
                if rec[0] == "M" and rec[2] in wanted:
                    by_owner.setdefault(rec[2], []).append(protocol.EncryptedCrdtMessage(rec[1], rec[3]))
                elif rec[0] == "T" and rec[1] in wanted:
                    shipped_trees[rec[1]] = rec[2]
            for uid, msgs in by_owner.items():
                self.store.add_messages(uid, msgs)
                # The ledger's ingress: these rows arrive as snapshot
                # chunks; add_messages posted their store terminals.
                ledger.count(ledger.INGRESS_SNAPSHOT, len(msgs), owner=uid)
                installed += len(msgs)
        return installed, shipped_trees

    def _replica_id(self) -> str:
        if self.replication is not None:
            return self.replication.replica_id
        return f"fleet:{self.self_url}"


def _http_get_status(url: str, timeout: float = 2.0) -> int:
    """One readiness probe GET → the HTTP status (an answered non-200, such
    as 503 mid-install, is "not serving", not "unreachable")."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status
    except urllib.error.HTTPError as e:
        return e.code


# -- one fleet relay process --


def _worker_main(argv: Optional[Sequence[str]] = None) -> None:
    """Run one fleet relay as its own process: store, RelayServer, scoped
    replication and FleetManager. With `--batching` the relay's engine
    passes run on the card."""
    import argparse
    import json
    import signal

    from evolu_tpu_torch.server.relay import RelayServer, RelayStore

    ap = argparse.ArgumentParser(description="one evolu_tpu_torch fleet relay process")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--path", default=":memory:")
    ap.add_argument("--self-url", required=True)
    ap.add_argument("--config-json", required=True, help="FleetConfig.to_json() of the shared fleet config")
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--replication-interval-s", type=float, default=1.0)
    ap.add_argument("--batching", action="store_true")
    args = ap.parse_args(argv)

    cfg = FleetConfig.from_json(json.loads(args.config_json))
    store = RelayStore(args.path, args.backend)
    peers = [u for u in cfg.relays if u != args.self_url.rstrip("/")]
    server = RelayServer(store, host=args.host, port=args.port, batching=args.batching,
                         peers=peers, replication_interval_s=args.replication_interval_s)
    # The fleet before start(): the loop's first round fires at once and
    # must already be placement-scoped.
    server.enable_fleet(cfg, self_url=args.self_url)
    server.start()
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_a: stop.set())
    print("READY", flush=True)  # the parent waits for listen()
    try:
        stop.wait()
    except KeyboardInterrupt:
        pass
    server.stop()


if __name__ == "__main__":  # pragma: no cover - subprocess entry
    _worker_main()
