"""Runtime configuration: the fields of `evolu_tpu.utils.config.Config`
that the handle (`runtime/client.py`), the worker and its planner
(`runtime/worker.py`), the sync transport (`sync/client.py`) and the
relay tier (`server/replicate.py`, `server/relay.py`) read, with the same
defaults, the process-wide `default_config` / `set_config`, and the
fleet's `FleetConfig`.

`backend` picks the merge PLANNER:

- "cpu": the host oracle `storage.apply.plan_batch` for every batch (no
  tensors);
- "auto": the device planner for batches of at least `min_device_batch`
  messages, the host oracle below;
- "cuda": the device planner for every batch (the reference calls this
  backend "tpu").

WHERE the device planner runs is a separate argument, `device=` of
`runtime.worker.DbWorker` and `select_planner`: None means the CUDA card
(it raises without one), "cpu" runs the plain PyTorch version of every
kernel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple, Union


@dataclass
class Config:
    # The relay's sync endpoint (the transport POSTs here).
    sync_url: str = "http://localhost:4000"
    # Accepted for the reference's shape; the port has no logger yet
    # (it comes with the observability seams).
    log: Union[bool, str, List[str]] = False
    max_drift: int = 60000
    backend: str = "auto"  # "cpu" | "auto" | "cuda"
    # Receive batches above this size apply chunk by chunk, each chunk
    # its own transaction, with the clock persisted per chunk. None =
    # whole-batch transactions always.
    receive_chunk_size: "int | None" = 1 << 20
    min_device_batch: int = 1024  # "auto": below this the host oracle plans
    # Keep each cell's stored winner in device memory across batches
    # (ops/winner_cache.py) instead of streaming it from SQLite per
    # batch. Ignored for backend "cpu".
    winner_cache: bool = True
    # Values beyond the reference wire's string|int32 (doubles, int64)
    # ride extension fields 6 and 7; False refuses to author them.
    wire_extensions: bool = True
    # Gate subscribed-query re-execution on the changed set; False
    # re-executes every query after every write, like the reference.
    query_invalidation: bool = True
    # Bound on the worker's per-query caches (least recently executed
    # evicted first). None = unbounded.
    query_cache_max: "int | None" = 32768
    # Partial replication scope. Only None (a full replica) is ported.
    sync_scope: "object | None" = None
    # Periodic pull interval in seconds for `sync.client.connect` (None =
    # only explicit `sync()` calls).
    sync_interval: "float | None" = None
    # Wire capabilities the transport advertises. `aead-batch-v1` gates
    # emission of session-keyed GCM records: only after a relay echoes
    # it; every client decodes them unconditionally. () sends the v1
    # wire byte for byte.
    sync_capabilities: Tuple[str, ...] = (
        "crdt-types-v1", "crdt-list-v1", "crdt-tensor-v1",
        "aead-batch-v1", "sync-scope-v1")
    # After a swallowed offline round, probe the relay's GET /ping from
    # this cadence in seconds (backing off 2x a failure up to 30 s); the
    # first success fires the reconnect hook. None disables probing.
    reconnect_probe_interval: "float | None" = 1.0
    # The client leg of relay push subscriptions (server/push.py):
    # `connect` attaches a `sync.client.PushSubscriber` that long-polls the
    # owner's relay and fires a sync round when foreign rows land there —
    # wake-driven rounds instead of (or on top of) the sync_interval timer.
    push_subscribe: bool = False
    # -- relay tier knobs. Live defaults: `RelayServer` and
    # `server.replicate.ReplicationManager` resolve any constructor
    # argument left at None from the process `default_config` (call
    # `set_config` before constructing relays). --
    # serve_pull budgets: at most this many messages an owner and a
    # response in one anti-entropy pull answer. None = the server
    # defaults (`replicate.PULL_MESSAGES_PER_OWNER` / `_PER_RESPONSE`).
    pull_messages_per_owner: "int | None" = None
    pull_messages_per_response: "int | None" = None
    # Snapshot bootstrap trigger (server/snapshot.py): a relay whose store
    # is empty, or lacks at least this many owners a peer advertises,
    # installs a full snapshot instead of crawling history through capped
    # pulls. None disables it (incremental anti-entropy only).
    bootstrap_lag_owners: "int | None" = None
    # Periodic local snapshot checkpoints (`RelayServer(
    # checkpoint_interval_s=...)` → `snapshot.CheckpointWriter`). None
    # disables them.
    checkpoint_interval_s: "float | None" = None
    # Connection tier (server/conn.py): "threaded" = a ThreadingHTTPServer
    # (one thread a connection, the reference relay's shape); "eventloop" =
    # one selectors loop owns every socket, complete requests run on a
    # bounded handler pool, and push long-polls park the bare connection,
    # so idle subscriptions cost file descriptors, not threads.
    # EVOLU_CONN_TIER overrides it at the relay.
    connection_tier: str = "threaded"
    # Event-tier bounds: the handler pool's size, the in-flight dispatches
    # past which the loop answers 503 + Retry-After itself, the ABSOLUTE
    # budget a request must fully arrive within, the no-progress write
    # budget, and the header cap (431 past it).
    conn_handler_threads: int = 8
    conn_max_pending: int = 512
    conn_read_timeout_s: float = 30.0
    conn_write_timeout_s: float = 30.0
    conn_max_header_bytes: int = 16384
    # Relay-held push subscriptions (server/push.py): GET /push/poll parks
    # until the owner gets rows authored by another node. On by default at
    # the relay (a new GET endpoint; no other response changes). The poll
    # timeout is the relay's default park and the client's request.
    push_subscriptions: bool = True
    push_poll_timeout_s: float = 25.0
    push_max_subscriptions: int = 1 << 17


default_config = Config()


def set_config(c: Config) -> None:
    global default_config
    default_config = c


@dataclass(frozen=True)
class FleetConfig:
    """The shared placement configuration of an owner-sharded relay fleet
    (server/fleet.py). Every member must hold the same FleetConfig: the
    owner→relay ring is a pure function of (relays, virtual_nodes,
    replication_factor, seed). It travels as static config (constructor
    argument or `POST /fleet/reload`); `version` is a monotonic operator
    counter so a relay refuses a stale reload racing a newer one."""

    relays: Tuple[str, ...]  # member base URLs (the ring membership)
    replication_factor: int = 2  # R: replicas (primary included) an owner
    virtual_nodes: int = 64  # ring points a relay
    seed: int = 0  # shared hash seed
    version: int = 0  # monotonic config generation (reload ordering)
    # A request landing on a non-placed relay: False = 307 to the
    # authoritative peer (the client follows and caches the route), True =
    # proxy-forward through `POST /fleet/forward`.
    forward: bool = False

    def __post_init__(self):
        object.__setattr__(self, "relays", tuple(u.rstrip("/") for u in self.relays))

    def to_json(self) -> dict:
        return {
            "relays": list(self.relays),
            "replication_factor": self.replication_factor,
            "virtual_nodes": self.virtual_nodes,
            "seed": self.seed,
            "version": self.version,
            "forward": self.forward,
        }

    @classmethod
    def from_json(cls, d: dict) -> "FleetConfig":
        """Decode a `/fleet/reload` body; ValueError on any malformed shape
        (the relay answers 400)."""
        try:
            raw = d["relays"]
            # A bare string would iterate into one-character "URLs".
            if isinstance(raw, (str, bytes)) or not isinstance(raw, (list, tuple)):
                raise ValueError('fleet config "relays" must be a list of URLs')
            relays = tuple(str(u) for u in raw)
            if not relays:
                raise ValueError("fleet config needs at least one relay")
            if len(relays) > 1024:
                raise ValueError(f"fleet config lists {len(relays)} relays (max 1024)")
            vnodes = int(d.get("virtual_nodes", 64))
            if not 1 <= vnodes <= 4096:
                # relays x vnodes ring points: an absurd value is a DoS.
                raise ValueError(f"virtual_nodes={vnodes} outside 1..4096")
            return cls(
                relays=relays,
                replication_factor=int(d.get("replication_factor", 2)),
                virtual_nodes=vnodes,
                seed=int(d.get("seed", 0)),
                version=int(d.get("version", 0)),
                forward=bool(d.get("forward", False)),
            )
        except (KeyError, TypeError) as e:
            raise ValueError(f"malformed fleet config: {e!r}") from e
