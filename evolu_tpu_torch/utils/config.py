"""Runtime configuration of the client: the fields of
`evolu_tpu.utils.config.Config` that the handle (`runtime/client.py`),
the worker and its planner (`runtime/worker.py`) and the sync transport
(`sync/client.py`) read, with the same defaults.

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
    # The relay push-subscription leg of `connect`. Not ported: True is
    # refused (`connect` raises NotImplementedError).
    push_subscribe: bool = False
