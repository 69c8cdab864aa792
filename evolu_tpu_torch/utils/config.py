"""Runtime configuration of the client worker: the fields of
`evolu_tpu.utils.config.Config` that `runtime/worker.py` and its planner
read, with the same defaults.

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
from typing import List, Union


@dataclass
class Config:
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
