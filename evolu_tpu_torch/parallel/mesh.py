"""The owner mesh and owner→shard placement.

Owners are the data-parallel unit: each owner's message log and Merkle
tree are independent, so the mesh has one axis, `owners`. In the JAX
package a mesh is a `jax.sharding.Mesh` and a sharded column a
`NamedSharding`. Here a mesh is a tuple of shards, each a `torch.device`
plus the rank of the process that hosts it:

- a flat host column of length D*S splits into D slices of S rows, and
  each slice goes straight to its shard's device (`put_sharded`); rows
  never cross devices;
- each shard runs the same kernels on its slice; shards that share a
  device run one after another on its current stream, each on its own
  slice;
- each shard's outputs come back in one pull wave and are joined in
  shard order, so the host sees the flat (D*S,) arrays of the JAX
  package's layout;
- the only cross-shard value is the batch digest, XOR-reduced on the host
  and across processes (`parallel.reconcile.xor_allreduce`).

A `MeshContext` records the reference's `evolu_mesh_*` family (the
devices gauge, the `shard_rows` and `padding_waste_rows` histograms, the
dispatch and cross-shard reduce counters) and keeps plain `counts` of
the same events beside it.
"""

from __future__ import annotations

import threading
import zlib
from typing import Dict, Hashable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from evolu_tpu_torch.obs import anatomy, metrics

OWNERS_AXIS = "owners"


class Shard(NamedTuple):
    device: torch.device
    rank: int


class Mesh:
    """A 1-D mesh: a tuple of shards in shard order."""

    def __init__(self, shards: Sequence[Shard]):
        if not shards:
            raise ValueError("a mesh needs at least one shard")
        self.shards = tuple(Shard(torch.device(s.device), int(s.rank)) for s in shards)

    @property
    def size(self) -> int:
        return len(self.shards)

    @property
    def devices(self) -> List[torch.device]:
        return [s.device for s in self.shards]

    def local_indices(self) -> List[int]:
        """Shard slots this process hosts."""
        me = process_index()
        return [i for i, s in enumerate(self.shards) if s.rank == me]

    def is_multiprocess(self) -> bool:
        return len({s.rank for s in self.shards}) > 1

    def __len__(self) -> int:
        return len(self.shards)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self.shards == other.shards

    def __hash__(self) -> int:
        return hash(self.shards)

    def __repr__(self) -> str:
        return f"Mesh({', '.join(f'{s.device}@{s.rank}' for s in self.shards)})"


def process_index() -> int:
    """This process's rank in the `torch.distributed` group (0 alone)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def create_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """A 1-D mesh over `devices` (default: every visible CUDA card; raises
    without one, as `ops.resolve_device` does), cut to `n_devices`. The
    shards are this process's. Entries may repeat: `["cpu"] * 8` is
    eight CPU shards, `["cuda:0"] * 8` eight shards sharing one card."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "evolu_tpu_torch: CUDA is not available; pass devices=['cpu', ...] "
                "to build a mesh of CPU shards")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    rank = process_index()
    mesh = Mesh([Shard(torch.device(d), rank) for d in devices])
    _set_platform(mesh)
    return mesh


def _set_platform(mesh: Mesh) -> None:
    """Push the platform into the stage-anatomy plane, which prices its
    floors from COST_LAWS by platform and never asks torch itself:
    "cuda" for a mesh on the card, "cpu" otherwise."""
    anatomy.set_platform("cuda" if mesh.shards[0].device.type == "cuda" else "cpu")


def single_mesh(device) -> Mesh:
    """The one-shard mesh on `device` (a resolved torch.device)."""
    mesh = Mesh([Shard(torch.device(device), process_index())])
    _set_platform(mesh)
    return mesh


def put_sharded(arr: np.ndarray, mesh: Mesh) -> List[Optional[np.ndarray]]:
    """Flat host column of length D*S → D host slices in shard order, None
    for shards another process hosts (each process feeds its own)."""
    size = len(arr) // mesh.size
    local = set(mesh.local_indices())
    return [arr[i * size : (i + 1) * size] if i in local else None for i in range(mesh.size)]


def require_single_process(what: str, mesh: Optional[Mesh] = None) -> None:
    """Guard for fan-ins that index kernel outputs with global positions:
    across processes each process pulls only its own shards, so global
    indexing would be wrong. With `mesh` the guard is that mesh's shards
    (a mesh of this process's own shards passes in a pod), else the
    process group. The multi-process pattern is
    `reconcile_columns_sharded` + `multihost.local_owners` per process,
    or `engine.reconcile_pod`."""
    if mesh.is_multiprocess() if mesh is not None else process_count() > 1:
        raise NotImplementedError(
            f"{what} assembles per-owner results from global output positions "
            "and runs in one process only; across processes use "
            "reconcile_columns_sharded + multihost.local_owners per process"
        )


def owner_shard(owner_id, n_shards: int) -> int:
    """Stable owner→shard placement: crc32 of the UTF-8 owner id (or of
    `str(owner)`) mod n, the hash of `ShardedRelayStore.shard_index` and
    `engine.owner_process`. A pure function of (owner, n), so every
    process and relay sharing a mesh places an owner on the same shard."""
    if not isinstance(owner_id, (bytes, bytearray)):
        owner_id = str(owner_id).encode("utf-8")
    return zlib.crc32(owner_id) % n_shards


XDEV_KINDS = ("digest", "owner_delta_partials", "winner_minute_partials")


class MeshContext:
    """One mesh shared by every sharded consumer of a process (engine
    passes, the sharded winner cache, a scheduler serving several relays),
    so they all place an owner on the same shard.

    It records the `evolu_mesh_*` family as the reference does, and
    `counts` holds the same events for this context alone:
    `dispatches`, `xdev_reduce` by kind, and the number of per-shard
    observations of `shard_rows` / `padding_waste_rows` (their sums too;
    `last_loads` is the newest dispatch's per-shard rows)."""

    def __init__(self, mesh: Optional[Mesh] = None, n_devices: Optional[int] = None, devices=None):
        self.mesh = mesh if mesh is not None else create_mesh(n_devices, devices)
        self.n_shards = self.mesh.size
        self._lock = threading.Lock()
        self.counts = {
            "dispatches": 0,
            "xdev_reduce": dict.fromkeys(XDEV_KINDS, 0),
            "shard_rows": 0,
            "shard_rows_sum": 0,
            "padding_waste_rows": 0,
            "padding_waste_rows_sum": 0,
        }
        self.last_loads: List[int] = []
        metrics.set_gauge("evolu_mesh_devices", self.n_shards)

    def place(self, owner_id) -> int:
        return owner_shard(owner_id, self.n_shards)

    def assign_stable(self, unit_sizes: Dict[Hashable, int]) -> List[List[Hashable]]:
        """Placement-stable layout with `assign_owners_to_shards`'s shape.
        Units are owner ids or (owner, chunk-index) tuples (the engine's
        hot-owner row split): chunk j of owner o lands on shard
        (place(o) + j) % n, chunk 0 on the owner's home shard."""
        shards: List[List[Hashable]] = [[] for _ in range(self.n_shards)]
        for u in unit_sizes:
            if isinstance(u, tuple) and len(u) == 2:
                owner, j = u
            else:
                owner, j = u, 0
            shards[(self.place(owner) + int(j)) % self.n_shards].append(u)
        return shards

    def record_occupancy(self, loads: Sequence[int], shard_size: int) -> None:
        """One sharded dispatch: per-shard rows and padding."""
        loads = [int(x) for x in loads]
        with self._lock:
            c = self.counts
            c["dispatches"] += 1
            c["shard_rows"] += len(loads)
            c["shard_rows_sum"] += sum(loads)
            c["padding_waste_rows"] += len(loads)
            c["padding_waste_rows_sum"] += sum(max(shard_size - x, 0) for x in loads)
            self.last_loads = loads
        for load in loads:
            metrics.observe("evolu_mesh_shard_rows", load,
                            buckets=metrics.COUNT_BUCKETS)
            metrics.observe("evolu_mesh_padding_waste_rows",
                            max(shard_size - load, 0),
                            buckets=metrics.COUNT_BUCKETS)
        metrics.inc("evolu_mesh_dispatches_total")

    def record_xdev_reduce(self, kind: str) -> None:
        """One cross-shard reduction: the digest of a sharded dispatch, or
        a host XOR-merge of per-owner delta partials that spanned shards."""
        with self._lock:
            self.counts["xdev_reduce"][kind] += 1
        metrics.inc("evolu_mesh_xdev_reduce_total", kind=kind)


_process_ctx: Optional[MeshContext] = None
_process_ctx_lock = threading.Lock()


def get_mesh_context(n_devices: Optional[int] = None, device=None, devices=None) -> MeshContext:
    """The process-wide MeshContext (relay and scheduler wiring; embedders
    and tests pass explicit contexts). Lazy: made at the first call, over
    `devices` when given (`create_mesh`'s argument, e.g. eight shards
    sharing one card), else over every visible CUDA card, or, when
    `device` names a non-CUDA device, over `n_devices` (default 1) shards
    on it.

    The first creation wins: placement is mod n_shards, so two contexts of
    different sizes would place one owner on different shards for
    different consumers. A later call with another size gets the first."""
    global _process_ctx
    with _process_ctx_lock:
        if _process_ctx is None:
            if devices is not None:
                _process_ctx = MeshContext(n_devices=n_devices, devices=devices)
            elif device is not None and torch.device(device).type != "cuda":
                _process_ctx = MeshContext(devices=[torch.device(device)] * (n_devices or 1))
            else:
                _process_ctx = MeshContext(n_devices=n_devices)
        return _process_ctx


def current_mesh_context() -> Optional[MeshContext]:
    """The process-wide context if one was made, else None."""
    return _process_ctx


def assign_owners_to_shards(owner_sizes: Dict[Hashable, int], n_shards: int) -> List[List[Hashable]]:
    """Greedy LPT balance: units (with their row counts) onto shards,
    heaviest first; a unit is never split. Units are owners, or (owner,
    chunk) tuples a caller pre-split."""
    shards: List[List[Hashable]] = [[] for _ in range(n_shards)]
    loads = [0] * n_shards
    for owner in sorted(owner_sizes, key=owner_sizes.get, reverse=True):
        i = loads.index(min(loads))
        shards[i].append(owner)
        loads[i] += owner_sizes[owner]
    return shards
