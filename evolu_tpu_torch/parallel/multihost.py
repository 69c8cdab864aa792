"""Multi-process initialization: the cross-host leg of the mesh.

Two channels, as in the JAX package:

1. the compute plane: a `torch.distributed` process group (gloo) that
   every process of a pod joins. It carries one thing, the batch digest's
   XOR all-reduce (`parallel.reconcile.xor_allreduce`): an all_gather of
   one int64 CPU tensor and a local XOR. NCCL has no XOR reduction, and
   the digest is one host number a process, so no NCCL is needed. Rows
   never cross processes: each process feeds its own shards from the same
   host layout.
2. the sync protocol plane: the unchanged protobuf-over-HTTP relay.

Nothing here tells a process of its cluster: the caller gives the init
method (`tcp://host:port` or `file:///path`), the world size and the rank.
"""

from __future__ import annotations

from typing import Optional

from evolu_tpu_torch.parallel.mesh import Mesh, Shard, create_mesh, process_count

_gloo_group = None


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    devices=None,
    timeout_s: float = 120.0,
) -> Mesh:
    """Join this process to the pod's gloo group and return the global
    owner mesh: every rank's local shards (`create_mesh(devices=devices)`,
    by default every visible CUDA card), gathered with
    `all_gather_object` and joined in rank order.

    `coordinator_address` is an init method URL (`tcp://host:port`,
    `file:///path`) or a bare `host:port`; with no arguments the
    `torch.distributed` environment variables (MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK) are read. Call once, before any sharded pass."""
    from datetime import timedelta

    import torch.distributed as dist

    init_method = coordinator_address
    if init_method is not None and "://" not in init_method:
        init_method = f"tcp://{init_method}"
    dist.init_process_group(
        "gloo", init_method=init_method, world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id, timeout=timedelta(seconds=timeout_s),
    )
    local = create_mesh(devices=devices)
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, [(str(s.device), s.rank) for s in local.shards])
    return Mesh([Shard(d, r) for shards in gathered for d, r in shards])


def digest_group():
    """The gloo group the digest all-reduce rides: the default group when
    its backend is gloo, else a gloo group over every rank."""
    global _gloo_group
    import torch.distributed as dist

    if dist.get_backend() == "gloo":
        return None
    if _gloo_group is None:
        _gloo_group = dist.new_group(backend="gloo")
    return _gloo_group


def is_multihost() -> bool:
    return process_count() > 1


def local_shard_indices(mesh: Mesh) -> list:
    """Shard slots of `mesh` this process hosts (each process feeds only
    its own shards)."""
    return mesh.local_indices()


def local_owners(mesh: Mesh, shards) -> list:
    """Owners this process materializes, given the shard assignment
    (`assign_owners_to_shards`: shard index s is mesh.shards[s])."""
    mine = set(local_shard_indices(mesh))
    return [o for i, shard in enumerate(shards) if i in mine for o in shard]
