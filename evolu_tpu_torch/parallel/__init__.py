"""Device-mesh parallelism: owners sharded over the shards of a mesh.

Owners never share state, so the reconcile is parallel over owners:
- owners are assigned to mesh shards (balanced by message count, or
  placed stably by a `MeshContext`);
- each shard plans its owners' LWW merges and Merkle deltas on its own
  device, with no cross-shard traffic in the pass;
- the batch digest combines across shards with an XOR reduction, on the
  host within a process and over a gloo group across processes
  (`xor_allreduce`).
"""

from evolu_tpu_torch.parallel.mesh import (
    MeshContext,
    assign_owners_to_shards,
    create_mesh,
    get_mesh_context,
    owner_shard,
)
from evolu_tpu_torch.parallel.reconcile import (
    build_owner_columns,
    reconcile_columns_sharded,
    reconcile_owner_batches,
    xor_allreduce,
)

__all__ = [
    "MeshContext",
    "create_mesh",
    "get_mesh_context",
    "owner_shard",
    "assign_owners_to_shards",
    "reconcile_columns_sharded",
    "reconcile_owner_batches",
    "xor_allreduce",
    "build_owner_columns",
]
