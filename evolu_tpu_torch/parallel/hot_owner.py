"""Cell-range sharding for one hot owner.

`parallel.reconcile` never splits an owner across shards: right for
fleets of owners, wrong when one owner's batch is bigger than a shard
should hold. Per-cell LWW merges are independent, so a hot owner's batch
shards by cell id instead: each shard plans a contiguous range of
interned cell ids (kernel L twice), hashes its xor rows (kernel H) and
folds its per-minute XOR deltas (kernel X); the per-shard minute partials
XOR-merge in the host decoder and the shards' digests XOR on the host.

Contract as the single-device planner's: masks in original batch order,
a {base3-minute-key: delta} dict, an unsigned 32-bit digest.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from evolu_tpu_torch.ops import bucket_size
from evolu_tpu_torch.ops.cuda_hash import masked_key_hashes
from evolu_tpu_torch.ops.encode import unpack_ts_keys
from evolu_tpu_torch.ops.merge import _PAD_CELL, plan_merge_sorted_core, unpermute_masks
from evolu_tpu_torch.ops.merkle_ops import decode_owner_minute_deltas, owner_minute_segments
from evolu_tpu_torch.parallel.mesh import Mesh, require_single_process
from evolu_tpu_torch.parallel.reconcile import dispatch_columns_sharded, pull_shards, xor_allreduce

_COLUMNS = ("cell_id", "k1", "k2", "ex_k1", "ex_k2")


def _shard_kernel(cell_id, k1, k2, ex_k1, ex_k2):
    """One shard's cells: the LWW plan, the hashes of its xor rows, its
    per-minute segments under owner 0, and its digest."""
    xor_s, upsert_s, i_s, s1, s2, _ = plan_merge_sorted_core(cell_id, k1, k2, ex_k1, ex_k2)
    hashes, digest = masked_key_hashes(s1, s2, xor_s)
    millis_s, _ = unpack_ts_keys(s1)
    _, minute_sorted, seg_end, seg_xor, valid_sorted = owner_minute_segments(
        torch.zeros_like(hashes), millis_s, hashes, xor_s
    )
    return xor_s, upsert_s, i_s, minute_sorted, seg_end, seg_xor, valid_sorted, digest


def reconcile_hot_owner(
    mesh: Mesh,
    cell_id: np.ndarray,
    k1: np.ndarray,
    k2: np.ndarray,
    ex_k1: np.ndarray,
    ex_k2: np.ndarray,
    millis: np.ndarray,
    counter: np.ndarray,
    node: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, Dict[str, int], int]:
    """One owner's columnar batch, cells sharded over the mesh. →
    (xor_mask, upsert_mask, minute_deltas, digest), masks in original
    batch order: the results of planning the batch on one device.

    Cells, not rows, are assigned: interned cell ids are dense, so the
    contiguous ranges `cell_id * n // num_cells` balance, and every row of
    a cell lands on one shard. The chunk is the bucket of the largest
    shard load; millis, counter and node are recovered on the device
    from the keys, so only the key columns are laid out."""
    require_single_process("reconcile_hot_owner")
    n = len(cell_id)
    n_dev = mesh.size
    num_cells = int(cell_id.max()) + 1 if n else 1
    shard_of = (cell_id.astype(np.int64) * n_dev) // num_cells
    order = np.argsort(shard_of, kind="stable")
    loads = np.bincount(shard_of, minlength=n_dev)
    chunk = bucket_size(int(loads.max()) if n else 1)
    total = n_dev * chunk

    cols = {
        "cell_id": np.full(total, int(_PAD_CELL), np.int32),
        "k1": np.zeros(total, np.uint64),
        "k2": np.zeros(total, np.uint64),
        "ex_k1": np.zeros(total, np.uint64),
        "ex_k2": np.zeros(total, np.uint64),
    }
    src = {"cell_id": cell_id, "k1": k1, "k2": k2, "ex_k1": ex_k1, "ex_k2": ex_k2}
    positions = np.empty(n, np.int64)  # where original row i lives in the layout
    start = 0
    for d in range(n_dev):
        rows = order[start : start + loads[d]]
        dst = np.arange(d * chunk, d * chunk + loads[d])
        positions[rows] = dst
        for name, a in src.items():
            cols[name][dst] = a[rows]
        start += loads[d]
    xor_s, upsert_s, i_s, minute_sorted, seg_end, seg_xor, valid, digests = pull_shards(
        dispatch_columns_sharded(mesh, cols, kernel=_shard_kernel, names=_COLUMNS))

    xor_flat, upsert_flat = unpermute_masks(xor_s, upsert_s, i_s, block_size=chunk)
    by_owner = decode_owner_minute_deltas(np.zeros_like(minute_sorted), minute_sorted, seg_end,
                                          seg_xor, valid)
    return (xor_flat[positions], upsert_flat[positions], by_owner.get(0, {}),
            xor_allreduce(digests.view(np.uint32).tolist(), mesh))
