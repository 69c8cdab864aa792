"""Device folds for the PN-counter and AW-set column types.

Host oracle: `core/crdt_types.py`; everything here is bit-identical to
it and to evolu_tpu/ops/crdt_merge.py.

- **PN-counter**: one packed int64 sort key (cell << 24 | idx, unique,
  so the unstable sort gives the stable order), then kernel S twice
  (positive and negative parts) over the cell-grouped deltas; each
  segment's total sits at its end row and is scattered into a dense
  per-cell table. The sums are non-negative and below 2^55 per cell,
  so the int64 bit patterns are the u64 values.
- **AW-set**: idempotent scatter-max tables (`killed[tag]`,
  `pair_alive[pair]`): order-free and duplicate-safe.

Scatters write into a table one slot longer than asked; rows that JAX
drops out of range (`mode="drop"`) land on that dump slot, which is
sliced off. Batches pad to power-of-two buckets like the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from evolu_tpu_torch.ops import bucket_size, resolve_device, to_host_many
from evolu_tpu_torch.ops.cuda_scan import segmented_sum_scan
from evolu_tpu_torch.ops.merge import _PAD_CELL, _ends, _starts


def _dump_set(size: int, tgt: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """zeros(size).at[tgt].set(vals, mode="drop") for tgt ∈ [0, size]:
    index `size` is the dump slot."""
    out = torch.zeros(size + 1, dtype=vals.dtype, device=vals.device)
    out[tgt] = vals
    return out[:size]


def _pos_neg(d_s: torch.Tensor):
    zero = torch.zeros((), dtype=d_s.dtype, device=d_s.device)
    return torch.where(d_s > 0, d_s, zero), torch.where(d_s < 0, -d_s, zero)


# --- PN-counter: per-cell (pos, neg) sums ---


def pn_counter_sums_core(cell_id, delta, table_size: int):
    """Cell-grouped segmented sums of the positive and negative delta
    parts → a (table_size,) pair of int64 tables (slot = cell id; pad
    rows park on the dump slot). `cell_id` int32 with _PAD_CELL padding,
    `delta` int64, n ≤ 2^24 (the packed-key bound)."""
    n = cell_id.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=cell_id.device)
    key_s, perm = torch.sort((cell_id.to(torch.int64) << 24) | idx)
    c_s = (key_s >> 24).to(torch.int32)
    d_s = delta[perm]
    seg_start = _starts(c_s)
    pos, neg = _pos_neg(d_s)
    pos_sum = segmented_sum_scan(seg_start, pos)
    neg_sum = segmented_sum_scan(seg_start, neg)
    real = c_s != int(_PAD_CELL)
    tgt = torch.where(_ends(seg_start) & real, c_s.to(torch.int64),
                      torch.full_like(c_s, table_size, dtype=torch.int64))
    return _dump_set(table_size, tgt, pos_sum), _dump_set(table_size, tgt, neg_sum)


def pn_counter_sums(cell_id: np.ndarray, delta: np.ndarray, num_cells: int, device=None):
    """Host entry: → (pos, neg) int64 numpy arrays of length num_cells,
    bit-identical to `crdt_types.fold_counter_ops` per cell. Batches
    beyond the 2^24 packed-key bound fold in chunks (the sum monoid is
    associative and commutative, so chunked accumulation is exact)."""
    n = len(cell_id)
    if n == 0:
        z = np.zeros(num_cells, np.int64)
        return z, z.copy()
    device = resolve_device(device)
    table = bucket_size(max(num_cells, 1))
    pos = np.zeros(table, np.uint64)
    neg = np.zeros(table, np.uint64)
    chunk = 1 << 24
    for i in range(0, n, chunk):
        c = cell_id[i : i + chunk]
        d = delta[i : i + chunk]
        size = bucket_size(len(c))
        c_p = np.concatenate([c.astype(np.int32), np.full(size - len(c), int(_PAD_CELL), np.int32)])
        d_p = np.concatenate([d.astype(np.int64), np.zeros(size - len(d), np.int64)])
        p_t, n_t = to_host_many(*pn_counter_sums_core(
            torch.from_numpy(c_p).to(device), torch.from_numpy(d_p).to(device), table))
        pos += p_t.view(np.uint64)
        neg += n_t.view(np.uint64)
    return pos[:num_cells].astype(np.int64), neg[:num_cells].astype(np.int64)


# --- AW-set: the order-free membership fold ---


def _scatter_max_table(ids, vals, size: int):
    """zeros(size + 1).at[ids].max(vals, mode="drop")[:size], int32."""
    out = torch.zeros(size + 1, dtype=torch.int32, device=ids.device)
    out.scatter_reduce_(0, ids.to(torch.int64), vals, "amax")
    return out[:size]


def _killed_table_core(kill_ids, num_tags: int):
    """killed[tag] = 1 iff any kill op names it; pad rows target the
    dump slot."""
    return _scatter_max_table(kill_ids, torch.ones_like(kill_ids), num_tags)


def awset_pair_alive_core(pair_id, alive, num_pairs: int):
    """pair_alive[p] = OR over its adds' alive flags; pad rows use
    pair_id = num_pairs (the dump slot)."""
    return _scatter_max_table(pair_id, alive.to(torch.int32), num_pairs)


def awset_alive_flags(add_tags, kills, state_killed, device=None):
    """Device twin of `crdt_types.alive_add_flags`: membership through a
    dense killed-tag table (host interning, one scatter, one gather on
    the host). → list[bool], bit-identical."""
    n = len(add_tags)
    if n == 0:
        return []
    device = resolve_device(device)
    kill_list = [t for t in kills if t is not None]
    kill_list.extend(state_killed)
    universe, inverse = np.unique(
        np.array(list(add_tags) + kill_list, dtype=object), return_inverse=True
    )
    num_tags = len(universe)
    add_ids = inverse[:n].astype(np.int32)
    kill_ids = inverse[n:].astype(np.int32)
    size = bucket_size(max(len(kill_ids), 1), multiple=16)
    kill_p = np.concatenate([kill_ids, np.full(size - len(kill_ids), num_tags, np.int32)])
    (killed,) = to_host_many(_killed_table_core(torch.from_numpy(kill_p).to(device), num_tags))
    return [not bool(killed[i]) for i in add_ids]


def awset_membership(pair_id: np.ndarray, alive: np.ndarray, num_pairs: int, device=None):
    """Host entry for the per-(cell, elem) fold: → int32 numpy 0/1 of
    length num_pairs."""
    n = len(pair_id)
    if n == 0:
        return np.zeros(num_pairs, np.int32)
    device = resolve_device(device)
    size = bucket_size(n)
    p_p = np.concatenate([pair_id.astype(np.int32), np.full(size - n, num_pairs, np.int32)])
    a_p = np.concatenate([alive.astype(np.int32), np.zeros(size - n, np.int32)])
    (out,) = to_host_many(awset_pair_alive_core(
        torch.from_numpy(p_p).to(device), torch.from_numpy(a_p).to(device), num_pairs))
    return out


# --- sharded (owner, cell) counter sums, the reconcile-shaped fold ---


def counter_shard_sums_core(owner_ix, cell_id, delta):
    """The typed fold for the multi-owner reconcile shape: ops group by
    the same packed owner|cell|idx key as the LWW shard kernel
    (`pack_owner_cell_key`, lo_bits=0), then kernel S runs per (owner,
    cell) segment. → (grp, seg_end, pos_sum, neg_sum): the per-cell
    totals sit at the seg-end rows. n ≤ 2^24, owners < 4095, cells <
    2^25 (one card holds one shard, so segments are complete)."""
    from evolu_tpu_torch.parallel.reconcile import pack_owner_cell_key

    n = cell_id.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=cell_id.device)
    key_s, perm = torch.sort(pack_owner_cell_key(owner_ix, cell_id, idx, lo_bits=0))
    d_s = delta[perm]
    grp = key_s >> 24  # owner|cell bits above idx
    seg_start = _starts(grp)
    pos, neg = _pos_neg(d_s)
    pos_sum = segmented_sum_scan(seg_start, pos)
    neg_sum = segmented_sum_scan(seg_start, neg)
    return grp, _ends(seg_start), pos_sum, neg_sum
