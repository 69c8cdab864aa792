"""Device folds for the tensor column type (`"col:tensor:…"`).

Host oracle: `core/crdt_tensor.py`; everything here is bit-identical to
it and to evolu_tpu/ops/crdt_tensor_merge.py.

The host applies the semidirect mask (raw-string timestamp order) and
hands over integer contributions: modular u64 fixed-point values for
sum and mean, monotone u32 keys zero-extended for max, all as int64 bit
patterns. Modular add and integer max are exactly associative and
commutative, so no scan order, chunking or kernel-vs-plain routing can
move a bit.

Layout: one packed int64 key (cell << 24 | idx) sorts alone, one row
gather `contrib[i_s]` recovers the (n, width) matrix, and the scan runs
over the d-major flattened (width·n,) view with the segment flags tiled
width times, so every element column starts its own segments and one
scan pass folds every element: kernel S for sum and mean, kernel L
(second key 0) for max.

The shard cores group by `reconcile.pack_owner_cell_key` (lo_bits=0);
the wide variant (cells ≥ 2^25 or owners ≥ 4095) carries the owner as
a gathered payload and segments by cell alone. `tensor_shard_sums`
routes between them on host maxima.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from evolu_tpu_torch.obs import metrics
from evolu_tpu_torch.ops import bucket_size, resolve_device, to_host_many
from evolu_tpu_torch.ops.crdt_merge import _dump_set
from evolu_tpu_torch.ops.cuda_scan import segmented_max_scan, segmented_sum_scan
from evolu_tpu_torch.ops.merge import _PAD_CELL, _ends, _starts

_OWNER_LIMIT = 4095  # reconcile._PAD_OWNER, the padding sentinel
_CELL_LIMIT = 1 << 25
_IDX_MASK = (1 << 24) - 1


def _flat_segmented_fold(c_s, v_s, monoid: str):
    """(n,) sorted group ids + (n, width) gathered contributions → the
    inclusive segmented fold over the d-major flattened view. Returns
    (agg_flat (width·n,), seg_end)."""
    width = v_s.shape[1]
    seg_start = _starts(c_s)
    flags = seg_start.repeat(width)
    flat = v_s.T.reshape(-1)
    if monoid == "max":
        agg, _ = segmented_max_scan(flags, flat, torch.zeros_like(flat))
    else:
        agg = segmented_sum_scan(flags, flat)
    return agg, _ends(seg_start)


def tensor_cell_fold_core(cell_id, contrib, table_size: int, monoid: str):
    """Cell-grouped segmented fold of (n, width) int64 contributions →
    a dense (table_size, width) int64 table (slot = cell id; pad rows
    park on the dump slot). `cell_id` int32 with _PAD_CELL padding,
    n ≤ 2^24 (the packed-key idx bound)."""
    n, width = contrib.shape
    dev = cell_id.device
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    key_s, _ = torch.sort((cell_id.to(torch.int64) << 24) | idx)
    i_s = key_s & _IDX_MASK
    c_s = key_s >> 24
    agg, seg_end = _flat_segmented_fold(c_s, contrib[i_s], monoid)
    live = (seg_end & (c_s != int(_PAD_CELL))).repeat(width)
    d_ix = torch.arange(width, dtype=torch.int64, device=dev).repeat_interleave(n)
    tgt = torch.where(live, c_s.repeat(width) * width + d_ix, table_size * width)
    return _dump_set(table_size * width, tgt, agg).reshape(table_size, width)


def tensor_cell_folds(cell_id: np.ndarray, contrib: np.ndarray, num_cells: int, monoid: str,
                      device=None) -> np.ndarray:
    """Host entry: → (num_cells, width) uint64 numpy, the per-cell
    modular sums (sum, mean) or max keys (max), bit-identical to the
    host oracle's accumulator. Batches beyond the 2^24 idx bound fold in
    chunks, which is exact for both monoids."""
    n = len(cell_id)
    width = contrib.shape[1]
    if n == 0:
        return np.zeros((num_cells, width), np.uint64)
    device = resolve_device(device)
    table_size = bucket_size(max(num_cells, 1))
    acc = np.zeros((table_size, width), np.uint64)
    chunk = 1 << 24
    for i in range(0, n, chunk):
        c = cell_id[i : i + chunk]
        v = contrib[i : i + chunk]
        size = bucket_size(len(c))
        c_p = np.concatenate([c.astype(np.int32), np.full(size - len(c), int(_PAD_CELL), np.int32)])
        v_p = np.concatenate([v.astype(np.uint64), np.zeros((size - len(v), width), np.uint64)])
        (t,) = to_host_many(tensor_cell_fold_core(
            torch.from_numpy(c_p).to(device), torch.from_numpy(v_p.view(np.int64)).to(device),
            table_size, monoid))
        t = t.view(np.uint64)
        if monoid == "max":
            np.maximum(acc, t, out=acc)
        else:
            acc += t
    return acc[:num_cells]


# --- reconcile-shaped shard cores (packed layout + the wide fallback) ---


def tensor_shard_sums_core(owner_ix, cell_id, contrib):
    """Sum fold for the multi-owner reconcile shape, grouped by the
    packed owner|cell|idx key. → (grp, seg_end, sums (width·n,) d-major);
    per-cell totals sit at the seg-end rows. Preconditions: owner <
    4095, cell < 2^25, n ≤ 2^24."""
    from evolu_tpu_torch.parallel.reconcile import pack_owner_cell_key

    n = cell_id.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=cell_id.device)
    key_s, _ = torch.sort(pack_owner_cell_key(owner_ix, cell_id, idx, lo_bits=0))
    grp = key_s >> 24  # owner|cell bits above idx
    sums, seg_end = _flat_segmented_fold(grp, contrib[key_s & _IDX_MASK], "sum")
    return grp, seg_end, sums


def tensor_shard_sums_wide_core(owner_ix, cell_id, contrib):
    """The wide-id form (cell ≥ 2^25 or owner ≥ 4095): key cell << 24 |
    idx (cells < 2^31), the owner gathered as a payload, segments by
    cell alone (cell ids are interned globally, unique per owner). →
    (own_s, c_s, seg_end, sums)."""
    n = cell_id.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=cell_id.device)
    key_s, _ = torch.sort((cell_id.to(torch.int64) << 24) | idx)
    i_s = key_s & _IDX_MASK
    c_s = (key_s >> 24).to(torch.int32)
    sums, seg_end = _flat_segmented_fold(c_s, contrib[i_s], "sum")
    return owner_ix.to(torch.int32)[i_s], c_s, seg_end, sums


def tensor_shard_sums(owner_ix: np.ndarray, cell_id: np.ndarray, contrib: np.ndarray,
                      device=None) -> Dict[Tuple[int, int], np.ndarray]:
    """Host entry with the static variant routing: packed when every
    owner < 4095, every cell < 2^25 and n ≤ 2^24, else wide. → {(owner,
    cell): int64 (width,) modular sums}."""
    n = len(cell_id)
    width = contrib.shape[1]
    if n == 0:
        return {}
    device = resolve_device(device)
    real = cell_id != int(_PAD_CELL)
    cell_max = int(cell_id.max(initial=0, where=real))
    owner_max = int(owner_ix.max(initial=0))
    packed = cell_max < _CELL_LIMIT and owner_max < _OWNER_LIMIT and n <= 1 << 24
    metrics.inc("evolu_crdt_tensor_kernel_total", variant="packed" if packed else "wide")
    size = bucket_size(n)
    o_p = np.concatenate([owner_ix.astype(np.int32), np.zeros(size - n, np.int32)])
    c_p = np.concatenate([cell_id.astype(np.int32), np.full(size - n, int(_PAD_CELL), np.int32)])
    v_p = np.concatenate([contrib.astype(np.uint64), np.zeros((size - n, width), np.uint64)])
    args = [torch.from_numpy(a).to(device) for a in (o_p, c_p, v_p.view(np.int64))]
    out: Dict[Tuple[int, int], np.ndarray] = {}
    if packed:
        grp, seg_end, sums = to_host_many(*tensor_shard_sums_core(*args))
        mat = sums.reshape(width, size)
        for i in np.nonzero(seg_end)[0]:
            g = int(grp[i])
            owner, cell = g >> 25, g & (_CELL_LIMIT - 1)
            if owner == _OWNER_LIMIT:  # padding segment
                continue
            out[(owner, cell)] = mat[:, i].copy()
    else:
        own_s, c_s, seg_end, sums = to_host_many(*tensor_shard_sums_wide_core(*args))
        mat = sums.reshape(width, size)
        for i in np.nonzero(seg_end)[0]:
            if int(c_s[i]) == int(_PAD_CELL):
                continue
            out[(int(own_s[i]), int(c_s[i]))] = mat[:, i].copy()
    return out
