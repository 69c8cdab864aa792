"""Device RGA list linearization (the `"col:list"` type).

Host oracle: `core/crdt_list.py::linearize` / `fold_cell`; everything
here is bit-identical to it and to evolu_tpu/ops/crdt_list_merge.py.

Euler-tour list ranking:

1. One `torch.sort` of a packed int64 key, group | parent+1 |
   descending rank, groups every (cell, parent) sibling run; first,
   last and previous-sibling pointers come from segment adjacency with
   scatters.
2. Each element has a down edge (enter) and an up edge (leave); the
   tour predecessor of every edge is a local function of (prev-sibling,
   parent, last-child). Pointer jumping over the predecessor chain
   (`bit_length(2n) + 1` rounds of gathers, a plain Python loop) sums
   the down edges strictly before each element's down edge: its
   document position, tombstones included. Index 2n is the TERM
   self-loop that ends every chain.
3. A second sort by (group, position) and kernel S over the alive flags
   give each alive element its output slot.

Every key carries the element index or its position in its low bits,
so keys are unique and the unstable sort gives one order. Bounds: the
batch core packs cell(22) | parent+1(20) | rank(20), so n ≤ 2^20-2 and
cells ≤ 2^22-2; the shard core uses the 37-bit owner|cell group of
`reconcile.pack_owner_cell_key` and 13-bit fields. Callers route
anything beyond the bounds to the host oracle.
"""

from __future__ import annotations

import numpy as np
import torch

from evolu_tpu_torch.ops import bucket_size, resolve_device, to_host_many
from evolu_tpu_torch.ops.cuda_scan import segmented_sum_scan
from evolu_tpu_torch.ops.merge import _ends, _starts

_B = 20  # parent / rank field width in the batch core's packed key
_PAD_LIST_CELL = (1 << 22) - 1  # pad sentinel: sorts after every real cell
_SHARD_B = 13  # per-field width under the 37-bit owner|cell group


def _rga_positions(group, parent_ix, b_bits: int):
    """Document position (0-based, within each group's tree, tombstones
    included) per element. `group` int64, `parent_ix` int32 index into
    the same arrays (-1 = head). Precondition: elements are sorted by
    (group, tag), so the index is the timestamp rank and every parent
    index is below its child's."""
    n = group.shape[0]
    dev = group.device
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    key = (group << (2 * b_bits)) | ((parent_ix.to(torch.int64) + 1) << b_bits) | (n - 1 - idx)
    key_s, e_s = torch.sort(key)  # (group, parent) runs in descending rank
    seg = key_s >> b_bits
    parent_s = (seg & ((1 << b_bits) - 1)) - 1
    seg_start = _starts(seg)
    seg_end = _ends(seg_start)

    # Sibling pointers; root and pad segments (parent -1) dump on slot n.
    minus1 = torch.full((n + 1,), -1, dtype=torch.int64, device=dev)
    last_child = minus1.clone()
    last_child[torch.where(seg_end & (parent_s >= 0), parent_s, n)] = e_s
    last_child = last_child[:n]
    prev_sib = minus1[:n].clone()
    prev_sib[e_s[1:]] = torch.where(seg[1:] == seg[:-1], e_s[:-1], -1)

    # Tour predecessor per edge (down = 2x enters x, up = 2x+1 leaves x);
    # each tree's chain ends at TERM = 2n, through the head element.
    m = 2 * n
    parent = parent_ix.to(torch.int64)
    pred_down = torch.where(prev_sib >= 0, 2 * prev_sib + 1,
                            torch.where(parent >= 0, 2 * parent, m))
    pred_up = torch.where(last_child >= 0, 2 * last_child + 1, 2 * idx)
    pred = torch.cat([torch.stack([pred_down, pred_up], dim=1).reshape(m),
                      torch.full((1,), m, dtype=torch.int64, device=dev)])
    weight = torch.zeros(m + 1, dtype=torch.int64, device=dev)
    weight[0:m:2] = 1  # down edges count

    # Pointer jumping: w[i] = Σ weight over edges strictly before i.
    w = weight[pred]
    for _ in range(max(1, m.bit_length() + 1)):
        pred, w = pred[pred], w + w[pred]
    return w[2 * idx].to(torch.int32)


def _alive_slots(group, pos, alive, b_bits: int):
    """Per-group output slot of every alive element (dead ones get -1):
    sort by (group, pos), then kernel S over the alive flags."""
    n = group.shape[0]
    key2_s, e2_s = torch.sort((group << b_bits) | pos.to(torch.int64))
    alive_s = alive[e2_s].to(torch.int64)
    incl = segmented_sum_scan(_starts(key2_s >> b_bits), alive_s)
    slot_s = torch.where(alive_s > 0, incl.to(torch.int32) - 1, -1).to(torch.int32)
    slot = torch.zeros(n, dtype=torch.int32, device=group.device)
    slot[e2_s] = slot_s
    return slot


def rga_order_core(cell_id, parent_ix, alive):
    """Batch core: → (pos, slot) int32. `cell_id` int32 (< 2^22-1; pad
    rows use _PAD_LIST_CELL), `parent_ix` int32 (-1 = head; pad rows -1),
    `alive` int32 0/1. Pad rows form their own sibling chain under the
    sentinel cell."""
    group = cell_id.to(torch.int64)
    pos = _rga_positions(group, parent_ix, _B)
    return pos, _alive_slots(group, pos, alive, _B)


def rga_order(cell_id: np.ndarray, parent_ix: np.ndarray, alive: np.ndarray, device=None):
    """Host entry: → (pos, slot) numpy int32, bit-identical to the host
    oracle (`crdt_list.fold_cell`) per cell. Elements must be sorted by
    (cell, tag) with parent indices resolved against that order
    (`crdt_list._materialize_device` builds exactly this). Batches
    beyond the packed-key bounds raise; callers route them to the host
    oracle."""
    from evolu_tpu_torch.core.crdt_list import DEVICE_MAX_CELLS, DEVICE_MAX_ELEMS

    n = len(cell_id)
    if n == 0:
        z = np.zeros(0, np.int32)
        return z, z.copy()
    if n > DEVICE_MAX_ELEMS:
        raise ValueError(f"batch of {n} elements exceeds the packed-key bound")
    if int(np.max(cell_id)) > DEVICE_MAX_CELLS:
        raise ValueError("cell id exceeds the packed-key bound")
    device = resolve_device(device)
    size = bucket_size(n)
    c_p = np.concatenate([cell_id.astype(np.int32), np.full(size - n, _PAD_LIST_CELL, np.int32)])
    p_p = np.concatenate([parent_ix.astype(np.int32), np.full(size - n, -1, np.int32)])
    a_p = np.concatenate([alive.astype(np.int32), np.zeros(size - n, np.int32)])
    pos, slot = to_host_many(*rga_order_core(*(torch.from_numpy(a).to(device) for a in (c_p, p_p, a_p))))
    return pos[:n], slot[:n]


def list_shard_order_core(owner_ix, cell_id, parent_ix, alive):
    """Linearization for the multi-owner reconcile shape: elements group
    by the packed owner|cell layout of `pack_owner_cell_key` (idx and lo
    zeroed, the 37 group bits kept), and parent and rank take 13 bits
    each, so a shard dispatch holds at most 2^13-2 elements. → (pos,
    slot) in shard-local order."""
    from evolu_tpu_torch.parallel.reconcile import pack_owner_cell_key

    zeros = torch.zeros_like(cell_id, dtype=torch.int32)
    group = pack_owner_cell_key(owner_ix, cell_id, zeros, lo_bits=0) >> 24
    pos = _rga_positions(group, parent_ix, _SHARD_B)
    return pos, _alive_slots(group, pos, alive, _SHARD_B)
