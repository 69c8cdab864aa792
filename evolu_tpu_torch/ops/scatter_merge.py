"""Sort-free scatter-argmax LWW merge plan.

LWW resolution needs a per-cell MAX, not a total order (reference
applyMessages.ts:34-40). This module is the dense formulation of the
planner: scatter each message's HLC key into a cell-indexed winner table
on the device, take the per-cell lexicographic max (two chained u64
scatter-max passes: the (k1, k2) compare is 128-bit, which no single
key carries), then gather the winners back to label each row. No sort
and no segmented scan (kernel L) run; the callers hash the xor-masked
rows (kernel H) and fold the (owner, minute) deltas (kernel X) over the
original-order columns, the fold's own tile sort doing the grouping.

The reference's xor quirk (applyMessages.ts:104-122) is the part a
per-cell max alone cannot give: the Merkle XOR is gated on "running
winner != message timestamp", where the running winner folds the stored
winner and every EARLIER batch row of the cell. With p the in-batch
prefix max and e the stored winner, a = e > s, b = e == s:

    xor[i]    = False  ⟺  ¬a ∧ ¬gt_before[i] ∧ (b ∨ eq_before[i])
    upsert[i] =            s_i == t(c) ∧ first-achiever ∧ ¬a ∧ ¬b

When the batch holds no duplicate (cell, k1, k2) row, eq_before is
False for every row; for b-rows gt_before ⟺ FB[c] < i, FB[c] being the
first batch index that beats the stored winner (one scatter-min of idx);
and the cell max has a unique achiever, so upsert needs no tie-break.
The ROUTER (`use_scatter_plan`, `scatter_table_for`) screens duplicates
on the host with a sorted hash (false positives over-route to the sort
plan; false negatives cannot happen: equal keys hash equal) and bounds
the table at 2^25 cells, so every batch it admits plans bit-identically
to the sort plan and every other batch keeps the sort plan.

The port carries u64 keys as int64 bit patterns (`ops/__init__.py`), and
torch's `scatter_reduce_(..., "amax")` is signed. So the table holds
`u64_order` keys: the per-cell max of the flipped k1, then of the
flipped k2 over the rows that achieve it, the flipped u64 zero (-2^63)
being both the table's start and what a loser contributes, as the u64
zero is the reference's monoid identity. A real row whose key is 0
still comes out exact: the max of the identity and real zeros is zero.
Equality needs no flip. The scatters are torch ops on either device, as
the reference's are XLA ops and not Pallas kernels.

Plan-path selection: "sort", "scatter" or "auto". The reference
resolves "auto" by its default backend (scatter on the CPU, sort on the
TPU); the port resolves it by the device the plan runs on: scatter on
the CPU, sort on CUDA. `counts` tallies the routes (the reference's
`evolu_merge_plan_total` by path and `evolu_reconcile_kernel_total` by
variant) until the port has a metrics registry.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

import numpy as np
import torch

from evolu_tpu_torch.ops import u64_order
from evolu_tpu_torch.ops.merge import _PAD_CELL, winner_flags
from evolu_tpu_torch.utils.config import MERGE_PLANS

# Hard table bound: cell ids ride 25 bits in the packed sort key, and
# 2^25 winner slots are 512 MB of u64 pairs. Batches beyond it keep the
# sort plan.
MAX_TABLE_BITS = 25

# Multiplicative hash constants for the duplicate screen (odd, from
# splitmix64's finalizer family; their quality only moves the false
# positive rate, never correctness).
_H1 = np.uint64(0xBF58476D1CE4E5B9)
_H2 = np.uint64(0x94D049BB133111EB)
_H3 = np.uint64(0x9E3779B97F4A7C15)

_U64_ZERO = -(1 << 63)  # u64_order of the u64 zero: the max monoid's identity

# Routing counts: "merge_plan" by path for the planners, "reconcile_kernel"
# by variant for the fleet reconcile's shard router.
counts = {"merge_plan": {"sort": 0, "scatter": 0},
          "reconcile_kernel": {"scatter": 0, "packed": 0, "wide": 0}}
_counts_lock = threading.Lock()


def count(kind: str, key: str) -> None:
    with _counts_lock:
        counts[kind][key] += 1


def table_size_for(cell_max: int) -> int:
    """Power-of-two winner-table size covering cell ids 0..cell_max."""
    size = 64
    while size <= cell_max:
        size *= 2
    return size


def batch_has_duplicate_keys(cell_id, k1, k2) -> bool:
    """Host-side duplicate screen: True if any two REAL rows MAY share
    (cell, k1, k2). Padding rows (all (PAD, 0, 0)) are left out, or every
    padded layout would report itself as duplicate. Sorted-hash check:
    equal triples hash equal (no false negatives: a missed duplicate would
    corrupt the xor mask), unequal ones collide with ~N²/2⁶⁴ probability
    and only over-route to the sort plan."""
    real = cell_id != int(_PAD_CELL)
    if not real.all():
        cell_id, k1, k2 = cell_id[real], k1[real], k2[real]
    n = len(k1)
    if n < 2:
        return False
    with np.errstate(over="ignore"):
        h = (
            k1.astype(np.uint64) * _H1
            ^ k2.astype(np.uint64) * _H2
            ^ cell_id.astype(np.uint64) * _H3
        )
    h.sort()
    return bool((h[1:] == h[:-1]).any())


# -- plan-path selection -------------------------------------------------

_plan_path = "auto"


def set_plan_path(path: str) -> None:
    """Select the LWW plan formulation: "sort", "scatter", or "auto" (by
    the device the plan runs on). Set from `Config.merge_plan` by
    `runtime.worker.select_planner`; EVOLU_MERGE_PLAN overrides either."""
    if path not in MERGE_PLANS:
        raise ValueError(f"merge_plan must be one of {MERGE_PLANS}, got {path!r}")
    global _plan_path
    _plan_path = path


def merge_plan_path(device=None) -> str:
    """The effective plan path ("sort" | "scatter") for a plan on `device`
    (None = the card, as everywhere in the port) after the env override
    and the "auto" rule: scatter on the CPU, sort on CUDA."""
    path = os.environ.get("EVOLU_MERGE_PLAN", "") or _plan_path
    if path not in MERGE_PLANS:
        # Loud: the variable exists to PIN a plan; a typo read as "auto"
        # would time or test the wrong one.
        raise ValueError(f"EVOLU_MERGE_PLAN must be one of {MERGE_PLANS}, got {path!r}")
    if path == "auto":
        on_cpu = device is not None and torch.device(device).type == "cpu"
        return "scatter" if on_cpu else "sort"
    return path


def _real_cell_max(cell_id) -> int:
    return int(cell_id.max(initial=0, where=cell_id != int(_PAD_CELL)))


def use_scatter_plan(cell_id, k1, k2, device=None, cell_max: Optional[int] = None) -> bool:
    """The whole routing decision for one batch of host columns: the
    configured path, the table bound and the duplicate screen. `cell_max`
    saves a pass when the caller holds the pad-free max already."""
    if merge_plan_path(device) != "scatter":
        return False
    if cell_max is None:
        cell_max = _real_cell_max(cell_id)
    if cell_max >= 1 << MAX_TABLE_BITS:
        return False
    return not batch_has_duplicate_keys(cell_id, k1, k2)


def scatter_table_for(cell_id, k1, k2, device=None) -> Optional[int]:
    """Admission and sizing in one call for the plan entry points: the
    winner-table size when the scatter plan serves this batch, else None.
    One pad-free cell max feeds both decisions."""
    if merge_plan_path(device) != "scatter":
        return None
    cell_max = _real_cell_max(cell_id)
    if cell_max >= 1 << MAX_TABLE_BITS or batch_has_duplicate_keys(cell_id, k1, k2):
        return None
    return table_size_for(cell_max)


# -- the plan ------------------------------------------------------------


def scatter_plan_masks(cell_id, k1, k2, ex_k1, ex_k2, table_size: int):
    """The dense LWW plan: → (xor_mask, upsert_mask) bools in ORIGINAL
    batch order, on the columns' device; no sort, no permutation.

    Preconditions (the router's, not checked again here): real cell ids <
    table_size and no duplicate (cell, k1, k2) row. Padding rows carry
    cell_id = _PAD_CELL and scatter to the dump slot `table_size` of a
    `table_size + 1` table; what they gather back is masked by `real`."""
    n = cell_id.shape[0]
    dev = cell_id.device
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    a, b = winner_flags(k1, k2, ex_k1, ex_k2)
    real = cell_id != int(_PAD_CELL)
    cell = cell_id.to(torch.int64).masked_fill(~real, table_size)

    def table(fill, dtype):
        return torch.full((table_size + 1,), fill, dtype=dtype, device=dev)

    # Per-cell lex max over (k1, k2), unsigned: chained signed scatter-max
    # passes over the flipped keys; the second pass maxes k2 only over the
    # rows achieving t1 (the others contribute the identity).
    o1 = u64_order(k1)
    t1 = table(_U64_ZERO, torch.int64).scatter_reduce_(0, cell, o1, "amax")
    is_t1 = (o1 == t1[cell]) & real
    o2 = torch.where(is_t1, u64_order(k2), _U64_ZERO)
    t2 = table(_U64_ZERO, torch.int64).scatter_reduce_(0, cell, o2, "amax")
    is_t = is_t1 & (o2 == t2[cell])
    # FB[c]: the first batch index that beats the stored winner, the only
    # prefix quantity the duplicate-free xor algebra needs.
    beats_e = ~a & ~b & real
    fb = table(n, torch.int32).scatter_reduce_(0, cell, torch.where(beats_e, idx, n), "amin")
    xor_mask = real & (~b | (fb[cell] < idx))
    upsert_mask = is_t & ~a & ~b
    return xor_mask, upsert_mask


# The reference's name of the mask-only dispatch (its jitted
# `scatter_plan_masks`).
plan_masks_scatter = scatter_plan_masks
