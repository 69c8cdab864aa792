"""Batched LWW merge planner on the card.

Replaces the reference's per-message applyMessages loop with one
columnar pass, with exactly the sequential loop's semantics:

    sort by (cell, batch order)
      → segmented inclusive max of HLC keys (kernel L, forward)
      → xor mask   (the running winner before the message differs from it)
      → segmented total max per cell (kernel L, reverse)
      → upsert mask (the cell's first max beats the stored winner)

HLC keys are (k1, k2) u64 pairs (int64 bit patterns), compared
lexicographically and unsigned; (0, 0) is the "no stored winner"
sentinel. Batches pad to power-of-two buckets like the JAX package's.

`_run_full_plan` and `plan_batch_device` route each batch between this
sort plan and the sort-free scatter-argmax plan (`ops/scatter_merge.py`)
on the host columns, by `Config.merge_plan` / EVOLU_MERGE_PLAN, the
table bound and the duplicate screen; both give the same plan wherever
the scatter plan is admitted.
"""

from __future__ import annotations

import operator
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from evolu_tpu_torch.core.types import CrdtMessage
from evolu_tpu_torch.obs import ledger, metrics
from evolu_tpu_torch.ops import bucket_size, columns_to_device, resolve_device, to_host_many, u64_order
from evolu_tpu_torch.ops.cuda_hash import masked_key_hashes
from evolu_tpu_torch.ops.cuda_scan import segmented_max_scan
from evolu_tpu_torch.ops.encode import pack_ts_key_host, unpack_ts_keys
from evolu_tpu_torch.utils.log import log

_PAD_CELL = np.int32(0x7FFFFFFF)


def _lex_gt(a1, a2, b1, b2):
    """(a1, a2) >lex (b1, b2), unsigned."""
    return (u64_order(a1) > u64_order(b1)) | ((a1 == b1) & (u64_order(a2) > u64_order(b2)))


def _lex_max(a1, a2, b1, b2):
    """Elementwise lexicographic max of unsigned (a1, a2) vs (b1, b2)."""
    a_wins = ~_lex_gt(b1, b2, a1, a2)
    return torch.where(a_wins, a1, b1), torch.where(a_wins, a2, b2)


def _starts(grp: torch.Tensor) -> torch.Tensor:
    return torch.cat([grp.new_ones(1, dtype=torch.bool), grp[1:] != grp[:-1]])


def _ends(seg_start: torch.Tensor) -> torch.Tensor:
    return torch.cat([seg_start[1:], seg_start.new_ones(1)])


def _exclusive(seg_start, m1, m2):
    """The running max BEFORE each row: the inclusive max shifted by one
    (`roll` wraps the last row into row 0, which seg_start masks)."""
    zero = torch.zeros((), dtype=m1.dtype, device=m1.device)
    return (torch.where(seg_start, zero, torch.roll(m1, 1)),
            torch.where(seg_start, zero, torch.roll(m2, 1)))


def winner_flags(k1, k2, ex_k1, ex_k2):
    """Per-row stored-winner relation bits, computed BEFORE the sort:
    a = e >lex s, b = e ==lex s."""
    return _lex_gt(ex_k1, ex_k2, k1, k2), (ex_k1 == k1) & (ex_k2 == k2)


def masks_from_sorted_flags(grp, s1, s2, a_s, b_s, real):
    """The post-sort planner tail shared by `plan_merge_sorted_flags` and
    the packed-owner shard kernel: segment boundaries from the sorted
    group key, the two segmented max scans (kernel L), and the flag-bit
    xor/upsert algebra. → (xor_sorted, upsert_sorted), masked by `real`."""
    seg_start = _starts(grp)
    m1, m2 = segmented_max_scan(seg_start, s1, s2)
    p1, p2 = _exclusive(seg_start, m1, m2)
    p_eq_s = (p1 == s1) & (p2 == s2)
    p_gt_s = _lex_gt(p1, p2, s1, s2)
    # lex_max(p, e) == s ⟺ (p==s ∨ e==s) ∧ p≤s ∧ e≤s; xor is its negation.
    xor_sorted = ~((p_eq_s | b_s) & ~p_gt_s & ~a_s)
    t1, t2 = segmented_max_scan(_ends(seg_start), m1, m2, reverse=True)
    eligible = (s1 == t1) & (s2 == t2)
    first_eligible = eligible & ~((p1 == t1) & (p2 == t2))
    # beats (t >lex e) is read only where s == t: there it is ¬(a ∨ b).
    upsert_sorted = first_eligible & ~(a_s | b_s) & real
    return xor_sorted & real, upsert_sorted


def plan_merge_sorted_core(cell_id, k1, k2, ex_k1, ex_k2, extras=(), return_winners=False):
    """The planner with the stored-winner VALUES riding the sort (the
    form for batches over 2^24 rows, whose idx no longer fits the packed
    key, and for the winner cache, which needs the values). → (xor_sorted,
    upsert_sorted, i_s, s1, s2, extras_sorted), and with `return_winners`
    also (beats1, beats2, seg_end, real): (beats1, beats2) is
    lex_max(segment total max, stored winner), unsigned, the cell's
    updated winner, meaningful at `seg_end` rows."""
    n = cell_id.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=cell_id.device)
    if n <= 1 << 24:
        key = (cell_id.to(torch.int64) << 24) | idx
        key_s, perm = torch.sort(key)
        c = (key_s >> 24).to(torch.int32)
        i_s = (key_s & ((1 << 24) - 1)).to(torch.int32)
    else:
        c, perm = torch.sort(cell_id, stable=True)
        i_s = perm.to(torch.int32)
    s1, s2, e1, e2 = k1[perm], k2[perm], ex_k1[perm], ex_k2[perm]
    extras_sorted = tuple(x[perm] for x in extras)

    seg_start = _starts(c)
    m1, m2 = segmented_max_scan(seg_start, s1, s2)
    p1, p2 = _exclusive(seg_start, m1, m2)
    r1, r2 = _lex_max(p1, p2, e1, e2)
    xor_sorted = (r1 != s1) | (r2 != s2)
    seg_end = _ends(seg_start)
    t1, t2 = segmented_max_scan(seg_end, m1, m2, reverse=True)
    eligible = (s1 == t1) & (s2 == t2)
    first_eligible = eligible & ~((p1 == t1) & (p2 == t2))
    beats1, beats2 = _lex_max(t1, t2, e1, e2)
    beats = (beats1 != e1) | (beats2 != e2)
    real = c != int(_PAD_CELL)
    out = (xor_sorted & real, first_eligible & beats & real, i_s, s1, s2, extras_sorted)
    if return_winners:
        return out + ((beats1, beats2, seg_end, real),)
    return out


def plan_merge_sorted_flags(cell_id, k1, k2, ex_k1, ex_k2, extras=()):
    """The planner in cell-sorted order with the stored winner reduced to
    two flag bits in the sort key: key = cell<<26 | idx<<2 | b<<1 | a
    (a = e >lex s, b = e ==lex s). The key total-orders by (cell, idx),
    so one unstable int64 sort gives the stable-by-cell order and only
    the two HLC keys are gathered. → (xor_sorted, upsert_sorted, i_s,
    s1, s2, extras_sorted); i_s is each sorted row's batch index."""
    n = cell_id.shape[0]
    if n > 1 << 24:
        return plan_merge_sorted_core(cell_id, k1, k2, ex_k1, ex_k2, extras)
    idx = torch.arange(n, dtype=torch.int64, device=cell_id.device)
    a, b = winner_flags(k1, k2, ex_k1, ex_k2)
    key = (
        (cell_id.to(torch.int64) << 26) | (idx << 2)
        | (b.to(torch.int64) << 1) | a.to(torch.int64)
    )
    key_s, perm = torch.sort(key)
    c = (key_s >> 26).to(torch.int32)
    i_s = ((key_s >> 2) & ((1 << 24) - 1)).to(torch.int32)
    a_s = (key_s & 1) != 0
    b_s = (key_s & 2) != 0
    s1, s2 = k1[perm], k2[perm]
    extras_sorted = tuple(x[perm] for x in extras)
    xor_sorted, upsert_sorted = masks_from_sorted_flags(
        key_s >> 26, s1, s2, a_s, b_s, c != int(_PAD_CELL)
    )
    return xor_sorted, upsert_sorted, i_s, s1, s2, extras_sorted


def plan_merge_core(cell_id, k1, k2, ex_k1, ex_k2):
    """Original-order planner: `plan_merge_sorted_flags` plus a restoring
    scatter by `i_s` on the device. → (xor_mask, upsert_mask) bools in
    batch order, on the columns' device; the mask-only planner's sort
    route."""
    xor_s, upsert_s, i_s, _, _, _ = plan_merge_sorted_flags(cell_id, k1, k2, ex_k1, ex_k2)
    order = i_s.to(torch.int64)
    xor_mask = torch.empty_like(xor_s)
    upsert_mask = torch.empty_like(upsert_s)
    xor_mask[order] = xor_s
    upsert_mask[order] = upsert_s
    return xor_mask, upsert_mask


def unpermute_masks(xor_sorted, upsert_sorted, i_s, block_size: int = 0):
    """Host side: sorted-order masks + permutation → batch order (numpy).
    With `block_size` > 0 the arrays are per-shard blocks joined in shard
    order, each block's `i_s` local to its shard; each block unpermutes
    within its own span."""
    xor_sorted, upsert_sorted, i_s = (np.asarray(x) for x in (xor_sorted, upsert_sorted, i_s))
    i_s = i_s.astype(np.int64)
    if block_size:
        i_s = i_s + (np.arange(len(i_s), dtype=np.int64) // block_size) * block_size
    xor_mask = np.empty_like(xor_sorted)
    upsert_mask = np.empty_like(upsert_sorted)
    xor_mask[i_s] = xor_sorted
    upsert_mask[i_s] = upsert_sorted
    return xor_mask, upsert_mask


class PlannedBatch(tuple):
    """A planner result that unpacks as the usual (xor_mask, upserts,
    deltas) 3-tuple and also carries the positional bool `upsert_mask`."""

    def __new__(cls, xor_mask, upserts, deltas, upsert_mask=None):
        self = super().__new__(cls, (xor_mask, upserts, deltas))
        self.upsert_mask = upsert_mask
        return self


def strip_typed_upserts(plan, messages, schema):
    """Typed cells never take the LWW app-table upsert: their app value
    is the merge-state materialization (`core.crdt_types`). One copy for
    every planner; the xor mask and Merkle deltas are timestamp-only and
    stay as they are. Takes the 2-tuple, 3-tuple or PlannedBatch plan
    and returns the same shape."""
    typed_idx = [i for i, m in enumerate(messages) if schema.is_typed(m.table, m.column)]
    if not typed_idx:
        return plan
    metrics.inc("evolu_crdt_upserts_stripped_total", len(typed_idx))

    def keep(m):
        return not schema.is_typed(m.table, m.column)

    if isinstance(plan, PlannedBatch):
        xor_mask, upserts, deltas = plan
        mask = plan.upsert_mask
        if mask is not None:
            mask = np.array(mask, copy=True)
            mask[typed_idx] = False
        return PlannedBatch(xor_mask, [m for m in upserts if keep(m)], deltas, mask)
    if len(plan) == 3:
        xor_mask, upserts, deltas = plan
        return xor_mask, [m for m in upserts if keep(m)], deltas
    xor_mask, upserts = plan
    return xor_mask, [m for m in upserts if keep(m)]


def select_messages(messages: Sequence[CrdtMessage], mask: np.ndarray) -> List[CrdtMessage]:
    """messages[i] for mask[i], without a per-message Python loop."""
    ix = np.nonzero(mask)[0]
    if len(ix) == 0:
        return []
    if len(ix) == 1:
        return [messages[int(ix[0])]]
    return list(operator.itemgetter(*ix)(messages))


def winner_key_columns(cells, winners: Dict[Tuple[str, str, str], str]):
    """Per-unique-cell stored-winner key columns → (ex1_u, ex2_u,
    canonical), zeros where a cell has no stored winner."""
    from evolu_tpu_torch.ops.host_parse import parse_timestamp_strings

    ex1_u = np.zeros(len(cells), np.uint64)
    ex2_u = np.zeros(len(cells), np.uint64)
    winner_cids = [i for i, cell in enumerate(cells) if cell in winners]
    canonical = True
    if winner_cids:
        w_millis, w_counter, w_node, w_case_ok = parse_timestamp_strings(
            [winners[cells[i]] for i in winner_cids], with_case=True
        )
        canonical = bool(w_case_ok.all())
        ex1_u[winner_cids] = pack_ts_key_host(w_millis, w_counter)
        ex2_u[winner_cids] = w_node
    return ex1_u, ex2_u, canonical


def messages_to_columns(
    messages: Sequence[CrdtMessage],
    existing_winners: Dict[Tuple[str, str, str], str],
):
    """Host-side columnarization, fully vectorized (numpy). → (cell_id,
    k1, k2, ex_k1, ex_k2, millis, counter, node, canonical); `canonical`
    is False when any message or stored winner uses non-canonical hex
    case, which the device order and hash cannot serve."""
    from evolu_tpu_torch.ops.host_parse import intern_cells, parse_timestamp_strings

    millis, counter, node, case_ok = parse_timestamp_strings(
        [m.timestamp for m in messages], with_case=True
    )
    canonical = bool(case_ok.all())
    cell_ids, cells = intern_cells(
        [m.table for m in messages], [m.row for m in messages], [m.column for m in messages],
    )
    ex1_u, ex2_u, winners_canonical = winner_key_columns(cells, existing_winners)
    k1 = pack_ts_key_host(millis, counter)
    return (cell_ids, k1, node, ex1_u[cell_ids], ex2_u[cell_ids], millis, counter, node,
            canonical and winners_canonical)


def pad_columns(arrays, n: int, pad_cell: bool = True):
    """Pad 1-D columns to the power-of-two bucket ≥ n. The first array is
    cell_id (padded with _PAD_CELL); the rest pad with 0."""
    size = bucket_size(n)
    out = []
    for j, a in enumerate(arrays):
        pad_val = int(_PAD_CELL) if (j == 0 and pad_cell) else 0
        out.append(np.concatenate([a, np.full(size - n, pad_val, dtype=a.dtype)]))
    return out, size


def plan_batch_device(
    messages: Sequence[CrdtMessage],
    existing_winners: Dict[Tuple[str, str, str], str],
    device=None,
):
    """The host `storage.apply.plan_batch` with the decision masks
    computed on `device` (None = the card): the same `(xor_mask: list of
    bool, upserts)` contract. A batch with non-canonical hex case takes
    the host oracle before anything touches the device."""
    n = len(messages)
    if n == 0:
        return [], []
    plan = _plan_batch_device_timed(messages, existing_winners, resolve_device(device))
    if plan is None:
        return _host_fallback(messages, existing_winners)
    return plan


def _plan_batch_device_timed(messages, existing_winners, device):
    """pad → the scatter plan's masks or `plan_merge_core` → one-wave
    pull. None on non-canonical hex case."""
    from evolu_tpu_torch.ops.scatter_merge import count, scatter_plan_masks, scatter_table_for

    n = len(messages)
    cell_ids, k1, k2, ex_k1, ex_k2, *rest = messages_to_columns(messages, existing_winners)
    if not rest[-1]:  # canonical flag
        return None
    table_size = scatter_table_for(cell_ids, k1, k2, device)
    (cell_ids, k1, k2, ex_k1, ex_k2), _ = pad_columns([cell_ids, k1, k2, ex_k1, ex_k2], n)
    cols = columns_to_device(
        {"cell_id": cell_ids, "k1": k1, "k2": k2, "ex_k1": ex_k1, "ex_k2": ex_k2}, device
    )
    args = (cols["cell_id"], cols["k1"], cols["k2"], cols["ex_k1"], cols["ex_k2"])
    if table_size is not None:
        count("merge_plan", "scatter")
        metrics.inc("evolu_merge_plan_total", path="scatter")
        masks = scatter_plan_masks(*args, table_size)
    else:
        count("merge_plan", "sort")
        metrics.inc("evolu_merge_plan_total", path="sort")
        masks = plan_merge_core(*args)
    xor_mask, upsert_mask = to_host_many(*masks)
    return xor_mask[:n].tolist(), select_messages(messages, upsert_mask[:n])


def _host_fallback(messages, existing_winners, with_deltas=False):
    """Non-canonical hex case in the batch or its stored winners: the
    device order and hash would diverge from the reference's raw-string
    semantics, so route to the host oracle before any side effect.
    `with_deltas` keeps the device planners' 3-tuple contract, with the
    Merkle deltas folded on the host (verbatim node case)."""
    from evolu_tpu_torch.core.merkle import minute_deltas_host
    from evolu_tpu_torch.storage.apply import plan_batch

    metrics.inc("evolu_merge_host_fallbacks_total")
    metrics.inc("evolu_merge_host_fallback_messages_total", len(messages))
    # Ledger tallies outside the flow equations (the batch's messages still
    # end through whichever apply route takes this plan): the messages the
    # host oracle planned, and the canonicality bounce that sent them here.
    ledger.count(ledger.ROUTE_HOST_FALLBACK, len(messages))
    ledger.count(ledger.BOUNCE_NON_CANONICAL, len(messages))
    log("kernel:merge", "non-canonical hex case: host-planner fallback", n=len(messages))
    xor_mask, upserts = plan_batch(messages, existing_winners)
    if not with_deltas:
        return xor_mask, upserts
    deltas, _ = minute_deltas_host(m.timestamp for flag, m in zip(xor_mask, messages) if flag)
    return xor_mask, upserts, deltas


def plan_full_kernel(cell_id, k1, k2, ex_k1, ex_k2):
    """Masks + per-minute Merkle XOR deltas in cell-sorted order, one
    owner (owner key 0). → (xor_s, upsert_s, i_s, minute_sorted,
    seg_end, seg_xor, valid_sorted), all on the columns' device."""
    from evolu_tpu_torch.ops.merkle_ops import owner_minute_segments

    xor_s, upsert_s, i_s, s1, s2, _ = plan_merge_sorted_flags(cell_id, k1, k2, ex_k1, ex_k2)
    millis_s, _ = unpack_ts_keys(s1)
    hashes, _ = masked_key_hashes(s1, s2, xor_s)
    _, minute_sorted, seg_end, seg_xor, valid_sorted = owner_minute_segments(
        torch.zeros_like(millis_s, dtype=torch.int32), millis_s, hashes, xor_s
    )
    return xor_s, upsert_s, i_s, minute_sorted, seg_end, seg_xor, valid_sorted


def plan_full_kernel_scatter(cell_id, k1, k2, ex_k1, ex_k2, table_size: int):
    """The sort-free twin of `plan_full_kernel` (ops/scatter_merge.py):
    the masks come from the scatter-argmax plan in ORIGINAL batch order
    (i_s is the identity), and kernel H and the minute fold (kernel X)
    run over the original-order columns; the fold's own tile sort does
    the grouping, and every decoder XOR-merges repeated keys. Same
    7-output contract; wherever the router admits a batch, the decoded
    plan equals the sort plan's."""
    from evolu_tpu_torch.ops.merkle_ops import owner_minute_segments
    from evolu_tpu_torch.ops.scatter_merge import scatter_plan_masks

    xor_m, upsert_m = scatter_plan_masks(cell_id, k1, k2, ex_k1, ex_k2, table_size)
    i_s = torch.arange(cell_id.shape[0], dtype=torch.int32, device=cell_id.device)
    millis, _ = unpack_ts_keys(k1)
    hashes, _ = masked_key_hashes(k1, k2, xor_m)
    _, minute_sorted, seg_end, seg_xor, valid_sorted = owner_minute_segments(
        torch.zeros_like(millis, dtype=torch.int32), millis, hashes, xor_m
    )
    return xor_m, upsert_m, i_s, minute_sorted, seg_end, seg_xor, valid_sorted


def _run_full_plan(cell_ids, k1, k2, ex_k1, ex_k2, n: int, device):
    """route → pad → `plan_full_kernel_scatter` or `plan_full_kernel` →
    one-wave pull → unpermute → delta decode. → (xor_mask, upsert_mask,
    deltas), masks in batch order."""
    from evolu_tpu_torch.ops.merkle_ops import decode_owner_minute_deltas
    from evolu_tpu_torch.ops.scatter_merge import count, scatter_table_for

    # Admission and table sizing before the padding (pad rows use the
    # dump slot, never the table).
    table_size = scatter_table_for(cell_ids, k1, k2, device)
    (cell_ids, k1, k2, ex_k1, ex_k2), size = pad_columns([cell_ids, k1, k2, ex_k1, ex_k2], n)
    cols = columns_to_device(
        {"cell_id": cell_ids, "k1": k1, "k2": k2, "ex_k1": ex_k1, "ex_k2": ex_k2}, device
    )
    args = (cols["cell_id"], cols["k1"], cols["k2"], cols["ex_k1"], cols["ex_k2"])
    if table_size is not None:
        count("merge_plan", "scatter")
        metrics.inc("evolu_merge_plan_total", path="scatter")
        outs = plan_full_kernel_scatter(*args, table_size)
    else:
        count("merge_plan", "sort")
        metrics.inc("evolu_merge_plan_total", path="sort")
        outs = plan_full_kernel(*args)
    xor_s, upsert_s, i_s, minute_sorted, seg_end, seg_xor, valid = to_host_many(*outs)
    xor_mask, upsert_mask = unpermute_masks(xor_s, upsert_s, i_s)
    deltas = decode_owner_minute_deltas(
        np.zeros(size, np.int32), minute_sorted, seg_end, seg_xor, valid
    ).get(0, {})
    return xor_mask[:n], upsert_mask[:n], deltas


def plan_packed_device_full(cell_ids, k1, k2, ex_k1, ex_k2, n: int, device=None):
    """The columns-only twin of `plan_batch_device_full` for a
    `PackedReceive`: the same kernels, but the result is
    `(xor_mask, upsert_mask, deltas)` with positional numpy masks only;
    the packed SQLite apply binds straight from the batch's buffers, so
    no `upserts` message list is built."""
    return _run_full_plan(cell_ids, k1, k2, ex_k1, ex_k2, n, resolve_device(device))


def plan_packed_streamed(db, pb, millis, counter, node, cells, touched_ids, device=None):
    """Packed plan with winners streamed from SQLite for the touched
    cells: one copy of the fetch, scatter and plan sequence, shared by
    the winner cache's streaming mode and the worker's no-cache packed
    route (they must stay identical or the cache-on and -off routes
    diverge). `cells` are the touched unique cells; `touched_ids` their
    indices into `pb.cells`. None on a non-canonical stored winner (the
    caller materializes the batch for the object path)."""
    from evolu_tpu_torch.storage.apply import fetch_existing_winners

    winners = fetch_existing_winners(db, cells)
    ex1_t, ex2_t, canonical = winner_key_columns(cells, winners)
    if not canonical:
        return None
    ex1 = np.zeros(len(pb.cells), np.uint64)
    ex2 = np.zeros(len(pb.cells), np.uint64)
    ex1[touched_ids] = ex1_t
    ex2[touched_ids] = ex2_t
    k1 = pack_ts_key_host(millis, counter)
    return plan_packed_device_full(
        pb.cell_id, k1, node, ex1[pb.cell_id], ex2[pb.cell_id], pb.n, device
    )


def plan_batch_device_full(
    messages: Sequence[CrdtMessage],
    existing_winners: Dict[Tuple[str, str, str], str],
    cols=None,
    device=None,
):
    """The device planner for `storage.apply.apply_messages`: →
    `(xor_mask, upserts, deltas)` with the per-minute Merkle XOR deltas
    computed on the card. `cols` optionally reuses a caller's
    `messages_to_columns` result. A batch with non-canonical hex case
    takes the host oracle before anything touches the device."""
    n = len(messages)
    if n == 0:
        return [], [], {}
    device = resolve_device(device)
    cell_ids, k1, k2, ex_k1, ex_k2, *rest = (
        cols if cols is not None else messages_to_columns(messages, existing_winners)
    )
    if not rest[-1]:  # canonical flag
        return _host_fallback(messages, existing_winners, with_deltas=True)
    xor_mask, upsert_mask, deltas = _run_full_plan(cell_ids, k1, k2, ex_k1, ex_k2, n, device)
    return PlannedBatch(
        xor_mask.tolist(), select_messages(messages, upsert_mask), deltas, upsert_mask
    )
