"""Multi-owner reconcile — the LWW reconcile pass for a fleet of owners.

One dispatch plans every owner's LWW merges and per-(owner, minute)
Merkle XOR deltas and reduces the batch digest. The JAX package shards
owners over a device mesh and XOR-all-reduces the per-shard digests;
here one card holds one shard, so the all-reduce is the identity and
the 9-output contract of the shard kernel stays as it is:

    (xor_sorted, upsert_sorted, i_s, owner_sorted, minute_sorted,
     seg_end, seg_xor, valid_sorted, digest)

Cell ids are interned per owner then offset by a running base, so cell
ids are unique across owners and cell segmentation keeps owners apart.

`shard_kernel_for` routes a batch on its host columns between the
sort-free scatter plan (`_shard_kernel_scatter`, ops/scatter_merge.py),
the packed-owner sort kernel and the wide-id sort kernel.
"""

from __future__ import annotations

import functools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from evolu_tpu_torch.core.types import CrdtMessage
from evolu_tpu_torch.ops import bucket_size, columns_to_device, resolve_device, to_host_many
from evolu_tpu_torch.ops.cuda_hash import masked_key_hashes
from evolu_tpu_torch.ops.encode import unpack_ts_keys
from evolu_tpu_torch.ops.merge import (
    _PAD_CELL,
    masks_from_sorted_flags,
    messages_to_columns,
    plan_merge_sorted_flags,
    select_messages,
    unpermute_masks,
    winner_flags,
)
from evolu_tpu_torch.ops.merkle_ops import decode_owner_minute_deltas, owner_minute_segments

# Packed-owner sort key: owner(12) | cell(25) | idx(24) | flags(2) = 63
# bits. Owner value 4095 is the padding sentinel (sorts last), so real
# owners must be < 4095 and cell ids < 2^25; `shard_kernel_for` routes
# batches beyond either bound to `_shard_kernel_wide`.
_OWNER_BITS, _CELL_BITS = 12, 25
_PAD_OWNER = (1 << _OWNER_BITS) - 1

COLUMN_NAMES = ("cell_id", "k1", "k2", "ex_k1", "ex_k2", "owner_ix")


def pack_owner_cell_key(owner_ix, cell_id, idx, lo_bits: int = 2, lo=None):
    """owner(12) | cell(25) | idx(24) | lo(lo_bits) as one int64 sort key.
    Padding rows (cell_id == _PAD_CELL) take the _PAD_OWNER sentinel."""
    own = torch.where(cell_id == int(_PAD_CELL),
                      torch.full_like(owner_ix, _PAD_OWNER, dtype=torch.int64),
                      owner_ix.to(torch.int64))
    key = (
        (own << (_CELL_BITS + 24 + lo_bits))
        | ((cell_id.to(torch.int64) & ((1 << _CELL_BITS) - 1)) << (24 + lo_bits))
        | (idx.to(torch.int64) << lo_bits)
    )
    return key if lo is None else key | lo


def _hash_and_fold(owner_s, s1, s2, xor_s):
    """Kernel H over the sorted keys + the (owner, minute) fold (kernel X)."""
    hashes, digest = masked_key_hashes(s1, s2, xor_s)
    millis_s, _ = unpack_ts_keys(s1)
    return owner_minute_segments(owner_s, millis_s, hashes, xor_s), digest


def _shard_kernel(cell_id, k1, k2, ex_k1, ex_k2, owner_ix):
    """LWW plan + (owner, minute) XOR deltas + digest for one shard.

    The sort key is owner<<51 | cell<<26 | idx<<2 | b<<1 | a, so one
    int64 sort carries the whole row identity and only the two HLC keys
    are gathered. Segments group by (owner, cell), which is cell
    grouping because cell ids are unique across owners."""
    n = cell_id.shape[0]
    if n > 1 << 24:  # idx no longer fits its 24 key bits
        return _shard_kernel_wide(cell_id, k1, k2, ex_k1, ex_k2, owner_ix)
    idx = torch.arange(n, dtype=torch.int64, device=cell_id.device)
    a, b = winner_flags(k1, k2, ex_k1, ex_k2)
    key = pack_owner_cell_key(
        owner_ix, cell_id, idx, lo_bits=2,
        lo=(b.to(torch.int64) << 1) | a.to(torch.int64),
    )
    key_s, perm = torch.sort(key)
    s1, s2 = k1[perm], k2[perm]
    owner_s = (key_s >> (_CELL_BITS + 26)).to(torch.int32)
    i_s = ((key_s >> 2) & ((1 << 24) - 1)).to(torch.int32)
    a_s = (key_s & 1) != 0
    b_s = (key_s & 2) != 0
    real = owner_s != _PAD_OWNER
    xor_s, upsert_s = masks_from_sorted_flags(key_s >> 26, s1, s2, a_s, b_s, real)
    segments, digest = _hash_and_fold(owner_s, s1, s2, xor_s)
    return (xor_s, upsert_s, i_s, *segments, digest)


def _shard_kernel_wide(cell_id, k1, k2, ex_k1, ex_k2, owner_ix):
    """The wide-id form (cell ≥ 2^25 or owner ≥ 4095): owner rides as a
    gathered payload and segmentation is by cell alone — the same
    results as the packed form wherever both apply."""
    xor_s, upsert_s, i_s, s1, s2, (owner_s,) = plan_merge_sorted_flags(
        cell_id, k1, k2, ex_k1, ex_k2, extras=(owner_ix.to(torch.int32),)
    )
    segments, digest = _hash_and_fold(owner_s, s1, s2, xor_s)
    return (xor_s, upsert_s, i_s, *segments, digest)


def _shard_kernel_scatter(cell_id, k1, k2, ex_k1, ex_k2, owner_ix, table_size):
    """The sort-free shard kernel (ops/scatter_merge.py): the masks come
    from the scatter-argmax plan in ORIGINAL order (i_s is the identity),
    and kernel H and the (owner, minute) fold (kernel X) run over the
    original-order columns; the fold's own tile sort groups them and
    every decoder XOR-merges repeated keys, so host-level plans, deltas
    and the digest equal the sort kernels' wherever the router admits a
    batch. Cell ids are unique across owners (the layout's running base),
    as `_shard_kernel_wide` assumes too. Same 9-output contract."""
    from evolu_tpu_torch.ops.scatter_merge import scatter_plan_masks

    xor_m, upsert_m = scatter_plan_masks(cell_id, k1, k2, ex_k1, ex_k2, table_size)
    i_s = torch.arange(cell_id.shape[0], dtype=torch.int32, device=cell_id.device)
    segments, digest = _hash_and_fold(owner_ix, k1, k2, xor_m)
    return (xor_m, upsert_m, i_s, *segments, digest)


@functools.lru_cache(maxsize=None)
def scatter_shard_kernel(table_size: int):
    """The scatter shard kernel bound to one table bucket (one callable a
    bucket, so a route compares by identity)."""
    kernel = functools.partial(_shard_kernel_scatter, table_size=table_size)
    kernel.__name__ = f"_shard_kernel_scatter_{table_size}"
    return kernel


def shard_kernel_for(cols: Dict[str, np.ndarray], device=None):
    """Host-side routing on the numpy columns, for a pass on `device`
    (None = the card): the scatter plan when the configured path and its
    admission allow it (cell ids < 2^25, no duplicate row); else the
    packed-owner kernel, which needs every real cell id < 2^25 and every
    owner index < 4095; else the wide kernel. Counted in
    `scatter_merge.counts["reconcile_kernel"]`."""
    from evolu_tpu_torch.ops.scatter_merge import count, table_size_for, use_scatter_plan

    real = cols["cell_id"] != int(_PAD_CELL)
    cell_max = int(cols["cell_id"].max(initial=0, where=real))
    owner_max = int(cols["owner_ix"].max(initial=0))
    if "k1" in cols and use_scatter_plan(cols["cell_id"], cols["k1"], cols["k2"], device,
                                         cell_max=cell_max):
        count("reconcile_kernel", "scatter")
        return scatter_shard_kernel(table_size_for(cell_max))
    if cell_max < (1 << _CELL_BITS) and owner_max < _PAD_OWNER:
        count("reconcile_kernel", "packed")
        return _shard_kernel
    count("reconcile_kernel", "wide")
    return _shard_kernel_wide


def reconcile_columns(cols: Dict[str, np.ndarray], device=None):
    """Run the shard kernel on flat padded numpy columns. → the 9 outputs
    as tensors on `device`; masks are in sorted order (batch order on the
    scatter route) and `unpermute_masks` restores batch order on the
    host."""
    device = resolve_device(device)
    kernel = shard_kernel_for(cols, device)
    t = columns_to_device({k: cols[k] for k in COLUMN_NAMES}, device)
    return kernel(*(t[k] for k in COLUMN_NAMES))


def build_owner_columns(
    owner_batches: Dict[str, Sequence[CrdtMessage]],
    existing_winners: Dict[str, Dict[Tuple[str, str, str], str]],
):
    """Host-side layout: per-owner columnarization → flat padded columns
    (owners contiguous, one shard) + the index to scatter results back.

    Returns (cols, index, host_owners): `host_owners` are owners whose
    batch or stored winners use non-canonical hex case; they stay out of
    the layout and are planned on the host, owner by owner."""
    per_owner = {}
    host_owners = []
    cell_base = 0
    for o, msgs in owner_batches.items():
        cell_ids, k1, k2, ex_k1, ex_k2, *_, canonical = messages_to_columns(
            msgs, existing_winners.get(o, {})
        )
        if not canonical:
            host_owners.append(o)
            continue
        per_owner[o] = (cell_ids + cell_base, k1, k2, ex_k1, ex_k2)
        cell_base += len(msgs)  # intern ids are < len(msgs)

    total = bucket_size(max(sum(len(owner_batches[o]) for o in per_owner), 1))
    out = {
        "cell_id": np.full(total, int(_PAD_CELL), np.int32),
        "k1": np.zeros(total, np.uint64),
        "k2": np.zeros(total, np.uint64),
        "ex_k1": np.zeros(total, np.uint64),
        "ex_k2": np.zeros(total, np.uint64),
        "owner_ix": np.zeros(total, np.int64),
    }
    index: Dict[str, Tuple[np.ndarray, int]] = {}
    pos = 0
    for o_ix, (o, (cell_ids, k1, k2, ex_k1, ex_k2)) in enumerate(per_owner.items()):
        sl = slice(pos, pos + len(cell_ids))
        out["cell_id"][sl] = cell_ids
        out["k1"][sl], out["k2"][sl] = k1, k2
        out["ex_k1"][sl], out["ex_k2"][sl] = ex_k1, ex_k2
        out["owner_ix"][sl] = o_ix
        index[o] = (np.arange(sl.start, sl.stop), o_ix)
        pos = sl.stop
    return out, index, host_owners


def reconcile_owner_batches(
    owner_batches: Dict[str, Sequence[CrdtMessage]],
    existing_winners: Dict[str, Dict[Tuple[str, str, str], str]],
    device=None,
):
    """Full multi-owner reconcile: one device pass for all owners.

    Returns ({owner: (xor_mask, upserts, minute_deltas)}, digest) with
    the per-owner contract of the single-owner planner
    (`storage.apply.plan_batch` + the host Merkle delta fold), so the
    caller can apply results to per-owner SQLite stores and trees."""
    if not owner_batches:
        return {}, 0
    device = resolve_device(device)
    cols, index, host_owners = build_owner_columns(owner_batches, existing_winners)
    results = {}
    digest = 0
    if index:
        (xor_s, upsert_s, i_s, owner_sorted, minute_sorted, seg_end, seg_xor, seg_valid,
         dev_digest) = to_host_many(*reconcile_columns(cols, device))
        xor_mask, upsert_mask = unpermute_masks(xor_s, upsert_s, i_s)
        deltas_by_ix = decode_owner_minute_deltas(
            owner_sorted, minute_sorted, seg_end, seg_xor, seg_valid
        )
        digest = int(dev_digest.view(np.uint32)[0])
        for owner, (positions, o_ix) in index.items():
            results[owner] = (
                xor_mask[positions].tolist(),
                select_messages(owner_batches[owner], upsert_mask[positions]),
                deltas_by_ix.get(o_ix, {}),
            )
    for owner in host_owners:
        plan, owner_digest = _host_owner_plan(
            owner_batches[owner], existing_winners.get(owner, {})
        )
        results[owner] = plan
        digest ^= owner_digest
    return results, digest


def _host_owner_plan(messages, winners):
    """Oracle-exact host plan for one quarantined owner: raw-string LWW
    order + the shared verbatim-case hash fold."""
    from evolu_tpu_torch.core.merkle import minute_deltas_host
    from evolu_tpu_torch.storage.apply import plan_batch

    xor_mask, upserts = plan_batch(messages, winners)
    deltas, digest = minute_deltas_host(
        m.timestamp for flag, m in zip(xor_mask, messages) if flag
    )
    return (xor_mask, upserts, deltas), digest
