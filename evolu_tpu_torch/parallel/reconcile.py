"""Multi-owner reconcile — the LWW reconcile pass for a fleet of owners.

One pass plans every owner's LWW merges and per-(owner, minute) Merkle
XOR deltas and reduces the batch digest. Owners are assigned to the
shards of a mesh (`parallel/mesh.py`; never split), each shard runs the
shard kernel on its own slice on its own device, and the only
cross-shard value is the digest: the shards' digests XOR on the host,
and across processes through one gloo all_gather (`xor_allreduce`). A
shard kernel keeps the 9-output contract:

    (xor_sorted, upsert_sorted, i_s, owner_sorted, minute_sorted,
     seg_end, seg_xor, valid_sorted, digest)

Cell ids are interned per owner then offset by a running base, so cell
ids are unique across owners and cell segmentation keeps owners apart.

`shard_kernel_for` routes a batch on its host columns between the
sort-free scatter plan (`_shard_kernel_scatter`, ops/scatter_merge.py),
the packed-owner sort kernel and the wide-id sort kernel.

The `evolu_reconcile_*` metrics (kernel variant, batch rows and owners,
shard rows, host-owner fallbacks) and the `kernel:reconcile` span are
recorded as in the reference, once a batch, from host values in hand.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from evolu_tpu_torch.core.types import CrdtMessage
from evolu_tpu_torch.obs import metrics
from evolu_tpu_torch.ops import bucket_size, columns_to_device, resolve_device, to_host_many
from evolu_tpu_torch.ops.cuda_hash import masked_key_hashes
from evolu_tpu_torch.ops.cuda_lib import device_work
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
from evolu_tpu_torch.parallel.mesh import (
    Mesh,
    assign_owners_to_shards,
    put_sharded,
    require_single_process,
    single_mesh,
)
from evolu_tpu_torch.utils.log import log, span

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
    `evolu_reconcile_kernel_total{variant}` and
    `scatter_merge.counts["reconcile_kernel"]`."""
    from evolu_tpu_torch.ops.scatter_merge import count, table_size_for, use_scatter_plan

    real = cols["cell_id"] != int(_PAD_CELL)
    cell_max = int(cols["cell_id"].max(initial=0, where=real))
    owner_max = int(cols["owner_ix"].max(initial=0))
    if "k1" in cols and use_scatter_plan(cols["cell_id"], cols["k1"], cols["k2"], device,
                                         cell_max=cell_max):
        count("reconcile_kernel", "scatter")
        metrics.inc("evolu_reconcile_kernel_total", variant="scatter")
        return scatter_shard_kernel(table_size_for(cell_max))
    if cell_max < (1 << _CELL_BITS) and owner_max < _PAD_OWNER:
        count("reconcile_kernel", "packed")
        metrics.inc("evolu_reconcile_kernel_total", variant="packed")
        return _shard_kernel
    count("reconcile_kernel", "wide")
    metrics.inc("evolu_reconcile_kernel_total", variant="wide")
    return _shard_kernel_wide


def xor_allreduce(digests, mesh: Optional[Mesh] = None) -> int:
    """XOR-combine per-shard digests across the mesh → the batch digest
    as an unsigned 32-bit int. Within a process the shards' digests are
    host numbers already (pulled with their outputs); across processes
    (a mesh whose shards live on several ranks) each process's XOR rides
    one `all_gather` of an int64 CPU tensor over a gloo group, then a
    local XOR. NCCL has no XOR reduction; XOR is associative and
    commutative, so the reduction is exact in any order."""
    local = 0
    for d in digests:
        local ^= int(d) & 0xFFFFFFFF
    if mesh is None or not mesh.is_multiprocess():
        return local
    import torch.distributed as dist

    from evolu_tpu_torch.parallel.multihost import digest_group

    group = digest_group()
    out = [torch.zeros(1, dtype=torch.int64) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, torch.tensor([local], dtype=torch.int64), group=group)
    total = 0
    for x in out:
        total ^= int(x[0])
    return total


def dispatch_columns_sharded(mesh: Mesh, cols: Dict[str, np.ndarray], kernel=None,
                             names=COLUMN_NAMES, run=None, what: str = "a sharded reconcile pass"):
    """Launch one shard's work on each of this process's shards: shard i
    takes rows [i*S, (i+1)*S) of the flat global columns `names` (shards
    sharing a device run in shard order on its current stream).
    `run(part, device)` launches a shard from its host slices (a dict in
    `names` order); by default they go straight to the shard's device and
    the shard kernel runs on them, routed once on the whole layout
    (`shard_kernel_for`), so every shard runs the same one. → per-shard
    output tuples, None for other processes' shards."""
    if run is None:
        if kernel is None:
            kernel = shard_kernel_for(cols, mesh.devices[0])

        def run(part, device):
            t = columns_to_device(part, device)
            return kernel(*(t[k] for k in names))
    outs: List[Optional[tuple]] = [None] * mesh.size
    with device_work(what):
        for i, part in enumerate(zip(*(put_sharded(cols[k], mesh) for k in names))):
            if part[0] is not None:
                outs[i] = run(dict(zip(names, part)), mesh.devices[i])
    return outs


def pull_shards(outs) -> List[tuple]:
    """The local shards' outputs in one pull wave, each output joined in
    shard order → one tuple of flat numpy arrays."""
    local = [o for o in outs if o is not None]
    if not local:
        return []
    width = len(local[0])
    with device_work("a sharded pass's pull"):
        flat = to_host_many(*(x for o in local for x in o))
    return [np.concatenate([flat[j * width + k] for j in range(len(local))]) for k in range(width)]


def reconcile_columns_sharded(mesh: Mesh, cols: Dict[str, np.ndarray]):
    """The sharded kernel on flat global columns (length D*S, owners laid
    out shard-contiguously). → (xor_sorted, upsert_sorted, i_s,
    owner_sorted, minute_sorted, seg_end, seg_xor, seg_valid, digest):
    numpy arrays of this process's shards joined in shard order (the
    whole layout in one process), masks in per-shard sorted order
    (`unpermute_masks(..., block_size=S)` restores batch order), and the
    whole batch's digest, all-reduced over every process's shards."""
    pulled = pull_shards(dispatch_columns_sharded(mesh, cols))
    if not pulled:
        return (*(np.zeros(0) for _ in range(8)), xor_allreduce((), mesh))
    *arrays, digests = pulled
    return (*arrays, xor_allreduce(digests.view(np.uint32).tolist(), mesh))


def _layout_mesh(mesh, mesh_ctx, device):
    if mesh is None:
        mesh = mesh_ctx.mesh if mesh_ctx is not None else single_mesh(resolve_device(device))
    return mesh


def build_owner_columns(
    owner_batches: Dict[str, Sequence[CrdtMessage]],
    existing_winners: Dict[str, Dict[Tuple[str, str, str], str]],
    mesh: Optional[Mesh] = None,
    mesh_ctx=None,
):
    """Host-side layout: per-owner columnarization → shard assignment →
    flat padded global columns (D shards of S rows, S the power-of-two
    bucket of the largest shard load) + the index to scatter results
    back. Owners go to shards by greedy LPT, or with `mesh_ctx` by its
    stable placement (`assign_stable`; the context records the per-shard
    rows and the digest reduce). `mesh` None is one shard (the context's
    mesh with a context).

    Returns (cols, index, host_owners): `host_owners` are owners whose
    batch or stored winners use non-canonical hex case; they stay out of
    the layout and are planned on the host, owner by owner."""
    if mesh is None and mesh_ctx is not None:
        mesh = mesh_ctx.mesh
    n_shards = 1 if mesh is None else mesh.size
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
    owner_ix = {o: i for i, o in enumerate(per_owner)}

    sizes = {o: len(owner_batches[o]) for o in per_owner}
    if mesh_ctx is not None:
        shards = mesh_ctx.assign_stable(sizes)
    else:
        shards = assign_owners_to_shards(sizes, n_shards)
    loads = [sum(sizes[o] for o in s) for s in shards]
    for load in loads:
        metrics.observe("evolu_reconcile_shard_rows", load, buckets=metrics.COUNT_BUCKETS)
    shard_size = bucket_size(max(max(loads, default=0), 1))
    if mesh_ctx is not None:
        mesh_ctx.record_occupancy(loads, shard_size)
        mesh_ctx.record_xdev_reduce("digest")

    total = n_shards * shard_size
    out = {
        "cell_id": np.full(total, int(_PAD_CELL), np.int32),
        "k1": np.zeros(total, np.uint64),
        "k2": np.zeros(total, np.uint64),
        "ex_k1": np.zeros(total, np.uint64),
        "ex_k2": np.zeros(total, np.uint64),
        "owner_ix": np.zeros(total, np.int64),
    }
    index: Dict[str, Tuple[np.ndarray, int]] = {}
    for si, shard in enumerate(shards):
        pos = si * shard_size
        for o in shard:
            cell_ids, k1, k2, ex_k1, ex_k2 = per_owner[o]
            sl = slice(pos, pos + len(cell_ids))
            out["cell_id"][sl] = cell_ids
            out["k1"][sl], out["k2"][sl] = k1, k2
            out["ex_k1"][sl], out["ex_k2"][sl] = ex_k1, ex_k2
            out["owner_ix"][sl] = owner_ix[o]
            index[o] = (np.arange(sl.start, sl.stop), owner_ix[o])
            pos = sl.stop
    return out, index, host_owners


def reconcile_owner_batches(
    owner_batches: Dict[str, Sequence[CrdtMessage]],
    existing_winners: Dict[str, Dict[Tuple[str, str, str], str]],
    device=None,
    mesh: Optional[Mesh] = None,
    mesh_ctx=None,
):
    """Full multi-owner reconcile: one device pass for all owners, each
    shard of `mesh` (default: the context's mesh, else one shard on
    `device`, None = the card) planning the owners laid out on it.

    Returns ({owner: (xor_mask, upserts, minute_deltas)}, digest) with
    the per-owner contract of the single-owner planner
    (`storage.apply.plan_batch` + the host Merkle delta fold), so the
    caller can apply results to per-owner SQLite stores and trees."""
    if not owner_batches:
        return {}, 0
    require_single_process("reconcile_owner_batches")
    mesh = _layout_mesh(mesh, mesh_ctx, device)
    n_msgs = sum(len(v) for v in owner_batches.values())
    metrics.observe("evolu_reconcile_batch_rows", n_msgs, buckets=metrics.COUNT_BUCKETS)
    metrics.observe("evolu_reconcile_batch_owners", len(owner_batches),
                    buckets=metrics.COUNT_BUCKETS)
    with span("kernel:reconcile", "reconcile_owner_batches", owners=len(owner_batches),
              n=n_msgs):
        return _reconcile_owner_batches_timed(owner_batches, existing_winners, mesh, mesh_ctx)


def _reconcile_owner_batches_timed(owner_batches, existing_winners, mesh, mesh_ctx):
    cols, index, host_owners = build_owner_columns(owner_batches, existing_winners, mesh, mesh_ctx)
    results = {}
    digest = 0
    if index:
        (xor_s, upsert_s, i_s, owner_sorted, minute_sorted, seg_end, seg_xor, seg_valid,
         digest) = reconcile_columns_sharded(mesh, cols)
        shard_size = len(cols["cell_id"]) // mesh.size
        xor_mask, upsert_mask = unpermute_masks(xor_s, upsert_s, i_s, block_size=shard_size)
        deltas_by_ix = decode_owner_minute_deltas(
            owner_sorted, minute_sorted, seg_end, seg_xor, seg_valid
        )
        for owner, (positions, o_ix) in index.items():
            results[owner] = (
                xor_mask[positions].tolist(),
                select_messages(owner_batches[owner], upsert_mask[positions]),
                deltas_by_ix.get(o_ix, {}),
            )
    metrics.inc("evolu_reconcile_host_owner_fallbacks_total", len(host_owners))
    for owner in host_owners:
        log("kernel:reconcile", "non-canonical hex case: host-planner fallback",
            owner=owner, n=len(owner_batches[owner]))
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
