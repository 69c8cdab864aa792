"""Batch reconcile engine — many owners' sync rounds in one device pass.

The port's copy of `evolu_tpu.server.engine`. The reference
relay handles one user per HTTP request, inserting and hashing message
by message (apps/server/src/index.ts:148-159). This engine takes a
whole batch of SyncRequests (config 3: 1M messages across 1k owners),
and:

1. finds the new rows: on a store with the native packed insert (the C++
   backend, or shards of it) one `INSERT OR IGNORE` call a shard that
   returns per-row was-new flags, then one native parse of the same
   packed buffer (`_ingest_packed`, shards in parallel threads; or the
   pipelined `start_batch`/`finish_batch`, which `run_batch_wire` and
   `reconcile_stream` take); elsewhere a bulk temp-table set-diff
   (`_ingest_generic`);
2. hashes every new timestamp (kernel H) and reduces per-(owner,
   minute) XOR deltas on the card (`owner_minute_segments`: a sort and
   kernel X), compacted on the card to the segment ends;
3. applies the deltas to each owner's sparse tree, persists, and
   answers each request with the standard diff response.

With a write-behind queue attached (`write_behind=`, storage/
write_behind.py) `run_batch_wire` defers step 3's persistence: the pass
folds the deltas onto the queue's in-memory trees, ACKs the packed rows
into the queue's fsync'd log, and answers from memory
(`_finish_batch_deferred`); drain workers materialize SQLite later.

With a `MeshContext` (`mesh_ctx=`, the mesh-sharded engine) every pass
runs over the context's shards: owners placed stably, a hot owner split
row-wise into units of at most ceil(rows / n), each shard compacting its
own segments to its own cap, the shards' digests XOR-reduced on the host
(`parallel.reconcile.xor_allreduce`). Without one a pass has one shard.
`reconcile_pod` runs the whole server across processes: each process
stores and answers its own owners, runs the kernels of its own shards,
and the digest is all-reduced over a gloo group. Every entry point runs
on the card unless the caller passes `device="cpu"` (or CPU shards);
without a card it raises.

A scoped request (a `ScopeClause`) ingests like any other; only its
answer differs: `server/scope.scoped_response` serves it from the scoped
Merkle subtree, folded on the engine's device, never on the fused wire
stream. Under write-behind that answer reads SQLite, so it waits for the
owner's drain first.

Observability as the reference's: `kernel:merkle` spans around each
pass (they nest under the scheduler's `engine.batch` span), the
`device_dispatch` and `host_apply` stage records, the compact-upload
bytes and the store passes by path, and `observe_jit_caches`, the
recompile sentinel's counterpart. Plain `counts` are kept beside them.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from evolu_tpu_torch.core.merkle import (
    apply_prefix_xors,
    diff_merkle_trees,
    merkle_tree_from_string,
    merkle_tree_to_string,
    minute_deltas_host,
    minutes_base3,
)
from evolu_tpu_torch.core.murmur import to_int32
from evolu_tpu_torch.core.types import NonCanonicalStoreError
from evolu_tpu_torch.obs import anatomy, flight, metrics
from evolu_tpu_torch.ops import (
    bucket_size,
    columns_to_device,
    record_pull_wave,
    resolve_device,
    to_host_many,
)
from evolu_tpu_torch.ops.cuda_hash import masked_key_hashes
from evolu_tpu_torch.ops.cuda_lib import device_work, stream_state_count
from evolu_tpu_torch.ops.encode import pack_ts_keys, unpack_ts_keys
from evolu_tpu_torch.ops.host_parse import parse_packed_timestamps, parse_timestamp_strings
from evolu_tpu_torch.ops.merkle_ops import decode_owner_minute_deltas, owner_minute_segments
from evolu_tpu_torch.parallel.mesh import (
    Mesh,
    MeshContext,
    assign_owners_to_shards,
    owner_shard,
    process_count,
    process_index,
    require_single_process,
    single_mesh,
)
from evolu_tpu_torch.parallel.reconcile import dispatch_columns_sharded, xor_allreduce
from evolu_tpu_torch.server import scope
from evolu_tpu_torch.server.relay import ShardedRelayStore, fetch_response_stream
from evolu_tpu_torch.sync import protocol
from evolu_tpu_torch.utils.log import span

# Dispatches by route, beside the reference's metrics: `delta` and
# `full` count the 16-B and 20-B compact uploads, `overflow` the
# full-width reruns after a cap overflow, `host_owners` the owners whose
# non-canonical hex case sent them to the host fold; `deferred_passes`
# the write-behind passes, and `store_duplicate` the rows their in-batch
# dedup dropped (the reference's `store.duplicate` ledger terminal for
# them). Every engine of the process counts here, from whichever thread
# dispatches: `_count` takes the lock.
counts = {"delta": 0, "full": 0, "overflow": 0, "host_owners": 0, "deferred_passes": 0, "store_duplicate": 0}
_counts_lock = threading.Lock()


def _count(key: str, n: int = 1) -> None:
    with _counts_lock:
        counts[key] += n


# The launch shapes the engine has dispatched: (route, shard rows, segment
# cap, shards). The port has no jit cache; a new entry here is its
# counterpart of a recompile (a new bucket shape for the kernels).
_DISPATCHED_BUCKETS: set = set()


def _note_bucket(route: str, shard_size: int, cap: int, n_shards: int) -> None:
    with _counts_lock:
        _DISPATCHED_BUCKETS.add((route, shard_size, cap, n_shards))


def merkle_jit_cache_size() -> int:
    """The number of launch shapes (route, shard rows, cap, shards) the
    engine has dispatched in this process."""
    with _counts_lock:
        return len(_DISPATCHED_BUCKETS)


# Recompile sentinel: last-observed sizes, diffed after each scheduler
# batch. Only the scheduler's dispatcher thread calls observe_jit_caches.
_JIT_SENTINEL_SIZES: Dict[str, int] = {}


def observe_jit_caches(batch_rows: int = 0) -> Dict[str, int]:
    """The recompile sentinel of the reference, for what the port keeps
    per launch shape: `merkle` counts the bucket shapes the engine has
    dispatched (`merkle_jit_cache_size`), `kernel_state` the kernels'
    per-(kind, device, stream) scratch states (`ops.cuda_lib.stream_state`).
    Exports `evolu_jit_cache_size{cache}` gauges and grows
    `evolu_jit_recompiles_total{cache}` by the diff since the last
    batch, with a `kernel:jit` flight event naming the batch's bucket.
    The first observation is the baseline; traffic within a bucket stays
    flat. Returns {cache: size}."""
    sizes = {"merkle": merkle_jit_cache_size(), "kernel_state": stream_state_count()}
    for cache, size in sizes.items():
        metrics.set_gauge("evolu_jit_cache_size", size, cache=cache)
        prev = _JIT_SENTINEL_SIZES.get(cache)
        if prev is not None and size > prev:
            metrics.inc("evolu_jit_recompiles_total", size - prev, cache=cache)
            flight.record(
                "kernel:jit", "launch-shape cache grew", cache=cache,
                new_entries=size - prev, total_entries=size,
                batch_rows=batch_rows,
                bucket_rows=bucket_size(max(1, batch_rows)),
            )
        _JIT_SENTINEL_SIZES[cache] = size
    return sizes


def _merkle_shard_kernel(millis, counter, node, valid, owner_ix):
    """Per-(owner, minute) XOR deltas and the batch digest over full-width
    columns: kernel H over the valid rows (k1 packed on the device), then
    `owner_minute_segments` (kernel X). → (owner_sorted, minute_sorted,
    seg_end, seg_xor, valid_sorted, digest)."""
    hashes, digest = masked_key_hashes(pack_ts_keys(millis, counter), node, valid)
    return (*owner_minute_segments(owner_ix, millis, hashes, valid), digest)


def _compact_segments_tail(owner_ix, k1, node, valid, cap):
    """The compaction tail both compact kernels share: hash (kernel H,
    masked, with the digest) → per-(owner, minute) segments with
    `tile_local=False` (the cap is budgeted against DISTINCT keys; tile
    partials would multiply the segment count) → a stable sort that moves
    the segment ends to the front → (packed owner<<32|minute keys[cap],
    xors[cap], seg_count, digest). seg_count > cap signals overflow: the
    caller reruns the full-width kernel."""
    hashes, digest = masked_key_hashes(k1, node, valid)
    millis, _ = unpack_ts_keys(k1)
    segments = owner_minute_segments(owner_ix, millis, hashes, valid, tile_local=False)
    return (*compact_segments(*segments, cap), digest)


def compact_segments(owner_s, minute_s, seg_end, seg_xor, valid_s, cap):
    """The compact-delta encode (the `delta_encode` stage): pack
    owner<<32|minute, move the segment ends to the front with a stable
    sort, keep `cap` of them. → (packed keys[cap], xors[cap], seg_count)."""
    is_seg = seg_end & valid_s
    packed = (owner_s.to(torch.int64) << 32) | (minute_s.to(torch.int64) & 0xFFFFFFFF)
    _, order = torch.sort((~is_seg).to(torch.uint8), stable=True)
    order = order[:cap]
    seg_count = is_seg.sum(dtype=torch.int32).reshape(1)
    return packed[order], seg_xor[order], seg_count


def _merkle_shard_kernel_compact(k1, node, owner_ix, cap):
    """20 bytes a row up: packed HLC key, node, and int32 owner with -1
    marking padding."""
    return _compact_segments_tail(owner_ix, k1, node, owner_ix >= 0, cap)


# Owner field bits of the delta-compact upload's owner|counter column.
# Owner 0xFFFF is the padding sentinel, so up to 65534 distinct owners a
# dispatch ride the 16-byte path; larger batches, millis spans of 2^32 ms
# or more, and pre-1970 rows keep the 20-byte kernel.
_DELTA_OWNER_BITS = 16
_DELTA_PAD_OWNER = (1 << _DELTA_OWNER_BITS) - 1


def _merkle_shard_kernel_compact_delta(dmillis, ownctr, node, base, cap):
    """16 bytes a row up: u32 millis delta against `base` (the batch's
    least millis), u32 owner<<16|counter (owner 0xFFFF = padding), both
    as int32 bit patterns, and the node. Millis rebuild exactly on the
    device (host routing keeps every delta under 2^32); outputs equal
    `_merkle_shard_kernel_compact`'s."""
    oc = ownctr.to(torch.int64) & 0xFFFFFFFF
    owner16 = oc >> _DELTA_OWNER_BITS
    valid = owner16 != _DELTA_PAD_OWNER
    owner_ix = torch.where(valid, owner16, torch.full_like(owner16, -1))
    millis = base + (dmillis.to(torch.int64) & 0xFFFFFFFF)
    k1 = pack_ts_keys(millis, oc & 0xFFFF)
    return _compact_segments_tail(owner_ix, k1, node, valid, cap)


def owner_minute_deltas(
    owner_rows: Dict[str, Sequence[str]], device=None, mesh=None, ctx=None
) -> Tuple[Dict[str, Dict[str, int]], int]:
    """Device pass: {owner: [timestamp strings]} → per-owner {minute-key:
    xor delta} plus the batch digest.

    The device hash renders the node hex lower case; the reference hashes
    the parsed node verbatim, so owners whose rows carry non-canonical hex
    case take the host fold (one vectorized parse gives the per-row case
    flags); the other owners stay on the card."""
    with span("kernel:merkle", "owner_minute_deltas", owners=len(owner_rows),
              n=sum(len(v) for v in owner_rows.values())):
        return _owner_minute_deltas_timed(owner_rows, device, mesh, ctx)


def _owner_minute_deltas_timed(owner_rows, device, mesh, ctx):
    owners = list(owner_rows)
    flat = [ts for o in owners for ts in owner_rows[o]]
    all_m, all_c, all_n, case_ok = parse_timestamp_strings(flat, with_case=True)
    owner_index: Dict[str, np.ndarray] = {}
    pos = 0
    for o in owners:
        k = len(owner_rows[o])
        owner_index[o] = np.arange(pos, pos + k)
        pos += k
    return deltas_from_columns(owner_index, all_m, all_c, all_n, case_ok, flat, device=device,
                               mesh=mesh, ctx=ctx)


def deltas_from_columns(
    owner_index: Dict[str, np.ndarray],
    all_m: np.ndarray,
    all_c: np.ndarray,
    all_n: np.ndarray,
    case_ok: np.ndarray,
    ts_strings: Sequence[str],
    device=None,
    mesh=None,
    ctx=None,
) -> Tuple[Dict[str, Dict[str, int]], int]:
    """Device Merkle pass over parsed columns: `owner_index` maps owner →
    row indices to hash. Owners touching any non-canonical row take the
    host fold (`ts_strings` gives it the raw strings); the rest ride one
    sharded dispatch."""
    return deltas_finish(
        deltas_dispatch(owner_index, all_m, all_c, all_n, case_ok, ts_strings, device=device,
                        mesh=mesh, ctx=ctx)
    )


def deltas_dispatch(
    owner_index: Dict[str, np.ndarray],
    all_m: np.ndarray,
    all_c: np.ndarray,
    all_n: np.ndarray,
    case_ok: np.ndarray,
    ts_strings: Sequence[str],
    device=None,
    mesh=None,
    ctx=None,
):
    """First half of `deltas_from_columns`: host folds, host packing, the
    upload and each shard's kernel launches (asynchronous on a card).
    Returns an opaque state for `deltas_finish`.

    The pass runs over `mesh` (default: `ctx`'s mesh, else one shard on
    `device`). An owner bigger than an even shard's share (ceil(rows / n))
    splits row-wise into (owner, j) units: hashing needs no cell locality,
    and the decoders XOR-merge repeated (owner, minute) keys. Units go to
    shards by `ctx.assign_stable` (the mesh engine's stable placement,
    which records each shard's rows and the `digest` and
    `owner_delta_partials` reduces), else by LPT. Each shard compacts its
    segments to its own cap, bucket_size(max(shard_size // 8, 64))."""
    if mesh is None:
        mesh = ctx.mesh if ctx is not None else single_mesh(resolve_device(device))
    require_single_process("engine.deltas_from_columns", mesh)
    owners = list(owner_index)
    deltas: Dict[str, Dict[str, int]] = {o: {} for o in owners}
    digest = 0
    host_owners = [o for o, ix in owner_index.items() if len(ix) and not case_ok[ix].all()]
    _count("host_owners", len(host_owners))
    for o in host_owners:
        deltas[o], d = minute_deltas_host(ts_strings[i] for i in owner_index[o])
        digest ^= d

    quarantined = set(host_owners)
    good = [o for o in owners if o not in quarantined and len(owner_index[o])]
    if not good:
        return (deltas, digest, good, None, None)

    owner_ix = {o: i for i, o in enumerate(good)}
    n_good_rows = sum(len(owner_index[o]) for o in good)
    target = max(1, -(-n_good_rows // mesh.size))  # ceil
    units: Dict[Tuple[str, int], np.ndarray] = {}
    for o in good:
        ix = owner_index[o]
        if len(ix) <= target:
            units[(o, 0)] = ix
        else:
            for j, start in enumerate(range(0, len(ix), target)):
                units[(o, j)] = ix[start : start + target]
    unit_sizes = {u: len(ix) for u, ix in units.items()}
    if ctx is not None:
        shards = ctx.assign_stable(unit_sizes)
    else:
        shards = assign_owners_to_shards(unit_sizes, mesh.size)
    loads = [sum(unit_sizes[u] for u in s) for s in shards]
    shard_size = bucket_size(max(max(loads, default=0), 1))
    total = mesh.size * shard_size
    if ctx is not None:
        ctx.record_occupancy(loads, shard_size)
        ctx.record_xdev_reduce("digest")
        homes: Dict[str, set] = {}
        for si, s in enumerate(shards):
            for o, _j in s:
                homes.setdefault(o, set()).add(si)
        for o, sis in homes.items():
            if len(sis) > 1:
                ctx.record_xdev_reduce("owner_delta_partials")

    k1 = np.zeros(total, np.uint64)
    node = np.zeros(total, np.uint64)
    oix = np.full(total, -1, np.int32)
    for si, shard in enumerate(shards):
        pos = si * shard_size
        for u in shard:
            ix = units[u]
            sl = slice(pos, pos + len(ix))
            # A pre-1970 millis wraps to u64 here and unpacks as ~2^48 -
            # |millis|, on every route, as in the JAX engine.
            k1[sl] = (all_m[ix].astype(np.uint64) << np.uint64(16)) | all_c[ix].astype(np.uint64)
            node[sl] = all_n[ix]
            oix[sl] = owner_ix[u[0]]
            pos = sl.stop

    cap = bucket_size(max(shard_size // 8, 64))
    real = oix >= 0
    millis = (k1 >> np.uint64(16)).astype(np.int64)
    real_millis = millis[real]
    base = int(real_millis.min())
    millis_span = int(real_millis.max()) - base
    # Delta-compact admission: a span under 2^32 ms, owner indexes under
    # the 16-bit padding sentinel, and no wrapped pre-1970 millis (they
    # land near 2^48).
    use_delta = (
        millis_span < (1 << 32)
        and base + millis_span < (1 << 47)
        and len(good) < _DELTA_PAD_OWNER
    )
    if use_delta:
        _count("delta")
        metrics.inc("evolu_engine_compact_upload_bytes_total", 16 * total, variant="delta")
        _note_bucket("delta", shard_size, cap, mesh.size)
        dmillis = np.where(real, millis - base, 0).astype(np.uint32)
        ownctr = np.where(
            real,
            (oix.astype(np.uint32) << np.uint32(_DELTA_OWNER_BITS))
            | (k1 & np.uint64(0xFFFF)).astype(np.uint32),
            np.uint32(_DELTA_PAD_OWNER << _DELTA_OWNER_BITS),
        )
        cols = {"dmillis": dmillis.view(np.int32), "ownctr": ownctr.view(np.int32), "node": node}
        kernel, args = _merkle_shard_kernel_compact_delta, (base, cap)
    else:
        _count("full")
        metrics.inc("evolu_engine_compact_upload_bytes_total", 20 * total, variant="full")
        _note_bucket("full", shard_size, cap, mesh.size)
        cols = {"k1": k1, "node": node, "owner_ix": oix}
        kernel, args = _merkle_shard_kernel_compact, (cap,)
    outs = _launch_shards(mesh, cols, lambda t: kernel(*t.values(), *args))
    return (deltas, digest, good, outs, (k1, node, oix, mesh, cap))


def _launch_shards(mesh, cols, run):
    """`run(columns on a shard's device)` on each of this process's shards'
    slice of the flat `cols` (`dispatch_columns_sharded`). → per-shard
    output tuples, None for other processes' shards."""
    return dispatch_columns_sharded(mesh, cols, names=tuple(cols), what="a relay batch",
                                    run=lambda part, dev: run(columns_to_device(part, dev)))


def _decode_compact(packed, xors, count, by_ix=None) -> Dict[int, Dict[str, int]]:
    """The compact outputs' first `count` entries → {owner_ix:
    {base3-minute-key: signed-int32 delta}}, one key render a minute,
    XOR-merged into `by_ix` (one shard's partials onto the others')."""
    if by_ix is None:
        by_ix = {}
    key_cache: Dict[int, str] = {}
    for p, x in zip(packed[:count].tolist(), xors[:count].tolist()):
        o_ix = p >> 32
        minute = p & 0xFFFFFFFF
        if minute >= 1 << 31:  # undo the uint32 carriage of the JS |0-wrapped
            minute -= 1 << 32  # int32 minute
        key = key_cache.get(minute)
        if key is None:
            key = key_cache[minute] = minutes_base3(minute * 60000)
        d = by_ix.setdefault(o_ix, {})
        d[key] = to_int32(d.get(key, 0) ^ x)
    return by_ix


def _start_pull(outs):
    """Queue the copy of every shard's compact outputs to the host behind
    its dispatch, on the stream that launched it, and record an event on
    each device's stream after its copies. → (events, per-shard host
    tensors). Waiting on the events waits for exactly this batch's device
    work, never for what other threads launched since."""
    with device_work("a relay batch"):
        host = [[x.to("cpu", non_blocking=True) for x in o] for o in outs]
        events = []
        for dev in dict.fromkeys(o[0].device for o in outs if o[0].is_cuda):
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
            events.append(event)
        return events, host


def _pull_outputs(events, host):
    """The pull thread's half of `_start_pull`: wait for the events, then
    hand each shard's outputs over as numpy arrays. One pull wave, recorded
    as `to_host_many` records its waves."""
    t0 = time.perf_counter()
    with device_work("a relay batch"):
        for event in events:
            event.synchronize()
        out = [tuple(x.numpy() for x in o) for o in host]
    record_pull_wave(time.perf_counter() - t0, [a for o in out for a in o])
    return out


def deltas_finish(state) -> Tuple[Dict[str, Dict[str, int]], int]:
    """Second half: pull every shard's compact outputs in one wave and
    decode the per-(owner, minute) deltas, XOR-merging the shards'
    partials. The pull slot may hold a Future of a pull already started on
    another thread (`start_batch`'s pull thread). If any shard produced
    more segments than the cap, rerun the full-width kernel on every shard
    on the calling thread and decode every row."""
    deltas, digest, good, outs, extra = state
    if outs is None:
        return deltas, digest
    if hasattr(outs, "result"):
        pulled = outs.result()
    else:
        with device_work("a relay batch"):
            flat = to_host_many(*(x for o in outs for x in o))
        pulled = [flat[i : i + 4] for i in range(0, len(flat), 4)]
    k1, node, oix, mesh, cap = extra
    if any(int(seg_count[0]) > cap for _, _, seg_count, _ in pulled):
        _count("overflow")
        _note_bucket("overflow", len(k1) // mesh.size, cap, mesh.size)
        cols = {
            "millis": (k1 >> np.uint64(16)).astype(np.int64),
            "counter": (k1 & np.uint64(0xFFFF)).astype(np.int32),
            "node": node, "valid": oix >= 0,
            "owner_ix": np.maximum(oix, 0).astype(np.int64),
        }
        reruns = _launch_shards(mesh, cols, lambda t: _merkle_shard_kernel(*t.values()))
        with device_work("a relay batch"):
            flat = to_host_many(*(x for o in reruns for x in o))
        *segments, digests = (np.concatenate(flat[k::6]) for k in range(6))
        by_ix = decode_owner_minute_deltas(*segments)
    else:
        by_ix: Dict[int, Dict[str, int]] = {}
        for packed, xors, seg_count, _ in pulled:
            _decode_compact(packed, xors, int(seg_count[0]), by_ix)
        digests = np.concatenate([p[3] for p in pulled])
    for o_ix, d in by_ix.items():
        deltas[good[o_ix]] = d
    return deltas, digest ^ xor_allreduce(digests.view(np.uint32).tolist())


def _pack_rows(ts_list, contents):
    """Pack one shard's rows into flat buffers. Each timestamp's width is
    checked before packing: a total-length check alone would accept
    ["", "<two stamps concatenated>"] and commit rows with shifted
    timestamp/content pairs."""
    n = len(ts_list)
    if (np.fromiter(map(len, ts_list), np.int64, count=n) != 46).any():
        raise ValueError("non-canonical timestamp width in batch")
    ts_packed = "".join(ts_list).encode("ascii")
    lens = np.fromiter(map(len, contents), np.int32, count=n)
    return ts_packed, b"".join(contents), lens


class _PackedRows:
    """Lazy timestamp-string access over per-shard packed 46-byte buffers
    (read only by the host fold of a non-canonical owner)."""

    def __init__(self, buffers: List[bytes], offsets: List[int]):
        self._buffers = buffers
        self._offsets = offsets

    def __getitem__(self, i: int) -> str:
        import bisect

        j = bisect.bisect_right(self._offsets, i) - 1
        local = i - self._offsets[j]
        return self._buffers[j][local * 46 : (local + 1) * 46].decode("ascii")


class BatchReconciler:
    """Reconcile a batch of SyncRequests against one RelayStore or a
    ShardedRelayStore, the Merkle leg on `device` (None = the card; raises
    without one). `write_behind`, a `storage.write_behind.WriteBehindQueue`
    over the same store, turns on the deferred serve of `run_batch_wire`.

    `mesh_ctx` (a `parallel.mesh.MeshContext`) is the mesh-sharded engine:
    every pass (one-shot, streaming, write-behind) lays its rows out over
    the context's shards by stable placement, and `device` defaults to the
    mesh's first shard (where scoped folds run). Without one the pass has
    one shard on `device`."""

    def __init__(self, store, device=None, write_behind=None, mesh_ctx=None):
        self.store = store
        self.write_behind = write_behind
        self.mesh_ctx = mesh_ctx
        if device is None and mesh_ctx is not None:
            device = mesh_ctx.mesh.devices[0]
        self.device = resolve_device(device)
        self.mesh = mesh_ctx.mesh if mesh_ctx is not None else single_mesh(self.device)
        self._executor = None
        self._pull_pool = None

    def _new_messages(
        self, requests: Sequence[protocol.SyncRequest]
    ) -> Dict[str, List[protocol.EncryptedCrdtMessage]]:
        """Bulk dedup: which (timestamp, userId) pairs are not yet stored.
        Batch equivalent of per-row INSERT OR IGNORE changes==1
        (index.ts:153-158). Duplicates inside the batch dedup here too."""
        db = self.store.db
        seen: set = set()
        incoming: List[Tuple[str, str, protocol.EncryptedCrdtMessage]] = []
        for r in requests:
            for m in r.messages:
                k = (m.timestamp, r.user_id)
                if k not in seen:
                    seen.add(k)
                    incoming.append((m.timestamp, r.user_id, m))
        if not incoming:
            return {}
        with db.transaction():
            db.exec('CREATE TEMP TABLE IF NOT EXISTS "__incoming" ("t" TEXT, "u" TEXT)')
            db.run('DELETE FROM "__incoming"')
            db.run_many('INSERT INTO "__incoming" VALUES (?, ?)', [(t, u) for t, u, _ in incoming])
            rows = db.exec_sql_query(
                'SELECT i."t" AS t, i."u" AS u FROM "__incoming" i '
                'JOIN "message" m ON m."timestamp" = i."t" AND m."userId" = i."u"'
            )
            db.run('DELETE FROM "__incoming"')
        existing = {(r["t"], r["u"]) for r in rows}
        out: Dict[str, List[protocol.EncryptedCrdtMessage]] = {}
        for t, u, m in incoming:
            if (t, u) not in existing:
                out.setdefault(u, []).append(m)
        return out

    def reconcile(
        self, requests: Sequence[protocol.SyncRequest]
    ) -> List[protocol.SyncResponse]:
        """One batched pass; responses align with `requests` order. End
        state is identical to running `store.sync` per request."""
        trees, strings = self._ingest(requests)
        return self._respond(requests, trees, strings)

    def _ingest(self, requests):
        """The batched ingest, routed by store shape → (trees, strings)."""
        metrics.inc("evolu_engine_store_passes_total", path="oneshot")
        strings: Dict[str, str] = {}
        if self._packed_store():
            trees = self._ingest_packed(requests, strings)
        elif isinstance(self.store, ShardedRelayStore) or getattr(self.store, "db", None) is None:
            # Sharded Python-backend shards, or a generic store with no
            # `.db` SQL handle: per-request ingest; the respond side
            # degrades likewise (`_respond_wire`'s object fallback).
            trees = {
                r.user_id: self.store.add_messages(r.user_id, r.messages)
                for r in requests
            }
        else:
            trees = self._ingest_generic(requests, strings)
        return trees, strings

    def _shards(self):
        if isinstance(self.store, ShardedRelayStore):
            return self.store.shards, self.store.shard_index
        return [self.store], (lambda _u: 0)

    def _packed_store(self) -> bool:
        """A native store, or a sharded store of native shards: every shard
        has the packed insert, so the packed and streaming ingests apply."""
        stores, _ = self._shards()
        return all(hasattr(getattr(s, "db", None), "relay_insert_packed") for s in stores)

    def _pool(self, n: int):
        """One worker per storage shard (sized to the store, not to the
        batch, so a small first batch cannot cap later ones)."""
        if self._executor is None and n > 1:
            from concurrent.futures import ThreadPoolExecutor

            self._executor = ThreadPoolExecutor(max_workers=n, thread_name_prefix="evolu-ingest")
        return self._executor

    def _pull_executor(self):
        """The one thread that waits for each streamed batch's device
        outputs while the dispatcher lands the batch before it."""
        if self._pull_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._pull_pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="evolu-pull")
        return self._pull_pool

    def _map_shards(self, fn, live, n_stores):
        """fn(si) for each live shard, in parallel when a pool exists. Waits
        for every worker before raising: a rollback while a worker still
        runs would let its insert land in autocommit mode, rows outside
        any tree."""
        pool = self._pool(n_stores)
        if pool is not None and len(live) > 1:
            futures = [pool.submit(fn, si) for si in live]
            results, first_err = [], None
            for f in futures:
                try:
                    results.append(f.result())
                except BaseException as e:  # noqa: BLE001 - re-raised below
                    first_err = first_err or e
            if first_err is not None:
                raise first_err
            return results
        return [fn(si) for si in live]

    @contextmanager
    def _shard_transactions(self, stores, live):
        """One open transaction per live shard, rolled back together on
        error, committed together on exit (the first commit error wins).
        Short-lock begin/commit, so worker threads can execute inside
        them; each shard has exactly one writer (its worker)."""
        begun: List[int] = []
        try:
            for si in live:
                stores[si].db.begin()
                begun.append(si)
            yield
        except BaseException:
            for si in begun:
                stores[si].db.rollback()
            raise
        commit_err: Optional[Exception] = None
        for si in begun:
            try:
                stores[si].db.commit()
            except Exception as e:  # noqa: BLE001 - re-raised below
                commit_err = commit_err or e
        if commit_err is not None:
            raise commit_err

    def close(self) -> None:
        """Stop the shard ingest's and the pull's thread pools."""
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None
        if self._pull_pool is not None:
            self._pull_pool.shutdown(wait=True)
            self._pull_pool = None

    def _ingest_packed(self, requests, tree_strings=None) -> Dict[str, dict]:
        """The packed columnar ingest. Per storage shard: pack the shard's
        timestamps and ciphertexts into flat buffers and INSERT OR IGNORE
        them in ONE native call (the primary key dedups, in-batch
        duplicates included, with per-row was-new flags: index.ts:153-158
        semantics), then parse the packed buffer natively. Shards ingest
        in parallel threads (the C calls drop the GIL). The new rows of
        every shard ride ONE device dispatch for the per-(owner, minute)
        hashes, and each shard's inserts and tree updates commit in one
        transaction, so rows never outrun their tree; a failure anywhere
        rolls every uncommitted shard back."""
        stores, shard_index = self._shards()
        per_shard: List[List[protocol.SyncRequest]] = [[] for _ in stores]
        for r in requests:
            per_shard[shard_index(r.user_id)].append(r)
        live = [si for si, reqs in enumerate(per_shard) if any(len(r.messages) for r in reqs)]
        trees: Dict[str, dict] = {}
        if not live:
            return trees

        def ingest_shard(si: int):
            db = stores[si].db
            reqs = per_shard[si]
            gu = [r.user_id for r in reqs]
            gc = [len(r.messages) for r in reqs]
            ts_list = [m.timestamp for r in reqs for m in r.messages]
            contents = [m.content for r in reqs for m in r.messages]
            ts_packed, content_packed, lens = _pack_rows(ts_list, contents)
            was_new = db.relay_insert_packed(gu, gc, ts_packed, content_packed, lens)
            cols = parse_packed_timestamps(ts_packed, len(ts_list), with_case=True)
            return gu, gc, ts_packed, was_new, cols

        with span("kernel:merkle", "reconcile_ingest", owners=len({r.user_id for r in requests}),
                  n=sum(len(r.messages) for r in requests), shards=len(live)), \
                self._shard_transactions(stores, live):
            # The transactions stay open across the device dispatch, so
            # the inserts and the trees commit together.
            results = self._map_shards(ingest_shard, live, len(stores))
            owner_index: Dict[str, List[np.ndarray]] = {}
            buffers, offsets = [], []
            col_parts = ([], [], [], [])
            off = 0
            for gu, gc, ts_packed, was_new, cols in results:
                pos = 0
                for u, k in zip(gu, gc):
                    ix = np.nonzero(was_new[pos : pos + k])[0] + (pos + off)
                    if len(ix):
                        owner_index.setdefault(u, []).append(ix)
                    pos += k
                buffers.append(ts_packed)
                offsets.append(off)
                for part, c in zip(col_parts, cols):
                    part.append(c)
                off += len(was_new)
            merged = {u: (v[0] if len(v) == 1 else np.concatenate(v)) for u, v in owner_index.items()}
            all_m, all_c, all_n, case_ok = (
                (p[0] if len(p) == 1 else np.concatenate(p)) for p in col_parts
            )
            deltas_by_owner, _digest = deltas_from_columns(
                merged, all_m, all_c, all_n, case_ok, _PackedRows(buffers, offsets),
                mesh=self.mesh, ctx=self.mesh_ctx,
            )
            tree_rows: List[List[Tuple[str, str]]] = [[] for _ in stores]
            for o, deltas in deltas_by_owner.items():
                if not deltas:
                    continue
                si = shard_index(o)
                tree = apply_prefix_xors(stores[si].get_merkle_tree(o), deltas)
                trees[o] = tree
                s = merkle_tree_to_string(tree)
                if tree_strings is not None:
                    tree_strings[o] = s  # the respond reuses the upsert's dump
                tree_rows[si].append((o, s))
            for si in live:
                if tree_rows[si]:
                    stores[si].db.run_many(
                        'INSERT OR REPLACE INTO "merkleTree" ("userId", "merkleTree") VALUES (?, ?)',
                        tree_rows[si],
                    )
        return trees

    # -- the pipelined streaming reconcile --
    #
    # `_ingest_packed` holds each shard transaction open across the device
    # dispatch, so host and device take turns. The streaming path hashes
    # the WHOLE batch on the device before the insert knows which rows are
    # new, and recomputes on the host the deltas of the owners that turn
    # out to hold rows already stored, from their new rows only: the same
    # fold the one-shot path runs. The device leg then needs nothing from
    # the database, so batch k+1's upload, kernels and pull run while batch
    # k's inserts, trees and commit run on the host (the C calls drop the
    # GIL).

    def start_batch(self, requests: Sequence[protocol.SyncRequest]):
        """Stage a batch: dedup it in request order, pack per shard, parse
        natively, dispatch the device hash of ALL kept rows, and hand the
        pull of the compact outputs to the pull thread. No database access
        happens here. → the state `finish_batch` lands."""
        t0_dispatch = time.perf_counter()
        stores, shard_index = self._shards()
        per_shard: List[List[protocol.SyncRequest]] = [[] for _ in stores]
        for r in requests:
            per_shard[shard_index(r.user_id)].append(r)

        seen: set = set()
        shard_data: Dict[int, tuple] = {}
        buffers: List[bytes] = []
        offsets: List[int] = []
        col_parts = ([], [], [], [])
        owner_rows: Dict[str, List[np.ndarray]] = {}
        live: List[int] = []
        off = 0
        for si, reqs in enumerate(per_shard):
            gu: List[str] = []
            gc: List[int] = []
            ts_list: List[str] = []
            contents: List[bytes] = []
            for r in reqs:
                # In-batch dedup up front (the one-shot path leaves it to the
                # primary key), so that was_new False means exactly "already
                # stored". One owner's rows stay in request order, so the
                # kept occurrence is the row the primary key would keep.
                kept = [
                    m for m in r.messages
                    if (m.timestamp, r.user_id) not in seen
                    and not seen.add((m.timestamp, r.user_id))
                ]
                if kept:
                    gu.append(r.user_id)
                    gc.append(len(kept))
                    ts_list.extend(m.timestamp for m in kept)
                    contents.extend(m.content for m in kept)
            n = len(ts_list)
            if n == 0:
                continue
            live.append(si)
            ts_packed, content_packed, lens = _pack_rows(ts_list, contents)
            cols = parse_packed_timestamps(ts_packed, n, with_case=True)
            pos = 0
            for u, k in zip(gu, gc):
                owner_rows.setdefault(u, []).append(np.arange(pos, pos + k) + off)
                pos += k
            buffers.append(ts_packed)
            offsets.append(off)
            for part, c in zip(col_parts, cols):
                part.append(c)
            shard_data[si] = (gu, gc, ts_packed, content_packed, lens)
            off += n

        packed = _PackedRows(buffers, offsets)
        dev_state = None
        if owner_rows:
            merged = {u: (v[0] if len(v) == 1 else np.concatenate(v)) for u, v in owner_rows.items()}
            all_m, all_c, all_n, case_ok = (
                (p[0] if len(p) == 1 else np.concatenate(p)) for p in col_parts
            )
            dev_state = deltas_dispatch(
                merged, all_m, all_c, all_n, case_ok, packed, mesh=self.mesh, ctx=self.mesh_ctx)
            if dev_state[3] is not None:
                pull = self._pull_executor().submit(_pull_outputs, *_start_pull(dev_state[3]))
                dev_state = (*dev_state[:3], pull, dev_state[4])
        anatomy.record_stage("device_dispatch", time.perf_counter() - t0_dispatch, rows=off)
        return {
            "requests": requests, "live": live, "shard_data": shard_data,
            "dev": dev_state, "packed": packed, "n_total": off,
            "shard_offsets": dict(zip(live, offsets)),
        }

    def finish_batch(self, st, wire: bool = False) -> List:
        """Land a staged batch: per-shard native inserts (in parallel), the
        pulled deltas with the duplicate owners' recomputed, the tree
        upserts, and one commit per shard, all rolled back together on a
        failure. `wire=True` answers in bytes (`_respond_wire`), else with
        SyncResponse objects (`_respond`)."""
        stores, shard_index = self._shards()
        metrics.inc("evolu_engine_store_passes_total", path="stream")
        respond = self._respond_wire if wire else self._respond
        live, shard_data = st["live"], st["shard_data"]
        trees: Dict[str, dict] = {}
        strings: Dict[str, str] = {}
        if not live:
            return respond(st["requests"], trees, strings)

        def ingest_shard(si: int):
            gu, gc, ts_packed, content_packed, lens = shard_data[si]
            return si, stores[si].db.relay_insert_packed(gu, gc, ts_packed, content_packed, lens)

        # host_apply: the native inserts, the delta decode, the tree folds
        # and the commits. The pull records itself as pull_wave on the
        # pull thread; the two legs can overlap.
        t0_apply = time.perf_counter()
        with span("kernel:merkle", "reconcile_stream_finish",
                  owners=len({r.user_id for r in st["requests"]}), n=st["n_total"],
                  shards=len(live)), \
                self._shard_transactions(stores, live):
            was_new_by_shard = dict(self._map_shards(ingest_shard, live, len(stores)))
            deltas_by_owner, st["digest"] = deltas_finish(st["dev"])
            self._recompute_duplicate_owners(st, was_new_by_shard, deltas_by_owner)
            tree_rows: List[List[Tuple[str, str]]] = [[] for _ in stores]
            for o, deltas in deltas_by_owner.items():
                if not deltas:
                    continue
                si = shard_index(o)
                tree = apply_prefix_xors(stores[si].get_merkle_tree(o), deltas)
                trees[o] = tree
                strings[o] = merkle_tree_to_string(tree)
                tree_rows[si].append((o, strings[o]))
            for si in live:
                if tree_rows[si]:
                    stores[si].db.run_many(
                        'INSERT OR REPLACE INTO "merkleTree" ("userId", "merkleTree") VALUES (?, ?)',
                        tree_rows[si],
                    )
        anatomy.record_stage("host_apply", time.perf_counter() - t0_apply, rows=st["n_total"])
        return respond(st["requests"], trees, strings)

    def _recompute_duplicate_owners(self, st, was_new_by_shard, deltas_by_owner) -> None:
        """The device hashed every kept row; an owner some of whose rows were
        already stored gets its deltas recomputed from its NEW rows only,
        by the host fold the one-shot path's host owners take, so which
        minute keys are present comes out the same: a minute whose new
        hashes XOR to 0 stays (its tree path is made), a minute with only
        stored rows goes. A steady batch has no such owner and returns
        after one pass over the flags."""
        affected: set = set()
        for si in st["live"]:
            gu, gc = st["shard_data"][si][:2]
            was_new = was_new_by_shard[si]
            pos = 0
            for u, k in zip(gu, gc):
                if not was_new[pos : pos + k].all():
                    affected.add(u)
                pos += k
        if not affected:
            return
        # An affected owner may span several requests: gather all its new
        # rows, then fold once.
        new_rows: Dict[str, List[np.ndarray]] = {}
        for si in st["live"]:
            gu, gc = st["shard_data"][si][:2]
            was_new = was_new_by_shard[si]
            base = st["shard_offsets"][si]
            pos = 0
            for u, k in zip(gu, gc):
                if u in affected:
                    new_rows.setdefault(u, []).append(np.nonzero(was_new[pos : pos + k])[0] + (pos + base))
                pos += k
        packed = st["packed"]
        for u in affected:
            ix = np.concatenate(new_rows[u])
            deltas_by_owner[u], _d = minute_deltas_host(packed[i] for i in ix)

    def reconcile_stream(
        self, batches: Sequence[Sequence[protocol.SyncRequest]]
    ) -> List[List[protocol.SyncResponse]]:
        """Software-pipelined reconcile over a stream of batches: batch
        k+1's device leg (upload, kernels, pull) overlaps batch k's host
        leg (inserts, trees, commit). The end state equals sequential
        `reconcile` calls. A store without the packed insert takes those
        sequential calls."""
        if not self._packed_store():
            return [self.reconcile(b) for b in batches]
        out: List[List[protocol.SyncResponse]] = []
        prev = None
        for reqs in batches:
            try:
                st = self.start_batch(reqs)
            except BaseException:
                # A bad batch k+1 must not drop batch k, already dispatched:
                # sequential reconcile calls would have committed it before
                # raising.
                if prev is not None:
                    out.append(self.finish_batch(prev))
                raise
            if prev is not None:
                out.append(self.finish_batch(prev))
            prev = st
        if prev is not None:
            out.append(self.finish_batch(prev))
        return out

    def _ingest_generic(self, requests, tree_strings=None) -> Dict[str, dict]:
        """Temp-table set-diff, the device Merkle pass over the new rows,
        then the bulk insert and the tree updates in one transaction."""
        new_by_owner = self._new_messages(requests)
        deltas_by_owner, _digest = (
            owner_minute_deltas(
                {o: [m.timestamp for m in ms] for o, ms in new_by_owner.items()},
                mesh=self.mesh, ctx=self.mesh_ctx,
            )
            if new_by_owner
            else ({}, 0)
        )
        db = self.store.db
        with db.transaction():
            self._insert_new(new_by_owner)
            return self._store_trees(deltas_by_owner, tree_strings)

    def _insert_new(self, new_by_owner) -> None:
        rows = [(m.timestamp, o, m.content) for o, ms in new_by_owner.items() for m in ms]
        if rows:
            self.store.db.run_many(
                'INSERT OR IGNORE INTO "message" ("timestamp", "userId", "content") '
                "VALUES (?, ?, ?)",
                rows,
            )

    def _store_trees(self, deltas_by_owner, tree_strings) -> Dict[str, dict]:
        trees: Dict[str, dict] = {}
        for o, deltas in deltas_by_owner.items():
            tree = apply_prefix_xors(self.store.get_merkle_tree(o), deltas)
            trees[o] = tree
            s = merkle_tree_to_string(tree)
            if tree_strings is not None:
                tree_strings[o] = s
            self.store.db.run(
                'INSERT OR REPLACE INTO "merkleTree" ("userId", "merkleTree") VALUES (?, ?)',
                (o, s),
            )
        return trees

    def _resolve_tree(self, user_id: str, trees, tree_strings):
        """Tree + serialized string for one owner, reusing the ingest's
        caches; owners not in `trees` (no new rows this batch: the
        cold-sync shape) read the STORED string verbatim and parse it
        once for the diff. Mutates both caches."""
        tree = trees.get(user_id)
        if tree is None:
            if hasattr(self.store, "get_merkle_tree_string"):
                raw = self.store.get_merkle_tree_string(user_id)
                tree = merkle_tree_from_string(raw)
            else:
                tree = self.store.get_merkle_tree(user_id)
                raw = merkle_tree_to_string(tree)
            trees[user_id] = tree
            tree_strings.setdefault(user_id, raw)
        raw = tree_strings.get(user_id)
        if raw is None:
            raw = tree_strings[user_id] = merkle_tree_to_string(tree)
        return tree, raw

    def _respond(
        self, requests, trees: Dict[str, dict],
        tree_strings: Optional[Dict[str, str]] = None,
    ) -> List[protocol.SyncResponse]:
        """Standard diff per request against the updated trees."""
        responses = []
        tree_strings = dict(tree_strings or {})
        for r in requests:
            if r.scope is not None:
                # The batch's ingest landed its rows in the full tree; only
                # the answer comes from the scoped subtree.
                responses.append(scope.scoped_response(self.store, r, device=self.device))
                continue
            tree, ts = self._resolve_tree(r.user_id, trees, tree_strings)
            client_tree = merkle_tree_from_string(r.merkle_tree)
            messages = self.store.get_messages(r.user_id, r.node_id, tree, client_tree)
            responses.append(protocol.SyncResponse(messages, ts))
        return responses

    def reconcile_wire(self, requests: Sequence[protocol.SyncRequest]) -> List[bytes]:
        """`reconcile` with each response encoded; byte-identical to
        `encode_sync_response(reconcile(...)[i])`."""
        trees, strings = self._ingest(requests)
        return self._respond_wire(requests, trees, strings)

    def run_batch_wire(self, requests: Sequence[protocol.SyncRequest]) -> List[bytes]:
        """ONE engine/store pass for a live micro-batch → wire bytes per
        request (the scheduler's entry point). With a write-behind queue
        attached the pass defers SQLite (`_finish_batch_deferred`): serve
        from in-memory trees, ACK into the durable log, answer; a
        `WriteBehindFull` raised before the ACK leaves no state anywhere
        (the scheduler answers 503 + Retry-After). Otherwise stores with
        the packed insert take `start_batch`/`finish_batch` (in-batch dedup
        in request order, the optimistic device hash, one insert and tree
        commit a shard); anything else takes `reconcile_wire`. Either way
        a failure rolls every shard transaction back before raising: the
        scheduler's singleton retry depends on that."""
        if self.write_behind is not None and hasattr(self.store, "get_merkle_tree_string"):
            return self._finish_batch_deferred(self.start_batch(requests))
        if self._packed_store():
            return self.finish_batch(self.start_batch(requests), wire=True)
        return self.reconcile_wire(requests)

    # -- the write-behind serve: the in-memory trees are the truth --

    def _finish_batch_deferred(self, st) -> List[bytes]:
        """Land a staged batch WITHOUT touching the btree: fold the device
        deltas onto the queue's per-owner trees (optimistically: every
        in-batch-deduped row XORs, and rows already stored are corrected
        exactly at drain time), append the packed row buffers and the tree
        strings to the durable log (the ACK point), and answer from the
        in-memory trees. Nothing is installed if the append raises."""
        from evolu_tpu_torch.storage.write_behind import IngestRecord

        wb = self.write_behind
        requests = st["requests"]
        live, shard_data = st["live"], st["shard_data"]
        trees: Dict[str, dict] = {}
        strings: Dict[str, str] = {}
        _count("deferred_passes")
        metrics.inc("evolu_engine_store_passes_total", path="write_behind")
        if not live:
            return self._respond_deferred(requests, trees, strings)
        with span("kernel:merkle", "reconcile_deferred", owners=len({r.user_id for r in requests}),
                  n=st["n_total"], shards=len(live)):
            deltas_by_owner, _digest = deltas_finish(st["dev"])
        for o, deltas in deltas_by_owner.items():
            if not deltas:
                continue
            cached = wb.serving_tree(o)
            if cached is not None:
                base_tree = cached[0]
            else:
                # Only the owner's SHARD lock: the other shards' drains run on.
                with wb.owner_lock(o):
                    raw = self.store.get_merkle_tree_string(o)
                base_tree = merkle_tree_from_string(raw)
            trees[o] = apply_prefix_xors(base_tree, deltas)
            strings[o] = merkle_tree_to_string(trees[o])
        records = []
        for si in live:
            gu, gc, ts_packed, content_packed, lens = shard_data[si]
            seen_o: set = set()
            tree_rows = []
            for o in gu:
                if o in strings and o not in seen_o:
                    seen_o.add(o)
                    tree_rows.append((o, strings[o]))
            records.append(IngestRecord(gu, gc, ts_packed, content_packed, lens, tree_rows))
        wb.append_batch(records, {o: (trees[o], strings[o]) for o in strings})
        # The queue counted its rows; the rows the in-batch dedup dropped
        # never reach it and end here, as duplicates. Nothing is counted if
        # the append raised.
        kept = sum(sum(shard_data[si][1]) for si in live)
        _count("store_duplicate", sum(len(r.messages) for r in requests) - kept)
        return self._respond_deferred(requests, trees, strings)

    def _resolve_tree_deferred(self, user_id: str, trees, tree_strings):
        """`_resolve_tree` against the write-behind truth: this batch's
        freshly folded tree, else the queue's serving tree (the owner has
        undrained history), else the stored string (SQLite is current)."""
        tree = trees.get(user_id)
        if tree is not None:
            return tree, tree_strings[user_id]
        cached = self.write_behind.serving_tree(user_id)
        if cached is not None:
            tree, raw = cached
        else:
            with self.write_behind.owner_lock(user_id):
                raw = self.store.get_merkle_tree_string(user_id)
            tree = merkle_tree_from_string(raw)
        trees[user_id] = tree
        tree_strings[user_id] = raw
        return tree, raw

    def _respond_deferred(self, requests, trees, strings) -> List[bytes]:
        """Bytes-mode respond of the deferred path. Trees that agree after
        the push answer tree-only from memory, with no SQLite. A non-empty
        diff needs stored messages: wait on the owner's drain watermark,
        re-read the owner's EXACT committed tree, and serve the stream under
        the owner's shard lock.

        The exact re-read matters beyond precision: a duplicate-carrying
        push folds an already-stored row's hash onto a base that holds it
        (XOR-cancel), so the optimistic tree claims the row is missing.
        Serving it would make the client re-send the row every round, each
        redelivery cancelling it again: a retry livelock. After the flush
        SQLite holds the drain-corrected tree, so the served tree converges.
        Shards that cannot serve the stream degrade to the batched object
        respond, also after the flush."""
        wb = self.write_behind
        shards, shard_ix = self._shards()
        out: List[Optional[bytes]] = []
        fallback: List[Tuple[int, protocol.SyncRequest]] = []
        for i, r in enumerate(requests):
            if r.scope is not None:
                # A scoped answer reads stored rows and lanes: SQLite must
                # be current for this owner first, and the serve runs under
                # the owner's shard lock against committed state.
                wb.flush_owner(r.user_id)
                with wb.owner_lock(r.user_id):
                    out.append(protocol.encode_sync_response(
                        scope.scoped_response(self.store, r, device=self.device)))
                continue
            tree, raw = self._resolve_tree_deferred(r.user_id, trees, strings)
            client_tree = merkle_tree_from_string(r.merkle_tree)
            if diff_merkle_trees(tree, client_tree) is None:
                out.append(protocol._string(2, raw))
                continue
            wb.flush_owner(r.user_id)
            with wb.owner_lock(r.user_id):
                raw = self.store.get_merkle_tree_string(r.user_id)
            tree = merkle_tree_from_string(raw)
            trees[r.user_id] = tree
            strings[r.user_id] = raw
            if diff_merkle_trees(tree, client_tree) is None:
                # The divergence was the duplicate-cancel artifact.
                out.append(protocol._string(2, raw))
                continue
            db = getattr(shards[shard_ix(r.user_id)], "db", None)
            if db is None or not hasattr(db, "fetch_relay_messages_wire"):
                fallback.append((i, r))
                out.append(None)
                continue
            try:
                with wb.owner_lock(r.user_id):
                    stream = fetch_response_stream(db, r.user_id, r.node_id, tree, client_tree)
            except NonCanonicalStoreError:
                fallback.append((i, r))
                out.append(None)
                continue
            out.append(stream + protocol._string(2, raw))
        if fallback:
            # The one deferred-mode site that needs the whole-store lock.
            with wb.db_lock:
                resps = self._respond([r for _i, r in fallback], trees, strings)
            for (i, _r), resp in zip(fallback, resps):
                out[i] = protocol.encode_sync_response(resp)
        return out

    def _respond_wire(
        self, requests, trees: Dict[str, dict],
        tree_strings: Optional[Dict[str, str]] = None,
    ) -> List[bytes]:
        """Bytes-mode twin of `_respond`: the messages stream from a
        database that serves it in one call (`fetch_response_stream`) plus
        the field-2 tree string. Requests a shard cannot serve so (every
        request on `PySqliteDatabase`, or a malformed stored row) degrade
        to ONE batched object-path respond at their original positions."""
        shards, shard_ix = self._shards()
        tree_strings = dict(tree_strings or {})
        out: List[Optional[bytes]] = []
        fallback: List[Tuple[int, protocol.SyncRequest]] = []
        for i, r in enumerate(requests):
            if r.scope is not None:
                # Never the fused stream: its per-row lane filter cannot
                # ride it.
                out.append(protocol.encode_sync_response(
                    scope.scoped_response(self.store, r, device=self.device)))
                continue
            tree, raw = self._resolve_tree(r.user_id, trees, tree_strings)
            db = getattr(shards[shard_ix(r.user_id)], "db", None)
            if db is None or not hasattr(db, "fetch_relay_messages_wire"):
                fallback.append((i, r))
                out.append(None)
                continue
            client_tree = merkle_tree_from_string(r.merkle_tree)
            try:
                stream = fetch_response_stream(db, r.user_id, r.node_id, tree, client_tree)
            except NonCanonicalStoreError:
                fallback.append((i, r))
                out.append(None)
                continue
            out.append(stream + protocol._string(2, raw))
        if fallback:
            resps = self._respond([r for _i, r in fallback], trees, tree_strings)
            for (i, _r), resp in zip(fallback, resps):
                out[i] = protocol.encode_sync_response(resp)
        return out


# -- the pod pass --
#
# `reconcile_pod` runs the whole server across the processes of a
# `torch.distributed` group: storage is partitioned by a stable owner →
# process hash (an owner's history always lives on one process), each
# process runs the streaming engine pass over its own owners on its own
# shards, and the digest is XOR-all-reduced over a gloo group, so every
# process sees the whole batch's digest. No rows and no deltas cross
# processes.


def owner_process(user_id: str, nproc: int) -> int:
    """Stable owner → process assignment (`parallel.mesh.owner_shard`, the
    crc32 of `ShardedRelayStore.shard_index`): storage ownership must
    survive across batches, so it cannot depend on a batch's load."""
    return owner_shard(user_id, nproc)


def reconcile_pod(mesh, store, requests: Sequence[protocol.SyncRequest],
                  wire: bool = False) -> Tuple[List, int]:
    """One pod pass. Call on every process of the group with the same
    `requests` (the ingest broadcasts a batch; each process answers for
    the owners it stores) and the same global `mesh`
    (`multihost.initialize_multihost`). → (responses, digest):
    `responses` aligns with `requests`, None for requests another process
    owns; the digest is the XOR over every device-hashed row of the batch
    (after the in-batch dedup, before the store's), the same on every
    process.

    Each process runs `BatchReconciler`'s streaming pass
    (`start_batch` / `finish_batch`) over the requests of the owners it
    stores, on a mesh of its own shards of `mesh`, on a store with the
    native packed insert: in-batch dedup in request order, primary-key
    dedup through per-row was-new flags, owners with any stored duplicate
    (or non-canonical hex case) re-folded on the host from their new rows
    only. `wire=True` answers in bytes. One process gives the plain
    engine's answers."""
    nproc, pid = process_count(), process_index()
    local = mesh.local_indices()
    if not local:
        raise ValueError(f"process {pid} hosts no shard of {mesh!r}")
    mine = [i for i, r in enumerate(requests) if owner_process(r.user_id, nproc) == pid]
    eng = BatchReconciler(store, mesh_ctx=MeshContext(Mesh([mesh.shards[i] for i in local])))
    try:
        if not eng._packed_store():
            raise ValueError("reconcile_pod needs a store with the native packed insert")
        with span("kernel:merkle", "reconcile_pod", owners=len({r.user_id for r in requests}),
                  local_owners=len(mine), n=sum(len(requests[i].messages) for i in mine),
                  nproc=nproc):
            st = eng.start_batch([requests[i] for i in mine])
            answers = eng.finish_batch(st, wire=wire)
    finally:
        eng.close()
    # The pass's digest holds the host-folded (non-canonical) owners' too;
    # the pod's digest is the device-hashed rows' alone.
    device_digest = st["digest"] ^ st["dev"][1] if st["dev"] is not None else 0
    responses: List = [None] * len(requests)
    for i, answer in zip(mine, answers):
        responses[i] = answer
    return responses, xor_allreduce([device_digest], mesh)
