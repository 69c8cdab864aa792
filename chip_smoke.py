#!/usr/bin/env python3
"""On-card smoke run of evolu_tpu_torch, the PyTorch/CUDA port of the
LWW reconcile pass. Needs one NVIDIA Hopper card; run from the repo
root:

    python3 chip_smoke.py

Phases (any failure ends the run with a traceback and a nonzero code):

1. build    — nvcc builds the kernels from evolu_tpu_torch/csrc/.
2. kernels  — kernels L (segmented lex-max scan), X (segmented XOR scan)
              and H (timestamp hash + digest) against their plain
              PyTorch versions on the card, bit for bit.
3. path A   — `reconcile_owner_batches` on 1M CrdtMessages across 1k
              owners (~4 messages per cell, 60% of cells with a stored
              winner, one owner in non-canonical hex case), every
              owner's result and the digest against the host oracle
              (`plan_batch` + `minute_deltas_host`); each kernel must
              have launched.
4. path B   — SQLite apply: 100k messages over todo/todoCategory in
              batches, then 64 replicas editing the same 100 rows,
              through `apply_messages(planner=plan_batch_device_full)`;
              every table and the Merkle tree string byte-identical to
              `apply_messages_sequential` on a second database.
5. columns  — the reconcile pass from device-resident columns at 1M and
              10M messages (1k owners), per-stage times with CUDA
              events, rows/s and peak device memory; outputs equal to
              the same pass with every kernel swapped for its plain
              version.
6. timing   — each kernel and its plain version timed on the inputs the
              1M columns pass handed it.

The last two lines are the card's `nvidia-smi` name and power limit
and then {"ok": true, "device": {...}}; the line before them is the
kernel table as JSON.
"""

from __future__ import annotations

import contextlib
import functools
import json
import statistics
import subprocess
import sys
import time

import numpy as np

BASE_MILLIS = 1_700_000_000_000
MEM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3, NVIDIA data sheet
INT32_OPS_PER_S = 16.7e12        # 132 SMs x 64 INT32 lanes x 1.98 GHz (derived, see PERF.md)
H_OPS_PER_HASHED_ROW = 300       # ALU ops of one render + murmur3, counted from ts_hash.cu, rounded down


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def phase(name: str, gpu: str):
    t0 = time.perf_counter()
    print(f"[{name}] start | {gpu}", flush=True)
    yield
    print(f"[{name}] ok {time.perf_counter() - t0:.3f}s | {gpu}", flush=True)


@contextlib.contextmanager
def patched(module, name, fn):
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)


def cuda_ms(fn, reps: int = 7, inner: int = 10) -> float:
    """Median over `reps` of the mean time of `inner` back-to-back calls,
    CUDA events around each run, after a warm-up."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def max_abs_err(got, want) -> int:
    """Largest |kernel - plain| over every output, as integers (the
    outputs are integer bit patterns, so anything but 0 is a fault)."""
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


def same(got, want, what):
    for g, w in zip(got, want):
        if not (g.dtype == w.dtype and g.shape == w.shape and bool((g == w).all())):
            raise AssertionError(f"{what}: kernel differs from its plain version")


# ---- data ---------------------------------------------------------------------------


def build_columns(n, owners=1000, seed=7):
    """bench.build_columns(stored_winners=True): ~4 messages per cell,
    cells owned by one of `owners`, minutes clustered in one day, ~60% of
    cells with a stored winner from the same window. Padded to the
    power-of-two bucket with the planner's padding cell."""
    from evolu_tpu_torch.ops import bucket_size

    rng = np.random.default_rng(seed)
    cells = max(n // 4, 1)
    cell_id = rng.integers(0, cells, n).astype(np.int32)
    owner_ix = rng.integers(0, owners, cells).astype(np.int64)[cell_id]
    millis = BASE_MILLIS + rng.integers(0, 86_400_000, n).astype(np.int64)
    counter = rng.integers(0, 256, n).astype(np.int32)
    node = rng.integers(1, 2**63, n).astype(np.uint64)
    k1 = (millis.astype(np.uint64) << np.uint64(16)) | counter.astype(np.uint64)
    has = rng.random(cells) < 0.6
    w_millis = (BASE_MILLIS + rng.integers(0, 86_400_000, cells)).astype(np.uint64)
    w_k1 = (w_millis << np.uint64(16)) | rng.integers(0, 256, cells).astype(np.uint64)
    w_k2 = rng.integers(1, 2**63, cells).astype(np.uint64)
    size = bucket_size(n)
    pad = size - n
    return {
        "cell_id": np.concatenate([cell_id, np.full(pad, 0x7FFFFFFF, np.int32)]),
        "k1": np.concatenate([k1, np.zeros(pad, np.uint64)]),
        "k2": np.concatenate([node, np.zeros(pad, np.uint64)]),
        "ex_k1": np.concatenate([np.where(has, w_k1, 0)[cell_id].astype(np.uint64), np.zeros(pad, np.uint64)]),
        "ex_k2": np.concatenate([np.where(has, w_k2, 0)[cell_id].astype(np.uint64), np.zeros(pad, np.uint64)]),
        "owner_ix": np.concatenate([owner_ix, np.zeros(pad, np.int64)]),
    }


def ts_strings(millis, counter, node, upper=False):
    from evolu_tpu_torch.core.timestamp import timestamp_to_string
    from evolu_tpu_torch.core.types import Timestamp

    out = []
    for m, c, d in zip(millis.tolist(), counter.tolist(), node.tolist()):
        h = f"{d:016x}"
        out.append(timestamp_to_string(Timestamp(m, c, h.upper() if upper else h)))
    return out


def owner_batches(n_owners=1000, per_owner=1000, seed=11, non_canonical=(0,)):
    """Config 3 as messages: per owner ~4 messages per cell over 2
    columns, 60% of cells with a stored winner from the same day."""
    from evolu_tpu_torch.core.types import CrdtMessage

    rng = np.random.default_rng(seed)
    batches, winners = {}, {}
    n_cells = per_owner // 4
    for o in range(n_owners):
        owner = f"owner{o:04d}"
        cell = rng.integers(0, n_cells, per_owner)
        ts = ts_strings(BASE_MILLIS + rng.integers(0, 86_400_000, per_owner),
                        rng.integers(0, 256, per_owner), rng.integers(1, 2**63, per_owner),
                        upper=o in non_canonical)
        cols = ("title", "isCompleted")
        batches[owner] = [
            CrdtMessage(s, "todo", f"{owner}-row{c >> 1:06d}", cols[c & 1], f"v{i}")
            for i, (s, c) in enumerate(zip(ts, cell.tolist()))
        ]
        has = np.nonzero(rng.random(n_cells) < 0.6)[0]
        w_ts = ts_strings(BASE_MILLIS + rng.integers(0, 86_400_000, len(has)),
                          rng.integers(0, 256, len(has)), rng.integers(1, 2**63, len(has)))
        winners[owner] = {("todo", f"{owner}-row{c >> 1:06d}", cols[c & 1]): s
                          for c, s in zip(has.tolist(), w_ts)}
    return batches, winners


# ---- phases -------------------------------------------------------------------------


def kernels_vs_plain(torch, dev):
    from evolu_tpu_torch.ops import cuda_hash, cuda_scan

    rng = np.random.default_rng(5)
    for n in (1, 127, 4096, 70000, (1 << 20) + 3):
        flags = rng.random(n) < 0.03
        flags[0] = True
        k1 = rng.integers(0, 2**64, n, dtype=np.uint64)
        k2 = rng.integers(0, 2**64, n, dtype=np.uint64)
        k1[rng.random(n) < 0.3] = np.uint64(42) << np.uint64(32)   # ties
        k1[rng.random(n) < 0.1] = np.uint64(1) << np.uint64(63)    # ≥ 2^63
        k2[rng.random(n) < 0.1] = 0
        f = torch.from_numpy(flags).to(dev)
        a = torch.from_numpy(k1.view(np.int64)).to(dev)
        b = torch.from_numpy(k2.view(np.int64)).to(dev)
        for reverse in (False, True):
            same(cuda_scan.segmented_max_scan(f, a, b, reverse=reverse),
                 cuda_scan.segmented_max_scan_plain(f, a, b, reverse=reverse), f"L n={n} reverse={reverse}")
        v = torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32).view(np.int32)).to(dev)
        same([cuda_scan.segmented_xor_scan(f, v)], [cuda_scan.segmented_xor_scan_plain(f, v)], f"X n={n}")
    edge = [0, 951_782_400_000, 4_107_542_399_000, 253_402_300_799_999, -1, -999, -1000,
            -86_400_001, -62_135_596_800_000, 2**47]
    n = 70003
    millis = np.concatenate([edge, BASE_MILLIS + rng.integers(0, 10**12, n - len(edge))]).astype(np.int64)
    counter = rng.integers(0, 65536, n).astype(np.int32)
    node = rng.integers(0, 2**64, n, dtype=np.uint64)
    node[:2] = [0, 2**64 - 1]
    m, c, d = (torch.from_numpy(x).to(dev) for x in (millis, counter, node.view(np.int64)))
    same([cuda_hash.timestamp_hashes_cuda(m, c, d)], [cuda_hash.timestamp_hashes_plain(m, c, d)], "H columns")
    k1 = (m.clamp(min=0) << 16) | c.to(torch.int64)
    mask = torch.from_numpy(rng.random(n) < 0.6).to(dev)
    same(cuda_hash.masked_key_hashes_cuda(k1, d, mask),
         cuda_hash.masked_key_hashes_plain(k1, d, mask), "H keys + digest")
    torch.cuda.synchronize()


def path_a(torch, kernels):
    from evolu_tpu_torch.core.merkle import minute_deltas_host
    from evolu_tpu_torch.parallel import reconcile_owner_batches
    from evolu_tpu_torch.storage.apply import plan_batch

    t0 = time.perf_counter()
    batches, winners = owner_batches()
    n_msgs = sum(len(v) for v in batches.values())
    print(f"  path A: {n_msgs} messages, {len(batches)} owners built in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    for k in kernels:
        k["fn"].launches = 0
    t0 = time.perf_counter()
    results, digest = reconcile_owner_batches(batches, winners)
    wall = time.perf_counter() - t0
    launches = {k["name"]: k["fn"].launches for k in kernels}
    print(f"  path A: reconcile_owner_batches {wall:.3f}s ({n_msgs / wall:,.0f} msgs/s "
          f"end to end incl. host columnarization); launches {launches}", flush=True)
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"path A: kernel {name} never launched")
    t0 = time.perf_counter()
    want_digest = 0
    for owner, msgs in batches.items():
        xor_mask, upserts, deltas = results[owner]
        exp_xor, exp_upserts = plan_batch(msgs, winners[owner])
        exp_deltas, owner_digest = minute_deltas_host(
            m.timestamp for f, m in zip(exp_xor, msgs) if f)
        want_digest ^= owner_digest
        if xor_mask != exp_xor or set(upserts) != set(exp_upserts) or deltas != exp_deltas:
            raise AssertionError(f"path A: owner {owner} differs from the host oracle")
    if digest != want_digest:
        raise AssertionError(f"path A: digest {digest:#x} != oracle {want_digest:#x}")
    print(f"  path A: every owner and digest {digest:#010x} equal the host oracle "
          f"({time.perf_counter() - t0:.1f}s)", flush=True)
    return launches


def path_b(torch, kernels):
    from evolu_tpu_torch.core.merkle import merkle_tree_to_string
    from evolu_tpu_torch.core.types import CrdtMessage, TableDefinition
    from evolu_tpu_torch.ops.merge import plan_batch_device_full
    from evolu_tpu_torch.storage import (
        PySqliteDatabase, apply_messages, apply_messages_sequential, init_db_model, update_db_schema,
    )

    tables = {"todo": ("title", "isCompleted", "categoryId"), "todoCategory": ("name",)}

    def make_db():
        db = PySqliteDatabase()
        init_db_model(db)
        update_db_schema(db, [TableDefinition.of(t, c) for t, c in tables.items()])
        return db

    rng = np.random.default_rng(13)
    n = 100_000
    table = np.where(rng.random(n) < 0.8, "todo", "todoCategory")
    row = rng.integers(0, 8000, n)
    col = rng.integers(0, 3, n)
    # Timestamps are unique per message, as HLC stamps are: __message
    # keys on the timestamp, so two cells sharing one would be a
    # different (and unrealistic) workload. Millis are shuffled so cells
    # still see out-of-order and concurrent writes.
    ts = ts_strings(BASE_MILLIS + rng.permutation(n) * 36, rng.integers(0, 4, n),
                    rng.integers(0, 64, n).astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15))
    msgs = [
        CrdtMessage(s, t, f"{t}{r:08d}", tables[t][c % len(tables[t])], f"value{i % 977}")
        for i, (s, t, r, c) in enumerate(zip(ts, table.tolist(), row.tolist(), col.tolist()))
    ]
    batches = [msgs[i:i + 10_000] for i in range(0, n, 10_000)]
    batches.append(msgs[:5000])  # re-delivery: duplicates against stored winners
    # Config 4: 64 replicas edit the same 100 rows in the same
    # millisecond per row; counter and node break the ties.
    nodes = [f"{(r * 0x9E3779B97F4A7C15) % 2**64:016x}" for r in range(64)]
    hot = []
    for r in range(64):
        t_ms = BASE_MILLIS + 7_200_000 + np.arange(100)
        hot += [CrdtMessage(s, "todo", f"hot{k:03d}", "title", f"replica{r}")
                for k, s in enumerate(ts_strings(t_ms, rng.integers(0, 3, 100),
                                                 np.full(100, int(nodes[r], 16), dtype=np.uint64)))]
    batches.append(hot)

    planner = plan_batch_device_full
    db, oracle = make_db(), make_db()
    tree, oracle_tree = {}, {}
    for k in kernels:
        k["fn"].launches = 0
    t0 = time.perf_counter()
    for b in batches:
        tree = apply_messages(db, tree, b, planner=planner)
    wall = time.perf_counter() - t0
    launches = {k["name"]: k["fn"].launches for k in kernels}
    total = sum(len(b) for b in batches)
    print(f"  path B: {total} messages in {len(batches)} batches applied in {wall:.3f}s "
          f"({total / wall:,.0f} msgs/s incl. SQLite); launches {launches}", flush=True)
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"path B: kernel {name} never launched")
    t0 = time.perf_counter()
    for b in batches:
        oracle_tree = apply_messages_sequential(oracle, oracle_tree, b)
    for t in ("__message", *tables):
        q = f'SELECT * FROM "{t}" ORDER BY 1, 2'
        if db.exec(q) != oracle.exec(q):
            raise AssertionError(f"path B: table {t} differs from the sequential oracle")
    if merkle_tree_to_string(tree) != merkle_tree_to_string(oracle_tree):
        raise AssertionError("path B: Merkle tree differs from the sequential oracle")
    print(f"  path B: every table and the Merkle tree byte-identical to the sequential oracle "
          f"({time.perf_counter() - t0:.1f}s)", flush=True)
    return launches


def columns_pass(torch, n, captured=None, reps=3):
    """The reconcile pass on device-resident columns: stage times from
    CUDA events recorded where each kernel is entered and left. Returns
    (decoded outputs, report)."""
    from evolu_tpu_torch.ops import columns_to_device, to_host_many
    from evolu_tpu_torch.ops import merge as pm
    from evolu_tpu_torch.ops import merkle_ops as mo
    from evolu_tpu_torch.ops.merge import unpermute_masks
    from evolu_tpu_torch.ops.merkle_ops import decode_owner_minute_deltas
    from evolu_tpu_torch.parallel import reconcile as pr

    cols = build_columns(n)
    t = columns_to_device(cols, "cuda")
    args = [t[k] for k in pr.COLUMN_NAMES]
    kernel = pr.shard_kernel_for(cols)
    ev = {}

    def mark(name):
        if name is not None and name not in ev:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            ev[name] = e

    def spy(orig, before, after, slot):
        def run(*a, **kw):
            mark(before)
            if captured is not None:
                captured.setdefault(slot, []).append((a, kw))
            out = orig(*a, **kw)
            if after:
                mark(after)
            return out
        return run

    runs = []
    for _ in range(reps):
        ev.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with patched(pm, "segmented_max_scan",
                     spy(pm.segmented_max_scan, "key_sort_end", None, "L")), \
             patched(pr, "masked_key_hashes",
                     spy(pr.masked_key_hashes, "plan_compare_end", "hash_render_end", "H")), \
             patched(mo, "segmented_xor_scan", spy(mo.segmented_xor_scan, None, None, "X")):
            t0 = time.perf_counter()
            mark("start")
            outs = kernel(*args)
            mark("minute_fold_end")
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            xor_s, upsert_s, i_s, *segs, digest = to_host_many(*outs)
            xor_mask, upsert_mask = unpermute_masks(xor_s, upsert_s, i_s)
            deltas = decode_owner_minute_deltas(*segs)
            t2 = time.perf_counter()
        captured = None  # capture the first run's inputs only
        order = ["start", "key_sort_end", "plan_compare_end", "hash_render_end", "minute_fold_end"]
        names = ["key_sort", "plan_compare", "hash_render", "minute_fold"]
        stages = {nm: ev[a].elapsed_time(ev[b]) for nm, a, b in zip(names, order, order[1:])}
        stages["delta_encode"] = (t2 - t1) * 1e3
        runs.append((stages, (t2 - t0), torch.cuda.max_memory_allocated()))
    stages = {k: statistics.median(r[0][k] for r in runs) for k in runs[0][0]}
    wall = statistics.median(r[1] for r in runs)
    report = {
        "messages": n, "rows_padded": int(args[0].shape[0]), "kernel": kernel.__name__,
        "stage_ms": {k: round(v, 4) for k, v in stages.items()},
        "device_ms": round(sum(v for k, v in stages.items() if k != "delta_encode"), 4),
        "pass_s": round(wall, 4), "rows_per_s": round(n / wall),
        "peak_device_bytes": max(r[2] for r in runs),
    }
    decoded = (xor_mask, upsert_mask, deltas, int(digest.view(np.uint32)[0]))
    return decoded, report, (kernel, args)


def plain_reference(torch, kernel, args):
    """The same pass with every kernel swapped for its plain version."""
    from evolu_tpu_torch.ops import cuda_hash, cuda_scan, to_host_many
    from evolu_tpu_torch.ops import merge as pm
    from evolu_tpu_torch.ops import merkle_ops as mo
    from evolu_tpu_torch.ops.merge import unpermute_masks
    from evolu_tpu_torch.ops.merkle_ops import decode_owner_minute_deltas
    from evolu_tpu_torch.parallel import reconcile as pr

    with patched(pm, "segmented_max_scan", cuda_scan.segmented_max_scan_plain), \
         patched(mo, "segmented_xor_scan", cuda_scan.segmented_xor_scan_plain), \
         patched(pr, "masked_key_hashes", cuda_hash.masked_key_hashes_plain):
        xor_s, upsert_s, i_s, *segs, digest = to_host_many(*kernel(*args))
    return (*unpermute_masks(xor_s, upsert_s, i_s), decode_owner_minute_deltas(*segs),
            int(digest.view(np.uint32)[0]))


def check_against_plain(decoded, reference, what):
    if not (np.array_equal(decoded[0], reference[0]) and np.array_equal(decoded[1], reference[1])
            and decoded[2] == reference[2] and decoded[3] == reference[3]):
        raise AssertionError(f"{what}: kernel pass differs from the plain pass")


def time_kernels(torch, kernels, captured):
    """Each kernel and its plain version on the inputs the 1M columns
    pass gave it; bound = max(bytes / HBM rate, ops / INT32 rate)."""
    from evolu_tpu_torch.ops import cuda_hash, cuda_scan

    rows = []
    for k in kernels:
        calls = captured[k["slot"]]
        (a, kw) = calls[0]
        n = a[0].shape[0]
        if k["slot"] == "L":
            got = [cuda_scan.segmented_max_scan_cuda(*a, **kw) for a, kw in calls]
            want = [cuda_scan.segmented_max_scan_plain(*a, **kw) for a, kw in calls]
            ms = sum(cuda_ms(functools.partial(cuda_scan.segmented_max_scan_cuda, *a, **kw)) for a, kw in calls) / len(calls)
            plain_ms = sum(cuda_ms(functools.partial(cuda_scan.segmented_max_scan_plain, *a, **kw), reps=3, inner=2) for a, kw in calls) / len(calls)
            bytes_ = n * (1 + 8 + 8) + n * 16
            ops = 0
        elif k["slot"] == "X":
            got = [[cuda_scan.segmented_xor_scan_cuda(*a)] for a, _ in calls]
            want = [[cuda_scan.segmented_xor_scan_plain(*a)] for a, _ in calls]
            ms = cuda_ms(functools.partial(cuda_scan.segmented_xor_scan_cuda, *a))
            plain_ms = cuda_ms(functools.partial(cuda_scan.segmented_xor_scan_plain, *a), reps=3, inner=2)
            bytes_ = n * (1 + 4) + n * 4
            ops = 0
        else:
            got = [cuda_hash.masked_key_hashes_cuda(*a) for a, _ in calls]
            want = [cuda_hash.masked_key_hashes_plain(*a) for a, _ in calls]
            ms = cuda_ms(functools.partial(cuda_hash.masked_key_hashes_cuda, *a))
            plain_ms = cuda_ms(functools.partial(cuda_hash.masked_key_hashes_plain, *a), reps=3, inner=2)
            bytes_ = n * (8 + 8 + 1) + n * 4 + 4
            ops = H_OPS_PER_HASHED_ROW * int(a[2].sum())
        err = max(max_abs_err(g, w) for g, w in zip(got, want))
        for g, w in zip(got, want):
            same(g, w, k["name"] + " on main-path inputs")
        t_bytes, t_ops = bytes_ / MEM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
        rows.append({
            "name": k["name"], "route": "cuda", "source": k["source"], "replaces": k["replaces"],
            "launches": k["launches"], "launches_path_b": k["launches_b"],
            "rows": n, "max_abs_err": err, "matches_plain": err == 0,
            "ms": round(ms, 5), "plain_ms": round(plain_ms, 5),
            "bound_ms": round(max(t_bytes, t_ops), 5),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
        })
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    from evolu_tpu_torch.ops import cuda_hash, cuda_lib, cuda_scan

    gpu = gpu_line()
    dev = torch.device("cuda")
    kernels = [
        {"name": "seg_lex_max_scan", "slot": "L", "fn": cuda_scan.segmented_max_scan_cuda,
         "source": "evolu_tpu_torch/csrc/seg_scan.cu", "replaces": "evolu_tpu/ops/pallas_scan.py:157"},
        {"name": "seg_xor_scan", "slot": "X", "fn": cuda_scan.segmented_xor_scan_cuda,
         "source": "evolu_tpu_torch/csrc/seg_scan.cu", "replaces": "evolu_tpu/ops/pallas_scan.py:158"},
        {"name": "timestamp_hash", "slot": "H", "fn": cuda_hash.timestamp_hash_cuda,
         "source": "evolu_tpu_torch/csrc/ts_hash.cu", "replaces": "evolu_tpu/ops/pallas_hash.py:98"},
    ]

    with phase("build", gpu):
        cuda_lib.load()
        print(f"  build {cuda_lib.build_info['seconds']:.2f}s -> {cuda_lib.build_info['path']}")
        for line in cuda_lib.build_info["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print("  " + line.strip())
    with phase("kernels vs plain", gpu):
        kernels_vs_plain(torch, dev)
    with phase("path A: reconcile_owner_batches 1M x 1k owners", gpu):
        for k, c in zip(kernels, path_a(torch, kernels).values()):
            k["launches"] = c
    with phase("path B: SQLite apply 100k + 64-replica contention", gpu):
        for k, c in zip(kernels, path_b(torch, kernels).values()):
            k["launches_b"] = c
    captured = {}
    reports = []
    for n in (1_000_000, 10_000_000):
        with phase(f"columns pass {n:,} messages", gpu):
            decoded, report, (kernel, args) = columns_pass(
                torch, n, captured=captured if n == 1_000_000 else None)
            check_against_plain(decoded, plain_reference(torch, kernel, args), f"columns {n}")
            print("  " + json.dumps(report), flush=True)
            reports.append(report)
            del args
            torch.cuda.empty_cache()
    with phase("kernel timing on main-path inputs", gpu):
        table = time_kernels(torch, kernels, captured)
    print(json.dumps({"columns": reports}))
    print(json.dumps({"kernels": table}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
