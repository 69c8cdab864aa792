"""Kernels L, X, H and S on the card against their plain PyTorch versions.

Imports neither jax nor `evolu_tpu`, so it runs on the GPU machine:

    python -m pytest tests/test_torch_cuda.py -q

Without a card every test skips with a reason (the CUDA kernels have no
CPU mode); the decision is made inside the fixture, at run time."""

import urllib.request

import numpy as np
import pytest
import torch

from evolu_tpu_torch.ops import cuda_hash, cuda_lib, cuda_scan

pytestmark = pytest.mark.cuda

TILE = 2048  # rows per block of kernels L and S (seg_scan.cu kTile)
X_TILE = 2 * TILE  # rows per block of kernel X (seg_scan.cu kXorRows)
SIZES = (1, 127, 128, TILE - 1, TILE, TILE + 1, 3 * TILE + 5, X_TILE, X_TILE + 1, 70000, (1 << 20) + 3)
# The last two: the ends of the days window [2^31 - 719468, 2^31 - 1] in
# which `days + 719468` wraps in int32.
EDGE_MILLIS = [0, 951_782_400_000, 4_107_542_399_000, 253_402_300_799_999,
               -1, -999, -86_400_001, -62_135_596_800_000, 2**47,
               185_480_425_152_000_000, 185_542_587_187_199_999]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _lex_inputs(n, seed, dev):
    rng = np.random.default_rng(seed)
    flags = rng.random(n) < 0.03
    flags[0] = True
    k1 = rng.integers(0, 2**64, n, dtype=np.uint64)
    k2 = rng.integers(0, 2**64, n, dtype=np.uint64)
    k1[rng.random(n) < 0.3] = np.uint64(42) << np.uint64(32)   # ties
    k1[rng.random(n) < 0.1] = np.uint64(1) << np.uint64(63)    # ≥ 2^63
    k2[rng.random(n) < 0.1] = 0
    return (torch.from_numpy(flags).to(dev), torch.from_numpy(k1.view(np.int64)).to(dev),
            torch.from_numpy(k2.view(np.int64)).to(dev))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", SIZES)
def test_kernel_l_matches_plain(n, reverse, dev):
    f, a, b = _lex_inputs(n, n, dev)
    before = cuda_scan.segmented_max_scan_cuda.launches
    got = cuda_scan.segmented_max_scan(f, a, b, reverse=reverse)
    assert cuda_scan.segmented_max_scan_cuda.launches == before + 1
    want = cuda_scan.segmented_max_scan_plain(f, a, b, reverse=reverse)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _xor_values(n, seed, dev):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint32)
                            .view(np.int32)).to(dev)


@pytest.mark.parametrize("n", SIZES)
def test_kernel_x_matches_plain(n, dev):
    f, _, _ = _lex_inputs(n, n, dev)
    v = _xor_values(n, n, dev)
    before = cuda_scan.segmented_xor_scan_cuda.launches
    got = cuda_scan.segmented_xor_scan(f, v)
    assert cuda_scan.segmented_xor_scan_cuda.launches == before + 1
    assert torch.equal(got, cuda_scan.segmented_xor_scan_plain(f, v))


def _h_inputs(n, seed, dev):
    """Columns (millis, counter, node) with EDGE_MILLIS first, and the
    reconcile form's keys k1 from them."""
    rng = np.random.default_rng(seed)
    edge = EDGE_MILLIS[:n]
    millis = np.concatenate([edge, 1_700_000_000_000 + rng.integers(0, 10**12, n - len(edge))])
    counter = rng.integers(0, 65536, n).astype(np.int32)
    node = rng.integers(0, 2**64, n, dtype=np.uint64)
    node[:2] = [0, 2**64 - 1][:n]
    m, c, d = (torch.from_numpy(x).to(dev) for x in (millis.astype(np.int64), counter, node.view(np.int64)))
    return m, c, d, (m.clamp(min=0) << 16) | c.to(torch.int64)


def _assert_h_matches_plain(m, c, d, k1, mask):
    assert torch.equal(cuda_hash.timestamp_hashes_cuda(m, c, d), cuda_hash.timestamp_hashes_plain(m, c, d))
    got_h, got_d = cuda_hash.masked_key_hashes(k1, d, mask)
    want_h, want_d = cuda_hash.masked_key_hashes_plain(k1, d, mask)
    assert torch.equal(got_h, want_h) and torch.equal(got_d, want_d)


@pytest.mark.parametrize("n", [len(EDGE_MILLIS), 70001])
def test_kernel_h_matches_plain(n, dev):
    m, c, d, k1 = _h_inputs(n, n, dev)
    mask = torch.from_numpy(np.random.default_rng(n).random(n) < 0.6).to(dev)
    _assert_h_matches_plain(m, c, d, k1, mask)


@pytest.mark.parametrize("mask_kind", ["random", "all false", "all true"])
@pytest.mark.parametrize("n", [1, 255, 257, (1 << 24) + 3])
def test_kernel_h_sizes_and_digest(n, mask_kind, dev):
    """Both forms around the block size and past 2^24 rows, where the grid
    strides; an all-false mask hashes nothing and its digest is 0."""
    m, c, d, k1 = _h_inputs(n, n + 1, dev)
    mask = {"random": torch.from_numpy(np.random.default_rng(n).random(n) < 0.6).to(dev),
            "all false": torch.zeros(n, dtype=torch.bool, device=dev),
            "all true": torch.ones(n, dtype=torch.bool, device=dev)}[mask_kind]
    before = cuda_hash.timestamp_hash_cuda.launches
    _assert_h_matches_plain(m, c, d, k1, mask)
    assert cuda_hash.timestamp_hash_cuda.launches == before + 2
    if mask_kind == "all false":
        assert int(cuda_hash.masked_key_hashes(k1, d, mask)[1]) == 0


def test_kernel_h_digest_across_calls_and_streams(dev):
    """The digest's block counter is reset by the last block of each call:
    calls back to back on one stream, the empty call (n = 0, digest 0),
    then calls on a second stream with its own scratch."""
    inputs = [_h_inputs(n, n, dev) for n in (70001, 257, 1 << 20)]
    masks = [torch.from_numpy(np.random.default_rng(i).random(k1.shape[0]) < 0.5).to(dev)
             for i, (_, _, _, k1) in enumerate(inputs)]
    empty = torch.zeros(0, dtype=torch.int64, device=dev)
    got = [cuda_hash.masked_key_hashes(k1, d, mask) for (_, _, d, k1), mask in zip(inputs, masks)]
    got.append(cuda_hash.masked_key_hashes(empty, empty, empty.bool()))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got += [cuda_hash.masked_key_hashes(k1, d, mask) for (_, _, d, k1), mask in zip(inputs, masks)]
    torch.cuda.current_stream().wait_stream(side)
    want = [cuda_hash.masked_key_hashes_plain(k1, d, mask) for (_, _, d, k1), mask in zip(inputs, masks)]
    want = want + [(empty.int(), torch.zeros(1, dtype=torch.int32, device=dev))] + want
    for (gh, gd), (wh, wd) in zip(got, want):
        assert torch.equal(gh, wh) and torch.equal(gd, wd)
    assert ("digest", torch.cuda.current_device(), side.cuda_stream) in cuda_lib._stream_states


def _sum_values(n, seed, dev):
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 2**64, n, dtype=np.uint64)
    v[rng.random(n) < 0.2] = np.uint64(2**64 - 1)  # every add wraps
    v[rng.random(n) < 0.1] = np.uint64(1) << np.uint64(63)
    return torch.from_numpy(v.view(np.int64)).to(dev)


@pytest.mark.parametrize("n", (1, 255, 256, TILE - 1, TILE, TILE + 1, 3 * TILE + 5, 4097, (1 << 15) + 3,
                               (1 << 20) + 3))
def test_kernel_s_matches_plain(n, dev):
    f, _, _ = _lex_inputs(n, n, dev)
    values = _sum_values(n, n, dev)
    before = cuda_scan.segmented_sum_scan_cuda.launches
    got = cuda_scan.segmented_sum_scan(f, values)
    assert cuda_scan.segmented_sum_scan_cuda.launches == before + 1
    assert torch.equal(got, cuda_scan.segmented_sum_scan_plain(f, values))


def test_kernel_s_wraps_like_u64(dev):
    f = torch.tensor([True, False, False, True, False], device=dev)
    v = torch.tensor(np.array([2**63 - 1, 1, 2**64 - 1, 2**64 - 2, 3], np.uint64).view(np.int64), device=dev)
    want = np.array([2**63 - 1, 2**63, 2**63 - 1, 2**64 - 2, 1], np.uint64)
    np.testing.assert_array_equal(cuda_scan.segmented_sum_scan(f, v).cpu().numpy().view(np.uint64), want)


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    f, a, b = _lex_inputs(256, 1, dev)
    with pytest.raises(ValueError):
        cuda_scan.segmented_max_scan_cuda(f, a[::2], b[::2])
    with pytest.raises(ValueError):
        cuda_scan.segmented_xor_scan_cuda(f, a)  # int64 values, kernel takes int32
    with pytest.raises(ValueError):
        cuda_scan.segmented_sum_scan_cuda(f, a.to(torch.int32))  # kernel S takes int64
    with pytest.raises(ValueError):
        cuda_scan.segmented_sum_scan_cuda(f, a[::2])  # wrong length, not contiguous
    with pytest.raises(ValueError):
        cuda_scan.segmented_sum_scan_cuda(f.cpu(), a.cpu())  # CPU tensors: plain version only
    with pytest.raises(ValueError):
        cuda_hash.masked_key_hashes_cuda(a, b, f[::2])  # a mask of another length
    with pytest.raises(ValueError):
        cuda_hash.timestamp_hashes_cuda(a, a, b)  # int64 counter, kernel takes int32


def _assert_l_and_s_match_plain(f, a, b, v):
    for reverse in (False, True):
        got = cuda_scan.segmented_max_scan(f, a, b, reverse=reverse)
        want = cuda_scan.segmented_max_scan_plain(f, a, b, reverse=reverse)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), f"L reverse={reverse}"
    assert torch.equal(cuda_scan.segmented_sum_scan(f, v), cuda_scan.segmented_sum_scan_plain(f, v)), "S"


@pytest.mark.parametrize("kind,n", [("one segment", (1 << 20) + 3), ("one segment", (1 << 23) + 5),
                                    ("no flag", 3 * TILE + 5), ("every row", TILE + 1),
                                    ("every row", (1 << 20) + 3)])
def test_kernels_l_and_s_on_look_back_chains(kind, n, dev):
    """One segment over the whole array (forward, and no segment end at
    all in reverse) makes every tile wait on its predecessor's inclusive
    prefix: the longest look-back chain. Every row flagged makes none wait."""
    _, a, b = _lex_inputs(n, n, dev)
    f = torch.full((n,), kind == "every row", dtype=torch.bool, device=dev)
    f[0] = kind != "no flag"
    _assert_l_and_s_match_plain(f, a, b, _sum_values(n, n, dev))


def _assert_x_matches_plain(f, v, what=""):
    assert torch.equal(cuda_scan.segmented_xor_scan(f, v), cuda_scan.segmented_xor_scan_plain(f, v)), f"X {what}"


@pytest.mark.parametrize("kind,n", [("one segment", (1 << 20) + 3), ("one segment", (1 << 23) + 5),
                                    ("no flag", 3 * X_TILE + 5), ("every row", X_TILE + 1),
                                    ("every row", (1 << 20) + 3), ("random", X_TILE - 1), ("random", X_TILE),
                                    ("random", X_TILE + 1)])
def test_kernel_x_on_look_back_chains(kind, n, dev):
    """X on the look-back stress inputs of L and S: the longest chain of
    tiles waiting on their predecessors, no flag at all, every row its own
    segment, and sizes around the tile."""
    if kind == "random":
        f, _, _ = _lex_inputs(n, n, dev)
    else:
        f = torch.full((n,), kind == "every row", dtype=torch.bool, device=dev)
        f[0] = kind != "no flag"
    _assert_x_matches_plain(f, _xor_values(n, n, dev))


@pytest.mark.parametrize("start", (1, 2, 3))
@pytest.mark.parametrize("n", (X_TILE + 1, 70001))
def test_kernel_x_on_offset_views(n, start, dev):
    """Views 1, 2 and 3 int32 rows past a 16-byte boundary: X's ragged head
    (the rows before the first 16-byte load) and tail rows run."""
    f, _, _ = _lex_inputs(n + start, n, dev)
    v = _xor_values(n + start, n, dev)[start:]
    assert v.data_ptr() % 16 == 4 * start
    _assert_x_matches_plain(f[start:], v, f"view at row {start}")


@pytest.mark.parametrize("start", (1, 2))
@pytest.mark.parametrize("n", (TILE + 1, 70001))
def test_kernels_l_and_s_on_offset_views(n, start, dev):
    """Views at a storage offset: the u64 columns start 8 bytes past a
    16-byte boundary (start 1) or on one (start 2), the flags 1 or 2
    bytes past one, so the kernels' ragged head and tail rows run."""
    f, a, b = (x[start:] for x in _lex_inputs(n, n, dev))
    v = _sum_values(n, n + 1, dev)[start:]
    assert a.data_ptr() % 16 == (8 if start == 1 else 0) and f.data_ptr() % 16 == start
    _assert_l_and_s_match_plain(f, a, b, v)


def test_look_back_scratch_across_calls_and_streams(dev):
    """Two different inputs back to back on one stream through L, X and S,
    which share the stream's scratch, then calls on a second stream: each
    call's status words carry their own epoch, and each stream has its own
    scratch."""
    n = 3 * TILE + 5
    first = (*_lex_inputs(n, 1, dev), _sum_values(n, 1, dev), _xor_values(n, 1, dev))
    second = list(_lex_inputs(n, 2, dev)) + [_sum_values(n, 2, dev), _xor_values(n, 2, dev)]
    second[0] = torch.zeros_like(second[0])
    second[0][0] = True
    got = [cuda_scan.segmented_sum_scan(first[0], first[3]), cuda_scan.segmented_xor_scan(second[0], second[4]),
           cuda_scan.segmented_sum_scan(second[0], second[3]), cuda_scan.segmented_xor_scan(first[0], first[4]),
           *cuda_scan.segmented_max_scan(*first[:3]), *cuda_scan.segmented_max_scan(*second[:3])]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got += [cuda_scan.segmented_sum_scan(first[0], first[3]), cuda_scan.segmented_xor_scan(second[0], second[4]),
                *cuda_scan.segmented_max_scan(*first[:3], reverse=True)]
    torch.cuda.current_stream().wait_stream(side)
    want = [cuda_scan.segmented_sum_scan_plain(first[0], first[3]),
            cuda_scan.segmented_xor_scan_plain(second[0], second[4]),
            cuda_scan.segmented_sum_scan_plain(second[0], second[3]),
            cuda_scan.segmented_xor_scan_plain(first[0], first[4]),
            *cuda_scan.segmented_max_scan_plain(*first[:3]), *cuda_scan.segmented_max_scan_plain(*second[:3]),
            cuda_scan.segmented_sum_scan_plain(first[0], first[3]),
            cuda_scan.segmented_xor_scan_plain(second[0], second[4]),
            *cuda_scan.segmented_max_scan_plain(*first[:3], reverse=True)]
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ("lookback", torch.cuda.current_device(), side.cuda_stream) in cuda_lib._stream_states


def test_look_back_epoch_wraps(dev):
    n = 3 * TILE + 5
    f, a, b = _lex_inputs(n, 3, dev)
    v = _sum_values(n, 3, dev)
    x = _xor_values(n, 3, dev)
    cuda_scan.segmented_sum_scan(f, v)  # the scratch of this stream exists
    state = cuda_lib._stream_states[("lookback", torch.cuda.current_device(),
                                     torch.cuda.current_stream().cuda_stream)]
    state.epoch = cuda_scan._EPOCH_LIMIT - 3
    for _ in range(3):  # 12 calls: the last two epochs, a wrap that clears the status words, epochs 2..10
        _assert_l_and_s_match_plain(f, a, b, v)
        _assert_x_matches_plain(f, x)
    assert state.epoch == 10


def test_look_back_two_threads_on_one_stream(dev):
    """Two host threads launch L, X and S 200 times each on the same device
    and stream, so they share one look-back scratch; every result equals its
    plain version (each launch takes its own epoch under the lock)."""
    import threading

    n = 3 * TILE + 5
    inputs = [(*_lex_inputs(n, 10 + i, dev), _sum_values(n, 10 + i, dev), _xor_values(n, 10 + i, dev))
              for i in range(2)]
    want = [(*cuda_scan.segmented_max_scan_plain(*x[:3]), cuda_scan.segmented_sum_scan_plain(x[0], x[3]),
             cuda_scan.segmented_xor_scan_plain(x[0], x[4])) for x in inputs]
    stream = torch.cuda.current_stream().cuda_stream
    bad, errors = [], []

    def run(i):
        try:
            f, a, b, v, x = inputs[i]
            for r in range(200):
                assert torch.cuda.current_stream().cuda_stream == stream
                got = (*cuda_scan.segmented_max_scan(f, a, b), cuda_scan.segmented_sum_scan(f, v),
                       cuda_scan.segmented_xor_scan(f, x))
                if not all(torch.equal(g, w) for g, w in zip(got, want[i])):
                    bad.append((i, r))
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert not bad, bad


def test_one_kernel_launch_per_call(dev):
    """Each dispatcher call of L (either direction), X, S and H's reconcile
    form launches exactly one CUDA kernel, as CUPTI records it: no memset
    and no fill kernel, nothing on the device but its outputs."""
    from torch.profiler import ProfilerActivity, profile

    n = 70000
    f, a, b = _lex_inputs(n, 4, dev)
    v = _sum_values(n, 4, dev)
    x = _xor_values(n, 4, dev)
    _, _, d, k1 = _h_inputs(n, 4, dev)
    calls = {"L": (lambda: cuda_scan.segmented_max_scan(f, a, b), "lookback_scan"),
             "L reverse": (lambda: cuda_scan.segmented_max_scan(f, a, b, reverse=True), "lookback_scan"),
             "X": (lambda: cuda_scan.segmented_xor_scan(f, x), "lookback_scan"),
             "S": (lambda: cuda_scan.segmented_sum_scan(f, v), "lookback_scan"),
             "H": (lambda: cuda_hash.masked_key_hashes(k1, d, f), "ts_hash_kernel")}
    for name, (call, kernel) in calls.items():
        call()  # the stream's scratch exists before the profiled call
        torch.cuda.synchronize()
        # CUPTI's record of a session now and then comes back empty on the
        # H100; such a session is profiled again, up to three in all.
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
            device = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
            if device:
                break
        assert len(device) == 1 and kernel in device[0], (name, device)
        assert not any("memset" in e.lower() or "fill" in e.lower() for e in device), (name, device)


# ---- the winner cache and the client worker on the card ---------------------

_TODO = 'CREATE TABLE "todo" ("id" TEXT PRIMARY KEY, "title" BLOB, "done" BLOB)'


def _cache_batches(seed, n_batches=6, n=3000, rows=700, big_frac=0.2):
    """Batches over a steady population with a churn burst in the middle;
    keys with bit 63 set (millis ≥ 2^47 for `big_frac` of the messages,
    nodes ≥ 2^63) beside small ones; timestamps unique per message."""
    from evolu_tpu_torch.core.timestamp import timestamp_to_string
    from evolu_tpu_torch.core.types import CrdtMessage, Timestamp

    rng = np.random.default_rng(seed)
    out, used = [], set()
    for b in range(n_batches):
        burst = b == 3
        batch = []
        while len(batch) < n:
            big = rng.random() < big_frac
            millis = (1 << 47) + int(rng.integers(0, 10**9)) if big else 1_700_000_000_000 + int(rng.integers(0, 10**9))
            node = int(rng.integers(0, 2**64, dtype=np.uint64))
            ts = timestamp_to_string(Timestamp(millis, int(rng.integers(0, 4)), f"{node:016x}"))
            if ts in used:
                continue
            used.add(ts)
            row = f"burst{b}-{rng.integers(0, 10**6)}" if burst else f"r{rng.integers(0, rows)}"
            batch.append(CrdtMessage(ts, "todo", row, ("title", "done")[int(rng.integers(0, 2))], f"v{len(used)}"))
        out.append(batch)
    return out


def test_cached_plan_on_card_matches_cpu(dev):
    """`DeviceWinnerCache` on the card against the same cache on the CPU
    (the plain versions), over twin databases and several batches:
    equal masks, deltas, routes, slots, slot arrays and SQLite end state,
    with L, H and X launched and S not."""
    from evolu_tpu_torch.ops.winner_cache import DeviceWinnerCache
    from evolu_tpu_torch.storage import PySqliteDatabase, apply_messages, init_db_model

    sides = []
    for device in ("cuda", "cpu"):
        db = PySqliteDatabase()
        init_db_model(db, "legal winner thank year wave sausage worth useful legal winner thank yellow")
        db.exec(_TODO)
        cache = DeviceWinnerCache(db, capacity=1024, device=device)
        plans = []

        def planner(messages, existing, cache=cache, plans=plans):
            plan = cache.plan_batch(messages, existing)
            plans.append((list(plan[0]), plan.upsert_mask.tolist(), plan[2], cache.last_route))
            return plan

        planner.fetches_winners = False
        sides.append({"db": db, "cache": cache, "plans": plans, "planner": planner, "tree": {}})
    counters = (cuda_scan.segmented_max_scan_cuda, cuda_hash.timestamp_hash_cuda,
                cuda_scan.segmented_xor_scan_cuda, cuda_scan.segmented_sum_scan_cuda)
    before = [c.launches for c in counters]
    card, cpu = sides
    for batch in _cache_batches(3):
        for side in sides:
            side["tree"] = apply_messages(side["db"], side["tree"], batch, planner=side["planner"])
        assert card["plans"] == cpu["plans"]
        assert card["cache"]._slots == cpu["cache"]._slots and card["cache"]._free == cpu["cache"]._free
        for a, b in zip(card["cache"].slot_values(), cpu["cache"].slot_values()):
            assert np.array_equal(a, b)
        assert card["cache"].verify_against_db() == cpu["cache"].verify_against_db() == len(card["cache"]._slots)
    launched = [c.launches - b for c, b in zip(counters, before)]
    assert launched[0] > 0 and launched[1] > 0 and launched[2] > 0 and launched[3] == 0, launched
    assert {p[3] for p in card["plans"]} == {"cached", "stream"}, card["plans"]
    assert card["tree"] == cpu["tree"]
    for t in ("__message", "todo"):
        q = f'SELECT * FROM "{t}" ORDER BY 1, 2'
        assert card["db"].exec(q) == cpu["db"].exec(q)


def test_db_worker_round_on_card(dev):
    """A small client round through `DbWorker(device=None)` on the card
    against a `backend="cpu"` worker: equal outputs, pushes and tables,
    and the cache audit passing."""
    from evolu_tpu_torch.core.types import CrdtMessage, NewCrdtMessage, TableDefinition
    from evolu_tpu_torch.runtime import messages as msg
    from evolu_tpu_torch.runtime.worker import DbWorker
    from evolu_tpu_torch.storage import PySqliteDatabase
    from evolu_tpu_torch.utils.config import Config

    mnemonic = "legal winner thank year wave sausage worth useful legal winner thank yellow"
    q = msg.serialize_query('SELECT * FROM "todo" ORDER BY "id"')
    sides = []
    for cfg in (Config(backend="cuda", receive_chunk_size=2000), Config(backend="cpu", receive_chunk_size=2000)):
        outs, pushes = [], []
        w = DbWorker(PySqliteDatabase(), cfg, on_output=outs.append, post_sync=pushes.append,
                     now=lambda: 1_700_000_000_000 + 10**9)  # past every remote stamp: no drift
        sides.append((w, outs, pushes))
    import evolu_tpu_torch.core.timestamp as ts_mod

    node = ts_mod.create_node_id
    ts_mod.create_node_id = lambda: "0f1e2d3c4b5a6978"
    try:
        for w, _, _ in sides:
            w.start(mnemonic)
    finally:
        ts_mod.create_node_id = node
    # Millis ≥ 2^47 would reach minutes past 2^31, where the Merkle diff
    # (JS `| 0`) goes negative and the resend query's timestamp has no
    # ISO form, in the JAX package too; the cache test above covers them.
    batches = _cache_batches(9, n_batches=4, n=2500, rows=300, big_frac=0.0)
    for w, _, _ in sides:
        w.post(msg.UpdateDbSchema((TableDefinition.of("todo", ("title", "done")),)))
        w.post(msg.Send(tuple(NewCrdtMessage("todo", f"r{i}", "title", f"mine{i}") for i in range(50)), (), (q,)))
        for b in batches:
            w.post(msg.Receive(tuple(CrdtMessage(*(m.timestamp, m.table, m.row, m.column, m.value)) for m in b),
                               "{}"))
        w.post(msg.Query((q,)))
        w.flush()
    (gw, gout, gpush), (ow, oout, opush) = sides
    try:
        assert not any(isinstance(o, msg.OnError) for o in gout + oout), [o for o in gout if isinstance(o, msg.OnError)]
        assert [type(o).__name__ for o in gout] == [type(o).__name__ for o in oout]
        assert [o.queries_patches for o in gout if isinstance(o, msg.OnQuery)] == \
            [o.queries_patches for o in oout if isinstance(o, msg.OnQuery)]
        assert [(r.messages, r.clock_timestamp, r.merkle_tree) for r in gpush] == \
            [(r.messages, r.clock_timestamp, r.merkle_tree) for r in opush]
        for t in ("__message", "todo", "__clock", "__owner"):
            qq = f'SELECT * FROM "{t}" ORDER BY 1, 2'
            assert gw.db.exec(qq) == ow.db.exec(qq)
        assert gw.verify_winner_cache() == len(gw._planner.cache._slots)
    finally:
        gw.stop(), ow.stop()


# ---- the relay engine on the card -----------------------------------------------


def _engine_columns(seed, n, total, owners, span_ms):
    rng = np.random.default_rng(seed)
    millis = np.zeros(total, np.int64)
    counter = np.zeros(total, np.int32)
    node = np.zeros(total, np.uint64)
    owner = np.full(total, -1, np.int32)
    millis[:n] = 1_700_000_000_000 + rng.integers(0, span_ms, n)
    counter[:n] = rng.integers(0, 16, n)
    node[:n] = rng.integers(0, 2**64, n, dtype=np.uint64)
    owner[:n] = np.sort(rng.integers(0, owners, n))
    return millis, counter, node, owner


@pytest.mark.parametrize("span", [300_000, 3_000_000_000])  # under the cap; past it
def test_engine_kernels_on_card_match_cpu(span, dev):
    """The three engine kernels at 2^16 rows on the card against the same
    calls on the CPU (the plain versions of H and X)."""
    from evolu_tpu_torch.ops import columns_to_device, to_host_many
    from evolu_tpu_torch.server import engine as pe

    n, total = 60_000, 1 << 16
    millis, counter, node, owner = _engine_columns(21, n, total, 1000, span)
    cap = pe.bucket_size(total // 8)
    base = int(millis[:n].min())
    real = owner >= 0
    k1 = (millis.astype(np.uint64) << np.uint64(16)) | counter.astype(np.uint64)
    cols = {"k1": k1, "node": node, "owner": owner,
            "dmillis": np.where(real, millis - base, 0).astype(np.uint32).view(np.int32),
            "ownctr": np.where(real, (owner.astype(np.uint32) << np.uint32(16)) | counter.astype(np.uint32),
                               np.uint32(0xFFFF << 16)).view(np.int32),
            "millis": millis, "counter": counter, "valid": real,
            "owner64": np.maximum(owner, 0).astype(np.int64)}
    outs = []
    for d in (dev, "cpu"):
        t = columns_to_device(cols, d)
        outs.append((
            to_host_many(*pe._merkle_shard_kernel_compact(t["k1"], t["node"], t["owner"], cap)),
            to_host_many(*pe._merkle_shard_kernel_compact_delta(t["dmillis"], t["ownctr"], t["node"], base, cap)),
            to_host_many(*pe._merkle_shard_kernel(t["millis"], t["counter"], t["node"], t["valid"], t["owner64"]))))
    (card_full, card_delta, card_wide), (cpu_full, cpu_delta, cpu_wide) = outs
    for got, want in ((card_full, cpu_full), (card_delta, cpu_delta), (card_delta, cpu_full)):
        c = min(int(want[2][0]), cap)
        assert int(got[2][0]) == int(want[2][0]) and c > 0
        assert np.array_equal(got[0][:c], want[0][:c]) and np.array_equal(got[1][:c], want[1][:c])
        assert got[3][0] == want[3][0]
    assert (int(cpu_full[2][0]) > cap) == (span > 10**9)
    ends = cpu_wide[2] & cpu_wide[4]
    for i in (0, 1, 2, 4, 5):
        assert np.array_equal(card_wide[i], cpu_wide[i])
    assert np.array_equal(card_wide[3][ends], cpu_wide[3][ends])


def _relay_batches():
    """Requests for `run_batch_wire`: 64 owners' first delivery with their
    post-apply trees, a re-delivery with stale trees, cold syncs, a batch
    whose every row has its own minute (cap overflow), and one spanning
    2^32 ms (the 20-B upload)."""
    from evolu_tpu_torch.core.merkle import apply_prefix_xors, merkle_tree_to_string, minute_deltas_host
    from evolu_tpu_torch.core.timestamp import timestamp_to_string
    from evolu_tpu_torch.core.types import Timestamp
    from evolu_tpu_torch.sync import protocol as pp

    rng = np.random.default_rng(22)
    base = 1_700_000_000_000

    def request(o, stamps, tree=None, node="f" * 16):
        msgs = tuple(pp.EncryptedCrdtMessage(s, bytes(rng.integers(0, 256, 16, dtype=np.uint8))) for s in stamps)
        if tree is None:
            deltas, _ = minute_deltas_host(stamps)
            tree = merkle_tree_to_string(apply_prefix_xors({}, deltas))
        return pp.SyncRequest(msgs, f"owner{o:03d}", node, tree)

    per = {o: [] for o in range(64)}
    for i in range(1 << 16):
        o = int(rng.integers(0, 64))
        per[o].append(timestamp_to_string(Timestamp(base + i // 16, i % 16, f"{o:015x}{int(rng.integers(0, 16)):x}")))
    first = [request(o, s[: len(s) * 3 // 4]) for o, s in per.items()]
    again = [request(o, s[len(s) * 3 // 4:] + s[:20], tree=first[o].merkle_tree) for o, s in per.items()]
    cold = [request(o, [], tree="{}", node="e" * 16) for o in range(8)]
    minutes = [request(64 + o, [timestamp_to_string(Timestamp(base + (o * 512 + i) * 60_000, 0, "a" * 16))
                                for i in range(512)]) for o in range(8)]
    wide = [request(80, [timestamp_to_string(Timestamp(m, 0, "b" * 16)) for m in (base, base + (1 << 32))])]
    return [first, again, cold, minutes, wide]


def test_relay_engine_on_card_matches_cpu(dev):
    """`BatchReconciler.run_batch_wire` on the card against the same batches
    with `device="cpu"`: equal bytes and tables, and the routes predicted."""
    from evolu_tpu_torch.server import engine as pe
    from evolu_tpu_torch.server.relay import RelayStore

    batches = _relay_batches()
    sides = []
    for d in (None, "cpu"):
        store = RelayStore(backend="python")
        engine = pe.BatchReconciler(store, device=d)
        before = dict(pe.counts)
        out = [engine.run_batch_wire(b) for b in batches]
        sides.append((out, {k: pe.counts[k] - before[k] for k in ("delta", "full", "overflow", "host_owners")}, store))
    (card, card_routes, card_store), (cpu, _, cpu_store) = sides
    assert card == cpu
    assert card_routes == {"delta": 3, "full": 1, "overflow": 1, "host_owners": 0}
    for q in ('SELECT * FROM "message" ORDER BY 1, 2', 'SELECT * FROM "merkleTree" ORDER BY 1'):
        assert card_store.db.exec(q) == cpu_store.db.exec(q)


@pytest.mark.parametrize("shards", [1, 4])
def test_native_ingest_on_card_matches_python_store(shards, dev):
    """The packed ingest (native `INSERT OR IGNORE` with was-new flags, the
    native parse, one device dispatch) on the card, on one native store and
    on four native shards, against the generic ingest on a Python store on
    the CPU: equal bytes and tables, the same routes."""
    from evolu_tpu_torch.server import engine as pe
    from evolu_tpu_torch.server.relay import RelayStore, ShardedRelayStore

    batches = _relay_batches()
    native = RelayStore(backend="native") if shards == 1 else ShardedRelayStore(shards=shards, backend="native")
    python = RelayStore(backend="python")
    sides = []
    for store, d in ((native, None), (python, "cpu")):
        engine = pe.BatchReconciler(store, device=d)
        before = dict(pe.counts)
        try:
            out = [engine.run_batch_wire(b) for b in batches]
        finally:
            engine.close()
        sides.append((out, {k: pe.counts[k] - before[k] for k in ("delta", "full", "overflow", "host_owners")}))
    assert sides[0] == sides[1]
    assert sides[0][1] == {"delta": 3, "full": 1, "overflow": 1, "host_owners": 0}
    for q in ('SELECT * FROM "message" ORDER BY 1, 2', 'SELECT * FROM "merkleTree" ORDER BY 1'):
        stores = native.shards if shards > 1 else [native]
        assert sorted(r for s in stores for r in s.db.exec(q)) == python.db.exec(q)


@pytest.mark.parametrize("entry", ["reconcile_stream", "run_batch_wire", "reconcile_wire"])
def test_streaming_ingest_on_card_matches_cpu(entry, dev):
    """The pipelined streaming ingest (`reconcile_stream`; `run_batch_wire`
    takes `start_batch`/`finish_batch` on a native store) and the one-shot
    `_ingest_packed` (`reconcile_wire`) on the card, against the same entry
    with `device="cpu"`: equal bytes and tables. The pull waits on the
    batch's own event on the engine's pull thread."""
    from evolu_tpu_torch.server import engine as pe
    from evolu_tpu_torch.server.relay import RelayStore
    from evolu_tpu_torch.sync import protocol as pp

    batches = _relay_batches()
    sides = []
    for d in (None, "cpu"):
        store = RelayStore(backend="native")
        engine = pe.BatchReconciler(store, device=d)
        try:
            if entry == "reconcile_stream":
                out = [[pp.encode_sync_response(r) for r in b] for b in engine.reconcile_stream(batches)]
            else:
                out = [getattr(engine, entry)(b) for b in batches]
        finally:
            engine.close()
        sides.append((out, [store.db.exec(q) for q in ('SELECT * FROM "message" ORDER BY 1, 2',
                                                       'SELECT * FROM "merkleTree" ORDER BY 1')]))
        store.close()
    assert sides[0] == sides[1]


def test_batching_relay_on_card_matches_cpu(dev):
    """A batching `RelayServer` on the card (`device=None`) and one on the
    CPU, each fed the same requests over HTTP from 8 threads (one owner a
    thread): equal responses and tables, every request coalesced, H and X
    launched."""
    import threading
    import urllib.request

    from evolu_tpu_torch.server.relay import RelayServer, RelayStore
    from evolu_tpu_torch.sync import protocol as pp

    first, again = _relay_batches()[:2]
    lanes = [[first[o], again[o]] for o in range(8)]
    sides = []
    for d in (None, "cpu"):
        server = RelayServer(RelayStore(backend="native"), batching=True, device=d).start()
        got = {}
        before = cuda_hash.timestamp_hash_cuda.launches
        try:
            def lane(o):
                for k, r in enumerate(lanes[o]):
                    req = urllib.request.Request(server.url, data=pp.encode_sync_request(r))
                    with urllib.request.urlopen(req, timeout=60) as resp:
                        got[(o, k)] = resp.read()

            threads = [threading.Thread(target=lane, args=(o,)) for o in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
            counts = dict(server.scheduler.counts)
            tables = [server.store.db.exec(q) for q in ('SELECT * FROM "message" ORDER BY 1, 2',
                                                        'SELECT * FROM "merkleTree" ORDER BY 1')]
        finally:
            server.stop()
        sides.append((got, tables, counts["coalesced"], cuda_hash.timestamp_hash_cuda.launches - before))
    (card, card_tables, card_coalesced, card_h), (cpu, cpu_tables, cpu_coalesced, cpu_h) = sides
    assert len(card) == 16 and card == cpu and card_tables == cpu_tables
    assert card_coalesced == cpu_coalesced == 16
    assert card_h >= 2 and cpu_h == 0

@pytest.mark.parametrize("fault", ["native rerun synchronize", "python synchronize", "native pull event"])
def test_device_fault_fails_the_batch_on_card(fault, monkeypatch, dev):
    """A CUDA error that torch raises on a batch's device leg on the card
    fails every member of the batch as a KernelError: no poisoned-batch
    singleton retry on the host path, nothing stored. The batch spreads
    its rows over one minute each, so the compact outputs overflow and the
    full-width rerun pulls with a device-wide synchronize on the
    dispatcher thread; the pull thread waits on the batch's event."""
    import threading

    from evolu_tpu_torch.server.relay import RelayStore
    from evolu_tpu_torch.server.scheduler import SyncScheduler

    def broken(*_a, **_kw):
        raise RuntimeError("CUDA error: an illegal memory access was encountered (injected)")

    if fault == "native pull event":
        monkeypatch.setattr(torch.cuda.Event, "synchronize", broken)
    else:
        monkeypatch.setattr(torch.cuda, "synchronize", broken)
    batch = _relay_batches()[3]
    store = RelayStore(backend="python" if fault.startswith("python") else "native")
    sched = SyncScheduler(store, max_batch=len(batch), max_wait_s=0.2)
    errors = {}

    def submit(r):
        try:
            sched.submit(r)
        except Exception as e:  # noqa: BLE001 - the outcome under test
            errors[r.user_id] = e

    try:
        threads = [threading.Thread(target=submit, args=(r,)) for r in batch]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        counts = dict(sched.counts)
    finally:
        sched.stop()
    assert len(errors) == len(batch)
    assert all(isinstance(e, cuda_lib.KernelError) for e in errors.values()), errors
    assert counts["singles"] == 0 and counts["poison_retries"] == 0 and counts["poisoned_batches"] == 0
    assert store.db.exec('SELECT * FROM "message"') == [] and store.db.exec('SELECT * FROM "merkleTree"') == []
    store.close()


@pytest.mark.parametrize("winner_cache", [True, False])
def test_packed_plan_on_card_matches_cpu(winner_cache, dev):
    """A `PackedReceive` from the native decrypt, planned by the worker's
    `plan_packed` (the winner cache's, or winners streamed from SQLite) on
    the card and on the CPU, over twin native databases: equal masks,
    deltas, trees and tables; every batch on the packed route, with L, H
    and X launched on the card."""
    from evolu_tpu_torch.runtime.worker import select_planner
    from evolu_tpu_torch.storage import apply as papply
    from evolu_tpu_torch.storage import CppSqliteDatabase, apply_messages, init_db_model
    from evolu_tpu_torch.sync import native_crypto, protocol
    from evolu_tpu_torch.utils.config import Config

    mnemonic = "legal winner thank year wave sausage worth useful legal winner thank yellow"
    batches = []
    for batch in _cache_batches(5, n_batches=4, n=3000):
        body = protocol.encode_sync_response(protocol.SyncResponse(native_crypto.encrypt_batch(batch, mnemonic), "{}"))
        batches.append(body)
    sides = []
    for device in ("cuda", "cpu"):
        db = CppSqliteDatabase()
        init_db_model(db, mnemonic)
        db.exec(_TODO)
        planner = select_planner(Config(backend="cuda", winner_cache=winner_cache), db, device)
        plans, plan_packed = [], planner.plan_packed

        def recording(pb, plans=plans, plan_packed=plan_packed):
            plan = plan_packed(pb)
            plans.append((plan[0].tolist(), plan[1].tolist(), plan[2]))
            return plan

        planner.plan_packed = recording
        sides.append({"db": db, "planner": planner, "plans": plans, "tree": {}})
    counters = (cuda_scan.segmented_max_scan_cuda, cuda_hash.timestamp_hash_cuda,
                cuda_scan.segmented_xor_scan_cuda, cuda_scan.segmented_sum_scan_cuda)
    before, packed_before = [c.launches for c in counters], papply.counts["packed"]
    for body in batches:
        for side in sides:
            pb, _tree = native_crypto.decrypt_response_columns(body, mnemonic)
            side["tree"] = apply_messages(side["db"], side["tree"], pb, planner=side["planner"])
    launched = [c.launches - b for c, b in zip(counters, before)]
    card, cpu = sides
    assert card["plans"] == cpu["plans"] and len(card["plans"]) == len(batches)
    assert papply.counts["packed"] - packed_before == 2 * len(batches)
    assert launched == [2 * len(batches), len(batches), len(batches), 0], launched
    assert card["tree"] == cpu["tree"]
    for t in ("__message", "todo"):
        q = f'SELECT * FROM "{t}" ORDER BY 1, 2'
        assert card["db"].exec(q) == cpu["db"].exec(q)


# ---- the client handle with encrypted sync on the card ---------------------------


def _handles_through_relay(device):
    """Two owners, two `create_evolu` clients each (`Config(backend="cuda")`,
    so every batch is device-planned), syncing through one relay
    (`BatchReconciler(RelayStore(backend="python"))` on `device`) with a SyncTransport each.
    Each owner's script runs on its own thread, so two owners' workers
    launch on the card at once. → every client's tables and the relay's."""
    import itertools
    import threading

    from evolu_tpu_torch.core import timestamp as ts_mod
    from evolu_tpu_torch.runtime.client import create_evolu
    from evolu_tpu_torch.runtime.synclock import SyncLock
    from evolu_tpu_torch.server.engine import BatchReconciler
    from evolu_tpu_torch.server.relay import RelayStore
    from evolu_tpu_torch.sync import protocol
    from evolu_tpu_torch.sync.client import SyncTransport
    from evolu_tpu_torch.utils.config import Config

    mnemonics = ("legal winner thank year wave sausage worth useful legal winner thank yellow",
                 "letter advice cage absurd amount doctor acoustic avoid letter advice cage above")
    engine, lock = BatchReconciler(RelayStore(backend="python"), device=device), threading.Lock()

    def post(url, body):
        with lock:
            return engine.run_batch_wire([protocol.decode_sync_request(body)])[0]

    nodes, node = itertools.count(1), ts_mod.create_node_id
    ts_mod.create_node_id = lambda: f"{next(nodes):016x}"
    pairs = []
    try:
        for m in mnemonics:
            pair = []
            for _ in range(2):
                e = create_evolu({"todo": ("title", "done")}, config=Config(backend="cuda"), mnemonic=m,
                                 device=device)
                clock = itertools.count(1_700_000_000_000, 60_000)  # a minute a command
                e.worker.now = lambda c=clock: next(c)
                e._now_iso = lambda: "2024-01-01T00:00:00.000Z"
                e.worker.sync_lock = SyncLock()  # owners do not wait on each other
                t = SyncTransport(e.config, on_receive=e.receive, sync_lock=e.worker.sync_lock, http_post=post)
                e.attach_transport(t)
                pair.append(e)
            pairs.append(pair)
    finally:
        ts_mod.create_node_id = node

    def settle(e):
        while True:
            n = e._transport.counts.get("requests", 0)
            e.worker.flush(); e._transport.flush(); e.worker.flush()
            if e._transport.counts.get("requests", 0) == n:
                return

    def drive(o, a, b, errors):
        try:
            for r in range(5):
                with a.batching():
                    for i in range(700):
                        a.update("todo", f"row{(i * 7 + r) % 400}", {"title": f"o{o}r{r}i{i}", "done": i % 3})
                settle(a)
                b.sync()
                settle(b)
            with b.batching():
                for i in range(600):
                    b.update("todo", f"row{i % 300}", {"done": -i})
            settle(b)
            a.sync()
            settle(a)
        except BaseException as e:  # noqa: BLE001 - reported on the test thread
            errors.append(e)

    errors = []
    threads = [threading.Thread(target=drive, args=(o, *pair, errors)) for o, pair in enumerate(pairs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    try:
        assert not any(t.is_alive() for t in threads) and not errors, errors
        assert all(e.get_error() is None for pair in pairs for e in pair)
        dumps = [{t: e.db.exec(f'SELECT * FROM "{t}" ORDER BY 1, 2') for t in ("__message", "todo", "__clock")}
                 for pair in pairs for e in pair]
        relay = [engine.store.db.exec(q) for q in ('SELECT "userId", "timestamp" FROM "message" ORDER BY 1, 2',
                                                   'SELECT * FROM "merkleTree" ORDER BY 1')]
        return dumps, relay
    finally:
        for pair in pairs:
            for e in pair:
                e.dispose()


def test_two_clients_sync_on_card_match_cpu(dev):
    """Path F in small: clients on the card (their workers on two threads
    at once, every batch device-planned, the relay's Merkle pass on the
    card too) end with the same tables and relay as the same scripts on
    `device="cpu"`; L, H and X launched."""
    before = {f: f.launches for f in (cuda_scan.segmented_max_scan_cuda, cuda_scan.segmented_xor_scan_cuda,
                                      cuda_hash.timestamp_hash_cuda)}
    got = _handles_through_relay(None)
    assert all(f.launches > n for f, n in before.items())
    want = _handles_through_relay("cpu")
    assert got == want
    assert len(got[0][0]["__message"]) == 5 * 700 * 3 + 600 * 2  # title, done, updatedAt; done, updatedAt


def _relay_tables(store):
    return [store.db.exec(q) for q in ('SELECT * FROM "message" ORDER BY 1, 2',
                                       'SELECT * FROM "merkleTree" ORDER BY 1')]


def _wait(pred, what, deadline_s=120.0):
    import time

    deadline = time.time() + deadline_s
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def test_relay_replication_on_card_matches_cpu(dev):
    """Anti-entropy between relays with the ingest on the card: a listener
    holding 16 owners' first deliveries (about 12k messages) and a fresh
    batching relay on the card whose `ReplicationManager.run_once` submits
    the pulled messages through its card scheduler. Every request is
    coalesced into engine passes; H and X launch once a pass (reruns
    included), L and S never; the tables equal a `device="cpu"` pair's."""
    from evolu_tpu_torch.server import engine as eng
    from evolu_tpu_torch.server.relay import RelayServer, RelayStore
    from evolu_tpu_torch.server.replicate import ReplicationManager

    first = _relay_batches()[0][:16]
    fns = (cuda_scan.segmented_max_scan_cuda, cuda_scan.segmented_xor_scan_cuda,
           cuda_hash.timestamp_hash_cuda, cuda_scan.segmented_sum_scan_cuda)
    sides = []
    for d in (None, "cpu"):
        donor = RelayServer(RelayStore(backend="native"), peers=[], device=d).start()
        fresh = RelayServer(RelayStore(backend="native"), batching=True, device=d).start()
        mgr = None
        try:
            for r in first:
                donor.store.add_messages(r.user_id, r.messages)
            mgr = ReplicationManager(fresh.store, [donor.url], scheduler=fresh.scheduler)
            before = [f.launches for f in fns]
            overflow = eng.counts["overflow"]
            mgr.run_once()
            launches = [f.launches - n for f, n in zip(fns, before)]
            counts = dict(fresh.scheduler.counts)
            tables = (_relay_tables(donor.store), _relay_tables(fresh.store))
            sides.append((tables, counts, launches, eng.counts["overflow"] - overflow,
                          mgr.peer_counts[donor.url]["messages_pulled"]))
        finally:
            if mgr is not None:
                mgr.stop()
            fresh.stop()
            donor.stop()
    (card_tables, card_counts, card_launches, card_over, pulled), (cpu_tables, cpu_counts, cpu_launches, _o, _p) = sides
    assert card_tables[0] == card_tables[1] == cpu_tables[0] == cpu_tables[1]
    assert pulled == sum(len(r.messages) for r in first)
    assert card_counts["coalesced"] == cpu_counts["coalesced"] == 16
    assert card_counts["singles"] == card_counts["poisoned_batches"] == card_counts["rejected"] == 0
    passes = card_counts["batches"] + card_over
    assert card_launches == [0, passes, passes, 0] and passes >= 1 and cpu_launches == [0, 0, 0, 0]


def test_snapshot_bootstrap_between_card_relays(dev):
    """A card relay `C(peers=[D], bootstrap_lag_owners=1)` cold-starts from
    a card donor D in one snapshot: the install and verify run on the host,
    so H and X do not launch during it. Then 10 new messages POSTed to D
    reach C by gossip: H and X launch once a pass of D's and C's card
    schedulers, and C's tables equal D's."""
    import urllib.request

    from evolu_tpu_torch.server.relay import RelayServer, RelayStore
    from evolu_tpu_torch.sync import protocol as pp

    first = _relay_batches()[0][:16]
    h, x = cuda_hash.timestamp_hash_cuda, cuda_scan.segmented_xor_scan_cuda
    donor = RelayServer(RelayStore(backend="native"), batching=True, peers=[]).start()
    fresh = None
    try:
        for r in first:
            with urllib.request.urlopen(urllib.request.Request(donor.url, data=pp.encode_sync_request(r)),
                                        timeout=60):
                pass
        before = (h.launches, x.launches)
        fresh = RelayServer(RelayStore(backend="native"), batching=True, peers=[donor.url],
                            bootstrap_lag_owners=1, replication_interval_s=3600).start()
        peer = lambda: fresh.replication.peer_counts.get(donor.url, {})  # noqa: E731
        # The bootstrap round, then the round its hint arms (nothing to pull).
        _wait(lambda: peer().get("rounds_ok", 0) >= 2, "the bootstrap and its follow-up round")
        assert peer()["snapshot_bootstraps"] == 1 and peer()["messages_pulled"] == 0
        assert (h.launches, x.launches) == before
        assert _relay_tables(fresh.store) == _relay_tables(donor.store)
        # The owner's first 10 stamps moved to 2031: new rows past the capture.
        later = tuple(pp.EncryptedCrdtMessage("2031" + m.timestamp[4:], b"tail%d" % i)
                      for i, m in enumerate(first[0].messages[:10]))
        tail = pp.SyncRequest(later, first[0].user_id, "f" * 16, "{}")
        d_batches, c_batches = donor.scheduler.counts["batches"], fresh.scheduler.counts["batches"]
        with urllib.request.urlopen(urllib.request.Request(donor.url, data=pp.encode_sync_request(tail)),
                                    timeout=60):
            pass
        fresh.replication.run_once()
        passes = (donor.scheduler.counts["batches"] - d_batches) + (fresh.scheduler.counts["batches"] - c_batches)
        assert peer()["messages_pulled"] == 10
        assert (h.launches - before[0], x.launches - before[1]) == (passes, passes) and passes == 2
        assert _relay_tables(fresh.store) == _relay_tables(donor.store)
    finally:
        if fresh is not None:
            fresh.stop()
        donor.stop()


def _park(server, owner, box, timeout=30):
    import threading
    import urllib.request

    url = f"{server.url}/push/poll?owner={owner}&node={'5' * 16}&cursor=0&timeout={timeout}"

    def poll():
        with urllib.request.urlopen(url, timeout=timeout + 10) as r:
            box["body"] = r.read()

    th = threading.Thread(target=poll)
    th.start()
    _wait(lambda: server.push_hub.stats_payload()["subscriptions"] == 1, "the parked poll", 30)
    return th


def test_push_wake_on_event_tier_card_relay(dev):
    """An event-tier batching relay on the card (`device=None`) serves a
    push wake: a long-poll parked as a bare connection wakes on a foreign
    POST whose one engine pass launches H and X once each, L and S not at
    all; the answers and tables equal those of the same relay on the CPU."""
    import urllib.request

    from evolu_tpu_torch.server.relay import RelayServer, RelayStore
    from evolu_tpu_torch.sync import protocol as pp

    req = _relay_batches()[0][0]
    kernels = (cuda_scan.segmented_max_scan_cuda, cuda_hash.timestamp_hash_cuda,
               cuda_scan.segmented_xor_scan_cuda, cuda_scan.segmented_sum_scan_cuda)
    sides = []
    for d in (None, "cpu"):
        server = RelayServer(RelayStore(backend="native"), batching=True, device=d,
                             connection_tier="eventloop").start()
        try:
            box = {}
            th = _park(server, req.user_id, box)
            before = [k.launches for k in kernels]
            with urllib.request.urlopen(urllib.request.Request(server.url, data=pp.encode_sync_request(req)),
                                        timeout=60) as r:
                answer = r.read()
            th.join(30)
            launches = [k.launches - b for k, b in zip(kernels, before)]
            passes = server.scheduler.counts["batches"]
            tables = _relay_tables(server.store)
            stats = server.push_hub.stats_payload()
        finally:
            server.stop()
        sides.append((answer, box.get("body"), tables, stats, passes, launches))
    (card, card_body, card_tables, card_stats, card_passes, card_launches), cpu = sides[0], sides[1]
    assert (card, card_body, card_tables, card_stats) == cpu[:4]
    assert card_body == b'{"wake": true, "cursor": 1}' and card_stats["wakeups_total"]["write"] == 1
    assert card_passes == cpu[4] == 1
    assert card_launches == [0, 1, 1, 0] and cpu[5] == [0, 0, 0, 0]


def test_stop_returns_with_a_threaded_long_poll_parked(dev):
    """`RelayServer.stop()` on a batching card relay of the threaded tier
    returns within 2 s while a long-poll holds a handler thread: the hub
    closes first and the poll answers wake=false."""
    import time

    from evolu_tpu_torch.server.relay import RelayServer, RelayStore

    server = RelayServer(RelayStore(backend="native"), batching=True, connection_tier="threaded").start()
    box = {}
    th = _park(server, "owner000", box)
    t0 = time.monotonic()
    server.stop()
    took = time.monotonic() - t0
    th.join(10)
    assert took < 2.0 and box["body"] == b'{"wake": false, "cursor": 0}'


def _wb_dump(store):
    stores = store.shards if hasattr(store, "shards") else [store]
    return [sorted(r for s in stores for r in s.db.exec(q))
            for q in ('SELECT * FROM "message"', 'SELECT * FROM "merkleTree"')]


@pytest.mark.parametrize("shards", [1, 4])
def test_deferred_pass_on_card_matches_synchronous(shards, dev):
    """The write-behind serve (`run_batch_wire` with a `WriteBehindQueue`) on
    the card against the synchronous pass on the card over the same
    batches: equal bytes, equal tables after `flush()`; H and X launch once
    an engine dispatch (twice for the cap overflow's rerun, never for a
    batch without rows), L and S never."""
    from evolu_tpu_torch.server import engine as pe
    from evolu_tpu_torch.server.relay import RelayStore, ShardedRelayStore
    from evolu_tpu_torch.storage.write_behind import WriteBehindQueue

    def store():
        return RelayStore(backend="native") if shards == 1 else ShardedRelayStore(shards=shards, backend="native")

    batches = _relay_batches()
    wb_store, sync_store = store(), store()
    wb = WriteBehindQueue(wb_store)
    deferred = pe.BatchReconciler(wb_store, write_behind=wb)
    synchronous = pe.BatchReconciler(sync_store)
    kernels = (cuda_hash.timestamp_hash_cuda, cuda_scan.segmented_xor_scan_cuda,
               cuda_scan.segmented_max_scan_cuda, cuda_scan.segmented_sum_scan_cuda)
    try:
        for b in batches:
            before = dict(pe.counts)
            launched = [k.launches for k in kernels]
            out = deferred.run_batch_wire(b)
            dispatches = sum(pe.counts[k] - before[k] for k in ("delta", "full", "overflow"))
            assert [k.launches - n for k, n in zip(kernels, launched)] == [dispatches, dispatches, 0, 0]
            assert dispatches == (0 if not any(r.messages for r in b) else 1 + pe.counts["overflow"] - before["overflow"])
            assert pe.counts["deferred_passes"] - before["deferred_passes"] == 1
            assert out == synchronous.run_batch_wire(b)
        wb.flush()
        assert _wb_dump(wb_store) == _wb_dump(sync_store)
        assert wb.counts["queued"] == wb.counts["drained"] == wb.counts["inserted"] + wb.counts["duplicate"]
    finally:
        wb.close()
        deferred.close()
        synchronous.close()
        wb_store.close()
        sync_store.close()


def test_drain_and_dispatcher_never_deadlock_under_the_barrier(dev):
    """A batching card relay with write-behind on 4 native shards: 8 client
    threads push and pull while another thread takes `drain_barrier()`
    again and again (as checkpoints and replication serves do) and the
    drain is slowed. Everything finishes inside its time limit, and the
    drained tables equal a synchronous relay's on the card."""
    import threading
    import time

    from evolu_tpu_torch.server.relay import RelayServer, ShardedRelayStore
    from evolu_tpu_torch.sync.client import _http_post
    from evolu_tpu_torch.sync import protocol as pp

    first, again, cold = _relay_batches()[:3]
    lanes = [[first[o], again[o], cold[o % len(cold)]] for o in range(8)]
    sides = []
    for wb_on in (True, False):
        server = RelayServer(ShardedRelayStore(shards=4, backend="native"), batching=True,
                             write_behind=wb_on).start()
        if wb_on:
            server.write_behind._drain_delay_s = 0.01
        stop, barriers, errors = threading.Event(), [0], []

        def barrier_loop():
            while not stop.is_set():
                with server.write_behind.drain_barrier():
                    barriers[0] += 1
                time.sleep(0.002)

        def lane(o):
            try:
                for r in lanes[o]:
                    _http_post(server.url, pp.encode_sync_request(r))
            except BaseException as e:  # noqa: BLE001 - reported below
                errors.append(e)

        threads = [threading.Thread(target=lane, args=(o,), daemon=True) for o in range(8)]
        if wb_on:
            threads.append(threading.Thread(target=barrier_loop, daemon=True))
        try:
            for t in threads:
                t.start()
            for t in threads[:8]:
                t.join(120)
            stop.set()
            for t in threads[8:]:
                t.join(60)
            assert not any(t.is_alive() for t in threads), "a lane or the barrier thread hung"
            assert not errors, errors
            if wb_on:
                assert barriers[0] > 0
                server.write_behind.flush(timeout=60)
            sides.append(_wb_dump(server.store))
        finally:
            stop.set()
            server.stop()
    assert sides[0] == sides[1]


def _scope_stamps(n, seed):
    """`n` canonical timestamp strings over a few hours, unique."""
    from evolu_tpu_torch.core.timestamp import timestamp_to_string
    from evolu_tpu_torch.core.types import Timestamp

    rng = np.random.default_rng(seed)
    millis = 1_700_000_000_000 + np.sort(rng.integers(0, 4 * 3_600_000, n))
    return [timestamp_to_string(Timestamp(int(m), i % 65536, f"{int(rng.integers(0, 2**63)):016x}"))
            for i, m in enumerate(millis)]


@pytest.mark.parametrize("n", [1024, 1 << 16, 1 << 20])
def test_scoped_fold_on_card_matches_host_and_cpu(n, dev):
    """`scoped_minute_deltas` with a 10% slice mask on the card equals the
    host fold and the `device="cpu"` fold; H and X launch once a device
    fold, and nothing launches on the host route (a batch below the
    threshold, and a batch with upper-case node hex)."""
    from evolu_tpu_torch.core.merkle import minute_deltas_host
    from evolu_tpu_torch.server import scope

    ts = _scope_stamps(n, n)
    mask = np.random.default_rng(n + 1).random(n) < 0.1
    kernels = (cuda_hash.timestamp_hash_cuda, cuda_scan.segmented_xor_scan_cuda,
               cuda_scan.segmented_max_scan_cuda, cuda_scan.segmented_sum_scan_cuda)
    before, counts = [k.launches for k in kernels], dict(scope.counts)
    got = scope.scoped_minute_deltas(ts, mask)
    assert [k.launches - b for k, b in zip(kernels, before)] == [1, 1, 0, 0]
    assert scope.counts["fold_device"] - counts["fold_device"] == 1
    want, _ = minute_deltas_host(t for t, keep in zip(ts, mask) if keep)
    assert got == want == scope.scoped_minute_deltas(ts, mask, device="cpu")
    before = [k.launches for k in kernels]
    scope.scoped_minute_deltas(ts[:scope.SCOPE_DEVICE_FOLD_MIN - 1], mask[:scope.SCOPE_DEVICE_FOLD_MIN - 1])
    upper = [t[:30] + t[30:].upper() for t in ts[:2048]]
    assert scope.scoped_minute_deltas(upper, mask[:2048]) == minute_deltas_host(
        t for t, keep in zip(upper, mask[:2048]) if keep)[0]
    assert [k.launches for k in kernels] == before


def _scoped_requests(seed, owners=16, per=600):
    """Per owner: a tagged push of two lanes from its own node, then a
    pull of one lane past a watermark from a fresh node, and the same pull
    with the tree it was answered is left to the caller."""
    from evolu_tpu_torch.sync import protocol as pp

    base = 1_700_000_000_000
    stamps = _scope_stamps(owners * per, seed)
    pushes, pulls = [], []
    for o in range(owners):
        own = [s[:30] + f"{o:016x}" for s in stamps[o * per:(o + 1) * per]]
        msgs = tuple(pp.EncryptedCrdtMessage(s, b"c%d" % i) for i, s in enumerate(own))
        clause = pp.ScopeClause(0, ("a" * 16,), tuple(("a" * 16, "b" * 16)[i % 2] for i in range(per)))
        pushes.append(pp.SyncRequest(msgs, f"owner{o:03d}", f"{o:016x}", "{}", (pp.CAP_SYNC_SCOPE,), clause))
        pulls.append(pp.SyncRequest((), f"owner{o:03d}", "f" * 16, "{}", (pp.CAP_SYNC_SCOPE,),
                                    pp.ScopeClause(base + 3_600_000, ("a" * 16,), ())))
    return pushes, pulls


def test_scoped_respond_under_write_behind_on_card_matches_synchronous(dev):
    """Scoped pushes and pulls through `run_batch_wire` with a
    `WriteBehindQueue` on the card answer the synchronous card engine's
    bytes (the scoped respond waits for its owner's drain), and the drained
    tables and lanes are equal."""
    from evolu_tpu_torch.server import engine as pe
    from evolu_tpu_torch.server import scope
    from evolu_tpu_torch.server.relay import RelayStore
    from evolu_tpu_torch.storage.write_behind import WriteBehindQueue

    pushes, pulls = _scoped_requests(31)
    out = []
    for wb_on in (True, False):
        scope.tree_cache.reset()
        store = RelayStore(backend="native")
        wb = WriteBehindQueue(store) if wb_on else None
        eng = pe.BatchReconciler(store, write_behind=wb)
        try:
            answers = [eng.run_batch_wire(pushes[:8] + pulls[8:]), eng.run_batch_wire(pushes[8:] + pulls[:8])]
            if wb is not None:
                wb.flush()
            out.append((answers, _wb_dump(store), store.db.exec('SELECT * FROM "scopeLane" ORDER BY 1, 2')))
        finally:
            if wb is not None:
                wb.close()
            eng.close()
            store.close()
    assert out[0] == out[1]
    assert len(out[0][2]) == 16 * 600


def test_multiprocess_scoped_post_on_card_matches_cpu(tmp_path, dev):
    """A `MultiprocessRelay` on the default device (the card) answers a
    scoped pull of 1,100 canonical candidates (a device fold) with the
    bytes of one whose workers fold on "cpu"."""
    from evolu_tpu_torch.core.timestamp import timestamp_to_string
    from evolu_tpu_torch.core.types import Timestamp
    from evolu_tpu_torch.server.relay import MultiprocessRelay
    from evolu_tpu_torch.sync import protocol as pp

    base, user, node = 1_700_000_000_000, "scoped-owner", "a" * 16
    push = pp.SyncRequest(tuple(pp.EncryptedCrdtMessage(timestamp_to_string(Timestamp(base + i * 1000, 0, node)),
                                                        b"ct-%d" % i) for i in range(1200)), user, node, "{}")
    pull = pp.SyncRequest((), user, "f" * 16, "{}", (pp.CAP_SYNC_SCOPE,), pp.ScopeClause(base + 100 * 1000))
    answers = []
    for device in (None, "cpu"):
        relay = MultiprocessRelay(str(tmp_path / f"relay-{device}.db"), workers=2, shards=4, device=device).start()
        try:
            for req in (push, pull):
                with urllib.request.urlopen(urllib.request.Request(
                        relay.url, data=pp.encode_sync_request(req),
                        headers={"Content-Type": "application/octet-stream"}), timeout=60) as r:
                    body = r.read()
            answers.append(body)
        finally:
            relay.stop()
    assert answers[0] == answers[1]
    assert len(pp.decode_sync_response(answers[0]).messages) == 1100


def test_scoped_card_worker_after_a_deferred_batch_matches_cpu(dev):
    """A scoped `DbWorker` on the card (`backend="cuda"`, the winner cache
    on) against a scoped `backend="cpu"` worker: a steady population in
    both tables from local writes, a Receive that defers a newer foreign
    write to a cached out-of-scope cell, then in-scope Receives and a
    widening. Equal outputs, pushes, tables and frontiers; the cache audit
    passes after every batch (the deferred leg invalidated the cell)."""
    from evolu_tpu_torch.core.timestamp import timestamp_to_string
    from evolu_tpu_torch.core.types import CrdtMessage, NewCrdtMessage, TableDefinition, Timestamp
    from evolu_tpu_torch.runtime import messages as msg
    from evolu_tpu_torch.runtime.worker import DbWorker
    from evolu_tpu_torch.storage import PySqliteDatabase
    from evolu_tpu_torch.sync.scope import SyncScope
    from evolu_tpu_torch.utils.config import Config
    import evolu_tpu_torch.core.timestamp as ts_mod

    now = 1_700_000_000_000
    mnemonic = "legal winner thank year wave sausage worth useful legal winner thank yellow"
    sides = []
    for backend in ("cuda", "cpu"):
        outs, pushes = [], []
        ticks = iter(range(now, now + 10**9, 1000))
        w = DbWorker(PySqliteDatabase(), Config(backend=backend, receive_chunk_size=500,
                                                sync_scope=SyncScope(tables=("todo",))),
                     on_output=outs.append, post_sync=pushes.append, now=lambda t=ticks: next(t))
        sides.append((w, outs, pushes))
    node = ts_mod.create_node_id
    ts_mod.create_node_id = lambda: "0f1e2d3c4b5a6978"
    try:
        for w, _, _ in sides:
            w.start(mnemonic)
    finally:
        ts_mod.create_node_id = node
    rng = np.random.default_rng(5)

    def remote(n, base, span):
        out, used = [], set()
        while len(out) < n:
            ts = timestamp_to_string(Timestamp(base + int(rng.integers(0, span)), 0, f"{int(rng.integers(1, 9)):016x}"))
            if ts not in used:
                used.add(ts)
                table = ("todo", "todoCategory")[int(rng.integers(0, 2))]
                out.append(CrdtMessage(ts, table, f"r{int(rng.integers(0, 40))}", ("title", "name")[table != "todo"],
                                       f"v{len(out)}"))
        return tuple(out)

    q = (msg.serialize_query('SELECT * FROM "todo" ORDER BY "id"'),
         msg.serialize_query('SELECT * FROM "todoCategory" ORDER BY "id"'))
    script = [msg.UpdateDbSchema((TableDefinition.of("todo", ("title",)),
                                  TableDefinition.of("todoCategory", ("name",))))]
    script += [msg.Send((NewCrdtMessage("todoCategory", "r1", "name", f"m{k}"),
                         NewCrdtMessage("todo", "r1", "title", f"t{k}")), (), q) for k in range(6)]
    script += [msg.Receive((CrdtMessage(timestamp_to_string(Timestamp(now + 40_000, 0, "0000000000000001")),
                                        "todoCategory", "r1", "name", "theirs"),
                            CrdtMessage(timestamp_to_string(Timestamp(now + 41_000, 0, "0000000000000001")),
                                        "todo", "r1", "title", "theirs")), "{}", None)]
    script += [msg.Receive(remote(1500, now + 2_000, 50_000), "{}", None), msg.Query(q),
               msg.WidenSyncScope(tables=("todoCategory",)),
               msg.Send((NewCrdtMessage("todoCategory", "r1", "name", "again"),), (), q),
               msg.Receive(remote(1500, now + 2_000, 50_000), "{}", None), msg.Query(q)]
    audits = []
    try:
        for command in script:
            for w, _, _ in sides:
                w.post(command)
                w.flush()
            audits.append(sides[0][0].verify_winner_cache())
            assert sides[0][0]._deferred_frontier() == sides[1][0]._deferred_frontier()
        names = ("__message", "__clock", "todo", "todoCategory", "__scope_deferred")
        tables = [{t: w.db.exec(f'SELECT * FROM "{t}" ORDER BY 1') for t in names} for w, _, _ in sides]
        assert tables[0] == tables[1]
        assert [(type(o).__name__, getattr(o, "queries_patches", None)) for o in sides[0][1]] == \
            [(type(o).__name__, getattr(o, "queries_patches", None)) for o in sides[1][1]]
        assert [(r.messages, r.merkle_tree) for r in sides[0][2]] == [(r.messages, r.merkle_tree) for r in sides[1][2]]
        assert sides[0][0]._planner.cache.counts["invalidated_cells"] > 0 and max(audits) > 0
    finally:
        for w, _, _ in sides:
            w.stop()


# ---- the scatter-argmax LWW plan on the card ------------------------------------


def _plan_columns(seed, n, cells, kind, size):
    """Planner columns padded to `size` with the padding cell: "random",
    "tie heavy" (equal millis, counters and few nodes) or "u64 edges" (k1
    and nodes at and past 2^63, real rows with all-zero keys). About 60%
    of cells have a stored winner; 10% of rows equal theirs. Duplicate
    (cell, k1, k2) rows are dropped, as the router requires."""
    rng = np.random.default_rng(seed)
    cell_id = rng.integers(0, cells, n).astype(np.int32)
    if kind == "tie heavy":
        k1 = ((1_700_000_000_000 + rng.integers(0, 3, n)).astype(np.uint64) << np.uint64(16)) \
            | rng.integers(0, 2, n).astype(np.uint64)
        k2 = rng.integers(1, 5, n).astype(np.uint64)
    else:
        k1 = ((1_700_000_000_000 + rng.integers(0, 86_400_000, n)).astype(np.uint64) << np.uint64(16)) \
            | rng.integers(0, 256, n).astype(np.uint64)
        k2 = rng.integers(1, 2**63, n).astype(np.uint64)
    if kind == "u64 edges":
        hi = np.uint64(1) << np.uint64(63)
        k1[rng.random(n) < 0.4] |= hi
        k2[rng.random(n) < 0.4] |= hi
        zero = rng.random(n) < 0.02
        k1[zero] = 0
        k2[zero] = 0
    has = rng.random(cells) < 0.6
    w1 = k1[rng.integers(0, n, cells)]
    w2 = rng.integers(0, 2**64, cells, dtype=np.uint64)
    ex_k1 = np.where(has, w1, 0)[cell_id].astype(np.uint64)
    ex_k2 = np.where(has, w2, 0)[cell_id].astype(np.uint64)
    eq = (rng.random(n) < 0.1) & has[cell_id]
    k1 = np.where(eq, ex_k1, k1)
    k2 = np.where(eq, ex_k2, k2)
    key = np.stack([cell_id.astype(np.uint64), k1, k2], axis=1)
    _, first = np.unique(key, axis=0, return_index=True)
    keep = np.sort(first)
    cols = [cell_id[keep], k1[keep], k2[keep], ex_k1[keep], ex_k2[keep]]
    pad = size - len(keep)
    return [np.concatenate([c, np.full(pad, 0x7FFFFFFF if j == 0 else 0, c.dtype)])
            for j, c in enumerate(cols)]


def _plan_tensors(cols, device):
    from evolu_tpu_torch.ops import columns_to_device

    names = ("cell_id", "k1", "k2", "ex_k1", "ex_k2")
    t = columns_to_device(dict(zip(names, cols)), device)
    return [t[k] for k in names]


_LWW_COUNTERS = {"L": cuda_scan.segmented_max_scan_cuda, "H": cuda_hash.timestamp_hash_cuda,
                 "X": cuda_scan.segmented_xor_scan_cuda, "S": cuda_scan.segmented_sum_scan_cuda}


def _launches():
    return {k: c.launches for k, c in _LWW_COUNTERS.items()}


@pytest.mark.parametrize("kind", ["random", "tie heavy", "u64 edges"])
@pytest.mark.parametrize("cells,n,size", [(48, 3000, 4096), ((1 << 22) - 1, 200_000, 1 << 18)])
def test_scatter_plan_on_card_matches_cpu_and_the_sort_route(kind, cells, n, size, dev):
    """`scatter_plan_masks` on the card equals its `device="cpu"` result
    and the card's sort route (`plan_merge_core`), with pad rows, at a
    64-slot table and at one of 2^22 slots."""
    from evolu_tpu_torch.ops import merge as pm
    from evolu_tpu_torch.ops import scatter_merge as psm

    cols = _plan_columns(cells, n, cells, kind, size)
    real = cols[0] != 0x7FFFFFFF
    table = psm.table_size_for(int(cols[0][real].max()))
    assert table == (64 if cells < 64 else 1 << 22)
    assert not psm.batch_has_duplicate_keys(cols[0], cols[1], cols[2]) and not real.all()
    card = [m.cpu().numpy() for m in psm.scatter_plan_masks(*_plan_tensors(cols, "cuda"), table)]
    cpu = [m.numpy() for m in psm.scatter_plan_masks(*_plan_tensors(cols, "cpu"), table)]
    sort = [m.cpu().numpy() for m in pm.plan_merge_core(*_plan_tensors(cols, "cuda"))]
    for got in (cpu, sort):
        assert np.array_equal(card[0], got[0]) and np.array_equal(card[1], got[1])
    assert card[0].any() and card[1].any() and not card[0][~real].any() and not card[1][~real].any()


def test_scatter_shard_kernel_on_card_matches_cpu_and_the_packed_kernel(dev):
    """The fleet reconcile's scatter kernel on the card: its decoded plan,
    deltas and digest equal its `device="cpu"` result and the packed sort
    kernel's; it launches H and X once each and L never."""
    from evolu_tpu_torch.ops import columns_to_device
    from evolu_tpu_torch.ops import merge as pm
    from evolu_tpu_torch.ops import scatter_merge as psm
    from evolu_tpu_torch.ops.merkle_ops import decode_owner_minute_deltas
    from evolu_tpu_torch.parallel import reconcile as pr

    cols = dict(zip(("cell_id", "k1", "k2", "ex_k1", "ex_k2"), _plan_columns(3, 60_000, 16_000, "u64 edges", 1 << 16)))
    real = cols["cell_id"] != 0x7FFFFFFF
    cols["owner_ix"] = np.where(real, cols["cell_id"] % 97, 0).astype(np.int64)
    table = psm.table_size_for(int(cols["cell_id"][real].max()))
    psm.set_plan_path("scatter")
    try:
        assert pr.shard_kernel_for(cols, "cuda") is pr.scatter_shard_kernel(table)
    finally:
        psm.set_plan_path("auto")

    def decoded(kernel, device):
        t = columns_to_device(cols, device)
        xor_s, upsert_s, i_s, *segs, digest = (o.cpu().numpy() for o in kernel(*(t[k] for k in pr.COLUMN_NAMES)))
        return (*pm.unpermute_masks(xor_s, upsert_s, i_s), decode_owner_minute_deltas(*segs),
                int(digest.view(np.uint32)[0]))

    before = _launches()
    card = decoded(pr.scatter_shard_kernel(table), "cuda")
    launched = {k: v - before[k] for k, v in _launches().items()}
    assert launched == {"L": 0, "H": 1, "X": 1, "S": 0}, launched
    for other in (decoded(pr.scatter_shard_kernel(table), "cpu"), decoded(pr._shard_kernel, "cuda")):
        assert np.array_equal(card[0], other[0]) and np.array_equal(card[1], other[1])
        assert card[2] == other[2] and card[3] == other[3]


def _planner_messages(seed, n=5000, rows=600, dup=False):
    """CrdtMessages over todo cells with stored winners; timestamps unique
    per message unless `dup`, which re-delivers one message."""
    from evolu_tpu_torch.core.timestamp import timestamp_to_string
    from evolu_tpu_torch.core.types import CrdtMessage, Timestamp

    rng = np.random.default_rng(seed)
    msgs, used = [], set()
    while len(msgs) < n:
        ts = timestamp_to_string(Timestamp(1_700_000_000_000 + int(rng.integers(0, 10**8)), int(rng.integers(0, 4)),
                                           f"{int(rng.integers(0, 2**64, dtype=np.uint64)):016x}"))
        if ts not in used:
            used.add(ts)
            msgs.append(CrdtMessage(ts, "todo", f"r{int(rng.integers(0, rows))}",
                                    ("title", "done")[int(rng.integers(0, 2))], f"v{len(msgs)}"))
    if dup:
        msgs.append(msgs[7])
    winners = {(m.table, m.row, m.column): m.timestamp for m in msgs[::9]}
    return msgs, winners


@pytest.mark.parametrize("path,dup,route", [("scatter", False, "scatter"), ("sort", False, "sort"),
                                            ("scatter", True, "sort")])
def test_planners_on_card_route_and_match_cpu(path, dup, route, dev):
    """`plan_batch_device` and `plan_batch_device_full` on the card, pinned
    to each route (a re-delivered message keeps the sort plan), equal the
    host oracle and their `device="cpu"` results; the scatter route
    launches H and X once a full plan, L never."""
    from evolu_tpu_torch.ops import merge as pm
    from evolu_tpu_torch.ops import scatter_merge as psm
    from evolu_tpu_torch.storage.apply import plan_batch

    msgs, winners = _planner_messages(11, dup=dup)
    hx, hu = plan_batch(msgs, winners)
    psm.set_plan_path(path)
    try:
        before, plans = _launches(), dict(psm.counts["merge_plan"])
        card = pm.plan_batch_device(msgs, winners)
        full = pm.plan_batch_device_full(msgs, winners)
        launched = {k: v - before[k] for k, v in _launches().items()}
        assert psm.counts["merge_plan"][route] == plans[route] + 2
        want = {"L": 0, "H": 1, "X": 1, "S": 0} if route == "scatter" else {"L": 4, "H": 1, "X": 1, "S": 0}
        assert launched == want, launched
        cpu = pm.plan_batch_device(msgs, winners, device="cpu")
        cpu_full = pm.plan_batch_device_full(msgs, winners, device="cpu")
    finally:
        psm.set_plan_path("auto")
    assert card[0] == cpu[0] == full[0] == hx
    assert card[1] == cpu[1] == full[1] and sorted(map(repr, card[1])) == sorted(map(repr, hu))
    assert full[2] == cpu_full[2]


# -- the owner mesh on the card: shards sharing cuda:0 against one shard --


def _fleet_messages(seed, owners=24, per=400):
    """{owner: CrdtMessages} with cell contention and one owner in
    upper-case hex (the host quarantine), and stored winners."""
    from evolu_tpu_torch.core.timestamp import timestamp_to_string
    from evolu_tpu_torch.core.types import CrdtMessage, Timestamp

    rng = np.random.default_rng(seed)
    batches, winners = {}, {}
    for o in range(owners):
        node = f"{int(rng.integers(0, 2**64, dtype=np.uint64)):016x}"
        node = node.upper() if o == 5 else node
        msgs = [CrdtMessage(timestamp_to_string(Timestamp(1_700_000_000_000 + o * 7 + i * 61, i % 3, node)), "todo",
                            f"r{int(rng.integers(0, 40))}", "title", f"v{o}-{i}")
                for i in range(int(rng.integers(per // 4, per)))]
        batches[f"owner{o:03d}"] = msgs
        winners[f"owner{o:03d}"] = {(m.table, m.row, m.column): m.timestamp for m in msgs[::11]}
    return batches, winners


@pytest.mark.parametrize("n_shards", [2, 8])
def test_sharded_reconcile_on_card_matches_one_shard_and_cpu(n_shards, dev):
    """`reconcile_owner_batches` over n shards sharing cuda:0 equals the
    one-shard card pass and the 8-CPU-shard pass, owner by owner and in its
    digest; the sort route launches L twice, H and X once a shard."""
    from evolu_tpu_torch.parallel.mesh import MeshContext, create_mesh
    from evolu_tpu_torch.parallel.reconcile import reconcile_owner_batches

    batches, winners = _fleet_messages(31)
    before = _launches()
    got = reconcile_owner_batches(batches, winners, mesh_ctx=MeshContext(create_mesh(devices=["cuda:0"] * n_shards)))
    launched = {k: v - before[k] for k, v in _launches().items()}
    assert launched == {"L": 2 * n_shards, "H": n_shards, "X": n_shards, "S": 0}, launched
    one = reconcile_owner_batches(batches, winners)
    cpu = reconcile_owner_batches(batches, winners, mesh=create_mesh(devices=["cpu"] * 8))
    assert got[1] == one[1] == cpu[1]
    for o in batches:
        assert got[0][o][0] == one[0][o][0] == cpu[0][o][0], o
        assert got[0][o][1] == one[0][o][1] == cpu[0][o][1], o
        assert got[0][o][2] == one[0][o][2] == cpu[0][o][2], o


def test_sharded_engine_on_card_matches_one_shard(dev):
    """The mesh engine on 8 shards of cuda:0 (4 native storage shards)
    against the one-shard card engine over the relay batches (cap
    overflow and the 20-B upload included): equal bytes and tables; H and
    X launch 8 times a dispatch (16 with the overflow's rerun)."""
    from evolu_tpu_torch.parallel.mesh import MeshContext, create_mesh
    from evolu_tpu_torch.server import engine as pe
    from evolu_tpu_torch.server.relay import ShardedRelayStore

    ctx = MeshContext(create_mesh(devices=["cuda:0"] * 8))
    stores = [ShardedRelayStore(shards=4, backend="native") for _ in range(2)]
    sharded, single = pe.BatchReconciler(stores[0], mesh_ctx=ctx), pe.BatchReconciler(stores[1])
    try:
        for b in _relay_batches():
            before, launched = dict(pe.counts), _launches()
            out = sharded.run_batch_wire(b)
            d = {k: v - launched[k] for k, v in _launches().items()}
            passes = sum(pe.counts[k] - before[k] for k in ("delta", "full", "overflow"))
            assert d == {"L": 0, "H": 8 * passes, "X": 8 * passes, "S": 0}, d
            assert out == single.run_batch_wire(b)
        assert _wb_dump(stores[0]) == _wb_dump(stores[1])
        assert ctx.counts["dispatches"] >= 4 and ctx.counts["xdev_reduce"]["digest"] == ctx.counts["dispatches"]
    finally:
        for x in (sharded, single, *stores):
            x.close()


def test_sharded_winner_cache_on_card_matches_cpu(dev):
    """`MeshShardedWinnerCache` on 8 shards of cuda:0 against the same cache
    on 8 CPU shards and the one-device card cache: equal tables, trees,
    slots and slot arrays; the audit holds on every shard."""
    from evolu_tpu_torch.core.merkle import merkle_tree_to_string
    from evolu_tpu_torch.ops.winner_cache import DeviceWinnerCache, MeshShardedWinnerCache
    from evolu_tpu_torch.parallel.mesh import MeshContext, create_mesh
    from evolu_tpu_torch.storage import PySqliteDatabase, apply_messages, init_db_model

    dbs = [PySqliteDatabase() for _ in range(3)]
    for db in dbs:
        init_db_model(db, "legal winner thank year wave sausage worth useful legal winner thank yellow")
        db.exec('CREATE TABLE "todo" ("id" TEXT PRIMARY KEY, "title" BLOB, "done" BLOB)')
    caches = [MeshShardedWinnerCache(dbs[0], mesh_ctx=MeshContext(create_mesh(devices=["cuda:0"] * 8)),
                                     capacity=64, adaptive=False),
              MeshShardedWinnerCache(dbs[1], mesh_ctx=MeshContext(create_mesh(devices=["cpu"] * 8)),
                                     capacity=64, adaptive=False),
              DeviceWinnerCache(dbs[2], adaptive=False)]
    trees = [{}, {}, {}]
    try:
        for batch in _cache_batches(41, n_batches=4, n=2000):
            before = _launches()
            for i, (db, cache) in enumerate(zip(dbs, caches)):
                trees[i] = apply_messages(db, trees[i], tuple(batch), planner=cache.plan_batch)
                if i == 0:
                    d = {k: v - before[k] for k, v in _launches().items()}
                    assert d == {"L": 16, "H": 8, "X": 8, "S": 0}, d
            dumps = [db.exec('SELECT * FROM "__message" ORDER BY 1') + db.exec('SELECT * FROM "todo" ORDER BY 1')
                     for db in dbs]
            assert dumps[0] == dumps[1] == dumps[2]
            assert merkle_tree_to_string(trees[0]) == merkle_tree_to_string(trees[1]) == merkle_tree_to_string(trees[2])
            assert caches[0]._slots == caches[1]._slots
            assert all(np.array_equal(a, b) for a, b in zip(caches[0].slot_values(), caches[1].slot_values()))
            assert caches[0].verify_against_db() == len(caches[0]._slots) > 0
    finally:
        for db in dbs:
            db.close()


def test_mesh_over_every_card(dev):
    """A mesh of one shard a card against one shard: needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip(f"needs at least 2 cards for a mesh of cards; this machine has {torch.cuda.device_count()}")
    from evolu_tpu_torch.parallel.mesh import MeshContext
    from evolu_tpu_torch.parallel.reconcile import reconcile_owner_batches

    batches, winners = _fleet_messages(37)
    ctx = MeshContext()
    assert ctx.n_shards == torch.cuda.device_count()
    got = reconcile_owner_batches(batches, winners, mesh_ctx=ctx)
    one = reconcile_owner_batches(batches, winners)
    assert got[1] == one[1] and all(got[0][o][0] == one[0][o][0] and got[0][o][2] == one[0][o][2] for o in batches)


def _obs_planes(on):
    from evolu_tpu_torch.obs import metrics, trace
    from evolu_tpu_torch.utils import log as log_mod

    metrics.set_enabled(on)
    trace.set_enabled(on)
    trace.set_sample_rate(1.0)
    log_mod.enable_trace_annotations(on)


def test_obs_planes_change_no_output_or_launch_on_the_card(dev):
    """The liveness fence on cuda:0: the columns pass and the engine's
    `deltas_dispatch` / `deltas_finish` with every observability plane on
    (metrics, tracing at 100% under a root span, the stage anatomy,
    record_function annotations) equal the same passes with every plane
    off, output for output, with the same launches of L, X and H and the
    same pull waves."""
    from evolu_tpu_torch.obs import metrics, trace
    from evolu_tpu_torch.ops.host_parse import parse_timestamp_strings
    from evolu_tpu_torch.parallel import reconcile as pr
    from evolu_tpu_torch.server import engine as pe
    from evolu_tpu_torch.utils.log import logger

    batches, winners = _fleet_messages(41)
    rows = {o: [m.timestamp for m in ms] for o, ms in batches.items() if o != "owner005"}
    flat = [t for ts in rows.values() for t in ts]
    all_m, all_c, all_n, case_ok = parse_timestamp_strings(flat, with_case=True)
    index, pos = {}, 0
    for o, ts in rows.items():
        index[o] = np.arange(pos, pos + len(ts))
        pos += len(ts)

    def run(on):
        _obs_planes(on)
        waves = []
        orig = (pr.to_host_many, pe.to_host_many)
        pr.to_host_many = lambda *xs: waves.append(1) or orig[0](*xs)
        pe.to_host_many = lambda *xs: waves.append(1) or orig[1](*xs)
        before = _launches()
        root = trace.start_span("fence.pass")
        try:
            with trace.use(root.context):
                plan = pr.reconcile_owner_batches(batches, winners)
                deltas = pe.deltas_finish(pe.deltas_dispatch(index, all_m, all_c, all_n, case_ok, flat))
            torch.cuda.synchronize()
        finally:
            root.end()
            pr.to_host_many, pe.to_host_many = orig
        return (plan, deltas), {k: v - before[k] for k, v in _launches().items()}, len(waves)

    logger.clear()
    try:
        off1, on, off2 = run(False), run(True), run(False)
        _obs_planes(True)
        assert metrics.registry.get_histogram("evolu_kernel_span_ms", target="kernel:reconcile")[3] == 1
        assert any(s.name.startswith("kernel:reconcile") for s in trace.recorder.dump())
    finally:
        _obs_planes(True)
        from evolu_tpu_torch.utils import log as log_mod

        log_mod.enable_trace_annotations(False)
        logger.clear()
    assert on[0] == off1[0] == off2[0]
    assert on[1] == off1[1] == off2[1] and on[1]["L"] == 2 and on[1]["H"] == 2 and on[1]["X"] == 2
    assert on[2] == off1[2] == off2[2] > 0


def test_live_profile_holds_the_port_kernels(dev):
    """`capture_live_profile` around one engine pass on the card returns
    a device lane whose CUDA kernel events are named after the port's
    kernels (`lookback_scan` of seg_scan.cu, `ts_hash_kernel` of
    ts_hash.cu)."""
    import threading

    from evolu_tpu_torch.server import relay as relay_mod
    from evolu_tpu_torch.server.engine import BatchReconciler
    from evolu_tpu_torch.server.relay import RelayStore

    store = RelayStore(backend="native")
    engine = BatchReconciler(store, device=dev)
    reqs = [_relay_request(f"prof{i}", i) for i in range(8)]
    engine.run_batch_wire(reqs[:1])  # builds the kernels before the window
    done = threading.Event()

    def one_pass():
        import time

        time.sleep(0.2)
        engine.run_batch_wire(reqs[1:])
        done.set()

    assert relay_mod.prepare_device_profiler()
    t = threading.Thread(target=one_pass)
    t.start()
    with relay_mod._PROFILE_LOCK:
        doc = relay_mod.capture_live_profile(1500)
    t.join()
    engine.close()
    store.close()
    assert done.is_set()
    assert doc["metadata"]["device_lane"] is True, doc["metadata"]
    kernels = {e["name"] for e in doc["traceEvents"] if e.get("cat") == "kernel"}
    assert any("lookback_scan" in k for k in kernels), sorted(kernels)[:20]
    assert any("ts_hash_kernel" in k for k in kernels), sorted(kernels)[:20]


def _relay_request(owner, seed, n=300):
    from evolu_tpu_torch.core.timestamp import timestamp_to_string
    from evolu_tpu_torch.core.types import Timestamp
    from evolu_tpu_torch.sync import protocol

    rng = np.random.default_rng(seed)
    node = f"{int(rng.integers(0, 2**63)):016x}"
    msgs = tuple(protocol.EncryptedCrdtMessage(
        timestamp_to_string(Timestamp(1_700_000_000_000 + seed * 100_000 + i * 37, 0, node)), b"ct%d" % i)
        for i in range(n))
    return protocol.SyncRequest(msgs, owner, node, "{}")


def test_start_host_transfer_pulls_on_a_side_stream(dev, monkeypatch):
    """`start_host_transfer` begins each CUDA tensor's copy on a side
    stream after the work queued on the current stream (`y` is still being
    computed there when the copy is queued); `to_host_many` on the results
    is one counted pull wave with the values, and `to_host` is a wave of
    one."""
    import evolu_tpu_torch.ops as ops

    waves = []
    real = ops.record_pull_wave
    monkeypatch.setattr(ops, "record_pull_wave",
                        lambda seconds, arrays: (waves.append(len(arrays)), real(seconds, arrays)))
    x = torch.arange(1 << 20, dtype=torch.int64, device=dev)
    y = (x * 3) % 7 == 1
    started = ops.start_host_transfer(x, y, "passes")
    assert isinstance(started[0], ops.HostTransfer) and started[2] == "passes"
    a, b, c = ops.to_host_many(*started)
    assert np.array_equal(a, np.arange(1 << 20)) and c == "passes"
    assert np.array_equal(b, (np.arange(1 << 20) * 3) % 7 == 1)
    assert np.array_equal(ops.to_host(x + 1), np.arange(1, (1 << 20) + 1))
    assert waves == [3, 1]
