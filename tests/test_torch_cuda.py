"""Kernels L, X, H and S on the card against their plain PyTorch versions.

Imports neither jax nor `evolu_tpu`, so it runs on the GPU machine:

    python -m pytest tests/test_torch_cuda.py -q

Without a card every test skips with a reason (the CUDA kernels have no
CPU mode); the decision is made inside the fixture, at run time."""

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
        sides.append((out, {k: v - before[k] for k, v in pe.counts.items()}, store))
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
        sides.append((out, {k: v - before[k] for k, v in pe.counts.items()}))
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
