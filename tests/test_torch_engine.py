"""Port parity: the relay engine's Merkle kernels and `owner_minute_deltas`.

The JAX side runs on a one-device mesh, so its raw kernel arrays are one
shard's, as the port's are. Kernel outputs must be equal wherever they
are defined (the compact kernels' first `seg_count` entries, the
full-width kernel's sorted keys and its XOR at every segment end), and
the decoded deltas and digest equal on every route."""

import jax
import numpy as np
import pytest
from _torch_jax_state import jax_process_state  # noqa: F401  (the JAX package's native libraries and ledger)

from evolu_tpu.core.merkle import minute_deltas_host
from evolu_tpu.core.timestamp import Timestamp, timestamp_to_string
from evolu_tpu.parallel.mesh import create_mesh
from evolu_tpu.server import engine as je
from evolu_tpu_torch.ops import columns_to_device, to_host_many
from evolu_tpu_torch.server import engine as pe

BASE = 1_700_000_000_000


def _columns(seed, n, total, owners, span_ms, pre1970=False):
    """n real rows of `owners` owners padded to `total`: millis, counter,
    node (np.uint64), owner (int32, -1 = padding)."""
    rng = np.random.default_rng(seed)
    millis = np.zeros(total, np.int64)
    counter = np.zeros(total, np.int32)
    node = np.zeros(total, np.uint64)
    owner = np.full(total, -1, np.int32)
    millis[:n] = BASE + rng.integers(0, span_ms, n)
    if pre1970:
        millis[: n // 4] = -rng.integers(1, 10**9, n // 4)
    counter[:n] = rng.integers(0, 16, n)
    node[:n] = rng.integers(0, 2**64, n, dtype=np.uint64)
    owner[:n] = np.sort(rng.integers(0, owners, n))
    return millis, counter, node, owner


def _k1(millis, counter):
    return (millis.astype(np.uint64) << np.uint64(16)) | counter.astype(np.uint64)


def _compact_equal(got, want):
    packed, xors, count, digest = got
    w_packed, w_xors, w_count, w_digest = (np.asarray(x) for x in want)
    c = min(int(w_count[0]), len(w_packed))
    assert int(count[0]) == int(w_count[0])
    assert np.array_equal(packed[:c].view(np.uint64), w_packed[:c])
    assert np.array_equal(xors[:c].view(np.uint32), w_xors[:c])
    assert int(digest.view(np.uint32)[0]) == int(w_digest)
    return int(count[0])


# (seed, real rows, padded rows, owners, millis span): a few segments a
# minute, then every row nearly its own minute (the count passes the cap).
KERNEL_CASES = [(1, 3000, 4096, 7, 600_000), (2, 30_000, 1 << 15, 300, 600_000_000)]


@pytest.mark.parametrize("seed,n,total,owners,span", KERNEL_CASES)
def test_compact_kernels_match_jax(seed, n, total, owners, span):
    millis, counter, node, owner = _columns(seed, n, total, owners, span)
    cap = pe.bucket_size(max(total // 8, 64))
    base = int(millis[:n].min())
    real = owner >= 0
    dmillis = np.where(real, millis - base, 0).astype(np.uint32)
    ownctr = np.where(real, (owner.astype(np.uint32) << np.uint32(16)) | counter.astype(np.uint32),
                      np.uint32(0xFFFF << 16))
    mesh = create_mesh(1)
    k1 = _k1(millis, counter)
    with jax.enable_x64(True):
        want_full = je._compiled_merkle_kernel_compact(mesh, cap)(k1, node, owner)
        want_delta = je._compiled_merkle_kernel_compact_delta(mesh, cap)(
            dmillis, ownctr, node, np.array([base], np.int64))
    t = columns_to_device({"k1": k1, "node": node, "owner": owner, "dmillis": dmillis.view(np.int32),
                           "ownctr": ownctr.view(np.int32)}, "cpu")
    got_full = to_host_many(*pe._merkle_shard_kernel_compact(t["k1"], t["node"], t["owner"], cap))
    got_delta = to_host_many(*pe._merkle_shard_kernel_compact_delta(
        t["dmillis"], t["ownctr"], t["node"], base, cap))
    counts = {_compact_equal(got_full, want_full), _compact_equal(got_delta, want_delta)}
    assert len(counts) == 1 and counts.pop() > 0


@pytest.mark.parametrize("seed,n,total,owners,span,pre1970",
                         [c + (False,) for c in KERNEL_CASES] + [(3, 20_000, 1 << 15, 40, 10**9, True)])
def test_full_width_kernel_matches_jax(seed, n, total, owners, span, pre1970):
    """The overflow rerun's kernel: the 2^15-row cases sort within 8192-row
    tiles in both packages; the last carries wrapped pre-1970 millis, as
    the rerun receives them."""
    millis, counter, node, owner = _columns(seed, n, total, owners, span, pre1970)
    k1 = _k1(millis, counter)
    millis = (k1 >> np.uint64(16)).astype(np.int64)  # what the rerun uploads
    valid = owner >= 0
    owner64 = np.maximum(owner, 0).astype(np.int64)
    with jax.enable_x64(True):
        want = [np.asarray(x) for x in je._compiled_merkle_kernel(create_mesh(1))(
            millis, counter, node, valid, owner64)]
    t = columns_to_device({"m": millis, "c": counter, "n": node, "v": valid, "o": owner64}, "cpu")
    got = to_host_many(*pe._merkle_shard_kernel(t["m"], t["c"], t["n"], t["v"], t["o"]))
    owner_s, minute_s, seg_end, seg_xor, valid_s, digest = got
    for g, w in zip((owner_s, minute_s, seg_end, valid_s), (want[0], want[1], want[2], want[4])):
        assert np.array_equal(g, w)
    ends = seg_end & valid_s
    assert np.array_equal(seg_xor[ends].view(np.uint32), want[3][ends])
    assert int(digest.view(np.uint32)[0]) == int(want[5])


def _stamp(millis, counter=0, node="00000000000000aa"):
    return timestamp_to_string(Timestamp(int(millis), int(counter), node))


def _rows_mixed():
    rng = np.random.default_rng(5)
    rows = {}
    for o in range(30):
        node = f"{int(rng.integers(0, 2**63)):016x}"
        node = node.upper() if o == 7 and any(c.isalpha() for c in node) else node
        rows[f"owner{o:03d}"] = [
            _stamp(BASE + int(rng.integers(0, 120_000)), int(rng.integers(0, 16)), node)
            for _ in range(int(rng.integers(1, 120)))]
    rows["owner007"][0] = _stamp(BASE, 0, "ABCDEF0123456789")  # upper-case hex
    rows["empty"] = []
    return rows


def _rows_overflow():
    """tests/test_parallel.py:533's shape: every row its own minute."""
    return {f"u{o:02d}": [_stamp(BASE + (o * 97 + i) * 60_000, 0, "a" * 16) for i in range(64)]
            for o in range(64)}


def _rows_wide_span():
    return {"a": [_stamp(BASE), _stamp(BASE + 5)], "b": [_stamp(BASE + (1 << 32))]}


def _rows_many_owners(n):
    return {f"o{i:05d}": [_stamp(BASE + i * 7, i % 16, f"{i:016x}")] for i in range(n)}


def _rows_pre1970():
    return {"old": [_stamp(-1), _stamp(-60_001, 3), _stamp(-86_400_000, 0, "00000000000000bb")],
            "new": [_stamp(BASE, 1)]}


# Each case and the routes it must take (the dispatch counts it adds).
DELTA_CASES = {
    "mixed with an upper-case-hex owner": (_rows_mixed, {"delta": 1, "host_owners": 1}),
    "cap overflow": (_rows_overflow, {"delta": 1, "overflow": 1}),
    "span of 2^32 ms": (_rows_wide_span, {"full": 1}),
    "65,534 owners": (lambda: _rows_many_owners(65_534), {"delta": 1, "overflow": 1}),
    "65,535 owners": (lambda: _rows_many_owners(65_535), {"full": 1, "overflow": 1}),
    "pre-1970 millis": (_rows_pre1970, {"full": 1}),
}


@pytest.mark.parametrize("case", list(DELTA_CASES))
def test_owner_minute_deltas_matches_jax(case):
    make, routes = DELTA_CASES[case]
    rows = make()
    want = je.owner_minute_deltas(create_mesh(1), rows)
    before = dict(pe.counts)
    got = pe.owner_minute_deltas(rows, device="cpu")
    assert got == want
    assert {k: v - before[k] for k, v in pe.counts.items() if v != before[k]} == routes


def test_pre1970_matches_the_jax_engine_not_the_host_fold():
    """A limit of the reference, kept: the engine packs k1 as u64 and
    unpacks it logically, so a pre-1970 millis reaches the device as about
    2^48 - |millis| and the deltas and digest differ from the host fold."""
    rows = _rows_pre1970()
    got = pe.owner_minute_deltas(rows, device="cpu")
    host = minute_deltas_host(rows["old"])
    assert got[0]["old"] != host[0]
    assert got == je.owner_minute_deltas(create_mesh(1), rows)
