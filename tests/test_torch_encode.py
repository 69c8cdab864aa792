"""Port parity: timestamp hashing, key packing and JS minutes.

The port's plain hash (the CPU side of kernel H) must equal the JAX
package's XLA hash, its Pallas kernel in interpret mode and the host
oracle, exactly (integer work, no tolerance)."""

import jax
import numpy as np
import pytest
import torch

from evolu_tpu.core.timestamp import Timestamp, timestamp_to_hash
from evolu_tpu.ops.encode import U32_MILLIS_BOUND
from evolu_tpu.ops.encode import pack_ts_keys as jax_pack
from evolu_tpu.ops.encode import timestamp_hashes as jax_hashes
from evolu_tpu.ops.merkle_ops import js_minutes as jax_js_minutes
from evolu_tpu.ops.pallas_hash import timestamp_hashes_pallas
from evolu_tpu_torch.ops.cuda_hash import masked_key_hashes, xor_reduce_plain
from evolu_tpu_torch.ops.encode import pack_ts_keys, timestamp_hashes, unpack_ts_keys
from evolu_tpu_torch.ops.merkle_ops import js_minutes

EDGE_MILLIS = [
    0,
    951_782_400_000,        # 2000-02-29
    4_107_542_399_000,      # 2100-02-28 end of day (2100 not a leap year)
    253_402_300_799_999,    # 9999-12-31T23:59:59.999
]


def _batch(n, seed, millis=None):
    rng = np.random.default_rng(seed)
    if millis is None:
        millis = BASE + rng.integers(0, 365 * 86_400_000, n)
    millis = np.asarray(millis, np.int64)
    n = len(millis)
    counter = rng.integers(0, 65536, n).astype(np.int32)
    node = rng.integers(0, 2**64, n, dtype=np.uint64)
    node[:2] = [0, 2**64 - 1]
    return millis, counter, node


BASE = 1_700_000_000_000

# days-since-epoch in [2^31 - 719468, 2^31 - 1]: `days + 719468` leaves
# int32 and wraps in the JAX package (int32 days, encode._civil_from_days
# and the Pallas kernel alike). Millis at the window's two ends, one step
# outside each end, and the same four shifted by ±2^32 days (their int32
# wrap images).
_DAY = 86_400_000
_WRAP_FIRST = ((1 << 31) - 719_468) * _DAY
_WRAP_LAST = (1 << 31) * _DAY - 1
DAY_WRAP_MILLIS = [
    m + shift * (1 << 32) * _DAY
    for shift in (0, 1, -1)
    for m in (_WRAP_FIRST, _WRAP_LAST, _WRAP_FIRST - 1, _WRAP_LAST + 1)
]


def _port(millis, counter, node):
    got = timestamp_hashes(torch.from_numpy(millis), torch.from_numpy(counter),
                           torch.from_numpy(node.view(np.int64)))
    return got.numpy().view(np.uint32)


def _jax(millis, counter, node):
    with jax.enable_x64(True):
        return np.asarray(jax_hashes(millis, counter, node))


@pytest.mark.parametrize("case", ["random", "edge_dates", "beyond_2_47", "negative", "non_tile",
                                  "int32_day_wrap"])
def test_timestamp_hashes_match_jax(case):
    millis = {
        "random": None,
        "edge_dates": EDGE_MILLIS * 13,
        "beyond_2_47": np.random.default_rng(1).integers(2**47, 253_402_300_799_999, 300),
        "negative": [-1, -999, -1000, -86_400_000, -86_400_001, -62_135_596_800_000, -(2**40)],
        "non_tile": None,
        "int32_day_wrap": DAY_WRAP_MILLIS * 5,
    }[case]
    millis, counter, node = _batch(8193 if case == "non_tile" else 300, seed=3, millis=millis)
    np.testing.assert_array_equal(_port(millis, counter, node), _jax(millis, counter, node))


@pytest.mark.parametrize("millis", [None, EDGE_MILLIS * 13, DAY_WRAP_MILLIS * 5])
def test_timestamp_hashes_match_pallas_interpret(millis):
    millis, counter, node = _batch(200, seed=4, millis=millis)
    want = np.asarray(timestamp_hashes_pallas(millis, counter, node, interpret=True))
    np.testing.assert_array_equal(_port(millis, counter, node), want)


def test_timestamp_hashes_match_host_oracle():
    millis, counter, node = _batch(64, seed=9, millis=[*EDGE_MILLIS, *(BASE + np.arange(60) * 7919)])
    got = _port(millis, counter, node)
    for i in range(len(millis)):
        t = Timestamp(int(millis[i]), int(counter[i]), f"{int(node[i]):016x}")
        assert int(got[i]) == timestamp_to_hash(t), i


def test_masked_key_hashes_and_digest():
    millis, counter, node = _batch(1000, seed=5, millis=[*EDGE_MILLIS * 10, *(BASE + np.arange(960))])
    mask = np.random.default_rng(5).random(len(millis)) < 0.7
    k1 = torch.from_numpy(millis) << 16 | torch.from_numpy(counter).to(torch.int64)
    hashes, digest = masked_key_hashes(k1, torch.from_numpy(node.view(np.int64)), torch.from_numpy(mask))
    want = np.where(mask, _jax(millis, counter, node), 0).astype(np.uint32)
    np.testing.assert_array_equal(hashes.numpy().view(np.uint32), want)
    assert int(digest.numpy().view(np.uint32)[0]) == int(np.bitwise_xor.reduce(want))


@pytest.mark.parametrize("n", [0, 1, 2, 7, 1000])
def test_xor_reduce_plain(n):
    v = np.random.default_rng(n).integers(0, 2**32, n, dtype=np.uint32)
    got = xor_reduce_plain(torch.from_numpy(v.view(np.int32))).numpy().view(np.uint32)[0]
    assert int(got) == int(np.bitwise_xor.reduce(v, initial=0))


def test_pack_unpack_round_trip_matches_jax():
    millis, counter, _ = _batch(500, seed=6, millis=[*EDGE_MILLIS * 100, *(2**47 + np.arange(100))])
    k1 = pack_ts_keys(torch.from_numpy(millis), torch.from_numpy(counter))
    with jax.enable_x64(True):
        want = np.asarray(jax_pack(millis, counter))
    np.testing.assert_array_equal(k1.numpy().view(np.uint64), want)
    m, c = unpack_ts_keys(k1)
    np.testing.assert_array_equal(m.numpy(), millis)
    np.testing.assert_array_equal(c.numpy(), counter)


def test_js_minutes_matches_jax_across_u32_bound():
    rng = np.random.default_rng(7)
    millis = np.concatenate([
        U32_MILLIS_BOUND + np.arange(-3, 3),
        rng.integers(0, U32_MILLIS_BOUND, 100),
        rng.integers(U32_MILLIS_BOUND, 253_402_300_799_999, 100),
        EDGE_MILLIS,
    ]).astype(np.int64)
    with jax.enable_x64(True):
        want = np.asarray(jax_js_minutes(millis))
    np.testing.assert_array_equal(js_minutes(torch.from_numpy(millis)).numpy(), want)
