"""Port parity: kernel S's plain version and the counter / AW-set folds
(`evolu_tpu_torch.ops.crdt_merge`) against the JAX package, exactly.

S against JAX `crdt_merge.segmented_sum_scan` (the blocked XLA scan)
and `pallas_scan.segmented_sum_scan_pallas` in interpret mode, on
full-range u64 values whose sums wrap past 2^64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evolu_tpu.ops import crdt_merge as jcm
from evolu_tpu.ops.pallas_scan import segmented_sum_scan_pallas
from evolu_tpu.parallel.reconcile import pack_owner_cell_key as jax_pack
from evolu_tpu_torch.ops import cuda_scan
from evolu_tpu_torch.ops import crdt_merge as pcm
from evolu_tpu_torch.parallel.reconcile import pack_owner_cell_key

SIZES = (1, 255, 256, 4097, (1 << 15) + 3)
_jax_sum_scan = jax.jit(jcm.segmented_sum_scan)


def _sum_inputs(n, seed):
    rng = np.random.default_rng(seed)
    flags = rng.random(n) < 0.02
    flags[0] = True
    v = rng.integers(0, 2**64, n, dtype=np.uint64)
    v[rng.random(n) < 0.2] = np.uint64(2**64 - 1)  # wraps on every add
    v[rng.random(n) < 0.1] = np.uint64(1) << np.uint64(63)
    v[rng.random(n) < 0.1] = 0
    return flags, v


def _port_sum(flags, v):
    out = cuda_scan.segmented_sum_scan(torch.from_numpy(flags), torch.from_numpy(v.view(np.int64)))
    return out.numpy().view(np.uint64)


@pytest.mark.parametrize("n", SIZES)
def test_sum_scan_matches_jax(n):
    flags, v = _sum_inputs(n, seed=n)
    before = cuda_scan.segmented_sum_scan_cuda.launches
    got = _port_sum(flags, v)
    assert cuda_scan.segmented_sum_scan_cuda.launches == before  # CPU tensors: plain version
    with jax.enable_x64(True):
        want = _jax_sum_scan(jnp.asarray(flags), jnp.asarray(v))
    np.testing.assert_array_equal(got, np.asarray(want))
    # The wrap really happens: some running sum is below its own input.
    assert n < 2 or (got < v).any()


@pytest.mark.parametrize("kind", ["one segment", "every row"])
def test_sum_scan_matches_jax_on_look_back_chains(kind):
    """The inputs that stress kernel S's look-back on the card: one
    segment over three tiles and a ragged one, and every row flagged."""
    n = 3 * 2048 + 5  # kernel S's tile is 2048 rows
    _, v = _sum_inputs(n, seed=11)
    flags = np.full(n, kind == "every row")
    flags[0] = True
    with jax.enable_x64(True):
        want = _jax_sum_scan(jnp.asarray(flags), jnp.asarray(v))
    np.testing.assert_array_equal(_port_sum(flags, v), np.asarray(want))


@pytest.mark.parametrize("n", SIZES)
def test_sum_scan_matches_pallas_interpret(n):
    flags, v = _sum_inputs(n, seed=1000 + n)
    with jax.enable_x64(True):
        want = segmented_sum_scan_pallas(jnp.asarray(flags), jnp.asarray(v), interpret=True)
    np.testing.assert_array_equal(_port_sum(flags, v), np.asarray(want))


def test_sum_scan_wraps_like_u64():
    flags = np.array([True, False, False, True, False])
    v = np.array([2**63 - 1, 1, 2**64 - 1, 2**64 - 2, 3], np.uint64)
    want = np.array([2**63 - 1, 2**63, 2**63 - 1, 2**64 - 2, 1], np.uint64)
    np.testing.assert_array_equal(_port_sum(flags, v), want)


def test_sum_scan_without_a_card_needs_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("the plain route is what a machine without a card runs")
    flags, v = _sum_inputs(64, 0)
    with pytest.raises(ValueError):  # the kernel wrapper takes CUDA tensors only
        cuda_scan.segmented_sum_scan_cuda(torch.from_numpy(flags), torch.from_numpy(v.view(np.int64)))


def test_pack_owner_cell_key_group_matches_jax():
    """`pack_owner_cell_key(…, lo_bits=0) >> 24` is the owner|cell group
    the shard decoders split at bit 25, as in JAX."""
    rng = np.random.default_rng(3)
    n = 4096
    owner = rng.integers(0, 4095, n).astype(np.int32)
    cell = rng.integers(0, 1 << 25, n).astype(np.int32)
    cell[rng.random(n) < 0.1] = 0x7FFFFFFF  # padding rows take the pad owner
    idx = rng.integers(0, 1 << 24, n).astype(np.int32)
    got = pack_owner_cell_key(torch.from_numpy(owner), torch.from_numpy(cell),
                              torch.from_numpy(idx), lo_bits=0).numpy()
    with jax.enable_x64(True):
        want = np.asarray(jax_pack(jnp.asarray(owner), jnp.asarray(cell), jnp.asarray(idx), lo_bits=0))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got >> 24 >> 25, np.where(cell == 0x7FFFFFFF, 4095, owner))


@pytest.mark.parametrize("seed,n,cells", [(2, 5000, 300), (17, 4097, 4097), (4040, 1, 1), (5, 20000, 7)])
def test_pn_counter_sums_matches_jax(seed, n, cells):
    rng = np.random.default_rng(seed)
    cell = rng.integers(0, cells, n).astype(np.int32)
    delta = rng.integers(-(2**31) + 1, 2**31, n).astype(np.int64)
    got = pcm.pn_counter_sums(cell, delta, cells, device="cpu")
    want = jcm.pn_counter_sums(cell, delta, cells)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_pn_counter_sums_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pcm.pn_counter_sums(np.zeros(4, np.int32), np.ones(4, np.int64), 1)
    z = pcm.pn_counter_sums(np.zeros(0, np.int32), np.zeros(0, np.int64), 3)  # nothing to fold
    assert all(len(a) == 3 and not a.any() for a in z)


@pytest.mark.parametrize("seed", [0, 9])
def test_counter_shard_sums_core_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = 4096
    owner = rng.integers(0, 60, n).astype(np.int32)
    cell = rng.integers(0, 500, n).astype(np.int32)
    cell[-100:] = 0x7FFFFFFF  # padding rows
    delta = rng.integers(-(2**31) + 1, 2**31, n).astype(np.int64)
    got = pcm.counter_shard_sums_core(*(torch.from_numpy(a) for a in (owner, cell, delta)))
    with jax.enable_x64(True):
        want = jax.jit(jcm.counter_shard_sums_core)(*(jnp.asarray(a) for a in (owner, cell, delta)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.asarray(w).dtype), np.asarray(w))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_awset_alive_flags_matches_jax(seed):
    rng = np.random.default_rng(seed)
    tags = [f"t{i:06d}" for i in range(int(rng.integers(1, 3000)))]
    adds = [tags[i] for i in rng.permutation(len(tags))[: len(tags) // 2]]
    kills = {tags[int(i)] for i in rng.integers(0, len(tags), len(tags) // 4)} | {"never-added", None}
    state_killed = {tags[int(i)] for i in rng.integers(0, len(tags), 20)}
    got = pcm.awset_alive_flags(adds, kills, state_killed, device="cpu")
    assert got == jcm.awset_alive_flags(adds, kills, state_killed)
    assert got == [t not in kills and t not in state_killed for t in adds]
    assert pcm.awset_alive_flags([], kills, state_killed, device="cpu") == []


@pytest.mark.parametrize("seed,n,pairs", [(4, 5000, 800), (5, 1, 3), (6, 300, 1)])
def test_awset_membership_matches_jax(seed, n, pairs):
    rng = np.random.default_rng(seed)
    pair_id = rng.integers(0, pairs, n).astype(np.int32)
    alive = rng.integers(0, 2, n).astype(np.int32)
    got = pcm.awset_membership(pair_id, alive, pairs, device="cpu")
    want = jcm.awset_membership(pair_id, alive, pairs)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))
