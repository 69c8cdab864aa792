"""Port parity: the multi-owner reconcile pass.

The JAX side runs on the 8-device CPU mesh, whose layout differs from
the port's single shard; per-owner results and the digest must not."""

import jax
import numpy as np
import pytest
import torch

from evolu_tpu.parallel import create_mesh
from evolu_tpu.parallel import reconcile_owner_batches as jax_reconcile
from evolu_tpu_torch.ops import columns_to_device
from evolu_tpu_torch.ops.merge import unpermute_masks
from evolu_tpu_torch.ops.merkle_ops import decode_owner_minute_deltas
from evolu_tpu_torch.parallel import reconcile as pr

from _torch_port_data import as_tuples, jax_messages, message_tuples, port_messages, stored_winners


def _fleet(seed, n_owners, per_owner, non_canonical=()):
    rng = np.random.default_rng(seed)
    batches, winners = {}, {}
    for i in range(n_owners):
        o = f"owner{i:05d}"
        t = message_tuples(rng, int(rng.integers(1, per_owner + 1)), n_rows=6,
                           upper_node=i in non_canonical)
        batches[o] = t
        winners[o] = stored_winners(rng, t)
    return batches, winners


def _compare(batches, winners):
    with jax.enable_x64(True):
        want, want_digest = jax_reconcile(
            create_mesh(), {o: jax_messages(t) for o, t in batches.items()}, winners)
    got, got_digest = pr.reconcile_owner_batches(
        {o: port_messages(t) for o, t in batches.items()}, winners, device="cpu")
    assert got.keys() == want.keys()
    for o in want:
        (jx, ju, jd), (px, pu, pd) = want[o], got[o]
        assert px == jx, o
        assert as_tuples(pu) == as_tuples(ju), o
        assert pd == jd, o
    assert got_digest == want_digest


def test_reconcile_matches_jax_few_dozen_owners():
    _compare(*_fleet(1, 36, 60))


def test_reconcile_matches_jax_with_non_canonical_owner():
    batches, winners = _fleet(2, 12, 40, non_canonical={3})
    _compare(batches, winners)


def test_reconcile_matches_jax_wide_kernel():
    """4100 owners: an owner index reaches 4095, the packed key's padding
    sentinel, so both packages route to the wide kernel."""
    batches, winners = _fleet(3, 4100, 2)
    cols, _, _ = pr.build_owner_columns(
        {o: port_messages(t) for o, t in batches.items()}, winners)
    assert pr.shard_kernel_for(cols) is pr._shard_kernel_wide
    _compare(batches, winners)


def test_empty_fleet():
    assert pr.reconcile_owner_batches({}, {}, device="cpu") == ({}, 0)


def _decoded(outs):
    xor_s, upsert_s, i_s, *segs, digest = (o.numpy() for o in outs)
    return (*unpermute_masks(xor_s, upsert_s, i_s), decode_owner_minute_deltas(*segs),
            int(digest.view(np.uint32)[0]))


def test_wide_kernel_matches_packed_kernel():
    batches, winners = _fleet(4, 50, 80)
    cols, _, _ = pr.build_owner_columns(
        {o: port_messages(t) for o, t in batches.items()}, winners)
    assert pr.shard_kernel_for(cols) is pr._shard_kernel
    t = columns_to_device(cols, "cpu")
    args = [t[k] for k in pr.COLUMN_NAMES]
    packed, wide = _decoded(pr._shard_kernel(*args)), _decoded(pr._shard_kernel_wide(*args))
    np.testing.assert_array_equal(packed[0], wide[0])
    np.testing.assert_array_equal(packed[1], wide[1])
    assert packed[2] == wide[2]
    assert packed[3] == wide[3]


def test_column_bridge_round_trip():
    batches, winners = _fleet(5, 5, 30)
    cols, _, _ = pr.build_owner_columns(
        {o: port_messages(t) for o, t in batches.items()}, winners)
    cols["k1"][0] = np.uint64(2**64 - 1)
    from evolu_tpu_torch.ops import columns_to_numpy

    back = columns_to_numpy(columns_to_device(cols, "cpu"))
    for k, v in cols.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v)
    assert columns_to_device(cols, "cpu")["k1"].dtype == torch.int64
