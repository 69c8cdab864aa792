"""Port parity: the LWW planner (`ops.merge`) against the JAX package.

Sorted-order masks and the permutation are deterministic (the packed
key is unique), so they compare as arrays; the full device plan
compares as (xor mask, upserts, deltas)."""

import functools
import zlib

import jax
import numpy as np
import pytest
import torch

from evolu_tpu.ops import merge as jm
from evolu_tpu_torch.ops import merge as pm

from _torch_port_data import (
    BASE_MILLIS,
    as_tuples,
    jax_messages,
    message_tuples,
    port_messages,
    stored_winners,
)


def _padded_columns(seed, n=3000, n_cells=700):
    rng = np.random.default_rng(seed)
    cell_id = rng.integers(0, n_cells, n).astype(np.int32)
    millis = BASE_MILLIS + rng.integers(0, 50_000, n)
    k1 = (millis.astype(np.uint64) << np.uint64(16)) | rng.integers(0, 3, n).astype(np.uint64)
    k1[rng.random(n) < 0.05] |= np.uint64(1) << np.uint64(63)  # keys ≥ 2^63
    k2 = rng.integers(0, 4, n).astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    dup = rng.random(n) < 0.1  # exact duplicates of an earlier row
    src = rng.integers(0, n, n)
    for i in np.nonzero(dup)[0]:
        j = min(int(src[i]), i)
        cell_id[i], k1[i], k2[i] = cell_id[j], k1[j], k2[j]
    has = rng.random(n_cells) < 0.6
    w1 = np.where(has, k1[rng.integers(0, n, n_cells)], 0).astype(np.uint64)
    w2 = np.where(has, k2[rng.integers(0, n, n_cells)], 0).astype(np.uint64)
    cols, _ = jm.pad_columns([cell_id, k1, k2, w1[cell_id], w2[cell_id]], n)
    return cols


@pytest.mark.parametrize("core", ["flags", "core"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sorted_plan_matches_jax(seed, core):
    cols = _padded_columns(seed)
    j_fn = jm.plan_merge_sorted_flags if core == "flags" else jm.plan_merge_sorted_core
    p_fn = pm.plan_merge_sorted_flags if core == "flags" else pm.plan_merge_sorted_core
    with jax.enable_x64(True):
        want = j_fn(*(jax.numpy.asarray(c) for c in cols))
    t = [torch.from_numpy(c.view(np.int64) if c.dtype == np.uint64 else c) for c in cols]
    got = p_fn(*t)
    for name, w, g in zip(("xor", "upsert", "i_s", "s1", "s2"), want[:5], got[:5]):
        g = g.numpy()
        if name in ("s1", "s2"):
            g = g.view(np.uint64)
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)


def _plans(batch_tuples, winners):
    with jax.enable_x64(True):
        want = jm.plan_batch_device_full(jax_messages(batch_tuples), winners)
    got = pm.plan_batch_device_full(port_messages(batch_tuples), winners, device="cpu")
    return want, got


@pytest.mark.parametrize("case", ["fresh", "stored_winners", "duplicates", "non_canonical",
                                  "non_canonical_winner"])
def test_plan_batch_device_full_matches_jax(case):
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    tuples = message_tuples(rng, 400, n_rows=12, upper_node=case == "non_canonical",
                            dup_frac=0.3 if case == "duplicates" else 0.05)
    winners = {}
    if case in ("stored_winners", "duplicates", "non_canonical_winner"):
        winners = stored_winners(rng, tuples, upper_node=case == "non_canonical_winner")
    if case == "duplicates":  # re-delivered stored winners
        cell = next(iter(winners))
        tuples.append((winners[cell], *cell, "dup"))
    (jx, ju, jd), (px, pu, pd) = _plans(tuples, winners)
    assert px == jx
    assert as_tuples(pu) == as_tuples(ju)
    assert pd == jd


def test_plan_batch_device_full_empty():
    assert pm.plan_batch_device_full([], {}, device="cpu") == ([], [], {})


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the no-card error cannot show")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pm.plan_batch_device_full(port_messages(message_tuples(np.random.default_rng(0), 3)), {})


def test_planner_partial_is_a_planner():
    """`functools.partial(plan_batch_device_full, device=...)` is the
    planner shape `storage.apply.apply_messages` takes."""
    planner = functools.partial(pm.plan_batch_device_full, device="cpu")
    msgs = port_messages(message_tuples(np.random.default_rng(3), 50))
    xor_mask, upserts, deltas = planner(msgs, {})
    assert len(xor_mask) == 50 and upserts and deltas
