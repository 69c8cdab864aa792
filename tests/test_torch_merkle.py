"""Port parity: the (owner, minute) Merkle fold.

Tile-local grouping fixes grouping, not order, so the raw segment
arrays may differ from the JAX package's outside segment ends; the
decoded {owner: {minute_key: delta}} dicts must be equal."""

import jax
import numpy as np
import pytest
from _torch_jax_state import jax_process_state  # noqa: F401  (the JAX package's native libraries and ledger)
import torch

from evolu_tpu.core.merkle import minute_deltas_host
from evolu_tpu.ops.merkle_ops import decode_owner_minute_deltas as jax_decode
from evolu_tpu.ops.merkle_ops import owner_minute_segments as jax_segments
from evolu_tpu_torch.ops.encode import timestamp_hashes
from evolu_tpu_torch.ops.merkle_ops import (
    decode_owner_minute_deltas,
    minute_deltas_to_dict,
    owner_minute_segments,
)

from _torch_port_data import BASE_MILLIS, ts_string


def _rows(n, seed, n_owners=37):
    rng = np.random.default_rng(seed)
    owner = rng.integers(0, n_owners, n).astype(np.int32)
    millis = BASE_MILLIS + rng.integers(0, 40 * 60_000, n)
    millis[:3] = [0, 253_402_300_799_999, 253_402_300_799_999 - 60_000]  # minute wraps int32
    hashes = rng.integers(0, 2**32, n, dtype=np.uint32)
    valid = rng.random(n) < 0.8
    hashes = np.where(valid, hashes, 0).astype(np.uint32)
    return owner, millis.astype(np.int64), hashes, valid


@pytest.mark.parametrize("n,tile_local", [(1 << 15, True), (1 << 15, False), (3000, True)])
def test_owner_minute_deltas_match_jax(n, tile_local):
    owner, millis, hashes, valid = _rows(n, seed=n)
    with jax.enable_x64(True):
        want = jax_decode(*jax_segments(jax.numpy.asarray(owner), jax.numpy.asarray(millis),
                                        jax.numpy.asarray(hashes), jax.numpy.asarray(valid),
                                        tile_local=tile_local))
    outs = owner_minute_segments(torch.from_numpy(owner), torch.from_numpy(millis),
                                 torch.from_numpy(hashes.view(np.int32)), torch.from_numpy(valid),
                                 tile_local=tile_local)
    assert decode_owner_minute_deltas(*(o.numpy() for o in outs)) == want


def test_minute_deltas_to_dict_matches_host_fold():
    rng = np.random.default_rng(11)
    n = 2000
    millis = BASE_MILLIS + rng.integers(0, 90 * 60_000, n)
    counter = rng.integers(0, 65536, n)
    node = rng.integers(0, 2**64, n, dtype=np.uint64)
    flagged = rng.random(n) < 0.7
    strings = [ts_string(m, c, d) for m, c, d in zip(millis, counter, node)]
    want, _ = minute_deltas_host(s for s, f in zip(strings, flagged) if f)
    mask = torch.from_numpy(flagged)
    hashes = timestamp_hashes(torch.from_numpy(millis.astype(np.int64)),
                              torch.from_numpy(counter.astype(np.int32)),
                              torch.from_numpy(node.view(np.int64)))
    hashes = torch.where(mask, hashes, torch.zeros_like(hashes))
    _, m_s, seg_end, seg_xor, valid = owner_minute_segments(
        torch.zeros(n, dtype=torch.int32), torch.from_numpy(millis.astype(np.int64)), hashes, mask)
    assert minute_deltas_to_dict(m_s.numpy(), seg_end.numpy(), seg_xor.numpy(), valid.numpy()) == want


def test_tree_strings_and_diff_match_jax():
    """Trees grown by inserts on both sides serialize byte-identically,
    parse back, and diff to the same earliest divergent minute."""
    from evolu_tpu.core import merkle as jm
    from evolu_tpu.core.timestamp import timestamp_from_string as jax_parse
    from evolu_tpu_torch.core import merkle as pm
    from evolu_tpu_torch.core.timestamp import timestamp_from_string

    rng = np.random.default_rng(12)
    strings = [ts_string(BASE_MILLIS + int(rng.integers(0, 10**9)), int(rng.integers(0, 4)),
                         rng.integers(0, 2**64, dtype=np.uint64)) for _ in range(60)]
    trees = []
    for cut in (60, 45):
        jt, pt = jm.create_initial_merkle_tree(), pm.create_initial_merkle_tree()
        for s in strings[:cut]:
            jt = jm.insert_into_merkle_tree(jax_parse(s), jt)
            pt = pm.insert_into_merkle_tree(timestamp_from_string(s), pt)
        assert pm.merkle_tree_to_string(pt) == jm.merkle_tree_to_string(jt)
        assert pm.merkle_tree_from_string(pm.merkle_tree_to_string(pt)) == pt
        trees.append((jt, pt))
    (j1, p1), (j2, p2) = trees
    assert pm.diff_merkle_trees(p1, p2) == jm.diff_merkle_trees(j1, j2) is not None
    assert pm.diff_merkle_trees(p1, p1) is None
