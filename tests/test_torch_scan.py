"""Port parity: kernels L and X (their plain versions on the CPU) against
the JAX package's scan references and its Pallas kernels in interpret
mode. Exact equality: integer work."""

import jax
import numpy as np
import pytest
from _torch_jax_state import jax_process_state  # noqa: F401  (the JAX package's native libraries and ledger)
import torch

from evolu_tpu.ops.merge import _segmented_max_scan_reference
from evolu_tpu.ops.merkle_ops import segmented_xor_scan_reference
from evolu_tpu.ops.pallas_scan import segmented_max_scan_pallas, segmented_xor_scan_pallas
from evolu_tpu_torch.ops.cuda_scan import (
    segmented_max_scan,
    segmented_max_scan_plain,
    segmented_xor_scan,
    segmented_xor_scan_plain,
)

SIZES = (1, 127, 128, 4096, 70000)

# Jitted once per shape: the eager associative_scan dispatches op by op.
_lex_reference = jax.jit(_segmented_max_scan_reference, static_argnames=("reverse",))
_xor_reference = jax.jit(segmented_xor_scan_reference)


def _lex_inputs(n, seed):
    rng = np.random.default_rng(seed)
    flags = rng.random(n) < 0.03
    flags[0] = True
    k1 = rng.integers(0, 2**64, n, dtype=np.uint64)
    k2 = rng.integers(0, 2**64, n, dtype=np.uint64)
    # Ties in k1 (the k2 compare decides), keys ≥ 2^63 and zero keys.
    k1[rng.random(n) < 0.3] = np.uint64(42) << np.uint64(32)
    k1[rng.random(n) < 0.1] = np.uint64(1) << np.uint64(63)
    k1[rng.random(n) < 0.1] = 0
    k2[rng.random(n) < 0.1] = 0
    return flags, k1, k2


def _port_lex(flags, k1, k2, reverse):
    o1, o2 = segmented_max_scan(torch.from_numpy(flags), torch.from_numpy(k1.view(np.int64)),
                                torch.from_numpy(k2.view(np.int64)), reverse=reverse)
    return o1.numpy().view(np.uint64), o2.numpy().view(np.uint64)


def _assert_lex_matches_reference(f, k1, k2, reverse):
    with jax.enable_x64(True):
        e1, e2 = _lex_reference(
            jax.numpy.asarray(f), jax.numpy.asarray(k1), jax.numpy.asarray(k2), reverse=reverse)
    g1, g2 = _port_lex(f, k1, k2, reverse)
    np.testing.assert_array_equal(g1, np.asarray(e1))
    np.testing.assert_array_equal(g2, np.asarray(e2))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", SIZES)
def test_lex_scan_matches_reference(n, reverse):
    flags, k1, k2 = _lex_inputs(n, seed=n)
    f = np.roll(flags, -1) if reverse else flags  # segment ends
    _assert_lex_matches_reference(f, k1, k2, reverse)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("kind", ["one segment", "every row"])
def test_lex_scan_matches_reference_on_look_back_chains(kind, reverse):
    """The inputs that stress kernel L's look-back on the card: one segment
    over three tiles and a ragged one (every tile waits on its
    predecessor), and every row its own segment."""
    n = 3 * 2048 + 5  # kernel L's tile is 2048 rows
    _, k1, k2 = _lex_inputs(n, seed=7)
    f = np.full(n, kind == "every row")
    f[-1 if reverse else 0] = True
    _assert_lex_matches_reference(f, k1, k2, reverse)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", (127, 4096))
def test_lex_scan_matches_pallas_interpret(n, reverse):
    flags, k1, k2 = _lex_inputs(n, seed=100 + n)
    f = np.roll(flags, -1) if reverse else flags
    with jax.enable_x64(True):
        e1, e2 = segmented_max_scan_pallas(
            jax.numpy.asarray(f), jax.numpy.asarray(k1), jax.numpy.asarray(k2),
            reverse=reverse, interpret=True)
    g1, g2 = _port_lex(f, k1, k2, reverse)
    np.testing.assert_array_equal(g1, np.asarray(e1))
    np.testing.assert_array_equal(g2, np.asarray(e2))


def _xor_inputs(n, seed):
    rng = np.random.default_rng(seed)
    flags = rng.random(n) < 0.02
    flags[0] = True
    return flags, rng.integers(0, 2**32, n, dtype=np.uint32)


def _port_xor(flags, v):
    out = segmented_xor_scan(torch.from_numpy(flags), torch.from_numpy(v.view(np.int32)))
    return out.numpy().view(np.uint32)


@pytest.mark.parametrize("n", SIZES)
def test_xor_scan_matches_reference(n):
    flags, v = _xor_inputs(n, seed=n)
    want = _xor_reference(jax.numpy.asarray(flags), jax.numpy.asarray(v))
    np.testing.assert_array_equal(_port_xor(flags, v), np.asarray(want))


@pytest.mark.parametrize("n", (1, 4096))
def test_xor_scan_matches_pallas_interpret(n):
    flags, v = _xor_inputs(n, seed=200 + n)
    want = segmented_xor_scan_pallas(jax.numpy.asarray(flags), jax.numpy.asarray(v), interpret=True)
    np.testing.assert_array_equal(_port_xor(flags, v), np.asarray(want))


def test_all_flags_and_no_flags_after_head():
    n = 1000
    _, k1, k2 = _lex_inputs(n, seed=1)
    every = np.ones(n, bool)
    g1, g2 = _port_lex(every, k1, k2, reverse=False)  # each row its own segment
    np.testing.assert_array_equal(g1, k1)
    np.testing.assert_array_equal(g2, k2)
    head = np.zeros(n, bool)
    head[0] = True
    g1, _ = _port_lex(head, k1, k2, reverse=False)  # one segment: running max
    np.testing.assert_array_equal(g1[-1], k1.max())
