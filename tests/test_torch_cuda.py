"""Kernels L, X, H and S on the card against their plain PyTorch versions.

Imports neither jax nor `evolu_tpu`, so it runs on the GPU machine:

    python -m pytest tests/test_torch_cuda.py -q

Without a card every test skips with a reason (the CUDA kernels have no
CPU mode); the decision is made inside the fixture, at run time."""

import numpy as np
import pytest
import torch

from evolu_tpu_torch.ops import cuda_hash, cuda_scan

pytestmark = pytest.mark.cuda

SIZES = (1, 127, 128, 4096, 70000, (1 << 20) + 3)
EDGE_MILLIS = [0, 951_782_400_000, 4_107_542_399_000, 253_402_300_799_999,
               -1, -999, -86_400_001, -62_135_596_800_000, 2**47]


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


@pytest.mark.parametrize("n", SIZES)
def test_kernel_x_matches_plain(n, dev):
    f, _, _ = _lex_inputs(n, n, dev)
    v = torch.from_numpy(np.random.default_rng(n).integers(0, 2**32, n, dtype=np.uint32)
                         .view(np.int32)).to(dev)
    assert torch.equal(cuda_scan.segmented_xor_scan(f, v), cuda_scan.segmented_xor_scan_plain(f, v))


@pytest.mark.parametrize("n", [len(EDGE_MILLIS), 70001])
def test_kernel_h_matches_plain(n, dev):
    rng = np.random.default_rng(n)
    millis = np.concatenate([EDGE_MILLIS, 1_700_000_000_000 + rng.integers(0, 10**12, n - len(EDGE_MILLIS))])
    counter = rng.integers(0, 65536, n).astype(np.int32)
    node = rng.integers(0, 2**64, n, dtype=np.uint64)
    node[:2] = [0, 2**64 - 1]
    m, c, d = (torch.from_numpy(x).to(dev) for x in (millis.astype(np.int64), counter, node.view(np.int64)))
    assert torch.equal(cuda_hash.timestamp_hashes_cuda(m, c, d), cuda_hash.timestamp_hashes_plain(m, c, d))
    k1 = (m.clamp(min=0) << 16) | c.to(torch.int64)
    mask = torch.from_numpy(rng.random(n) < 0.6).to(dev)
    got_h, got_d = cuda_hash.masked_key_hashes(k1, d, mask)
    want_h, want_d = cuda_hash.masked_key_hashes_plain(k1, d, mask)
    assert torch.equal(got_h, want_h) and torch.equal(got_d, want_d)


@pytest.mark.parametrize("n", (1, 255, 256, 4097, (1 << 15) + 3, (1 << 20) + 3))
def test_kernel_s_matches_plain(n, dev):
    f, _, _ = _lex_inputs(n, n, dev)
    rng = np.random.default_rng(n)
    v = rng.integers(0, 2**64, n, dtype=np.uint64)
    v[rng.random(n) < 0.2] = np.uint64(2**64 - 1)  # every add wraps
    v[rng.random(n) < 0.1] = np.uint64(1) << np.uint64(63)
    values = torch.from_numpy(v.view(np.int64)).to(dev)
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
