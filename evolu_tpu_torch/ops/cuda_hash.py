"""Kernel H (`csrc/ts_hash.cu`) and its plain PyTorch version.

murmur3-32 of each canonical timestamp string, the hash_render stage of
the reconcile pass. Replaces evolu_tpu/ops/pallas_hash.py `_hash_kernel`.
Two entry shapes share the one kernel:

- `timestamp_hashes_*(millis, counter, node)` — the columns form behind
  `encode.timestamp_hashes`;
- `masked_key_hashes_*(k1, k2, mask)` — the reconcile form: sorted HLC
  keys plus the xor mask → (`hash if xor else 0`, batch XOR digest).

Hashes are u32 carried in int32; the digest is a 1-element int32 tensor.
"""

from __future__ import annotations

import torch

from evolu_tpu_torch.ops import wrap_int32
from evolu_tpu_torch.ops.cuda_lib import KernelError, check, load, require, stream_handle, stream_state
from evolu_tpu_torch.ops.encode import render_hashes_i64, unpack_ts_keys


# ---- plain versions -------------------------------------------------------


def xor_reduce_plain(x: torch.Tensor) -> torch.Tensor:
    """XOR of every element of a 1-D int tensor → 1-element tensor, by
    folding halves (torch has no XOR reduction)."""
    x = x.reshape(-1)
    if x.shape[0] == 0:
        return x.new_zeros(1)
    while x.shape[0] > 1:
        if x.shape[0] % 2:
            x = torch.cat([x, x.new_zeros(1)])
        half = x.shape[0] // 2
        x = x[:half] ^ x[half:]
    return x


def timestamp_hashes_plain(millis, counter, node):
    """Plain version of kernel H, columns form → int32-carried u32."""
    return wrap_int32(render_hashes_i64(millis, counter, node))


def masked_key_hashes_plain(k1, k2, mask):
    """Plain version of kernel H, reconcile form → (hashes, digest)."""
    millis, counter = unpack_ts_keys(k1)
    hashes = torch.where(mask, timestamp_hashes_plain(millis, counter, k2),
                         torch.zeros((), dtype=torch.int32, device=k1.device))
    return hashes, xor_reduce_plain(hashes)


# ---- kernel ---------------------------------------------------------------


def _digest_scratch(buf, device):
    """The reconcile form's digest scratch (None before the first call): a
    block counter that each call leaves at 0, and one partial a block,
    zeroed once, when made. → (state, view), both the buffer itself."""
    # No epoch and never replaced: launches on one stream run in order, so
    # threads that share the stream need nothing more than the buffer.
    if buf is None:
        size = load().evolu_ts_hash_scratch_bytes()
        if size <= 0:
            raise KernelError("evolu_tpu_torch: timestamp hash grid query failed")
        buf = torch.zeros(size, dtype=torch.uint8, device=device)
    return buf, buf


def timestamp_hash_cuda(a, counter, node, mask):
    """The launch of kernel H, one a call. `counter=None` means `a` holds
    packed keys k1 (millis << 16 | counter) and `mask` picks the rows to
    hash: the one output holds the n hashes, then the digest. Otherwise
    every row is hashed and the output holds the n hashes."""
    n = a.shape[0]
    keys = counter is None
    if keys:
        scratch, stream = stream_state("digest", a, _digest_scratch)
    else:
        scratch, stream = None, stream_handle(a)
    out = torch.empty(n + 1 if keys else n, dtype=torch.int32, device=a.device)
    rc = load().evolu_ts_hash(
        a.data_ptr(), None if keys else counter.data_ptr(), node.data_ptr(),
        mask.data_ptr() if keys else None, out.data_ptr(),
        scratch.data_ptr() if keys else None, n, stream,
    )
    check(rc, "timestamp hash")
    timestamp_hash_cuda.launches += 1
    return out


timestamp_hash_cuda.launches = 0


def timestamp_hashes_cuda(millis, counter, node):
    """Kernel H, columns form: int64 millis, int32 counter, int64 node."""
    n = millis.shape[0]
    require(millis, torch.int64, n, "timestamp_hashes millis")
    require(counter, torch.int32, n, "timestamp_hashes counter")
    require(node, torch.int64, n, "timestamp_hashes node")
    return timestamp_hash_cuda(millis, counter, node, None)


def masked_key_hashes_cuda(k1, k2, mask):
    """Kernel H, reconcile form: int64 k1/k2 and bool mask → (hashes,
    digest), two views of one allocation; no memset, one launch."""
    n = k1.shape[0]
    require(k1, torch.int64, n, "masked_key_hashes k1")
    require(k2, torch.int64, n, "masked_key_hashes k2")
    require(mask, torch.bool, n, "masked_key_hashes mask")
    # Both views from one call: two slices, or `split`, cost more host time.
    hashes, digest = timestamp_hash_cuda(k1, None, k2, mask).split_with_sizes((n, 1))
    return hashes, digest


# ---- dispatch -------------------------------------------------------------


def masked_key_hashes(k1, k2, mask):
    """Kernel H on a CUDA tensor, its plain version on the CPU."""
    if k1.is_cuda:
        return masked_key_hashes_cuda(k1, k2, mask)
    return masked_key_hashes_plain(k1, k2, mask)
