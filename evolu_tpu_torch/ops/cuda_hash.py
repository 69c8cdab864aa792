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
from evolu_tpu_torch.ops.cuda_lib import check, load, require, stream_handle
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


def timestamp_hash_cuda(a, counter, node, mask, digest):
    """The launch of kernel H. `counter=None` means `a` holds packed keys
    k1 (millis << 16 | counter); `mask` and `digest` may be None."""
    n = a.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=a.device)
    rc = load().evolu_ts_hash(
        a.data_ptr(), None if counter is None else counter.data_ptr(), node.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(),
        None if digest is None else digest.data_ptr(), n, stream_handle(a),
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
    return timestamp_hash_cuda(millis, counter, node, None, None)


def masked_key_hashes_cuda(k1, k2, mask):
    """Kernel H, reconcile form: int64 k1/k2 and bool mask → (hashes, digest)."""
    n = k1.shape[0]
    require(k1, torch.int64, n, "masked_key_hashes k1")
    require(k2, torch.int64, n, "masked_key_hashes k2")
    require(mask, torch.bool, n, "masked_key_hashes mask")
    digest = torch.zeros(1, dtype=torch.int32, device=k1.device)
    return timestamp_hash_cuda(k1, None, k2, mask, digest), digest


# ---- dispatch -------------------------------------------------------------


def masked_key_hashes(k1, k2, mask):
    """Kernel H on a CUDA tensor, its plain version on the CPU."""
    if k1.is_cuda:
        return masked_key_hashes_cuda(k1, k2, mask)
    return masked_key_hashes_plain(k1, k2, mask)
