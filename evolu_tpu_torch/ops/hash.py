"""Batched MurmurHash3 x86/32 in plain PyTorch.

Bit-exact with `core.murmur.murmur3_32`. torch has no uint32 arithmetic
on the CPU, so every u32 value rides in an int64 tensor in [0, 2^32)
and each step masks back to 32 bits. The two murmur multipliers are
32-bit, so a 32×32 product would overflow int64; `_mul32` multiplies by
the constant's 16-bit halves instead, which keeps every intermediate
below 2^49 and the result exact.
"""

from __future__ import annotations

from typing import Sequence

import torch

from evolu_tpu_torch.ops import wrap_int32

_M32 = 0xFFFFFFFF
_C1 = 0xCC9E2D51
_C2 = 0x1B873593


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) and a constant c < 2^32."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def _mix_k(k: torch.Tensor) -> torch.Tensor:
    return _mul32(_rotl(_mul32(k, _C1), 15), _C2)


def murmur3_32_bytes(bytes_i64: Sequence[torch.Tensor], length: int, seed: int = 0) -> torch.Tensor:
    """murmur3-32 over `length` bytes given as `length` int64 tensors
    (one per byte position, values 0..255) → int64 tensor of u32 values."""
    if len(bytes_i64) != length:
        raise ValueError(f"expected {length} byte columns, got {len(bytes_i64)}")
    h = torch.full_like(bytes_i64[0], seed & _M32)
    n_blocks = length // 4
    for i in range(n_blocks):
        b = i * 4
        k = (
            bytes_i64[b]
            | (bytes_i64[b + 1] << 8)
            | (bytes_i64[b + 2] << 16)
            | (bytes_i64[b + 3] << 24)
        )
        h = _rotl(h ^ _mix_k(k), 13)
        h = (_mul32(h, 5) + 0xE6546B64) & _M32
    tail = length & 3
    if tail:
        base = n_blocks * 4
        k = torch.zeros_like(h)
        if tail >= 3:
            k = k ^ (bytes_i64[base + 2] << 16)
        if tail >= 2:
            k = k ^ (bytes_i64[base + 1] << 8)
        k = k ^ bytes_i64[base]
        h = h ^ _mix_k(k)
    h = h ^ length
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def murmur3_32_batch(data: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """murmur3-32 of each row of an (N, L) uint8 tensor → (N,) u32 hashes
    as int32 bit patterns, on the tensor's device. Every row is L bytes
    long (no per-row lengths)."""
    _, length = data.shape
    cols = data.to(torch.int64)
    return wrap_int32(murmur3_32_bytes([cols[:, i] for i in range(length)], length, seed))
