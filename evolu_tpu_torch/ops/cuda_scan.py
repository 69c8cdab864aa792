"""Kernels L, X and S (`csrc/seg_scan.cu`) and their plain PyTorch versions.

- L, `segmented_max_scan`: inclusive segmented lexicographic max of
  (k1, k2) unsigned u64 pairs (int64 bit patterns). `flags[i]` marks a
  segment start, or a segment end with `reverse=True`, when the scan
  runs right to left. Replaces evolu_tpu/ops/pallas_scan.py `_LEX_KERNEL`.
- X, `segmented_xor_scan`: inclusive segmented XOR of u32 hashes (int32
  bit patterns); at a segment's last row the value is the segment's
  Merkle delta. Replaces pallas_scan.py `_XOR_KERNEL`.
- S, `segmented_sum_scan`: inclusive segmented modular u64 sum (int64
  bit patterns; int64 `+` wraps exactly as u64 addition does), forward,
  flags marking segment starts. Serves the typed-CRDT folds (counter
  pos/neg sums, RGA alive slots, tensor sum/mean). Replaces
  pallas_scan.py `_SUM_KERNEL`.

On a CUDA tensor the dispatchers launch the kernel (or raise); the plain
versions serve CPU tensors only. The plain versions are the blocked
Hillis–Steele form of evolu_tpu/ops/merge.py::_segmented_max_scan:
log2(256) shifted combines inside (N/256, 256) rows, then the same scan
over the row totals (recursively) and a carry into each row.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch

from evolu_tpu_torch.ops import u64_order
from evolu_tpu_torch.ops.cuda_lib import check, load, require, stream_state

_BLOCK = 256


# ---- plain versions -------------------------------------------------------


def _lex_max(left: Sequence[torch.Tensor], right: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Elementwise lexicographic max of unsigned (a1, a2) vs (b1, b2)."""
    a1, a2 = left
    b1, b2 = right
    a_wins = (u64_order(a1) > u64_order(b1)) | ((a1 == b1) & (u64_order(a2) >= u64_order(b2)))
    return [torch.where(a_wins, a1, b1), torch.where(a_wins, a2, b2)]


def _xor(left: Sequence[torch.Tensor], right: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return [left[0] ^ right[0]]


def _add(left: Sequence[torch.Tensor], right: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return [left[0] + right[0]]


def _shift_right(x: torch.Tensor, shift: int) -> torch.Tensor:
    """Rows shifted `shift` columns right, the monoid identity (0/False)
    shifted in."""
    pad = torch.zeros((x.shape[0], shift), dtype=x.dtype, device=x.device)
    return torch.cat([pad, x[:, :-shift]], dim=1)


def _seg_scan_plain(flags: torch.Tensor, vals: Sequence[torch.Tensor],
                    op: Callable) -> List[torch.Tensor]:
    """Inclusive segmented scan under `combine(l, r) = (l.f | r.f,
    r.f ? r.v : op(l.v, r.v))`, forward, on 1-D tensors."""
    n = flags.shape[0]
    if n == 0:
        return [v.clone() for v in vals]
    width = min(_BLOCK, n)
    pad = (-n) % width
    if pad:  # identity rows at the end never reach earlier outputs
        flags = torch.cat([flags, flags.new_zeros(pad)])
        vals = [torch.cat([v, v.new_zeros(pad)]) for v in vals]
    f = flags.reshape(-1, width)
    v = [x.reshape(-1, width) for x in vals]
    shift = 1
    while shift < width:
        m = op([_shift_right(x, shift) for x in v], v)
        v = [torch.where(f, x, mx) for x, mx in zip(v, m)]
        f = f | _shift_right(f, shift)
        shift *= 2
    if f.shape[0] > 1:
        # Exclusive carry from the scan of the row totals, combined into
        # the rows whose prefix holds no segment start (f is that mask).
        c = _seg_scan_plain(f[:, -1], [x[:, -1] for x in v], op)
        e = [torch.cat([x.new_zeros(1), x[:-1]]) for x in c]
        carried = op([x[:, None] for x in e], v)
        v = [torch.where(f, x, cx) for x, cx in zip(v, carried)]
    return [x.reshape(-1)[:n] for x in v]


def segmented_max_scan_plain(flags, k1, k2, reverse: bool = False):
    """Plain version of kernel L (any device)."""
    if reverse:
        o1, o2 = _seg_scan_plain(flags.flip(0), [k1.flip(0), k2.flip(0)], _lex_max)
        return o1.flip(0), o2.flip(0)
    o1, o2 = _seg_scan_plain(flags, [k1, k2], _lex_max)
    return o1, o2


def segmented_xor_scan_plain(flags, values):
    """Plain version of kernel X (any device)."""
    (out,) = _seg_scan_plain(flags, [values], _xor)
    return out


def segmented_sum_scan_plain(flags, values):
    """Plain version of kernel S (any device)."""
    (out,) = _seg_scan_plain(flags, [values], _add)
    return out


# ---- kernels --------------------------------------------------------------


class _LookBack:
    """Look-back scratch of one device and stream: the tiles' status words
    and values, zeroed when made, and the epoch of the last call on it."""

    __slots__ = ("buf", "tiles", "rows", "epoch")

    def __init__(self, buf, tiles, rows):
        self.buf, self.tiles, self.rows, self.epoch = buf, tiles, rows, 0


_EPOCH_LIMIT = 1 << 29  # status words hold epoch << 3 (seg_scan.cu kEpochLimit)


def _next_epoch(s, device, n: int):
    """The look-back state `s` (None before the first call) ready for one
    scan of n rows: grown to the largest n seen, zeroed only when made or
    when the epoch wraps, and on a fresh epoch, so a status word an
    earlier call left never reads as ready. → (state, (buf, tiles,
    epoch)): the view is taken here, under `stream_state`'s lock, and
    holds the buffer itself, so a grow by another thread cannot free it
    before this launch is queued."""
    if s is None or n > s.rows:
        lib = load()
        tile = lib.evolu_seg_scan_tile_rows()
        tiles = max(-(-n // tile), 2 * s.tiles if s is not None else 1)
        buf = torch.zeros(lib.evolu_seg_scan_lookback_bytes(tiles), dtype=torch.uint8, device=device)
        s = _LookBack(buf, tiles, tiles * tile)
    s.epoch += 1
    if s.epoch == _EPOCH_LIMIT:
        s.buf.zero_()
        s.epoch = 1
    return s, (s.buf, s.tiles, s.epoch)


def _lookback_scratch(t, n: int):
    """(buffer, tiles, epoch, stream) for one look-back scan of n rows on
    `t`'s device and current stream, whose scratch L, X and S share."""
    (buf, tiles, epoch), stream = stream_state("lookback", t, _next_epoch, n)
    return buf, tiles, epoch, stream


def segmented_max_scan_cuda(flags, k1, k2, reverse: bool = False):
    """Kernel L on CUDA tensors: bool flags, int64 k1/k2 → (m1, m2). One
    launch, no allocation but the outputs."""
    n = flags.shape[0]
    require(flags, torch.bool, n, "segmented_max_scan flags")
    require(k1, torch.int64, n, "segmented_max_scan k1")
    require(k2, torch.int64, n, "segmented_max_scan k2")
    o1 = torch.empty(n, dtype=torch.int64, device=k1.device)
    o2 = torch.empty(n, dtype=torch.int64, device=k1.device)
    scratch, tiles, epoch, stream = _lookback_scratch(k1, n)
    rc = load().evolu_seg_lex_max_scan(
        flags.data_ptr(), k1.data_ptr(), k2.data_ptr(), o1.data_ptr(), o2.data_ptr(),
        n, int(reverse), scratch.data_ptr(), tiles, epoch, stream,
    )
    check(rc, "segmented lex-max scan")
    segmented_max_scan_cuda.launches += 1
    return o1, o2


segmented_max_scan_cuda.launches = 0


def segmented_xor_scan_cuda(flags, values):
    """Kernel X on CUDA tensors: bool flags, int32 values → int32. One
    launch, no allocation but the output."""
    n = flags.shape[0]
    require(flags, torch.bool, n, "segmented_xor_scan flags")
    require(values, torch.int32, n, "segmented_xor_scan values")
    out = torch.empty(n, dtype=torch.int32, device=values.device)
    scratch, tiles, epoch, stream = _lookback_scratch(values, n)
    rc = load().evolu_seg_xor_scan(
        flags.data_ptr(), values.data_ptr(), out.data_ptr(), n, scratch.data_ptr(), tiles, epoch, stream,
    )
    check(rc, "segmented xor scan")
    segmented_xor_scan_cuda.launches += 1
    return out


segmented_xor_scan_cuda.launches = 0


def segmented_sum_scan_cuda(flags, values):
    """Kernel S on CUDA tensors: bool flags, int64 values → int64. One
    launch, no allocation but the output."""
    n = flags.shape[0]
    require(flags, torch.bool, n, "segmented_sum_scan flags")
    require(values, torch.int64, n, "segmented_sum_scan values")
    out = torch.empty(n, dtype=torch.int64, device=values.device)
    scratch, tiles, epoch, stream = _lookback_scratch(values, n)
    rc = load().evolu_seg_sum_scan(
        flags.data_ptr(), values.data_ptr(), out.data_ptr(), n, scratch.data_ptr(), tiles, epoch, stream,
    )
    check(rc, "segmented sum scan")
    segmented_sum_scan_cuda.launches += 1
    return out


segmented_sum_scan_cuda.launches = 0


# ---- dispatch -------------------------------------------------------------


def segmented_max_scan(flags, k1, k2, reverse: bool = False):
    """Kernel L on a CUDA tensor, its plain version on the CPU."""
    if flags.is_cuda:
        return segmented_max_scan_cuda(flags, k1, k2, reverse=reverse)
    return segmented_max_scan_plain(flags, k1, k2, reverse=reverse)


def segmented_xor_scan(flags, values):
    """Kernel X on a CUDA tensor, its plain version on the CPU."""
    if flags.is_cuda:
        return segmented_xor_scan_cuda(flags, values)
    return segmented_xor_scan_plain(flags, values)


def segmented_sum_scan(flags, values):
    """Kernel S on a CUDA tensor, its plain version on the CPU."""
    if flags.is_cuda:
        return segmented_sum_scan_cuda(flags, values)
    return segmented_sum_scan_plain(flags, values)
