"""Batched Merkle-trie minute deltas on the card.

XOR is associative and commutative, so a whole batch reduces to one XOR
delta per distinct (owner, minute); the host then applies each delta
along its ≤16-node path (`core.merkle.apply_prefix_xors`).

Device pass: the hashed rows (kernel H) → minute key with JS `|0`
int32 truncation → group by (owner, minute) with a sort → ONE inclusive
segmented XOR scan (kernel X); at each segment's last row the scan
value IS the segment's XOR, the only positions the decoders read.
Hashes are u32 carried in int32; the host converts to JS signed int32.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from evolu_tpu_torch.core.merkle import minutes_base3
from evolu_tpu_torch.core.murmur import to_int32
from evolu_tpu_torch.ops import columns_to_device, to_host_many, wrap_int32
from evolu_tpu_torch.ops.cuda_scan import segmented_xor_scan
from evolu_tpu_torch.ops.encode import timestamp_hashes

_SENTINEL_HI = 0x7FFFFFFF  # int32 max: masked rows sort after every real key

# Tile width of the block-local grouping sort: only the GROUPING of equal
# keys matters to the decoders, so rows sort within (N/8192, 8192) tiles.
_GROUP_TILE = 8192


def segment_xor2_core(hi_i32, lo_i32, hashes_i32, tile_local=True):
    """Sorted segmented-XOR reduce over an (hi, lo) int32 key pair packed
    into one int64 key, the hash gathered by the sort's permutation.

    Masked rows must carry hash 0 and hi = _SENTINEL_HI; validity is
    read back from the sorted hi key. → (hi_sorted, lo_sorted, seg_end,
    seg_xor, valid_sorted); rows where seg_end & valid give one (key,
    xor) per segment.

    With `tile_local` and a length that tiles (n ≥ 2·8192, n % 8192 ==
    0) the sort runs within 8192-row tiles: a key spanning tiles emits
    one partial delta per tile, and equal keys meeting at a tile junction
    fuse back into one segment. The decoders XOR-merge repeated keys, so
    the decoded deltas are the same either way, but the raw arrays are
    not comparable outside segment ends."""
    key = (hi_i32.to(torch.int64) << 32) | (lo_i32.to(torch.int64) & 0xFFFFFFFF)
    n = key.shape[0]
    if tile_local and n >= 2 * _GROUP_TILE and n % _GROUP_TILE == 0:
        k2, perm = torch.sort(key.reshape(-1, _GROUP_TILE), dim=1)
        k_s = k2.reshape(n)
        h_sorted = torch.gather(hashes_i32.reshape(-1, _GROUP_TILE), 1, perm).reshape(n)
    else:
        k_s, perm = torch.sort(key)
        h_sorted = hashes_i32[perm]
    hi_s = (k_s >> 32).to(torch.int32)
    lo_s = wrap_int32(k_s)
    valid_sorted = hi_s != _SENTINEL_HI
    key_change = k_s[1:] != k_s[:-1]
    one = key_change.new_ones(1)
    seg_start = torch.cat([one, key_change])
    seg_end = torch.cat([key_change, one])
    seg_xor = segmented_xor_scan(seg_start, h_sorted)
    return hi_s, lo_s, seg_end, seg_xor, valid_sorted


def js_minutes(millis: torch.Tensor) -> torch.Tensor:
    """JS `((millis/1000/60) | 0)`: floor division, then the int32 wrap of
    `|0` (year 9999 gives a minute above 2^31, which wraps negative)."""
    return wrap_int32(torch.div(millis, 60000, rounding_mode="floor"))


def owner_minute_segments(owner_ix, millis, hashes_i32, valid, tile_local=True):
    """Segmented XOR over (owner, minute): owner in the hi half (sentinel
    int32-max for masked rows), JS-wrapped minute in the lo half.
    → (owner_sorted, minute_sorted, seg_end, seg_xor, valid_sorted)."""
    sentinel = torch.full_like(hashes_i32, _SENTINEL_HI)
    hi = torch.where(valid, owner_ix.to(torch.int32), sentinel)
    lo = torch.where(valid, js_minutes(millis), torch.zeros_like(hashes_i32))
    return segment_xor2_core(hi, lo, hashes_i32, tile_local=tile_local)


def decode_owner_minute_deltas(
    owner_sorted, minute_sorted, seg_end, seg_xor, valid_sorted
) -> Dict[int, Dict[str, int]]:
    """Host side: `owner_minute_segments` outputs (numpy) → {owner_ix:
    {base3-minute-key: signed-int32 delta}} for `apply_prefix_xors`.
    Repeated (owner, minute) keys XOR-combine (tile partials)."""
    owner_sorted, minute_sorted, seg_end, seg_xor, valid_sorted = (
        np.asarray(x) for x in (owner_sorted, minute_sorted, seg_end, seg_xor, valid_sorted)
    )
    out: Dict[int, Dict[str, int]] = {}
    for i in np.nonzero(seg_end & valid_sorted)[0]:
        o_ix, minute = int(owner_sorted[i]), int(minute_sorted[i])
        key = minutes_base3(minute * 60000)
        d = out.setdefault(o_ix, {})
        d[key] = to_int32(d.get(key, 0) ^ int(seg_xor[i]))
    return out


def minute_deltas_core(millis, counter, node, xor_mask):
    """Per-minute XOR deltas for one owner's timestamp batch on tensors:
    int64 millis, int32 counter, int64-carried u64 node, bool xor_mask
    (False rows contribute nothing). Masked rows park under the hi-key
    sentinel, so they never share a segment with a real minute. →
    (minute_sorted int64, seg_end, seg_xor, valid_sorted)."""
    zero = torch.zeros((), dtype=torch.int32, device=millis.device)
    hashes = torch.where(xor_mask, timestamp_hashes(millis, counter, node), zero)
    hi = torch.where(xor_mask, zero, torch.full_like(hashes, _SENTINEL_HI))
    lo = torch.where(xor_mask, js_minutes(millis), zero)
    _, lo_s, seg_end, seg_xor, valid_sorted = segment_xor2_core(hi, lo, hashes)
    return lo_s.to(torch.int64), seg_end, seg_xor, valid_sorted


def merkle_minute_deltas(millis, counter, node, xor_mask, device=None):
    """`minute_deltas_core` on host numpy columns (node as np.uint64):
    uploaded to `device` (None = the card), outputs pulled back as numpy
    for `minute_deltas_to_dict`."""
    t = columns_to_device({"millis": millis, "counter": counter, "node": node,
                           "xor_mask": xor_mask}, device)
    return to_host_many(*minute_deltas_core(t["millis"], t["counter"], t["node"], t["xor_mask"]))


def minute_deltas_to_dict(m_sorted, seg_end, seg_xor, valid_sorted) -> Dict[str, int]:
    """Host side: one owner's outputs → {base3-minute-key: signed-int32
    delta}. Repeated minute keys XOR-combine."""
    m, ends, xs, valid = (np.asarray(x) for x in (m_sorted, seg_end, seg_xor, valid_sorted))
    out: Dict[str, int] = {}
    for i in np.nonzero(ends & valid)[0]:
        key = minutes_base3(int(m[i]) * 60000)
        out[key] = to_int32(out.get(key, 0) ^ int(xs[i]))
    return out
