"""Canonical timestamp rendering, hashing and packed HLC sort keys.

The reference orders all CRDT writes by the lexicographic order of the
46-char string `ISO8601(millis)-HEX4(counter)-node16`. On device the
timestamps stay columnar — millis int64, counter int32, node u64 (as an
int64 bit pattern) — and

- `timestamp_hashes` gives murmur3-32 of each canonical string: kernel H
  (`ops.cuda_hash`) on a CUDA tensor, the plain render below on the CPU;
- `render_timestamp_strings` gives the canonical strings themselves, as
  an (N, 46) uint8 tensor, from the same plain render;
- `pack_ts_keys` packs (millis, counter) into one u64 whose unsigned
  order equals the string order (node is the second u64 tiebreak).

millis < 2^48 for any representable date, so `millis << 16 | counter`
is exact in 64 bits (it reaches 2^63 from about the year 6429 on, which
is why every key compare in the port is unsigned).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from evolu_tpu_torch.ops import wrap_int32
from evolu_tpu_torch.ops.hash import murmur3_32_bytes

TIMESTAMP_STRING_LENGTH = 46
_M32 = 0xFFFFFFFF


def _fdiv(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def _civil_from_days(days: torch.Tensor):
    """int32-valued days-since-1970-01-01 → (year, month, day), Howard
    Hinnant's civil_from_days with floor division throughout.

    The JAX package runs it in int32, so `days + 719468` wraps for days
    in [2^31 - 719468, 2^31 - 1]; `wrap_int32` repeats that wrap. No later
    step leaves int32 except `era * 146097` at era = -14700, and there
    `doe` is the same exact value in [0, 146096] either way."""
    z = wrap_int32(days + 719468).to(torch.int64)
    era = _fdiv(z, 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524) - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = mp + torch.where(mp < 10, 3, -9)
    y = y + (m <= 2).to(torch.int64)
    return y, m, d


def _digits(x: torch.Tensor, n: int) -> List[torch.Tensor]:
    """x (u32 values in int64) → n ASCII decimal digits, most significant first."""
    return [(x // 10**i) % 10 + ord("0") for i in range(n - 1, -1, -1)]


def _hex_nibble(x: torch.Tensor, upper: bool) -> torch.Tensor:
    return torch.where(x < 10, x + ord("0"), x + (ord("A" if upper else "a") - 10))


def timestamp_bytes(millis, counter, node) -> List[torch.Tensor]:
    """The 46 canonical-string bytes as 46 int64 tensors
    (`YYYY-MM-DDTHH:mm:ss.sssZ-CCCC-n*16`): counter hex UPPER case, node
    hex lower case. Floor division splits millis, so a negative millis
    renders as its pre-1970 date; the year, month and day then render
    as u32 like the JAX path's `.astype(uint32)`."""
    millis = millis.to(torch.int64)
    ms = millis % 1000
    secs = _fdiv(millis, 1000)
    days = wrap_int32(_fdiv(secs, 86400)).to(torch.int64)
    sod = secs % 86400
    hh, mm, ss = sod // 3600, (sod // 60) % 60, sod % 60
    y, mo, d = (v & _M32 for v in _civil_from_days(days))

    dash = torch.full_like(millis, ord("-"))
    colon = torch.full_like(millis, ord(":"))
    cols = _digits(y, 4) + [dash] + _digits(mo, 2) + [dash] + _digits(d, 2)
    cols += [torch.full_like(millis, ord("T"))]
    cols += _digits(hh, 2) + [colon] + _digits(mm, 2) + [colon] + _digits(ss, 2)
    cols += [torch.full_like(millis, ord("."))] + _digits(ms, 3)
    cols += [torch.full_like(millis, ord("Z")), dash]
    c32 = counter.to(torch.int64) & _M32
    cols += [_hex_nibble((c32 >> s) & 0xF, upper=True) for s in (12, 8, 4, 0)]
    cols.append(dash)
    node = node.to(torch.int64)
    for half in ((node >> 32) & _M32, node & _M32):
        cols += [_hex_nibble((half >> s) & 0xF, upper=False)
                 for s in (28, 24, 20, 16, 12, 8, 4, 0)]
    return cols


def render_timestamp_strings(millis, counter, node) -> torch.Tensor:
    """(N,) int64 millis, int32 counter, int64-carried u64 node → (N, 46)
    uint8 canonical strings `YYYY-MM-DDTHH:mm:ss.sssZ-CCCC-n*16`, on the
    tensors' device: the bytes `timestamp_hashes` hashes."""
    return torch.stack(timestamp_bytes(millis, counter, node), dim=1).to(torch.uint8)


def timestamp_hashes(millis, counter, node) -> torch.Tensor:
    """Batched `timestampToHash`: (N,) int64 millis, int32 counter,
    int64-carried u64 node → (N,) int32-carried u32 murmur3 hashes.
    Kernel H on a CUDA tensor, its plain version on the CPU."""
    from evolu_tpu_torch.ops.cuda_hash import timestamp_hashes_cuda, timestamp_hashes_plain

    if millis.is_cuda:
        return timestamp_hashes_cuda(millis, counter, node)
    return timestamp_hashes_plain(millis, counter, node)


def render_hashes_i64(millis, counter, node) -> torch.Tensor:
    """The plain render + murmur3, u32 values in an int64 tensor."""
    return murmur3_32_bytes(timestamp_bytes(millis, counter, node), TIMESTAMP_STRING_LENGTH)


def pack_ts_keys(millis, counter) -> torch.Tensor:
    """(millis, counter) → int64-carried u64 key; unsigned order == string order.

    Key 0 is the "no stored winner" sentinel: a stored message never has
    millis == 0 and counter == 0 with the all-zero node."""
    return (millis.to(torch.int64) << 16) | counter.to(torch.int64)


def unpack_ts_keys(k1: torch.Tensor):
    """Inverse of `pack_ts_keys`: → (millis int64, counter int32). The
    shift is a logical one (masked), so keys ≥ 2^63 unpack right."""
    millis = (k1 >> 16) & ((1 << 48) - 1)
    counter = (k1 & 0xFFFF).to(torch.int32)
    return millis, counter


def pack_ts_key_host(millis, counter):
    """Host twin of `pack_ts_keys` — numpy (→ np.uint64) or Python ints."""
    if isinstance(millis, np.ndarray):
        return (millis.astype(np.uint64) << np.uint64(16)) | counter.astype(np.uint64)
    return (int(millis) << 16) | int(counter)


def node_hex_to_u64(node: str) -> int:
    """16-hex-char node id → uint64 (big-endian nibbles)."""
    return int(node, 16)


def u64_to_node_hex(v: int) -> str:
    """uint64 → the 16 lower-case hex digits of a node id."""
    return f"{v:016x}"
