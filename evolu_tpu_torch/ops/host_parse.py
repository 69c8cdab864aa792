"""Vectorized host-side batch parsing.

Parses a whole batch of canonical 46-char timestamp strings and interns
cells with numpy, leaving no per-message Python in the batched apply
path. Timestamps must be exactly `YYYY-MM-DDTHH:mm:ss.sssZ-CCCC-node16`;
any malformed row raises TimestampParseError, aborting the batch.
`parse_packed_timestamps` parses an already-packed buffer of 46-byte
records in one call into the native host library.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from evolu_tpu_torch.core.types import TimestampParseError

_LEN = 46


def _days_from_civil(y, m, d):
    """Inverse of Howard Hinnant's civil_from_days, vectorized int64."""
    y = y - (m <= 2)
    era = np.floor_divide(y, 400)
    yoe = y - era * 400
    mp = m + np.where(m > 2, -3, 9)
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def _days_in_month(y, m):
    """Vectorized month lengths with Gregorian leap rules."""
    lengths = np.array([0, 31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31])
    days = lengths[m]
    leap = ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)
    return np.where((m == 2) & leap, 29, days)


def parse_timestamp_strings(timestamps: Sequence[str], with_case: bool = False):
    """Batch `timestampFromString`: → (millis int64, counter int32,
    node uint64), validating the full fixed-width layout.

    With `with_case=True`, appends a per-row bool array: True where the
    row uses the canonical encoder's hex case (UPPERCASE counter,
    lowercase node). Callers quarantine non-canonical rows to host
    paths: the device kernels order by numeric keys and hash a canonical
    re-render, which matches the reference's raw-string order and
    verbatim-node hash only for canonical strings."""
    n = len(timestamps)
    if n == 0:
        empty = (np.empty(0, np.int64), np.empty(0, np.int32), np.empty(0, np.uint64))
        return (*empty, np.ones(0, bool)) if with_case else empty
    # Per-string length check first: a joined-length check alone would
    # accept e.g. ["", "<two valid stamps concatenated>"].
    if any(len(t) != _LEN for t in timestamps):
        raise TimestampParseError("malformed timestamp in batch")
    joined = "".join(timestamps)
    if not joined.isascii():
        raise TimestampParseError("malformed timestamp in batch")
    buf = np.frombuffer(joined.encode("ascii"), np.uint8).reshape(n, _LEN)

    seps = {4: ord("-"), 7: ord("-"), 10: ord("T"), 13: ord(":"), 16: ord(":"),
            19: ord("."), 23: ord("Z"), 24: ord("-"), 29: ord("-")}
    for pos, ch in seps.items():
        if not (buf[:, pos] == ch).all():
            raise TimestampParseError("malformed timestamp in batch")

    def dec(a, b):
        cols = buf[:, a:b]
        if ((cols < ord("0")) | (cols > ord("9"))).any():
            raise TimestampParseError("malformed timestamp in batch")
        v = np.zeros(n, np.int64)
        for i in range(a, b):
            v = v * 10 + (buf[:, i].astype(np.int64) - ord("0"))
        return v

    y, mo, d = dec(0, 4), dec(5, 7), dec(8, 10)
    hh, mi, ss, ms = dec(11, 13), dec(14, 16), dec(17, 19), dec(20, 23)
    # Field ranges as the scalar parser's datetime constructor checks them
    # (a month 13 or hour 25 must abort, not wrap).
    if (
        (y < 1).any()
        or (mo < 1).any() or (mo > 12).any()
        or (d < 1).any() or (d > _days_in_month(y, mo)).any()
        or (hh > 23).any() or (mi > 59).any() or (ss > 59).any()
    ):
        raise TimestampParseError("malformed timestamp in batch")
    days = _days_from_civil(y, mo, d)
    millis = ((days * 86400 + hh * 3600 + mi * 60 + ss) * 1000) + ms

    def hexv(a, b):
        # Both hex cases parse, like the scalar parser.
        v = np.zeros(n, np.uint64)
        for i in range(a, b):
            c = buf[:, i]
            digit = (c >= ord("0")) & (c <= ord("9"))
            lower = (c >= ord("a")) & (c <= ord("f"))
            upper = (c >= ord("A")) & (c <= ord("F"))
            if ((~digit) & (~lower) & (~upper)).any():
                raise TimestampParseError("malformed timestamp in batch")
            nib = np.where(
                digit, c - ord("0"),
                np.where(lower, c - ord("a") + 10, c - ord("A") + 10),
            ).astype(np.uint64)
            v = (v << np.uint64(4)) | nib
        return v

    counter = hexv(25, 29).astype(np.int32)
    node = hexv(30, 46)
    if with_case:
        cb, nb = buf[:, 25:29], buf[:, 30:46]
        case_ok = ~(
            ((cb >= ord("a")) & (cb <= ord("f"))).any(axis=1)
            | ((nb >= ord("A")) & (nb <= ord("F"))).any(axis=1)
        )
        return millis, counter, node, case_ok
    return millis, counter, node


def parse_packed_timestamps(packed: bytes, n: int, with_case: bool = False, strict: bool = True):
    """Native (C) batch parse over an already-packed buffer of n 46-byte
    records: one pass, and no join when the caller already built the
    buffer (the relay's packed ingest reuses its insert buffer here).

    Returns the same tuple as `parse_timestamp_strings`. With
    `strict=False`, returns None when the native library is unavailable
    so the caller can parse the strings with numpy."""
    import ctypes

    from evolu_tpu_torch.storage.native import load_library, native_available

    if not strict and not native_available():
        return None
    lib = load_library()
    if len(packed) != n * _LEN:
        raise TimestampParseError("malformed timestamp in batch")
    millis = np.empty(n, np.int64)
    counter = np.empty(n, np.int32)
    node = np.empty(n, np.uint64)
    case_ok = np.empty(n, np.uint8)
    rc = lib.eh_parse_timestamps(
        packed, n,
        millis.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        counter.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        node.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        case_ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if rc != 0:
        raise TimestampParseError("malformed timestamp in batch")
    if with_case:
        return millis, counter, node, case_ok.astype(bool)
    return millis, counter, node


def intern_cells(
    tables: Sequence[str], rows: Sequence[str], columns: Sequence[str]
) -> Tuple[np.ndarray, List[Tuple[str, str, str]]]:
    """→ (cell_id int32 per message, unique cell tuples indexed by id),
    ids dense 0..k-1 in order of first occurrence."""
    # Length-prefixed keys: a separator inside a field can never collide
    # two distinct cells (fields arrive from untrusted peers).
    keys = np.array(
        [f"{len(t)}.{len(r)}.{t}{r}{c}" for t, r, c in zip(tables, rows, columns)],
        dtype=object,
    )
    _, first_idx, inverse = np.unique(keys, return_index=True, return_inverse=True)
    order = np.argsort(first_idx, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    cell_id = rank[inverse].astype(np.int32)
    cells = [(tables[i], rows[i], columns[i]) for i in first_idx[order]]
    return cell_id, cells
