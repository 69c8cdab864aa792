"""HLC timestamp strings with the reference's exact encoding.

`ISO8601(millis) + "-" + HEX4(counter) + "-" + node` is fixed-width, so
lexicographic order of timestamp strings equals the (millis, counter,
node) tuple order. The device path relies on it through the packed u64
keys `k1 = millis << 16 | counter`, `k2 = node`.
"""

from __future__ import annotations

import datetime

from evolu_tpu_torch.core.murmur import murmur3_32
from evolu_tpu_torch.core.types import Timestamp, TimestampParseError

TIMESTAMP_STRING_LENGTH = 46  # 24 (ISO) + 1 + 4 (hex counter) + 1 + 16 (node)


def millis_to_iso(millis: int) -> str:
    """JS `new Date(millis).toISOString()`: always
    `YYYY-MM-DDTHH:mm:ss.sssZ` (24 chars, 3-digit millis)."""
    dt = datetime.datetime.fromtimestamp(millis // 1000, tz=datetime.timezone.utc)
    return (
        f"{dt.year:04d}-{dt.month:02d}-{dt.day:02d}T{dt.hour:02d}:"
        f"{dt.minute:02d}:{dt.second:02d}.{millis % 1000:03d}Z"
    )


def iso_to_millis(iso: str) -> int:
    """Inverse of millis_to_iso (JS Date.parse on the ISO string)."""
    if (
        len(iso) != 24
        or iso[4] != "-" or iso[7] != "-" or iso[10] != "T"
        or iso[13] != ":" or iso[16] != ":" or iso[19] != "."
        or iso[23] != "Z"
    ):
        raise TimestampParseError(f"bad ISO timestamp: {iso!r}")
    digits = iso[0:4] + iso[5:7] + iso[8:10] + iso[11:13] + iso[14:16] + iso[17:19] + iso[20:23]
    if not digits.isascii() or not digits.isdigit():
        raise TimestampParseError(f"bad ISO timestamp: {iso!r}")
    try:
        dt = datetime.datetime(
            int(iso[0:4]), int(iso[5:7]), int(iso[8:10]),
            int(iso[11:13]), int(iso[14:16]), int(iso[17:19]),
            tzinfo=datetime.timezone.utc,
        )
    except ValueError as e:
        raise TimestampParseError(f"bad ISO timestamp: {iso!r}") from e
    return int(dt.timestamp()) * 1000 + int(iso[20:23])


def timestamp_to_string(t: Timestamp) -> str:
    """Counter is 4 UPPERCASE hex digits; node is 16 lowercase hex."""
    return f"{millis_to_iso(t.millis)}-{t.counter:04X}-{t.node}"


_HEX = set("0123456789abcdefABCDEF")


def timestamp_from_string(s: str) -> Timestamp:
    """Strict parse: separators checked, counter 4 hex digits, node 16 hex
    digits (either case, kept verbatim)."""
    if len(s) != TIMESTAMP_STRING_LENGTH or s[24] != "-" or s[29] != "-":
        raise TimestampParseError(f"bad timestamp string: {s!r}")
    counter_s, node = s[25:29], s[30:46]
    if not all(c in _HEX for c in counter_s) or not all(c in _HEX for c in node):
        raise TimestampParseError(f"bad timestamp string: {s!r}")
    return Timestamp(iso_to_millis(s[0:24]), int(counter_s, 16), node)


def timestamp_to_hash(t: Timestamp) -> int:
    """murmur3-32 (unsigned) of the timestamp's string, node case verbatim."""
    return murmur3_32(timestamp_to_string(t).encode("ascii"))
