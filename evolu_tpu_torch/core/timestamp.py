"""Hybrid logical clocks with the reference's exact encoding and rules.

`ISO8601(millis) + "-" + HEX4(counter) + "-" + node` is fixed-width, so
lexicographic order of timestamp strings equals the (millis, counter,
node) tuple order. The device path relies on it through the packed u64
keys `k1 = millis << 16 | counter`, `k2 = node`. The send and receive
rules, and the batch fold of receive over a whole command, are host
work (Python and numpy), as in the JAX package.
"""

from __future__ import annotations

import datetime
from typing import Optional

import numpy as np

from evolu_tpu_torch.core.ids import create_node_id
from evolu_tpu_torch.core.murmur import murmur3_32
from evolu_tpu_torch.core.types import (
    MAX_COUNTER,
    Timestamp,
    TimestampCounterOverflowError,
    TimestampDriftError,
    TimestampDuplicateNodeError,
    TimestampParseError,
)

SYNC_NODE_ID = "0000000000000000"
TIMESTAMP_STRING_LENGTH = 46  # 24 (ISO) + 1 + 4 (hex counter) + 1 + 16 (node)


def create_initial_timestamp(node: Optional[str] = None) -> Timestamp:
    """millis 0, counter 0 and a fresh random node id."""
    return Timestamp(0, 0, node if node is not None else create_node_id())


def create_sync_timestamp(millis: int = 0) -> Timestamp:
    """The all-zero node id: the key of 'everything after minute X'."""
    return Timestamp(millis, 0, SYNC_NODE_ID)


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


def _increment_counter(counter: int) -> int:
    if counter < MAX_COUNTER:
        return counter + 1
    raise TimestampCounterOverflowError()


def send_timestamp(t: Timestamp, now: int, max_drift: int = 60000) -> Timestamp:
    """Stamp a local event: millis' = max(local.millis, now); the same
    millis increments the counter, a newer wall clock resets it to 0.
    Drift guard: next - now <= max_drift."""
    next_millis = max(t.millis, now)
    if next_millis - now > max_drift:
        raise TimestampDriftError(next_millis, now)
    counter = _increment_counter(t.counter) if next_millis == t.millis else 0
    return Timestamp(next_millis, counter, t.node)


def receive_timestamp(
    local: Timestamp, remote: Timestamp, now: int, max_drift: int = 60000
) -> Timestamp:
    """Merge a remote timestamp into the local clock. The checks run in
    the reference's order: drift, then duplicate node, then the counter
    rules."""
    next_millis = max(local.millis, remote.millis, now)
    if next_millis - now > max_drift:
        raise TimestampDriftError(next_millis, now)
    if local.node == remote.node:
        raise TimestampDuplicateNodeError(local.node)
    if next_millis == local.millis and next_millis == remote.millis:
        counter = _increment_counter(max(local.counter, remote.counter))
    elif next_millis == local.millis:
        counter = _increment_counter(local.counter)
    elif next_millis == remote.millis:
        counter = _increment_counter(remote.counter)
    else:
        counter = 0
    return Timestamp(next_millis, counter, local.node)


def receive_timestamps_batch(
    local: Timestamp, millis, counter, node_hex, now: int = 0, max_drift: int = 60000,
) -> Timestamp:
    """`receive_timestamp` folded over a whole batch in O(n) numpy.

    With one `now` for the whole command, the fold reduces: the final
    millis is the batch's prefix max, and the counter follows a max-plus
    recurrence `c_i = max(a_i, c_{i-1} + 1)` inside runs where the
    prefix max is flat, resetting when it rises, so the final counter is
    a window max over the last run. If any step could error (drift,
    duplicate node, a counter that might overflow), the exact sequential
    fold runs instead, so the error's type, payload and position match.

    `millis`/`counter` are numpy arrays; `node_hex` is the raw wire node
    strings (the duplicate-node check is an exact string compare)."""
    return _receive_batch(
        local, millis, counter, now, max_drift,
        dup_screen=lambda: any(h == local.node for h in node_hex),
        nodes=lambda: node_hex,
    )


def receive_timestamps_batch_packed(
    local: Timestamp, millis, counter, node_u64, nodes, now: int = 0, max_drift: int = 60000,
) -> Timestamp:
    """`receive_timestamps_batch` for the packed receive: node ids arrive
    as the parsed uint64 column, and `nodes` is a zero-argument callable
    giving the raw node strings, called only when a screen fires and
    the exact sequential fold must run. The duplicate-node screen
    compares u64 values, which is case-insensitive and so a superset of
    the sequential fold's exact string equality: a false positive only
    costs the slow path, never a wrong outcome."""
    try:
        local_u64 = np.uint64(int(local.node, 16))
    except (ValueError, OverflowError):
        # A non-hex or out-of-range local node: sequential, as the
        # safe path for direct callers (the worker's strict parse pins
        # 16 hex characters).
        return _receive_batch(local, millis, counter, now, max_drift,
                              dup_screen=lambda: True, nodes=nodes)
    return _receive_batch(
        local, millis, counter, now, max_drift,
        dup_screen=lambda: bool((np.asarray(node_u64, np.uint64) == local_u64).any()),
        nodes=nodes,
    )


def _receive_batch(
    local: Timestamp, millis, counter, now: int, max_drift: int, dup_screen, nodes,
) -> Timestamp:
    """The closed-form fold. `dup_screen()` must be True whenever any
    remote node string-equals the local node (supersets only force the
    sequential path); `nodes()` gives the raw node strings for it."""
    n = len(millis)
    if n == 0:
        return local
    millis = np.asarray(millis, np.int64)
    counter_arr = np.asarray(counter, np.int64)

    seed = max(local.millis, now)
    pm = np.maximum.accumulate(np.maximum(millis, seed))
    prev_pm = np.empty_like(pm)
    prev_pm[0] = local.millis
    prev_pm[1:] = pm[:-1]
    tie_local = pm == prev_pm
    tie_remote = pm == millis

    # Conservative screens: any possible error takes the exact sequential
    # path. The counter only grows inside a flat-millis run, so the bound
    # uses the longest such run.
    reset_pos = np.flatnonzero(~tie_local)
    run_lengths = np.diff(np.concatenate(([-1], reset_pos, [n]))) - 1
    longest_run = int(run_lengths.max(initial=0))
    counter_bound = max(local.counter, int(counter_arr.max(initial=0)) + 1) + longest_run
    if int(pm[-1]) - now > max_drift or dup_screen() or counter_bound > MAX_COUNTER:
        node_hex = nodes()
        t = local
        for i in range(n):
            t = receive_timestamp(
                t, Timestamp(int(millis[i]), int(counter_arr[i]), node_hex[i]), now, max_drift,
            )
        return t

    resets = ~tie_local
    neg = np.int64(-(1 << 40))
    a = np.where(tie_remote, counter_arr + 1, np.where(resets, 0, neg))
    idx = np.arange(1, n + 1, dtype=np.int64)
    reset_positions = np.nonzero(resets)[0]
    if len(reset_positions) == 0:
        k = 0
        base = local.counter  # virtual step 0 carries the seed counter
    else:
        k = int(reset_positions[-1]) + 1  # 1-based step index of the last reset
        base = neg
    window = a[k - 1:] - idx[k - 1:] if k >= 1 else a - idx
    best = int(window.max(initial=neg))
    final_counter = max(best, base) + n
    return Timestamp(int(pm[-1]), int(final_counter), local.node)
