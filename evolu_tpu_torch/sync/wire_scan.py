"""The relay front's decoder of a sync POST: the messages go from the wire
into the packed columns the engine inserts, with no per-message Python
object in between.

`decode_sync_post(body)` scans the body natively (`csrc/wire_scan.cpp`,
through ctypes, which releases the GIL for the scan). A canonical body
(each message a 46-byte ASCII timestamp then its content, no scope
clause, no unknown field: what every client encoder writes) decodes to a
`SyncRequest` whose `messages` is a `PackedMessages` over the scan's
columns, and its route is "packed". Every other body, or any body when
the library cannot be built, goes through `protocol.decode_sync_request`
("object"), so the error surface is that decoder's, byte for byte.

`PackedMessages` is a sequence of `EncryptedCrdtMessage`s built on
demand. It compares equal to, and hashes like, the tuple of the same
messages, so every object path sees the request `decode_sync_request`
gives. The relay's per-message walks (`scheduler._batchable`,
`aead.count_v2`, the push hub's author nodes, `engine.start_batch`) read
its columns instead.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from evolu_tpu_torch.sync import protocol
from evolu_tpu_torch.utils.native_loader import try_load_native_library

SO_NAME = "libevolu_wire_scan.so"
TS_LEN = 46
# The shortest canonical message entry: its key and length, the
# timestamp's key, length and 46 bytes, the content's key and length.
_MIN_ENTRY = 1 + 1 + 1 + 1 + TS_LEN + 1 + 1
_MAX_CAPS = 64  # protocol._MAX_CAPABILITIES: a 65th is declined
_SPANS = 7 + 2 * _MAX_CAPS

ROUTE_PACKED = "packed"
ROUTE_OBJECT = "object"


class PackedMessages:
    """A request's messages as packed columns: `ts_packed` (46 bytes a
    row), `content_packed` (the contents back to back) and `lens` (int32
    content lengths). `distinct` is True when no two timestamps are
    equal. Indexing and iteration build `EncryptedCrdtMessage`s."""

    __slots__ = ("ts_packed", "content_packed", "lens", "distinct", "_starts")

    def __init__(self, ts_packed: bytes, content_packed: bytes, lens: np.ndarray, distinct: bool):
        self.ts_packed = ts_packed
        self.content_packed = content_packed
        self.lens = lens
        self.distinct = distinct
        self._starts: Optional[list] = None

    def __len__(self) -> int:
        return len(self.lens)

    def starts(self) -> np.ndarray:
        """Each content's offset in `content_packed`."""
        out = np.zeros(len(self.lens), np.int64)
        np.cumsum(self.lens[:-1], out=out[1:])
        return out

    def _message(self, i: int) -> protocol.EncryptedCrdtMessage:
        if self._starts is None:
            self._starts = self.starts().tolist()
        s = self._starts[i]
        return protocol.EncryptedCrdtMessage(
            self.ts_packed[i * TS_LEN:(i + 1) * TS_LEN].decode("ascii"),
            self.content_packed[s:s + int(self.lens[i])])

    def __getitem__(self, i):
        n = len(self.lens)
        if isinstance(i, slice):
            return tuple(self._message(j) for j in range(*i.indices(n)))
        i = int(i)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError("PackedMessages index out of range")
        return self._message(i)

    def __iter__(self):
        for i in range(len(self.lens)):
            yield self._message(i)

    def __eq__(self, other):
        if isinstance(other, PackedMessages):
            return (self.ts_packed == other.ts_packed and self.content_packed == other.content_packed
                    and np.array_equal(self.lens, other.lens))
        if isinstance(other, tuple):
            return len(other) == len(self) and tuple(self) == other
        return NotImplemented

    def __hash__(self) -> int:
        return hash(tuple(self))

    def __repr__(self) -> str:
        return f"PackedMessages({len(self)} messages)"

    def count_prefix(self, prefix: bytes) -> int:
        """How many contents start with `prefix` (the v2 record magic):
        compared at each content offset, vectorised."""
        starts = self.starts()[self.lens >= len(prefix)]
        hit = np.ones(len(starts), bool)
        data = np.frombuffer(self.content_packed, np.uint8)
        for j, b in enumerate(prefix):
            hit &= data[starts + j] == b
        return int(np.count_nonzero(hit))

    def node_suffixes(self, width: int) -> frozenset:
        """The distinct last `width` characters of the timestamps."""
        rows = np.frombuffer(self.ts_packed, np.uint8).reshape(-1, TS_LEN)
        tails = np.ascontiguousarray(rows[:, TS_LEN - width:]).view(np.dtype((np.void, width))).ravel()
        return frozenset(t.tobytes().decode("ascii") for t in np.unique(tails))

    def first_occurrences(self) -> np.ndarray:
        """Indices of each timestamp's first row, ascending."""
        if self.distinct:
            return np.arange(len(self.lens))
        rows = np.frombuffer(self.ts_packed, np.uint8).reshape(-1, TS_LEN)
        keys = rows.view(np.dtype((np.void, TS_LEN))).ravel()
        return np.sort(np.unique(keys, return_index=True)[1])

    def take(self, keep: np.ndarray) -> Tuple[bytes, bytes, np.ndarray]:
        """The columns of rows `keep` (ascending indices)."""
        if len(keep) == len(self.lens):
            return self.ts_packed, self.content_packed, self.lens
        rows = np.frombuffer(self.ts_packed, np.uint8).reshape(-1, TS_LEN)
        mask = np.zeros(len(self.lens), bool)
        mask[keep] = True
        data = np.frombuffer(self.content_packed, np.uint8)
        return (rows[keep].tobytes(), data[np.repeat(mask, self.lens)].tobytes(),
                np.ascontiguousarray(self.lens[keep]))


def _configure(lib: ctypes.CDLL) -> None:
    i64, p = ctypes.c_int64, ctypes.c_void_p
    lib.ws_scan_sync_request.argtypes = [ctypes.c_char_p, i64, i64, p, p, p, p, p]
    lib.ws_scan_sync_request.restype = i64


def load_library() -> Optional[ctypes.CDLL]:
    """The scanner, built on first use; None when it cannot be built (its
    log stays in `native_loader.build_info`)."""
    return try_load_native_library(SO_NAME, _configure)


def _scan(lib, body: bytes) -> Optional[protocol.SyncRequest]:
    """The native scan → the request, or None when the body is not
    canonical or a string field is not UTF-8."""
    cap = len(body) // _MIN_ENTRY
    ts = np.empty(cap * TS_LEN, np.uint8)
    content = np.empty(len(body), np.uint8)
    lens = np.empty(cap, np.int32)
    spans = np.empty(_SPANS, np.int64)
    distinct = np.empty(1, np.int32)
    n = lib.ws_scan_sync_request(body, len(body), cap, ts.ctypes.data, content.ctypes.data,
                                 lens.ctypes.data, spans.ctypes.data, distinct.ctypes.data)
    if n < 0:
        return None
    sp = spans.tolist()
    try:
        user_id, node_id, merkle_tree = (body[sp[j]:sp[j] + sp[j + 1]].decode("utf-8") for j in (0, 2, 4))
        caps = tuple(body[sp[j]:sp[j] + sp[j + 1]].decode("utf-8") for j in range(7, 7 + 2 * sp[6], 2))
    except UnicodeDecodeError:
        return None
    lens = lens[:n].copy()
    messages = PackedMessages(ts[:n * TS_LEN].tobytes(), content[:int(lens.sum())].tobytes(), lens,
                              bool(distinct[0])) if n else ()
    return protocol.SyncRequest(messages, user_id, node_id, merkle_tree, caps, None)


def decode_sync_post(body: bytes) -> Tuple[protocol.SyncRequest, str]:
    """→ (the request, its route): "packed" when the native scan took the
    body, else "object", decoded by `protocol.decode_sync_request` (which
    raises its ValueError on a malformed body)."""
    lib = load_library()
    if lib is not None:
        request = _scan(lib, body)
        if request is not None:
            return request, ROUTE_PACKED
    return protocol.decode_sync_request(body), ROUTE_OBJECT
