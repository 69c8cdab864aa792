"""Frozen plain copy of Evolu's sync wire (protobuf, hand-encoded).

Evolu v0.5.1 packages/evolu/protobuf.proto:

    EncryptedCrdtMessage { timestamp=1 content=2 }
    SyncRequest  { messages=1 userId=2 nodeId=3 merkleTree=4 }
    SyncResponse { messages=1 merkleTree=2 }

The relay cells send capability-less requests, so the answers are this
wire byte for byte (apps/server/src/index.ts:224-248). Messages of one
content length encode in one NumPy pass.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def field(num: int, data: bytes) -> bytes:
    """A length-delimited field."""
    return varint(num << 3 | 2) + varint(len(data)) + data


def messages_field(ts: np.ndarray, contents: np.ndarray) -> bytes:
    """Field 1 entries, one an (timestamp, content) row: `ts` (n, 46) and
    `contents` (n, c) uint8 arrays."""
    n, c = contents.shape
    if n == 0:
        return b""
    ts_len = ts.shape[1]
    inner = b"\x0a" + varint(ts_len)
    mid = b"\x12" + varint(c)
    body = len(inner) + ts_len + len(mid) + c
    head = b"\x0a" + varint(body)
    row = np.empty((n, len(head) + body), np.uint8)
    pos = 0
    for part in (head, inner):
        row[:, pos:pos + len(part)] = np.frombuffer(part, np.uint8)
        pos += len(part)
    row[:, pos:pos + ts_len] = ts
    pos += ts_len
    row[:, pos:pos + len(mid)] = np.frombuffer(mid, np.uint8)
    pos += len(mid)
    row[:, pos:] = contents
    return row.tobytes()


def messages_field_rows(rows: Sequence[Tuple[str, bytes]]) -> bytes:
    """Field 1 entries from (timestamp string, content) pairs."""
    out = []
    for ts, content in rows:
        out.append(field(1, field(1, ts.encode("utf-8")) + field(2, content)))
    return b"".join(out)


def request(messages: bytes, user_id: str, node_id: str, tree: str) -> bytes:
    """A SyncRequest from pre-encoded field 1 entries."""
    return messages + field(2, user_id.encode()) + field(3, node_id.encode()) + field(4, tree.encode())


def response(messages: bytes, tree: str) -> bytes:
    """A SyncResponse from pre-encoded field 1 entries."""
    return messages + field(2, tree.encode())


def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    v = shift = 0
    while True:
        b = data[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, pos
        shift += 7


def count_messages(data: bytes) -> int:
    """How many field 1 entries a SyncRequest or SyncResponse carries."""
    n, pos = 0, 0
    while pos < len(data):
        key, pos = _read_varint(data, pos)
        size, pos = _read_varint(data, pos)
        pos += size
        n += key == 0x0A
    return n
