"""Frozen plain copy of Evolu's timestamp strings, murmur3 and Merkle trie.

The yardstick's own arithmetic: it imports nothing of the program, so a
later change to the program cannot move it. It follows, line for line in
behaviour:

- Evolu v0.5.1 packages/evolu/src/timestamp.ts `timestampToString` (ISO
  millis, 4 upper-case hex counter digits, 16 hex node digits) and
  `timestampToHash` (npm `murmurhash` v3, seed 0, over the ASCII string);
- packages/evolu/src/merkleTree.ts `insertIntoMerkleTree` (a ternary trie
  keyed by `((millis / 1000 / 60) | 0).toString(3)`, each node the XOR of
  the hashes under it, kept as a JS signed int32), `diffMerkleTrees` and
  the JSON the relay stores (`JSON.stringify`: integer keys in ascending
  order, then "hash", no whitespace);
- apps/server/src/index.ts:173-202 `createSyncTimestamp(diff)`: the
  all-zero node id after the first differing minute.

Hashes are vectorised with NumPy over fixed-width 46-byte strings;
`murmur3_32` is the scalar form the tests hold them to.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np

TS_LEN = 46  # 24 (ISO) + 1 + 4 (hex counter) + 1 + 16 (node)
SYNC_NODE = "0000000000000000"
_M32 = 0xFFFFFFFF
_C1, _C2 = 0xCC9E2D51, 0x1B873593
_HEXU = np.frombuffer(b"0123456789ABCDEF", np.uint8)


def murmur3_32(data: bytes, seed: int = 0) -> int:
    """MurmurHash3 x86 32-bit of `data`, unsigned."""
    h = seed & _M32
    n = len(data) & ~3
    for i in range(0, n, 4):
        k = int.from_bytes(data[i:i + 4], "little")
        k = (k * _C1) & _M32
        k = ((k << 15) | (k >> 17)) & _M32
        k = (k * _C2) & _M32
        h ^= k
        h = ((h << 13) | (h >> 19)) & _M32
        h = (h * 5 + 0xE6546B64) & _M32
    k = 0
    tail = data[n:]
    for i in range(len(tail) - 1, -1, -1):
        k = (k << 8) | tail[i]
    if tail:
        k = (k * _C1) & _M32
        k = ((k << 15) | (k >> 17)) & _M32
        k = (k * _C2) & _M32
        h ^= k
    h ^= len(data)
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def murmur3_rows(rows: np.ndarray) -> np.ndarray:
    """murmur3_32 (seed 0) of each row of a (n, 46) uint8 array → uint32[n]."""
    n, width = rows.shape
    if width != TS_LEN:
        raise ValueError(f"rows of {width} bytes, expected {TS_LEN}")
    h = np.zeros(n, np.uint32)
    words = np.ascontiguousarray(rows[:, :44]).view("<u4")
    with np.errstate(over="ignore"):
        for i in range(11):
            k = words[:, i] * np.uint32(_C1)
            k = _rotl(k, 15) * np.uint32(_C2)
            h = _rotl(h ^ k, 13) * np.uint32(5) + np.uint32(0xE6546B64)
        k = rows[:, 44].astype(np.uint32) | (rows[:, 45].astype(np.uint32) << np.uint32(8))
        k = _rotl(k * np.uint32(_C1), 15) * np.uint32(_C2)
        h ^= k
        h ^= np.uint32(TS_LEN)
        h ^= h >> np.uint32(16)
        h *= np.uint32(0x85EBCA6B)
        h ^= h >> np.uint32(13)
        h *= np.uint32(0xC2B2AE35)
        h ^= h >> np.uint32(16)
    return h


def millis_to_iso(millis: int) -> str:
    """JS `new Date(millis).toISOString()` for millis after 1970."""
    s = str(np.datetime64(int(millis), "ms"))
    return s + "Z"


def ts_string(millis: int, counter: int, node: str) -> str:
    return f"{millis_to_iso(millis)}-{counter:04X}-{node}"


def ts_rows(millis: np.ndarray, counter: np.ndarray, nodes: np.ndarray) -> np.ndarray:
    """Timestamp strings as a (n, 46) uint8 array. `nodes` is a (n, 16)
    uint8 array of lower-case hex; millis lie after 1970 and before 10000."""
    n = len(millis)
    out = np.empty((n, TS_LEN), np.uint8)
    iso = np.datetime_as_string(np.asarray(millis, np.int64).astype("datetime64[ms]"), unit="ms")
    out[:, :23] = np.frombuffer(iso.astype("S23").tobytes(), np.uint8).reshape(n, 23)
    out[:, 23] = ord("Z")
    out[:, 24] = out[:, 29] = ord("-")
    c = np.asarray(counter, np.int64)
    for i in range(4):
        out[:, 25 + i] = _HEXU[(c >> (4 * (3 - i))) & 0xF]
    out[:, 30:46] = nodes
    return out


def node_rows(nodes: Iterable[str]) -> np.ndarray:
    return np.frombuffer("".join(nodes).encode("ascii"), np.uint8).reshape(-1, 16)


def minute_key(millis: int) -> str:
    """`((millis / 1000 / 60) | 0).toString(3)` for millis after 1970."""
    m = int(millis) // 60000
    if m == 0:
        return "0"
    digits = []
    while m:
        digits.append("012"[m % 3])
        m //= 3
    return "".join(reversed(digits))


def to_int32(x: int) -> int:
    x &= _M32
    return x - (1 << 32) if x >= 1 << 31 else x


def minute_deltas(millis: np.ndarray, hashes: np.ndarray) -> Dict[str, int]:
    """{minute key: XOR of the hashes in that minute, as int32}."""
    minutes = np.asarray(millis, np.int64) // 60000
    if len(minutes) == 0:
        return {}
    order = np.argsort(minutes, kind="stable")
    m_s, h_s = minutes[order], np.asarray(hashes, np.uint32)[order]
    starts = np.flatnonzero(np.r_[True, m_s[1:] != m_s[:-1]])
    xors = np.bitwise_xor.reduceat(h_s, starts)
    return {minute_key(int(m) * 60000): to_int32(int(x)) for m, x in zip(m_s[starts], xors)}


def apply_deltas(tree: dict, deltas: Dict[str, int]) -> dict:
    """`tree` with each minute's XOR folded into every node on its path
    (a copy: the nodes on the paths are new dicts)."""
    new = dict(tree)
    for key, h in deltas.items():
        new["hash"] = to_int32((new.get("hash") or 0) ^ h)
        node = new
        for c in key:
            child = dict(node.get(c) or {})
            child["hash"] = to_int32((child.get("hash") or 0) ^ h)
            node[c] = child
            node = child
    return new


def tree_from_rows(millis: np.ndarray, hashes: np.ndarray) -> dict:
    """A fresh tree holding the rows (`apply_deltas({}, minute_deltas(...))`),
    built a trie level at a time. Every minute must have a 16-digit key
    (1997 to 2051); other trees take `apply_deltas`."""
    minutes = np.asarray(millis, np.int64) // 60000
    if len(minutes) == 0:
        return {}
    if minutes.min() < 3 ** 15 or minutes.max() >= 3 ** 16:
        return apply_deltas({}, minute_deltas(millis, hashes))
    order = np.argsort(minutes, kind="stable")
    m, h = minutes[order], np.asarray(hashes, np.uint32)[order]
    tree = {"hash": to_int32(int(np.bitwise_xor.reduce(h)))}
    parents = {0: tree}
    for level in range(1, 17):
        prefix = m // 3 ** (16 - level)
        starts = np.flatnonzero(np.r_[True, prefix[1:] != prefix[:-1]])
        xors = np.bitwise_xor.reduceat(h, starts)
        nodes = {}
        for p, x in zip(prefix[starts].tolist(), xors.tolist()):
            node = nodes[p] = {"hash": x - (1 << 32) if x >= 1 << 31 else x}
            parents[p // 3][str(p % 3)] = node
        parents = nodes
    return tree


def tree_to_string(tree: dict) -> str:
    """`JSON.stringify(tree)`: keys "0", "1", "2" in that order, then "hash"."""
    parts = [f'"{k}":{tree_to_string(tree[k])}' for k in ("0", "1", "2") if k in tree]
    if "hash" in tree:
        parts.append(f'"hash":{int(tree["hash"])}')
    return "{" + ",".join(parts) + "}"


def diff(tree1: dict, tree2: dict) -> Optional[int]:
    """The first minute (as millis) where the trees differ, else None."""
    if tree1.get("hash") == tree2.get("hash"):
        return None
    n1, n2, key = tree1, tree2, ""
    while True:
        kids = sorted((set(n1) | set(n2)) - {"hash"})
        step = next((k for k in kids if (n1.get(k) or {}).get("hash") != (n2.get(k) or {}).get("hash")), None)
        if step is None:
            return int((key + "0" * (16 - len(key))), 3) * 60000
        key += step
        n1, n2 = n1.get(step) or {}, n2.get(step) or {}


def sync_since(millis: int) -> str:
    """The timestamp string a relay selects rows after (`createSyncTimestamp`)."""
    return ts_string(millis, 0, SYNC_NODE)
