"""Merkle trie anti-entropy digest, bit-exact with the reference.

A ternary trie keyed by base-3-encoded minutes-since-epoch (truncated
to int32 like JS `| 0`). Each node's hash is the XOR of the murmur3
hashes of all timestamps under that prefix, kept as JS signed int32 so
serialized trees match reference replicas byte for byte.

Tree representation: a dict with optional keys "hash" (signed int32)
and "0"/"1"/"2" (child dicts), the reference's JSON wire shape.
"""

from __future__ import annotations

import json
from typing import Optional

from evolu_tpu_torch.core.murmur import to_int32
from evolu_tpu_torch.core.timestamp import timestamp_from_string, timestamp_to_hash
from evolu_tpu_torch.core.types import Timestamp

MERKLE_KEY_LENGTH = 16  # base-3 digits of int32 minutes


def create_initial_merkle_tree() -> dict:
    return {}


def minutes_base3(millis: int) -> str:
    """`((millis/1000/60) | 0).toString(3)` (no padding, JS sign prefix)."""
    minutes = int(millis / 1000 / 60) & 0xFFFFFFFF
    if minutes >= 0x80000000:
        minutes -= 0x100000000
    sign = "-" if minutes < 0 else ""
    m = abs(minutes)
    if m == 0:
        return "0"
    digits = []
    while m:
        digits.append(str(m % 3))
        m //= 3
    return sign + "".join(reversed(digits))


def key_to_timestamp_millis(key: str) -> int:
    """Right-pad the prefix to 16 digits, parse base 3, to millis."""
    fullkey = key + "0" * (MERKLE_KEY_LENGTH - len(key))
    return int(fullkey, 3) * 1000 * 60


def _xor(a: Optional[int], b: int) -> int:
    """JS `a ^ b` with `undefined ^ b === b | 0`."""
    return to_int32((a or 0) ^ b)


def insert_into_merkle_tree(t: Timestamp, tree: dict) -> dict:
    """Insert one timestamp. Returns a new tree; input is not mutated."""
    key = minutes_base3(t.millis)
    h = timestamp_to_hash(t)
    new_tree = dict(tree)
    new_tree["hash"] = _xor(tree.get("hash"), h)
    node = new_tree
    for c in key:
        child = dict(node.get(c) or {})
        child["hash"] = _xor(child.get("hash"), h)
        node[c] = child
        node = child
    return new_tree


def minute_deltas_host(timestamp_strings) -> tuple:
    """Oracle-exact host fold over timestamp STRINGS already flagged for
    insertion: → ({minute-key: int32 XOR delta}, uint32 digest). Hashes
    the re-render with the node case kept verbatim — the one host fold
    behind every host-oracle route."""
    deltas: dict = {}
    digest = 0
    for s in timestamp_strings:
        t = timestamp_from_string(s)
        h = timestamp_to_hash(t)
        k = minutes_base3(t.millis)
        deltas[k] = to_int32(deltas.get(k, 0) ^ h)
        digest ^= h & 0xFFFFFFFF
    return deltas, digest


def apply_prefix_xors(tree: dict, prefix_xors: dict) -> dict:
    """Apply {base3-minute-key: xor-of-hashes} deltas to a tree, touching
    O(distinct minutes * 16) nodes. Equivalent to inserting the batch
    one timestamp at a time."""
    new_tree = dict(tree)
    for key, h in prefix_xors.items():
        # A zero delta must still materialize the path nodes, exactly as
        # individual inserts would.
        new_tree["hash"] = _xor(new_tree.get("hash"), h)
        node = new_tree
        for c in key:
            child = dict(node.get(c) or {})
            child["hash"] = _xor(child.get("hash"), h)
            node[c] = child
            node = child
    return new_tree


def _child_keys(tree: dict):
    return [k for k in tree if k != "hash"]


def diff_merkle_trees(tree1: dict, tree2: dict) -> Optional[int]:
    """Earliest minute (as millis) where the trees diverge, else None."""
    if tree1.get("hash") == tree2.get("hash"):
        return None
    node1, node2 = tree1, tree2
    k = ""
    while True:
        keys = sorted(set(_child_keys(node1)) | set(_child_keys(node2)))
        diffkey = None
        for key in keys:
            next1 = node1.get(key) or {}
            next2 = node2.get(key) or {}
            if next1.get("hash") != next2.get("hash"):
                diffkey = key
                break
        if diffkey is None:
            return key_to_timestamp_millis(k)
        k += diffkey
        node1 = node1.get(diffkey) or {}
        node2 = node2.get(diffkey) or {}


def _ordered(tree: dict) -> dict:
    """JS property order: integer-like keys ascending, then "hash"."""
    out = {}
    for k in ("0", "1", "2"):
        if k in tree:
            out[k] = _ordered(tree[k])
    if "hash" in tree:
        out["hash"] = tree["hash"]
    return out


def merkle_tree_to_string(tree: dict) -> str:
    """JSON with JS property order and no whitespace."""
    return json.dumps(_ordered(tree), separators=(",", ":"))


def merkle_tree_from_string(s: str) -> dict:
    return json.loads(s)
