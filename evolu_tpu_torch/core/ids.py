"""Identity helpers: row ids, node ids, owner id derivation.

Reference: packages/evolu/src/model.ts:44 (nanoid row ids),
types.ts:42-49 (16-hex node ids), initDbModel.ts:21-22 (owner id =
first 21 hex chars of SHA-256(mnemonic) — 1/3 of the hash; the
mnemonic cannot be recovered from it).
"""

from __future__ import annotations

import hashlib
import secrets

# The standard nanoid URL alphabet (64 chars).
_NANOID_ALPHABET = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789_-"
_HEX_ALPHABET = "0123456789abcdef"


def create_id() -> str:
    """A 21-char nanoid row id (model.ts:44)."""
    return "".join(secrets.choice(_NANOID_ALPHABET) for _ in range(21))


def create_node_id() -> str:
    """A 16-lowercase-hex-char HLC node id (types.ts:48-49)."""
    return "".join(secrets.choice(_HEX_ALPHABET) for _ in range(16))


_ID_CHARS = set(_NANOID_ALPHABET)


def is_valid_id(s: str) -> bool:
    """model.ts:35 — /^[\\w-]{21}$/ (ASCII word chars only, like the zod regex)."""
    return len(s) == 21 and all(c in _ID_CHARS for c in s)


def is_valid_node_id(s: str) -> bool:
    """types.ts:42 — /^[0-9a-f]{16}$/i."""
    return len(s) == 16 and all(c in "0123456789abcdefABCDEF" for c in s)


def mnemonic_to_owner_id(mnemonic: str) -> str:
    """initDbModel.ts:21-22."""
    return hashlib.sha256(mnemonic.encode("utf-8")).hexdigest()[:21]
