"""BIP-39 mnemonic generation/validation (12 words, 128-bit entropy).

Reference: packages/evolu/src/generateMnemonic.ts (extracted from
bitcoinjs/bip39) and validateMnemonic.ts. The mnemonic is the owner's
identity and the E2EE password; owner id = sha256(mnemonic)[:21 hex]
(initDbModel.ts:21-22).
"""

from __future__ import annotations

import hashlib
import secrets

from evolu_tpu_torch.core._bip39_words import WORDS

_WORD_INDEX = {w: i for i, w in enumerate(WORDS)}


def _entropy_to_mnemonic(entropy: bytes) -> str:
    """generateMnemonic.ts:43-72 — entropy bits + sha256-checksum bits, 11-bit word indices."""
    if not (16 <= len(entropy) <= 32) or len(entropy) % 4:
        raise ValueError("INVALID_ENTROPY")
    ent_bits = len(entropy) * 8
    cs_bits = ent_bits // 32
    checksum = hashlib.sha256(entropy).digest()
    bits = int.from_bytes(entropy, "big") << cs_bits
    bits |= checksum[0] >> (8 - cs_bits) if cs_bits <= 8 else int.from_bytes(checksum, "big") >> (256 - cs_bits)
    n_words = (ent_bits + cs_bits) // 11
    words = []
    for i in range(n_words):
        shift = (n_words - 1 - i) * 11
        words.append(WORDS[(bits >> shift) & 0x7FF])
    return " ".join(words)


def generate_mnemonic(strength: int = 128) -> str:
    """generateMnemonic.ts:76-79 — default 12 words."""
    return _entropy_to_mnemonic(secrets.token_bytes(strength // 8))


def validate_mnemonic(mnemonic: str) -> bool:
    """Word-list membership + checksum check (BIP-39)."""
    words = mnemonic.split(" ")
    if len(words) not in (12, 15, 18, 21, 24):
        return False
    try:
        indices = [_WORD_INDEX[w] for w in words]
    except KeyError:
        return False
    bits = 0
    for idx in indices:
        bits = (bits << 11) | idx
    total_bits = len(words) * 11
    cs_bits = total_bits // 33
    ent_bits = total_bits - cs_bits
    entropy = (bits >> cs_bits).to_bytes(ent_bits // 8, "big")
    checksum = bits & ((1 << cs_bits) - 1)
    expected = int.from_bytes(hashlib.sha256(entropy).digest(), "big") >> (256 - cs_bits)
    return checksum == expected
