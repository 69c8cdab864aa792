"""Batched-AEAD v2 sync payload — the `aead-batch-v1` capability.

The port's copy of `evolu_tpu.sync.aead`. The reference wire
(sync/crypto.py) pays a FRESH iterated+salted S2K — a 1 KiB SHA-256 —
per message, a format cost no merge speed can hide. This module is
the protocol change: the key is derived ONCE per (owner, session)
with salted HKDF-SHA-256 from the same owner secret that feeds S2K
today, and each message becomes one small AES-256-GCM record under
that session key.

Record layout (the per-message envelope; all lengths fixed):

    offset 0   magic   0x45 0x32 ("E2") — bit 7 of the first byte is
               CLEAR, so a v2 record can never parse as an OpenPGP
               packet stream (every valid CTB has bit 7 set) and an
               OpenPGP message can never match the magic: the two
               formats are structurally disjoint and records
               self-describe, which is what lets v1 and v2 ciphertexts
               share one store, one Merkle tree, and one decode path.
    offset 2   version 0x01
    offset 3   salt    16 bytes — the HKDF session salt. Carried per
               record (not per leg) because the relay re-serves STORED
               records merged across many past sessions: every record
               must stay decryptable standalone, long after the leg
               that carried it is gone.
    offset 19  nonce   12 bytes, random per record
    offset 31  AES-256-GCM ciphertext ‖ 16-byte tag. The plaintext is
               the same CrdtMessageContent protobuf the v1 literal
               packet carries (protocol.encode_content bytes).

Why per-record tags rather than one envelope tag over the whole batch:
the relay is E2EE-blind but MUST decompose a push into per-message
rows (INSERT OR IGNORE by timestamp, Merkle XOR per row) and later
re-compose responses from rows written by DIFFERENT sessions — a
single ciphertext spanning the batch cannot be split or re-served
without the key. The batch-level saving lives in the KEY SCHEDULE
(one HKDF per session instead of one S2K per message); the reference's
batched C leg is not ported, so every record here takes the pure loop.
Tamper anywhere in a leg still surfaces as
one PgpError for the leg: decode stops at the first failing record,
exactly like the v1 per-message MDC path.

Error contract (fuzz-pinned, tests/test_wire_v2.py): ValueError for
wire framing (the protobuf layer), PgpError for everything inside the
record — truncation, auth-tag failure, key mismatch. PgpError
subclasses ValueError, so every existing ValueError-keyed caller is
unchanged.

Crypto stays host-side by design: the CUDA kernels never see
plaintext, and the relay stores v2 ciphertext as opaquely as v1.
Session keys derived and records that fail authentication count into
the metrics registry (`evolu_crypto_*`) as in the reference, and into
plain `counts` beside it.
"""

from __future__ import annotations

import hmac as _hmac
import hashlib
import os
import threading
from collections import OrderedDict
from typing import Tuple

from evolu_tpu_torch.obs import metrics
from evolu_tpu_torch.sync.crypto import PgpError, decrypt_symmetric
from evolu_tpu_torch.sync.wire_scan import PackedMessages

try:
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
    from cryptography.exceptions import InvalidTag
except ModuleNotFoundError:
    # No `cryptography` wheel: the one primitive used here is
    # AES-256-GCM, served equally by OpenSSL libcrypto over ctypes
    # (same InvalidTag-on-auth-failure semantics — see _evp_gcm).
    from evolu_tpu_torch.sync._evp_gcm import AESGCM, InvalidTag

MAGIC = b"\x45\x32\x01"  # "E2" + version 1
SALT_LEN = 16
NONCE_LEN = 12
TAG_LEN = 16
RECORD_OVERHEAD = len(MAGIC) + SALT_LEN + NONCE_LEN + TAG_LEN  # = 47
# HKDF-SHA-256 info string — byte for byte the reference's (its C leg
# derives the same key from (secret, salt)).
HKDF_INFO = b"evolu-tpu aead-batch-v1 key"

# Session keys derived and records that failed authentication, by name,
# each with its evolu_crypto_* counter.
_FAMILIES = {
    "session_keys_derived": "evolu_crypto_session_keys_derived_total",
    "auth_failures": "evolu_crypto_auth_failures_total",
}
counts = dict.fromkeys(_FAMILIES, 0)


def hkdf_sha256(secret: bytes, salt: bytes) -> bytes:
    """RFC 5869 extract+expand for exactly one 32-byte block:
    PRK = HMAC(salt, secret); OKM = HMAC(PRK, info ‖ 0x01)."""
    prk = _hmac.new(salt, secret, hashlib.sha256).digest()
    return _hmac.new(prk, HKDF_INFO + b"\x01", hashlib.sha256).digest()


def derive_key(password: str, salt: bytes) -> bytes:
    _count("session_keys_derived")
    return hkdf_sha256(password.encode("utf-8"), salt)


def is_v2_record(content: bytes) -> bool:
    """The ONE dispatch predicate, shared (by value) with the
    reference's C fast path: magic match ⇒ v2 record, else OpenPGP. Never ambiguous —
    see the module docstring on the disjoint first byte."""
    return content[: len(MAGIC)] == MAGIC


class AeadSession:
    """One owner's encrypt-side session: a fresh salt and its derived
    key, minted once per (secret, process) and reused for every leg —
    this is where the per-message S2K cost collapses to one HKDF.
    `used` counts records sealed under the key (see
    SESSION_RECORD_LIMIT)."""

    __slots__ = ("salt", "key", "used")

    def __init__(self, salt: bytes, key: bytes):
        self.salt = salt
        self.key = key
        self.used = 0


_lock = threading.Lock()


def _count(name: str) -> None:
    with _lock:
        counts[name] += 1
    metrics.inc(_FAMILIES[name])


_sessions: "OrderedDict[str, AeadSession]" = OrderedDict()  # password → session
_decrypt_keys: "OrderedDict[Tuple[str, bytes], bytes]" = OrderedDict()
_MAX_SESSIONS = 64
_MAX_DECRYPT_KEYS = 512  # decrypt side sees one salt per REMOTE session
# Nonces are random 96-bit per record: NIST SP 800-38D caps random-IV
# GCM at 2^32 invocations per key (collision probability 2^-32 at
# that point). Rotate the session WELL under it — a fresh salt+key is
# one HKDF, and records self-describe so retired-session
# records stay decryptable forever.
SESSION_RECORD_LIMIT = 1 << 28


def get_session(password: str, records: int = 0) -> AeadSession:
    """The encrypt-side session for `password`, about to seal
    `records` more records — a session that would cross
    SESSION_RECORD_LIMIT is retired and a fresh salt+key minted
    (the 2^32 random-nonce GCM bound can never be approached)."""
    with _lock:
        s = _sessions.get(password)
        if s is not None and s.used + records <= SESSION_RECORD_LIMIT:
            s.used += records
            _sessions.move_to_end(password)
            return s
    salt = os.urandom(SALT_LEN)
    s = AeadSession(salt, derive_key(password, salt))
    s.used = records
    with _lock:
        _sessions[password] = s
        while len(_sessions) > _MAX_SESSIONS:
            _sessions.popitem(last=False)
    # Seed the decrypt cache too: our own records come back in pull
    # responses and must not pay a second derivation.
    _remember_decrypt_key(password, salt, s.key)
    return s


def reset_sessions() -> None:
    """Drop every cached session/key (tests; also safe any time — the
    next leg simply mints a fresh salt)."""
    with _lock:
        _sessions.clear()
        _decrypt_keys.clear()


def _remember_decrypt_key(password: str, salt: bytes, key: bytes) -> None:
    with _lock:
        _decrypt_keys[(password, salt)] = key
        while len(_decrypt_keys) > _MAX_DECRYPT_KEYS:
            _decrypt_keys.popitem(last=False)


def _decrypt_key(password: str, salt: bytes) -> bytes:
    with _lock:
        k = _decrypt_keys.get((password, salt))
        if k is not None:
            _decrypt_keys.move_to_end((password, salt))
            return k
    k = derive_key(password, salt)
    _remember_decrypt_key(password, salt, k)
    return k


def encrypt_record(key: bytes, salt: bytes, plaintext: bytes) -> bytes:
    """One v2 record under an established session key (the pure-Python
    leg)."""
    nonce = os.urandom(NONCE_LEN)
    return MAGIC + salt + nonce + AESGCM(key).encrypt(nonce, plaintext, None)


def decrypt_record(record: bytes, password: str) -> bytes:
    """→ the CrdtMessageContent plaintext. Raises PgpError ONLY (auth
    failure, truncation, key mismatch — all tamper-shaped outcomes);
    the caller's protobuf decode owns the ValueError surface."""
    if not is_v2_record(record):
        raise PgpError("not an aead-batch-v1 record")
    if len(record) < RECORD_OVERHEAD:
        _count("auth_failures")
        raise PgpError("truncated aead-batch-v1 record")
    salt = record[3 : 3 + SALT_LEN]
    nonce = record[3 + SALT_LEN : 3 + SALT_LEN + NONCE_LEN]
    key = _decrypt_key(password, salt)
    try:
        return AESGCM(key).decrypt(nonce, record[3 + SALT_LEN + NONCE_LEN :], None)
    except (InvalidTag, ValueError) as e:
        _count("auth_failures")
        raise PgpError(
            "aead-batch-v1 authentication failed (tampered or wrong key?)"
        ) from e


def decrypt_content(content: bytes, password: str) -> bytes:
    """The version dispatch every decrypt path funnels through: stored
    logs mix v1 OpenPGP and v2 records freely (records self-describe),
    so decoding never depends on what was negotiated."""
    if is_v2_record(content):
        return decrypt_record(content, password)
    return decrypt_symmetric(content, password)


def count_v2(messages) -> int:
    """How many of a request's EncryptedCrdtMessages are v2 records —
    the relay's ingest-side observability (it stays E2EE-blind; the
    3-byte magic is framing, not content). Packed messages (the relay
    front's `wire_scan.PackedMessages`) are counted on their columns."""
    if isinstance(messages, PackedMessages):
        return messages.count_prefix(MAGIC)
    return sum(1 for m in messages if is_v2_record(m.content))
