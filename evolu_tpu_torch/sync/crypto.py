"""OpenPGP symmetric message encryption (RFC 4880 subset).

Reference: packages/evolu/src/sync.worker.ts:59-91 encrypts each
CrdtMessageContent with OpenPGP.js v5 `encrypt({passwords: mnemonic,
config: {s2kIterationCountByte: 0}})`. This module produces and
consumes the same wire format so ciphertexts interoperate:

- SKESK packet (tag 3), v4: AES-256, iterated+salted S2K with SHA-256
  and count byte 0 (= 1024 octets hashed — the speed-over-KDF-hardness
  choice the reference makes; security rests on the 128-bit mnemonic
  entropy, not the KDF).
- SEIPD packet (tag 18), v1: AES-256-CFB over
  (16 random bytes ‖ last-2-repeat ‖ Literal-Data packet ‖ MDC),
  zero IV, with the SHA-1 MDC (tag 19) integrity trailer.

Decryption accepts any definite/partial-length new- or old-format
packet stream with an uncompressed, ZIP, or ZLIB compressed payload —
the shapes OpenPGP.js can emit for these small messages.

Crypto is host-side work by design: the CUDA kernels never see
plaintext values, mirroring the E2EE-blind relay. This is the port's
copy of `evolu_tpu.sync.crypto`, byte-compatible with it both ways.

Each message pays its own iterated+salted S2K (a 1 KiB SHA-256).
`sync/aead.py` is the negotiated escape hatch — session-keyed
AES-256-GCM records under the `aead-batch-v1` capability — and
`aead.decrypt_content` is the dispatch that lets stored logs mix both
formats; this module stays the reference-parity format and the only
one un-negotiated peers ever receive.
"""

from __future__ import annotations

import hashlib
import os
import struct
import zlib
from typing import List, Optional, Tuple

try:
    from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes
except ModuleNotFoundError:
    # No `cryptography` wheel in this environment: the only primitive
    # used here is AES-CFB128, served equally by OpenSSL libcrypto over
    # ctypes (same ValueError size-check semantics — see _evp_cfb).
    from evolu_tpu_torch.sync._evp_cfb import Cipher, algorithms, modes

SYM_AES256 = 9
HASH_SHA256 = 8
_S2K_COUNT_BYTE = 0  # sync.worker.ts:77-78


def _s2k_count(count_byte: int) -> int:
    return (16 + (count_byte & 15)) << ((count_byte >> 4) + 6)


def _s2k_iterated_salted(password: bytes, salt: bytes, count_byte: int, key_len: int) -> bytes:
    """RFC 4880 §3.7.1.3. SHA-256 emits 32 bytes = AES-256 key length,
    so a single hash context suffices (no preloaded-zero contexts)."""
    count = _s2k_count(count_byte)
    data = salt + password
    h = hashlib.sha256()
    full, rem = divmod(max(count, len(data)), len(data))
    h.update(data * full + data[:rem])
    return h.digest()[:key_len]


def _new_packet(tag: int, body: bytes) -> bytes:
    """New-format packet header with a definite length (RFC 4880 §4.2.2)."""
    if len(body) < 192:
        length = bytes([len(body)])
    elif len(body) < 8384:
        n = len(body) - 192
        length = bytes([192 + (n >> 8), n & 0xFF])
    else:
        length = b"\xff" + struct.pack(">I", len(body))
    return bytes([0xC0 | tag]) + length + body


def _aes_cfb(key: bytes):
    return Cipher(algorithms.AES(key), modes.CFB(b"\x00" * 16))


def encrypt_symmetric(plaintext: bytes, password: str) -> bytes:
    """→ SKESK ‖ SEIPD, decryptable by OpenPGP.js with the same password."""
    salt = os.urandom(8)
    key = _s2k_iterated_salted(password.encode("utf-8"), salt, _S2K_COUNT_BYTE, 32)
    skesk = _new_packet(3, bytes([4, SYM_AES256, 3, HASH_SHA256]) + salt + bytes([_S2K_COUNT_BYTE]))

    literal = _new_packet(11, b"b" + b"\x00" + b"\x00\x00\x00\x00" + plaintext)
    prefix = os.urandom(16)
    body = prefix + prefix[14:16] + literal
    mdc = hashlib.sha1(body + b"\xd3\x14").digest()
    body += b"\xd3\x14" + mdc
    enc = _aes_cfb(key).encryptor()
    seipd = _new_packet(18, b"\x01" + enc.update(body) + enc.finalize())
    return skesk + seipd


class PgpError(ValueError):
    pass


def _read_packets(data: bytes) -> List[Tuple[int, bytes]]:
    """Parse a packet stream → [(tag, body)]. Handles new-format
    (one/two/five-octet + partial lengths) and old-format headers."""
    packets: List[Tuple[int, bytes]] = []
    pos = 0
    while pos < len(data):
        ctb = data[pos]
        pos += 1
        if not ctb & 0x80:
            raise PgpError("bad packet header")
        if ctb & 0x40:  # new format
            tag = ctb & 0x3F
            body = bytearray()
            while True:
                first = data[pos]
                pos += 1
                if first < 192:
                    length, partial = first, False
                elif first < 224:
                    length = ((first - 192) << 8) + data[pos] + 192
                    pos += 1
                    partial = False
                elif first == 255:
                    length = struct.unpack(">I", data[pos : pos + 4])[0]
                    pos += 4
                    partial = False
                else:
                    length, partial = 1 << (first & 0x1F), True
                body += data[pos : pos + length]
                pos += length
                if not partial:
                    break
        else:  # old format
            tag = (ctb >> 2) & 0x0F
            ltype = ctb & 3
            if ltype == 0:
                length = data[pos]
                pos += 1
            elif ltype == 1:
                length = struct.unpack(">H", data[pos : pos + 2])[0]
                pos += 2
            elif ltype == 2:
                length = struct.unpack(">I", data[pos : pos + 4])[0]
                pos += 4
            else:
                length = len(data) - pos  # indeterminate: to end of input
            body = data[pos : pos + length]
            pos += length
        packets.append((tag, bytes(body)))
    return packets


def _unwrap_literal(body: bytes) -> bytes:
    """Literal Data packet (tag 11) → its data bytes."""
    name_len = body[1]
    return body[2 + name_len + 4 :]


def _unwrap_payload(packets: List[Tuple[int, bytes]]) -> bytes:
    for tag, body in packets:
        if tag == 11:
            return _unwrap_literal(body)
        if tag == 8:  # Compressed Data
            algo, payload = body[0], body[1:]
            if algo == 0:
                inner = payload
            elif algo == 1:  # ZIP (raw deflate)
                inner = zlib.decompress(payload, wbits=-15)
            elif algo == 2:  # ZLIB
                inner = zlib.decompress(payload)
            else:
                raise PgpError(f"unsupported compression algo {algo}")
            return _unwrap_payload(_read_packets(inner))
    raise PgpError("no literal data packet")


def decrypt_symmetric(message: bytes, password: str) -> bytes:
    """Inverse of `encrypt_symmetric`; verifies the MDC. ANY malformed
    input raises PgpError (truncated packet grammar otherwise escapes
    as IndexError/struct.error — found by fuzzing)."""
    try:
        return _decrypt_symmetric(message, password)
    except PgpError:
        raise
    except (IndexError, ValueError, struct.error, zlib.error) as e:
        # ValueError covers the cryptography layer too (e.g. a
        # truncated legacy-SED body yields an invalid CFB IV size).
        raise PgpError(f"malformed OpenPGP message: {e}") from e


def _decrypt_symmetric(message: bytes, password: str) -> bytes:
    skesk: Optional[bytes] = None
    seipd: Optional[bytes] = None
    sed: Optional[bytes] = None
    for tag, body in _read_packets(message):
        if tag == 3 and skesk is None:
            skesk = body
        elif tag == 18 and seipd is None:
            seipd = body
        elif tag == 9 and sed is None:
            sed = body  # legacy SED (no MDC) — accepted, not produced
    if skesk is None or (seipd is None and sed is None):
        raise PgpError("not a symmetrically encrypted OpenPGP message")

    version, sym_algo, s2k_type = skesk[0], skesk[1], skesk[2]
    if version != 4 or sym_algo != SYM_AES256:
        raise PgpError(f"unsupported SKESK version/algo {version}/{sym_algo}")
    if s2k_type == 3:
        hash_algo, salt, count_byte = skesk[3], skesk[4:12], skesk[12]
        if hash_algo != HASH_SHA256:
            raise PgpError(f"unsupported S2K hash {hash_algo}")
        key = _s2k_iterated_salted(password.encode("utf-8"), salt, count_byte, 32)
    elif s2k_type == 1:  # salted: ONE hash of salt‖password (RFC 4880 §3.7.1.2)
        if skesk[3] != HASH_SHA256:
            raise PgpError(f"unsupported S2K hash {skesk[3]}")
        salt = skesk[4:12]
        key = hashlib.sha256(salt + password.encode("utf-8")).digest()
    elif s2k_type == 0:  # simple: hash of the password alone (§3.7.1.1)
        if skesk[3] != HASH_SHA256:
            raise PgpError(f"unsupported S2K hash {skesk[3]}")
        key = hashlib.sha256(password.encode("utf-8")).digest()
    else:
        raise PgpError(f"unsupported S2K type {s2k_type}")

    if seipd is not None:
        if seipd[0] != 1:
            raise PgpError(f"unsupported SEIPD version {seipd[0]}")
        dec = _aes_cfb(key).decryptor()
        body = dec.update(seipd[1:]) + dec.finalize()
        prefix, repeat, rest = body[:16], body[16:18], body[18:]
        if repeat != prefix[14:16]:
            raise PgpError("session key check failed (wrong password?)")
        if rest[-22:-20] != b"\xd3\x14":
            raise PgpError("missing MDC")
        if hashlib.sha1(body[:-20]).digest() != rest[-20:]:
            raise PgpError("MDC integrity check failed")
        return _unwrap_payload(_read_packets(rest[:-22]))

    # Legacy SED: CFB with resync (RFC 4880 §13.9).
    block = 16
    dec = _aes_cfb(key).decryptor()
    head = dec.update(sed[: block + 2])
    if head[block : block + 2] != head[block - 2 : block]:
        raise PgpError("session key check failed (wrong password?)")
    resync = Cipher(algorithms.AES(key), modes.CFB(sed[2 : block + 2])).decryptor()
    rest = resync.update(sed[block + 2 :]) + resync.finalize()
    return _unwrap_payload(_read_packets(rest))
