"""AES-256-GCM fallback over OpenSSL libcrypto via ctypes.

`sync/aead.py` (the batched-AEAD v2 oracle) uses exactly one primitive
from the `cryptography` package: the `AESGCM` AEAD. Containers without
that wheel (this repo's image bakes in libcrypto for the batched C++
layer but not the Python wheel) get the same seal/open surface over
the EVP ABI instead, mirroring `_evp_cfb.py` for the OpenPGP oracle.

Error semantics mirror what aead.py depends on: a bad key/nonce SIZE
raises ValueError at call time, and an authentication failure raises
`InvalidTag` (defined here, also aliased by aead.py when the wheel
supplies its own) — never a third exception type.
"""

from __future__ import annotations

import ctypes
import ctypes.util

from evolu_tpu_torch.sync._evp_cfb import load_libcrypto

# EVP_CIPHER_CTX_ctrl codes (stable across OpenSSL 1.1 / 3.x; the AEAD
# aliases EVP_CTRL_AEAD_{GET,SET}_TAG share the GCM values).
_CTRL_GCM_GET_TAG = 0x10
_CTRL_GCM_SET_TAG = 0x11
TAG_LEN = 16
NONCE_LEN = 12


class InvalidTag(Exception):
    """GCM authentication failed (tampered ciphertext or wrong key)."""


def _bind_gcm(lib):
    c = ctypes
    lib.EVP_CIPHER_CTX_new.restype = c.c_void_p
    lib.EVP_CIPHER_CTX_new.argtypes = []
    lib.EVP_CIPHER_CTX_free.restype = None
    lib.EVP_CIPHER_CTX_free.argtypes = [c.c_void_p]
    lib.EVP_aes_256_gcm.restype = c.c_void_p
    lib.EVP_aes_256_gcm.argtypes = []
    lib.EVP_CipherInit_ex.restype = c.c_int
    lib.EVP_CipherInit_ex.argtypes = [
        c.c_void_p, c.c_void_p, c.c_void_p,
        c.c_char_p, c.c_char_p, c.c_int,
    ]
    lib.EVP_CipherUpdate.restype = c.c_int
    lib.EVP_CipherUpdate.argtypes = [
        c.c_void_p, c.c_char_p, c.POINTER(c.c_int),
        c.c_char_p, c.c_int,
    ]
    lib.EVP_CipherFinal_ex.restype = c.c_int
    lib.EVP_CipherFinal_ex.argtypes = [
        c.c_void_p, c.c_char_p, c.POINTER(c.c_int),
    ]
    lib.EVP_CIPHER_CTX_ctrl.restype = c.c_int
    lib.EVP_CIPHER_CTX_ctrl.argtypes = [
        c.c_void_p, c.c_int, c.c_int, c.c_void_p,
    ]


_LIB = load_libcrypto(_bind_gcm)
# NB: a missing libcrypto is reported at first USE, not at import —
# same contract as _evp_cfb (the import-hygiene walk imports this
# module unconditionally).


def _require_lib():
    if _LIB is None:  # pragma: no cover - neither wheel nor libcrypto
        raise ImportError(
            "AES-GCM unavailable: install the `cryptography` package or "
            "provide OpenSSL libcrypto for the ctypes fallback"
        )
    return _LIB


class _Gcm:
    """One GCM operation's EVP context (freed eagerly)."""

    def __init__(self, key: bytes, nonce: bytes, encrypt: bool):
        lib = _require_lib()
        if len(key) != 32:
            raise ValueError(f"Invalid AES-256-GCM key size: {len(key)}")
        if len(nonce) != NONCE_LEN:
            raise ValueError(f"Invalid GCM nonce size: {len(nonce)}")
        self._lib = lib
        self._ctx = lib.EVP_CIPHER_CTX_new()
        if not self._ctx:
            raise MemoryError("EVP_CIPHER_CTX_new failed")
        # Default GCM IV length is 12 bytes, so no SET_IVLEN ctrl needed.
        ok = lib.EVP_CipherInit_ex(
            self._ctx, lib.EVP_aes_256_gcm(), None, key, nonce,
            1 if encrypt else 0,
        )
        if ok != 1:
            self.free()
            raise ValueError("EVP_CipherInit_ex (GCM) failed")

    def update(self, data: bytes) -> bytes:
        out = ctypes.create_string_buffer(len(data) + 16)
        outl = ctypes.c_int(0)
        ok = self._lib.EVP_CipherUpdate(
            self._ctx, out, ctypes.byref(outl), data, len(data)
        )
        if ok != 1:
            raise ValueError("EVP_CipherUpdate (GCM) failed")
        return out.raw[: outl.value]

    def ctrl(self, code: int, buf) -> int:
        return self._lib.EVP_CIPHER_CTX_ctrl(self._ctx, code, TAG_LEN, buf)

    def final(self) -> int:
        out = ctypes.create_string_buffer(16)
        outl = ctypes.c_int(0)
        return self._lib.EVP_CipherFinal_ex(self._ctx, out, ctypes.byref(outl))

    def free(self) -> None:
        if self._ctx is not None:
            self._lib.EVP_CIPHER_CTX_free(self._ctx)
            self._ctx = None


class AESGCM:
    """The `cryptography.hazmat.primitives.ciphers.aead.AESGCM` subset
    aead.py uses: encrypt/decrypt with a 12-byte nonce and no AAD."""

    def __init__(self, key: bytes):
        if len(key) != 32:
            raise ValueError(f"Invalid AES-256-GCM key size: {len(key)}")
        self._key = bytes(key)
        _require_lib()

    def encrypt(self, nonce: bytes, data: bytes, aad=None) -> bytes:
        if aad:
            raise ValueError("AAD unsupported by the EVP fallback")
        g = _Gcm(self._key, nonce, encrypt=True)
        try:
            ct = g.update(bytes(data))
            if g.final() != 1:
                raise ValueError("EVP_CipherFinal_ex (GCM encrypt) failed")
            tag = ctypes.create_string_buffer(TAG_LEN)
            if g.ctrl(_CTRL_GCM_GET_TAG, tag) != 1:
                raise ValueError("EVP GCM GET_TAG failed")
            return ct + tag.raw[:TAG_LEN]
        finally:
            g.free()

    def decrypt(self, nonce: bytes, data: bytes, aad=None) -> bytes:
        if aad:
            raise ValueError("AAD unsupported by the EVP fallback")
        data = bytes(data)
        if len(data) < TAG_LEN:
            raise InvalidTag("ciphertext shorter than the GCM tag")
        ct, tag = data[:-TAG_LEN], data[-TAG_LEN:]
        g = _Gcm(self._key, nonce, encrypt=False)
        try:
            pt = g.update(ct)
            if g.ctrl(_CTRL_GCM_SET_TAG, ctypes.create_string_buffer(tag, TAG_LEN)) != 1:
                raise ValueError("EVP GCM SET_TAG failed")
            if g.final() != 1:
                raise InvalidTag("GCM tag mismatch")
            return pt
        finally:
            g.free()
