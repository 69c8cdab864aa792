"""AES-CFB fallback over OpenSSL libcrypto via ctypes.

`sync/crypto.py` (the OpenPGP oracle) uses exactly one primitive from
the `cryptography` package: AES-CFB128 stream ciphers built as
`Cipher(algorithms.AES(key), modes.CFB(iv))`. Containers without that
package (this repo's image bakes in libcrypto for the batched C++
layer but not the Python wheel) would lose the WHOLE sync chain at
import time; this module supplies the same three names over the EVP
ABI instead, so `crypto.py` gates on availability rather than failing
collection for nine test files.

Error semantics mirror `cryptography` where crypto.py depends on them:
bad key/IV SIZES raise ValueError at construction (decrypt_symmetric
translates that to PgpError — the truncated-legacy-SED fuzz case), and
a failed EVP call raises ValueError, never a new exception type.
"""

from __future__ import annotations

import ctypes
import ctypes.util


def load_libcrypto(bind):
    """Probe the candidate libcrypto sonames (images differ: 3 vs 1.1
    vs a loader-path `crypto`) and return the first CDLL that `bind`
    accepts — bind(lib) declares the caller's EVP prototypes and lets
    AttributeError escape on a missing symbol. None when no candidate
    loads+binds. Shared with `_evp_gcm` so the distro-specific probe
    list lives in exactly one place."""
    names = ["libcrypto.so.3", "libcrypto.so.1.1", "libcrypto.so"]
    found = ctypes.util.find_library("crypto")
    if found:
        names.append(found)
    for name in names:
        try:
            lib = ctypes.CDLL(name)
            bind(lib)
            return lib
        except (OSError, AttributeError):
            continue
    return None


def _bind_cfb(lib):
    c = ctypes
    lib.EVP_CIPHER_CTX_new.restype = c.c_void_p
    lib.EVP_CIPHER_CTX_new.argtypes = []
    lib.EVP_CIPHER_CTX_free.restype = None
    lib.EVP_CIPHER_CTX_free.argtypes = [c.c_void_p]
    for sym in ("EVP_aes_128_cfb128", "EVP_aes_192_cfb128",
                "EVP_aes_256_cfb128"):
        fn = getattr(lib, sym)
        fn.restype = c.c_void_p
        fn.argtypes = []
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


_LIB = load_libcrypto(_bind_cfb)
# NB: a missing libcrypto is reported at first USE, not at import —
# this module is imported unconditionally by the import-hygiene walk
# (and speculatively by crypto.py's except branch), and must stay
# importable on machines where the `cryptography` wheel serves AES and
# no loader-path libcrypto exists.


def _require_lib():
    if _LIB is None:  # pragma: no cover - neither wheel nor libcrypto
        raise ImportError(
            "AES-CFB unavailable: install the `cryptography` package or "
            "provide OpenSSL libcrypto for the ctypes fallback"
        )
    return _LIB

_CIPHER_BY_KEYLEN = {
    16: "EVP_aes_128_cfb128", 24: "EVP_aes_192_cfb128", 32: "EVP_aes_256_cfb128",
}


class _CfbStream:
    """One direction of a CFB cipher: update()/finalize(), matching the
    `cryptography` CipherContext surface crypto.py uses. CFB is a
    stream mode — finalize() never emits buffered bytes."""

    def __init__(self, key: bytes, iv: bytes, encrypt: bool):
        _require_lib()
        self._ctx = _LIB.EVP_CIPHER_CTX_new()
        if not self._ctx:
            raise MemoryError("EVP_CIPHER_CTX_new failed")
        cipher = getattr(_LIB, _CIPHER_BY_KEYLEN[len(key)])()
        ok = _LIB.EVP_CipherInit_ex(
            self._ctx, cipher, None, key, iv, 1 if encrypt else 0
        )
        if ok != 1:
            self._free()
            raise ValueError("EVP_CipherInit_ex failed")

    def update(self, data: bytes) -> bytes:
        if self._ctx is None:
            raise ValueError("cipher context already finalized")
        data = bytes(data)
        out = ctypes.create_string_buffer(len(data) + 16)
        outl = ctypes.c_int(0)
        ok = _LIB.EVP_CipherUpdate(
            self._ctx, out, ctypes.byref(outl), data, len(data)
        )
        if ok != 1:
            raise ValueError("EVP_CipherUpdate failed")
        return out.raw[: outl.value]

    def finalize(self) -> bytes:
        self._free()
        return b""

    def _free(self) -> None:
        if self._ctx is not None:
            _LIB.EVP_CIPHER_CTX_free(self._ctx)
            self._ctx = None

    def __del__(self):  # belt-and-braces for abandoned streams
        try:
            self._free()
        except Exception:  # noqa: BLE001,S110 - interpreter teardown
            pass


class algorithms:  # noqa: N801 - mirrors the cryptography namespace
    class AES:
        def __init__(self, key: bytes):
            if len(key) not in _CIPHER_BY_KEYLEN:
                raise ValueError(f"Invalid AES key size: {len(key) * 8} bits")
            self.key = bytes(key)


class modes:  # noqa: N801 - mirrors the cryptography namespace
    class CFB:
        def __init__(self, initialization_vector: bytes):
            if len(initialization_vector) != 16:
                raise ValueError(
                    f"Invalid IV size ({len(initialization_vector)}) for CFB"
                )
            self.initialization_vector = bytes(initialization_vector)


class Cipher:
    def __init__(self, algorithm: "algorithms.AES", mode: "modes.CFB"):
        self._key = algorithm.key
        self._iv = mode.initialization_vector

    def encryptor(self) -> _CfbStream:
        return _CfbStream(self._key, self._iv, encrypt=True)

    def decryptor(self) -> _CfbStream:
        return _CfbStream(self._key, self._iv, encrypt=False)
