"""ctypes binding for the batched OpenPGP layer (native/evolu_crypto.cpp).

The port's copy of `evolu_tpu.sync.native_crypto`. The per-message
encrypt/decrypt loop is the sync leg's host cost (reference
packages/evolu/src/sync.worker.ts:50-91,135-173). The pure Python
implementation (`sync/crypto.py`, `sync/aead.py`) stays the semantic
oracle, correct for every wire shape and the sole producer of error
strings, while this layer runs the canonical shapes as one C call per
sync leg. The library is the reference's unchanged source, built with
g++ at first use into `evolu_tpu_torch/_build/native/`
(`utils.native_loader`).

Fallback contract (exact-behavior preserving):
- `encrypt_batch` returns None when any message needs the Python path
  (unencodable value types, out-of-range ints); the caller then runs
  the pure loop, which raises the canonical TypeError.
- `decrypt_batch` takes per-message statuses from C++: status 0 rows
  were fully verified (prefix + MDC) and decoded on the canonical
  path; every other row — old-format headers, partial lengths,
  compression, legacy SED, wrong password, MDC failure, non-canonical
  protobuf — re-runs through the Python oracle at its original
  position, so error types, messages, and first-failure order are
  byte-identical to the pure path. UTF-8 validation happens here (the
  `.decode()` below), with invalid rows demoted to the oracle too.
- `decrypt_response_columns` returns None whenever any row needs the
  object path; the caller then decodes the object way.
- Every entry point answers None (or runs the oracle) when the library
  does not build here; its log stays in `native_loader.build_info`.
"""

from __future__ import annotations

import ctypes
import struct
from array import array
from typing import List, Optional, Sequence, Tuple

from evolu_tpu_torch.core.types import CrdtMessage
from evolu_tpu_torch.sync import protocol
from evolu_tpu_torch.sync.aead import decrypt_content
from evolu_tpu_torch.utils.native_loader import build_info, try_load_native_library

SO_NAME = "libevolu_crypto.so"
_INT64_LO, _INT64_HI = -(1 << 63), (1 << 63) - 1


def _configure(lib: ctypes.CDLL) -> Optional[str]:
    c = ctypes
    u8p = c.POINTER(c.c_uint8)
    lib.ehc_available.restype = c.c_int
    lib.ehc_encrypt_batch.restype = c.c_int
    lib.ehc_encrypt_batch.argtypes = [
        c.c_int64, c.c_char_p, c.POINTER(c.c_int32), c.POINTER(c.c_int8),
        c.POINTER(c.c_int64), c.POINTER(c.c_double), c.c_char_p, c.c_int32,
        c.POINTER(c.c_void_p), c.POINTER(c.c_int64),
    ]
    lib.ehc_encrypt_wire_batch.restype = c.c_int
    lib.ehc_encrypt_wire_batch.argtypes = [
        c.c_int64, c.c_char_p, c.POINTER(c.c_int32), c.c_char_p,
        c.POINTER(c.c_int32), c.POINTER(c.c_int8), c.POINTER(c.c_int64),
        c.POINTER(c.c_double), c.c_char_p, c.c_int32,
        c.POINTER(c.c_void_p), c.POINTER(c.c_int64),
    ]
    lib.ehc_decrypt_batch.restype = c.c_int
    lib.ehc_decrypt_batch.argtypes = [
        c.c_int64, c.c_char_p, c.POINTER(c.c_int32), c.c_char_p, c.c_int32,
        u8p, c.POINTER(c.c_void_p), c.POINTER(c.c_int64),
    ]
    lib.ehc_decrypt_response.restype = c.c_int
    lib.ehc_decrypt_response.argtypes = [
        c.c_char_p, c.c_int64, c.c_char_p, c.c_int32,
        c.POINTER(c.c_void_p), c.POINTER(c.c_int64),
    ]
    lib.ehc_decrypt_response_columns.restype = c.c_int
    lib.ehc_decrypt_response_columns.argtypes = [
        c.c_char_p, c.c_int64, c.c_char_p, c.c_int32,
        c.POINTER(c.c_void_p), c.POINTER(c.c_int64),
    ]
    lib.ehc_free.argtypes = [c.c_void_p]
    # The aead-batch-v1 leg.
    lib.ehc_aead_encrypt_wire_batch.restype = c.c_int
    lib.ehc_aead_encrypt_wire_batch.argtypes = [
        c.c_int64,
        c.c_char_p, c.POINTER(c.c_int32),  # timestamps
        c.c_char_p, c.POINTER(c.c_int32),  # tables
        c.c_char_p, c.POINTER(c.c_int32),  # rows
        c.c_char_p, c.POINTER(c.c_int32),  # columns
        c.c_char_p, c.POINTER(c.c_int32),  # string values
        c.POINTER(c.c_int8), c.POINTER(c.c_int64), c.POINTER(c.c_double),
        c.c_char_p, c.c_char_p,  # key32, salt16
        c.POINTER(c.c_void_p), c.POINTER(c.c_int64),
    ]
    if not lib.ehc_available():
        return "ehc_available() is 0: libcrypto lacks the ciphers the layer needs"
    return None


def load_library() -> Optional[ctypes.CDLL]:
    """The library, built on first use; None when it does not build or
    load here."""
    return try_load_native_library(SO_NAME, _configure)


def native_available() -> bool:
    return load_library() is not None


def _pack_values(messages: Sequence):
    """Columnar packing shared by both encrypt entry points; None when
    any value needs the Python oracle's error surface."""
    n = len(messages)
    parts: List[bytes] = []
    lens = (ctypes.c_int32 * (4 * n))()
    vkinds = (ctypes.c_int8 * n)()
    ivals = (ctypes.c_int64 * n)()
    dvals = (ctypes.c_double * n)()
    for j, m in enumerate(messages):
        t = m.table.encode("utf-8")
        r = m.row.encode("utf-8")
        col = m.column.encode("utf-8")
        parts += (t, r, col)
        v = m.value
        base = 4 * j
        lens[base], lens[base + 1], lens[base + 2] = len(t), len(r), len(col)
        lens[base + 3] = -1
        if v is None:
            vkinds[j] = 0
        elif isinstance(v, bool):
            vkinds[j], ivals[j] = 2, int(v)
        elif isinstance(v, str):
            sv = v.encode("utf-8")
            parts.append(sv)
            vkinds[j], lens[base + 3] = 1, len(sv)
        elif isinstance(v, int):
            if not _INT64_LO <= v <= _INT64_HI:
                return None  # oracle raises the canonical TypeError
            vkinds[j], ivals[j] = 2, v
        elif isinstance(v, float):
            vkinds[j], dvals[j] = 3, v
        else:
            return None  # unencodable → oracle raises
    return b"".join(parts), lens, vkinds, ivals, dvals


def encrypt_batch(messages: Sequence, password: str):
    """→ tuple[EncryptedCrdtMessage] or None (Python path required).

    Mirrors `encrypt_symmetric(encode_content(...))` per message
    (crypto.py:70-83) with batch-level S2K/AES/MDC in C++. Returns
    None — never raises — when any value needs the oracle's error
    surface."""
    lib = load_library()
    if lib is None:
        return None
    packed = _pack_values(messages)
    if packed is None:
        return None
    blob, lens, vkinds, ivals, dvals = packed
    pw = password.encode("utf-8")
    out_p = ctypes.c_void_p()
    out_len = ctypes.c_int64()
    rc = lib.ehc_encrypt_batch(
        len(messages), blob, lens, vkinds, ivals, dvals, pw, len(pw),
        ctypes.byref(out_p), ctypes.byref(out_len),
    )
    if rc != 0:
        return None
    try:
        raw = ctypes.string_at(out_p.value, out_len.value)
    finally:
        lib.ehc_free(out_p)
    out = []
    pos = 0
    for m in messages:
        (ct_len,) = struct.unpack_from("<I", raw, pos)
        pos += 4
        out.append(protocol.EncryptedCrdtMessage(m.timestamp, raw[pos : pos + ct_len]))
        pos += ct_len
    if pos != len(raw):
        return None  # size accounting drift — distrust the whole batch
    return tuple(out)


def encode_push_request(
    messages: Sequence, password: str, user_id: str, node_id: str,
    merkle_tree: str,
) -> Optional[bytes]:
    """The whole SyncRequest body with ZERO per-message Python:
    `ehc_encrypt_wire_batch` emits the encrypted `messages` field-1
    stream byte-compatibly with `protocol.encode_sync_request`, and
    the three scalar fields append here. None → pure path."""
    lib = load_library()
    if lib is None:
        return None
    packed = _pack_values(messages)
    if packed is None:
        return None
    blob, lens, vkinds, ivals, dvals = packed
    n = len(messages)
    ts_parts = []
    ts_lens = (ctypes.c_int32 * n)()
    for j, m in enumerate(messages):
        ts = m.timestamp.encode("utf-8")
        ts_parts.append(ts)
        ts_lens[j] = len(ts)
    pw = password.encode("utf-8")
    out_p = ctypes.c_void_p()
    out_len = ctypes.c_int64()
    rc = lib.ehc_encrypt_wire_batch(
        n, b"".join(ts_parts), ts_lens, blob, lens, vkinds, ivals, dvals,
        pw, len(pw), ctypes.byref(out_p), ctypes.byref(out_len),
    )
    if rc != 0:
        return None
    try:
        stream = ctypes.string_at(out_p.value, out_len.value)
    finally:
        lib.ehc_free(out_p)
    return (
        stream
        + protocol._string(2, user_id)
        + protocol._string(3, node_id)
        + protocol._string(4, merkle_tree)
    )


# Exact-type → wire kind for the columnar packer. 4 = not packable
# (bytes, str/int subclasses, anything exotic) → the Python oracle owns
# the error surface. bool IS exact here (2: varint like int); a bool in
# an array("q") slot is its 0/1 int value by the buffer protocol.
_VKIND_OF = {type(None): 0, str: 1, bool: 2, int: 2, float: 3}


def _pack_columns(messages: Sequence):
    """Columnar packing for the aead wire leg — one blob + length array
    PER FIELD instead of the v1 interleave. The per-message Python
    share is the binding cost of the v2 leg (the C side dropped to one
    GCM per record), so every pass here is a comprehension or a map —
    no per-message interpreter loop with method-call dispatch (that
    shape measured ~2× slower). int64 range policing is delegated to
    `array("q")`'s own OverflowError: one C-level check instead of two
    Python comparisons per message.
    None when any value needs the Python oracle's error surface."""
    enc = str.encode
    try:
        tsb = [enc(m.timestamp) for m in messages]
        tb = [enc(m.table) for m in messages]
        rb = [enc(m.row) for m in messages]
        cb = [enc(m.column) for m in messages]
    except (TypeError, AttributeError):
        return None  # non-string field → oracle raises canonically
    kind_of = _VKIND_OF
    vals = [m.value for m in messages]
    kinds = [kind_of.get(type(v), 4) for v in vals]
    if 4 in kinds:
        return None  # unencodable somewhere → oracle raises
    try:
        ivals = array("q", [v if k == 2 else 0 for k, v in zip(kinds, vals)])
    except OverflowError:
        return None  # beyond int64 → oracle raises the canonical TypeError
    dvals = array("d", [v if k == 3 else 0.0 for k, v in zip(kinds, vals)])
    sparts = [enc(v) if k == 1 else b"" for k, v in zip(kinds, vals)]
    join = b"".join
    i32 = ctypes.c_int32
    lens = array("i", map(len, tsb)) + array("i", map(len, tb)) \
        + array("i", map(len, rb)) + array("i", map(len, cb)) \
        + array("i", map(len, sparts))
    n = len(tsb)
    la = (i32 * len(lens)).from_buffer(lens)
    return (
        join(tsb), la, join(tb), n, join(rb), join(cb), join(sparts),
        (ctypes.c_int8 * n).from_buffer(array("b", kinds)),
        (ctypes.c_int64 * n).from_buffer(ivals),
        (ctypes.c_double * n).from_buffer(dvals),
    )


_PY_PUSH = False  # resolved lazily: False=untried, None=unavailable


def _py_push_fn():
    """The CPython-ABI encode lane (`ehc_aead_encrypt_push_py` via
    ctypes.PyDLL — PyDLL keeps the GIL, which the extraction phase
    requires; the C side drops it itself for the seal loop so other
    threads overlap the crypto). Enabled only after `ehc_py_abi_probe`
    validates the
    self-declared PyObject layout against a live str on THIS
    interpreter — any drift (debug build, free-threading, future
    CPython) silently falls back to the blob packer. None when
    unavailable."""
    global _PY_PUSH
    if _PY_PUSH is not False:
        return _PY_PUSH
    _PY_PUSH = None
    if load_library() is None:
        return None
    try:
        c = ctypes
        plib = c.PyDLL(build_info[SO_NAME]["path"])
        probe = plib.ehc_py_abi_probe
        probe.restype = c.c_int
        probe.argtypes = [c.py_object]
        if probe("x") != 0:
            return None
        fn = plib.ehc_aead_encrypt_push_py
        fn.restype = c.c_int
        fn.argtypes = [
            c.py_object, c.c_int64, c.c_char_p, c.c_char_p,
            c.POINTER(c.c_void_p), c.POINTER(c.c_int64),
        ]
        _PY_PUSH = fn
    except (OSError, AttributeError, ctypes.ArgumentError):
        _PY_PUSH = None
    return _PY_PUSH


def encode_push_request_aead(
    messages: Sequence, key: bytes, salt: bytes, user_id: str, node_id: str,
    merkle_tree: str,
) -> Optional[bytes]:
    """The v2 twin of `encode_push_request`: the whole SyncRequest body
    with ONE session key schedule and one GCM per message, byte-
    compatible with `protocol.encode_sync_request` over
    `aead.encrypt_record` contents. Two native lanes: the CPython-ABI
    extraction (`ehc_aead_encrypt_push_py`, zero per-message Python)
    and the columnar blob ABI (`ehc_aead_encrypt_wire_batch`) behind
    it. None → pure path (library or symbol unavailable, or a value
    that needs the oracle's error surface)."""
    lib = load_library()
    if lib is None:
        return None
    fn = _py_push_fn()
    if fn is not None:
        if not isinstance(messages, (tuple, list)):
            messages = tuple(messages)
        out_p = ctypes.c_void_p()
        out_len = ctypes.c_int64()
        rc = fn(messages, len(messages), key, salt,
                ctypes.byref(out_p), ctypes.byref(out_len))
        if rc == 0:
            try:
                stream = ctypes.string_at(out_p.value, out_len.value)
            finally:
                lib.ehc_free(out_p)
            return (
                stream
                + protocol._string(2, user_id)
                + protocol._string(3, node_id)
                + protocol._string(4, merkle_tree)
            )
        # rc != 0: shape demotion — the blob packer (then the oracle)
        # owns the canonical error surface.
    packed = _pack_columns(messages)
    if packed is None:
        return None
    ts_blob, lens, t_blob, n, r_blob, c_blob, s_blob, vkinds, ivals, dvals = packed
    p32 = ctypes.POINTER(ctypes.c_int32)
    base = ctypes.cast(lens, p32)
    out_p = ctypes.c_void_p()
    out_len = ctypes.c_int64()
    rc = lib.ehc_aead_encrypt_wire_batch(
        n, ts_blob, base,
        t_blob, ctypes.cast(ctypes.byref(lens, 4 * n), p32),
        r_blob, ctypes.cast(ctypes.byref(lens, 8 * n), p32),
        c_blob, ctypes.cast(ctypes.byref(lens, 12 * n), p32),
        s_blob, ctypes.cast(ctypes.byref(lens, 16 * n), p32),
        vkinds, ivals, dvals, key, salt,
        ctypes.byref(out_p), ctypes.byref(out_len),
    )
    if rc != 0:
        return None
    try:
        stream = ctypes.string_at(out_p.value, out_len.value)
    finally:
        lib.ehc_free(out_p)
    return (
        stream
        + protocol._string(2, user_id)
        + protocol._string(3, node_id)
        + protocol._string(4, merkle_tree)
    )


_REC_HEAD = struct.Struct("<iiiib q d")


def _parse_record(raw: bytes, pos: int):
    """ONE parser for the C decoded-content record layout
    (append_content_record) — both decrypt entry points use it, so the
    format can never drift between them. → (table, row, column, value,
    next_pos); raises UnicodeDecodeError on invalid UTF-8 (callers
    demote to the pure oracle)."""
    tl, rl, cl, vl, vkind, ival, dval = _REC_HEAD.unpack_from(raw, pos)
    pos += _REC_HEAD.size
    table = raw[pos : pos + tl].decode("utf-8")
    pos += tl
    row = raw[pos : pos + rl].decode("utf-8")
    pos += rl
    column = raw[pos : pos + cl].decode("utf-8")
    pos += cl
    if vkind == 0:
        value = None
    elif vkind == 1:
        value = raw[pos : pos + vl].decode("utf-8")
        pos += vl
    elif vkind == 2:
        value = ival
    else:
        value = dval
    return table, row, column, value, pos


def decrypt_batch(messages: Sequence, password: str) -> Tuple[CrdtMessage, ...]:
    """→ tuple[CrdtMessage]; raises exactly what the pure path raises.

    C++ handles canonical rows; every status≠0 row re-runs through the
    Python oracle IN ORDER, so the first failing message raises the
    same error the pure loop would have."""
    lib = load_library()
    if lib is None:
        return _pure(messages, password)
    n = len(messages)
    ct_blob = b"".join(m.content for m in messages)
    ct_lens = (ctypes.c_int32 * n)(*(len(m.content) for m in messages))
    statuses = (ctypes.c_uint8 * n)()
    pw = password.encode("utf-8")
    out_p = ctypes.c_void_p()
    out_len = ctypes.c_int64()
    rc = lib.ehc_decrypt_batch(
        n, ct_blob, ct_lens, pw, len(pw), statuses,
        ctypes.byref(out_p), ctypes.byref(out_len),
    )
    if rc != 0:
        return _pure(messages, password)
    try:
        raw = ctypes.string_at(out_p.value, out_len.value)
    finally:
        lib.ehc_free(out_p)

    out: List[CrdtMessage] = []
    pos = 0
    for j, m in enumerate(messages):
        if statuses[j] != 0:
            out.append(_pure_one(m, password))
            continue
        try:
            table, row, column, value, pos = _parse_record(raw, pos)
        except UnicodeDecodeError:
            # Invalid UTF-8 in a string field: demote the whole batch
            # to the oracle for the canonical ValueError.
            return _pure(messages, password)
        out.append(CrdtMessage(m.timestamp, table, row, column, value))
    return tuple(out)


def decrypt_response(response_bytes: bytes, password: str):
    """Fused `decode_sync_response` + `decrypt_messages`: → (messages
    tuple, merkle_tree str), or None when the WIRE shape needs the
    pure decoder (whole-batch fallback preserves its exact ValueError
    surface; per-message crypto fallbacks re-run the oracle at their
    position). Raises what the pure path raises."""
    lib = load_library()
    if lib is None:
        return None
    pw = password.encode("utf-8")
    out_p = ctypes.c_void_p()
    out_len = ctypes.c_int64()
    rc = lib.ehc_decrypt_response(
        response_bytes, len(response_bytes), pw, len(pw),
        ctypes.byref(out_p), ctypes.byref(out_len),
    )
    if rc != 0:
        return None  # rc 2: non-canonical wire → pure decoder wholesale
    try:
        raw = ctypes.string_at(out_p.value, out_len.value)
    finally:
        lib.ehc_free(out_p)
    # Pass 1 — decode EVERY wire-derived string (timestamps, decoded
    # records, the tree) before any fallback decrypt runs: the pure
    # path fully parses the response, THEN decrypts in order, so a
    # bad-UTF-8 tree must surface before a bad ciphertext (fuzz-found
    # ordering divergence). Any UnicodeDecodeError → None, the pure
    # decoder owns that exact error.
    try:
        (n,) = struct.unpack_from("<q", raw, 0)
        (tree_len,) = struct.unpack_from("<I", raw, 8)
        pos = 12
        items: List[tuple] = []  # (timestamp, decoded CrdtMessage | ct span)
        for _ in range(n):
            status = raw[pos]
            pos += 1
            (ts_len,) = struct.unpack_from("<I", raw, pos)
            pos += 4
            timestamp = raw[pos : pos + ts_len].decode("utf-8")
            pos += ts_len
            if status != 0:
                (ct_off,) = struct.unpack_from("<q", raw, pos)
                pos += 8
                (ct_len,) = struct.unpack_from("<I", raw, pos)
                pos += 4
                items.append((timestamp, (ct_off, ct_len)))
                continue
            table, row, column, value, pos = _parse_record(raw, pos)
            items.append((timestamp, CrdtMessage(timestamp, table, row, column, value)))
        tree = raw[pos : pos + tree_len].decode("utf-8")
    except UnicodeDecodeError:
        return None

    # Pass 2 — oracle re-runs for demoted rows, in wire order (their
    # PgpError/ValueError fires exactly where the pure loop's would).
    out: List[CrdtMessage] = []
    for timestamp, item in items:
        if isinstance(item, CrdtMessage):
            out.append(item)
            continue
        ct_off, ct_len = item
        ct = response_bytes[ct_off : ct_off + ct_len]
        table, row, column, value = protocol.decode_content(
            decrypt_content(ct, password)
        )
        out.append(CrdtMessage(timestamp, table, row, column, value))
    return tuple(out), tree


def decrypt_response_columns(response_bytes: bytes, password: str):
    """The fully-fused receive decode: SyncResponse protobuf walk +
    decrypt + columnarization in ONE C call → (PackedReceive, tree) —
    zero per-row Python objects, interned cells, a 46-wide timestamp
    slab, bind-ready value columns. None whenever ANY row needs the
    object path (demoted crypto, non-46 timestamp, invalid UTF-8,
    non-canonical wire) — the caller then runs `decrypt_response` /
    the pure decoder, which own the exact error surface. Success here
    implies the object path would have produced the same batch
    (pinned by tests), so behavior is identical either way."""
    lib = load_library()
    if lib is None:
        return None
    pw = password.encode("utf-8")
    out_p = ctypes.c_void_p()
    out_len = ctypes.c_int64()
    rc = lib.ehc_decrypt_response_columns(
        response_bytes, len(response_bytes), pw, len(pw),
        ctypes.byref(out_p), ctypes.byref(out_len),
    )
    if rc != 0:
        return None
    try:
        raw = ctypes.string_at(out_p.value, out_len.value)
    finally:
        lib.ehc_free(out_p)
    from evolu_tpu_torch.core.packed import PackedReceive

    try:
        return PackedReceive.from_blob(raw)
    except UnicodeDecodeError:  # defense in depth: C validated UTF-8
        return None


def _pure_one(m, password: str) -> CrdtMessage:
    # decrypt_content dispatches v1 OpenPGP vs aead-batch-v1 records by
    # the self-describing magic — the oracle reads BOTH unconditionally
    # (negotiation gates emission, never decoding).
    table, row, column, value = protocol.decode_content(
        decrypt_content(m.content, password)
    )
    return CrdtMessage(m.timestamp, table, row, column, value)


def _pure(messages: Sequence, password: str) -> Tuple[CrdtMessage, ...]:
    return tuple(_pure_one(m, password) for m in messages)
