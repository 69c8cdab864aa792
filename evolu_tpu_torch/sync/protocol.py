"""The protobuf wire contract, hand-rolled: the port's copy of
`evolu_tpu.sync.protocol` for the client's `Send` gate, the sync
transport's message contents and the relay's sync wire. The replica,
snapshot and fleet codecs come with the slices that use them.

Field numbers are the contract with the reference's protobuf.proto:

    CrdtMessageContent { table=1 row=2 column=3
                         oneof value { stringValue=4 numberValue=5 } }
    EncryptedCrdtMessage { timestamp=1 content=2 }
    SyncRequest  { messages=1 userId=2 nodeId=3 merkleTree=4 }
    SyncResponse { messages=1 merkleTree=2 }

Non-integer numbers travel in an extension field `doubleValue=6` (wire
type I64) and 64-bit ints in `int64Value=7`; `extensions=False`
(`Config.wire_extensions = False`) refuses such values instead.
Extensions of the sync messages: capability names (SyncRequest field 5,
SyncResponse field 3) and the partial-replication scope clause
(SyncRequest field 6), each emitted only when present, so the
capability-less wire stays the reference's byte for byte.
"""

from __future__ import annotations

import functools
import struct
from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

from evolu_tpu_torch.core.types import CrdtValue

_INT32_MIN, _INT32_MAX = -(2**31), 2**31 - 1


def _wire_decoder(fn):
    """Typed error contract for the public decoders: ANY malformed input
    raises ValueError (wire-type mismatches otherwise surface as
    AttributeError/TypeError from e.g. `int.decode`)."""

    @functools.wraps(fn)
    def wrapper(data: bytes):
        try:
            return fn(data)
        except ValueError:
            raise
        except (AttributeError, TypeError, IndexError, OverflowError,
                struct.error, UnicodeDecodeError) as e:
            raise ValueError(f"malformed {fn.__name__[7:]} message: {e}") from e

    return wrapper


# --- primitive writers ---


def _varint(value: int) -> bytes:
    if value < 0:  # proto3 int32: negatives are 10-byte two's-complement varints
        value += 1 << 64
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field_number: int, wire_type: int) -> bytes:
    return _varint((field_number << 3) | wire_type)


def _len_delimited(field_number: int, data: bytes) -> bytes:
    return _tag(field_number, 2) + _varint(len(data)) + data


def _string(field_number: int, s: str) -> bytes:
    return _len_delimited(field_number, s.encode("utf-8"))


# --- primitive readers ---


def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        if pos >= len(data):
            raise ValueError("truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _read_field(data: bytes, pos: int) -> Tuple[int, int, Union[int, bytes], int]:
    """→ (field_number, wire_type, value, next_pos). Length-delimited
    values come back as bytes, varints/fixed as ints."""
    key, pos = _read_varint(data, pos)
    field_number, wire_type = key >> 3, key & 7
    if wire_type == 0:
        value, pos = _read_varint(data, pos)
    elif wire_type == 1:
        if pos + 8 > len(data):
            raise ValueError("truncated fixed64 field")
        value = int.from_bytes(data[pos : pos + 8], "little")
        pos += 8
    elif wire_type == 2:
        length, pos = _read_varint(data, pos)
        value = data[pos : pos + length]
        if len(value) != length:
            raise ValueError("truncated length-delimited field")
        pos += length
    elif wire_type == 5:
        if pos + 4 > len(data):
            raise ValueError("truncated fixed32 field")
        value = int.from_bytes(data[pos : pos + 4], "little")
        pos += 4
    else:
        raise ValueError(f"unsupported wire type {wire_type}")
    return field_number, wire_type, value, pos


# --- CrdtMessageContent (proto:5-13) ---


def encode_content(
    table: str, row: str, column: str, value: CrdtValue, *, extensions: bool = True
) -> bytes:
    out = _string(1, table) + _string(2, row) + _string(3, column)
    if value is None:
        pass  # oneofKind undefined → no value field (sync.worker.ts:40-48)
    elif isinstance(value, str):
        out += _string(4, value)
    elif isinstance(value, bool):  # bools are stored cast to 0/1 upstream
        out += _tag(5, 0) + _varint(int(value))
    elif isinstance(value, int) and _INT32_MIN <= value <= _INT32_MAX:
        out += _tag(5, 0) + _varint(value)
    elif isinstance(value, int):
        if not -(2**63) <= value < 2**63:
            raise TypeError(f"integer exceeds int64: {value!r}")
        if not extensions:
            raise TypeError(
                f"integer exceeds the reference's int32 value schema: {value!r} "
                "(strict interop mode — a reference peer would silently drop "
                "field 7; set Config.wire_extensions=True to allow it)"
            )
        out += _tag(7, 0) + _varint(value)  # int64 extension — exact
    elif isinstance(value, float):
        if not extensions:
            raise TypeError(
                f"float is outside the reference's string|int32 value schema: "
                f"{value!r} (strict interop mode — a reference peer would "
                "silently drop field 6; set Config.wire_extensions=True, or "
                "store it as a string)"
            )
        out += _tag(6, 1) + struct.pack("<d", value)
    else:
        raise TypeError(f"unencodable CrdtValue: {value!r}")
    return out


def assert_wire_encodable(value: CrdtValue, extensions: bool = True) -> None:
    """Mutation-time wire gate, applied BEFORE a value enters the local
    log — enforcing at transport-encode time would be too late: the
    value would already be committed and every later anti-entropy
    resend batch containing it would fail to encode, wedging sync for
    the owner permanently. With extensions, anything `encode_content`
    can express passes (str|int64|double|bool|None — e.g. bytes never
    can, SQLite accepts them happily); strict mode
    (Config.wire_extensions=False) narrows to the reference's
    string|int32 oneof.

    Implemented BY the encoder (a throwaway encode of the value alone)
    so gate and encoder can never drift apart — drift would recreate
    the wedge: a value the gate passed but the encoder later rejects."""
    if isinstance(value, str):
        return  # skip encoding arbitrarily large strings just to gate
    encode_content("", "", "", value, extensions=extensions)


@_wire_decoder
def decode_content(data: bytes) -> Tuple[str, str, str, CrdtValue]:
    table = row = column = ""
    value: CrdtValue = None
    pos = 0
    while pos < len(data):
        num, wt, v, pos = _read_field(data, pos)
        if num == 1:
            table = v.decode("utf-8")
        elif num == 2:
            row = v.decode("utf-8")
        elif num == 3:
            column = v.decode("utf-8")
        elif num == 4:
            value = v.decode("utf-8")
        elif num == 5:
            # int32: sign-extended 64-bit varint on the wire; truncate
            # to int32 like every conformant decoder.
            value = ((v & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000
        elif num == 6:
            value = struct.unpack("<d", int(v).to_bytes(8, "little"))[0]
        elif num == 7:
            value = v - (1 << 64) if v >= 1 << 63 else v  # int64 extension
    return table, row, column, value


# --- EncryptedCrdtMessage (proto:15-18) ---


@dataclass(frozen=True)
class EncryptedCrdtMessage:
    timestamp: str  # stays plaintext — the relay orders/diffs by it
    content: bytes  # OpenPGP ciphertext of encode_content


def encode_encrypted_message(m: EncryptedCrdtMessage) -> bytes:
    return _string(1, m.timestamp) + _len_delimited(2, m.content)


@_wire_decoder
def decode_encrypted_message(data: bytes) -> EncryptedCrdtMessage:
    timestamp, content = "", b""
    pos = 0
    while pos < len(data):
        num, wt, v, pos = _read_field(data, pos)
        if num == 1:
            timestamp = v.decode("utf-8")
        elif num == 2:
            if wt != 2:
                # A varint here would make bytes(v) ALLOCATE v zero bytes —
                # a remote memory-DoS; only length-delimited content is valid.
                raise ValueError(f"content field has wire type {wt}")
            content = bytes(v)
    return EncryptedCrdtMessage(timestamp, content)


# --- SyncRequest (proto:20-25) / SyncResponse (proto:27-30) ---
#
# Capabilities are advisory names, answered by a relay with the
# intersection of the request's and its own; the scope clause asks for a
# partial serve (a relay of the port refuses it until scoped sync is
# ported, never serving it unscoped).

CAP_CRDT_TYPES = "crdt-types-v1"
CAP_CRDT_LIST = "crdt-list-v1"
CAP_AEAD_BATCH = "aead-batch-v1"
CAP_SYNC_SCOPE = "sync-scope-v1"
CAP_CRDT_TENSOR = "crdt-tensor-v1"
KNOWN_CAPABILITIES = (CAP_CRDT_TYPES, CAP_CRDT_LIST, CAP_CRDT_TENSOR,
                      CAP_AEAD_BATCH, CAP_SYNC_SCOPE)
_MAX_CAPABILITIES = 64  # decode bound: a hostile body must not mint unbounded strings
# Scope-clause decode bounds: requested tags are capped here; push tags
# by the message count they annotate (checked after the field walk).
_MAX_SCOPE_TAGS = 16
_MAX_SCOPE_TAG_LEN = 128


@dataclass(frozen=True)
class ScopeClause:
    """The wire form of a sync scope (SyncRequest field 6):
    `watermark_millis` (0 = none), the requested lane `tags`, and
    `push_tags`, one lane a pushed message ("" = untagged)."""

    watermark_millis: int = 0
    tags: Tuple[str, ...] = ()
    push_tags: Tuple[str, ...] = ()


@dataclass(frozen=True)
class SyncRequest:
    messages: Tuple[EncryptedCrdtMessage, ...]
    user_id: str
    node_id: str
    merkle_tree: str
    capabilities: Tuple[str, ...] = ()
    scope: Optional[ScopeClause] = None


@dataclass(frozen=True)
class SyncResponse:
    messages: Tuple[EncryptedCrdtMessage, ...]
    merkle_tree: str
    capabilities: Tuple[str, ...] = ()


def encode_request_capabilities(capabilities: Tuple[str, ...]) -> bytes:
    """SyncRequest field-5 bytes, appendable to an encoded request."""
    return b"".join(_string(5, c) for c in capabilities)


def encode_response_capabilities(capabilities: Tuple[str, ...]) -> bytes:
    """SyncResponse field-3 bytes, appendable to an encoded response."""
    return b"".join(_string(3, c) for c in capabilities)


def _decode_capability(v, caps: List[str]) -> None:
    if len(caps) >= _MAX_CAPABILITIES:
        raise ValueError("too many capability entries")
    caps.append(v.decode("utf-8"))


def encode_scope_clause(s: ScopeClause) -> bytes:
    """The nested scope message: watermarkMillis=1 (varint), tags=2
    (repeated string), pushTags=3 (repeated string)."""
    out = b""
    if s.watermark_millis:
        out += _tag(1, 0) + _varint(s.watermark_millis)
    out += b"".join(_string(2, t) for t in s.tags)
    out += b"".join(_string(3, t) for t in s.push_tags)
    return out


def encode_request_scope(s: Optional[ScopeClause]) -> bytes:
    """SyncRequest field-6 bytes; b"" when no scope."""
    if s is None:
        return b""
    return _len_delimited(6, encode_scope_clause(s))


def _decode_scope_tag(v, wt: int, tags: List[str], what: str) -> None:
    if wt != 2:
        raise ValueError(f"scope {what} field has wire type {wt}")
    if len(tags) >= _MAX_SCOPE_TAGS:
        raise ValueError(f"too many scope {what} entries")
    if len(v) > _MAX_SCOPE_TAG_LEN:
        raise ValueError(f"scope {what} too long ({len(v)} bytes)")
    tags.append(v.decode("utf-8"))


@_wire_decoder
def decode_scope_clause(data: bytes) -> ScopeClause:
    watermark = 0
    tags: List[str] = []
    push_tags: List[str] = []
    pos = 0
    while pos < len(data):
        num, wt, v, pos = _read_field(data, pos)
        if num == 1:
            watermark = int(v)
            # Varints are unsigned on the wire: a negative int64 arrives
            # as a value in [2^63, 2^64).
            if watermark >= 1 << 63:
                raise ValueError("scope watermark must be non-negative")
        elif num == 2:
            _decode_scope_tag(v, wt, tags, "tag")
        elif num == 3:
            # One push tag a message: the count is checked against the
            # messages by decode_sync_request; each entry's length here.
            if wt != 2:
                raise ValueError(f"scope push tag field has wire type {wt}")
            if len(v) > _MAX_SCOPE_TAG_LEN:
                raise ValueError(f"scope push tag too long ({len(v)} bytes)")
            push_tags.append(v.decode("utf-8"))
    return ScopeClause(watermark, tuple(tags), tuple(push_tags))


def encode_sync_request(r: SyncRequest) -> bytes:
    out = b"".join(_len_delimited(1, encode_encrypted_message(m)) for m in r.messages)
    out += _string(2, r.user_id) + _string(3, r.node_id) + _string(4, r.merkle_tree)
    return out + encode_request_capabilities(r.capabilities) \
        + encode_request_scope(r.scope)


@_wire_decoder
def decode_sync_request(data: bytes) -> SyncRequest:
    messages: List[EncryptedCrdtMessage] = []
    user_id = node_id = merkle_tree = ""
    capabilities: List[str] = []
    scope: Optional[ScopeClause] = None
    pos = 0
    while pos < len(data):
        num, wt, v, pos = _read_field(data, pos)
        if num == 1:
            messages.append(decode_encrypted_message(v))
        elif num == 2:
            user_id = v.decode("utf-8")
        elif num == 3:
            node_id = v.decode("utf-8")
        elif num == 4:
            merkle_tree = v.decode("utf-8")
        elif num == 5:
            _decode_capability(v, capabilities)
        elif num == 6:
            if wt != 2:
                raise ValueError(f"scope clause field has wire type {wt}")
            scope = decode_scope_clause(v)
    if scope is not None and scope.push_tags and \
            len(scope.push_tags) != len(messages):
        raise ValueError(
            f"scope push tags ({len(scope.push_tags)}) do not match the "
            f"message count ({len(messages)})"
        )
    return SyncRequest(tuple(messages), user_id, node_id, merkle_tree,
                       tuple(capabilities), scope)


def encode_sync_response(r: SyncResponse) -> bytes:
    out = b"".join(_len_delimited(1, encode_encrypted_message(m)) for m in r.messages)
    return out + _string(2, r.merkle_tree) + encode_response_capabilities(r.capabilities)


@_wire_decoder
def scan_sync_response_capabilities(data: bytes) -> Tuple[str, ...]:
    """Top-level walk collecting ONLY the field-3 capability strings of a
    raw response."""
    caps: List[str] = []
    pos = 0
    while pos < len(data):
        num, wt, v, pos = _read_field(data, pos)
        if num == 3:
            _decode_capability(v, caps)
    return tuple(caps)


@_wire_decoder
def decode_sync_response(data: bytes) -> SyncResponse:
    messages: List[EncryptedCrdtMessage] = []
    merkle_tree = ""
    capabilities: List[str] = []
    pos = 0
    while pos < len(data):
        num, wt, v, pos = _read_field(data, pos)
        if num == 1:
            messages.append(decode_encrypted_message(v))
        elif num == 2:
            merkle_tree = v.decode("utf-8")
        elif num == 3:
            _decode_capability(v, capabilities)
    return SyncResponse(tuple(messages), merkle_tree, tuple(capabilities))
