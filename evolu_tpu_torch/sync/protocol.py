"""The protobuf encoding of `CrdtMessageContent`, hand-rolled: the part
of `evolu_tpu.sync.protocol` the client worker's `Send` needs to gate
values before they enter the log. The rest of the wire (requests,
responses, decoders) comes with the sync slice.

Field numbers are the contract with the reference's protobuf.proto:

    CrdtMessageContent { table=1 row=2 column=3
                         oneof value { stringValue=4 numberValue=5 } }

Non-integer numbers travel in an extension field `doubleValue=6` (wire
type I64) and 64-bit ints in `int64Value=7`; `extensions=False`
(`Config.wire_extensions = False`) refuses such values instead.
"""

from __future__ import annotations

import struct

from evolu_tpu_torch.core.types import CrdtValue

_INT32_MIN, _INT32_MAX = -(2**31), 2**31 - 1


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
