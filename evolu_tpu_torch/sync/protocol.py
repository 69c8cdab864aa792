"""The protobuf wire contract, hand-rolled: the port's copy of
`evolu_tpu.sync.protocol` for the client's `Send` gate, the sync
transport's message contents, the relay's sync wire, and the relay
tier's replica, snapshot and fleet codecs.

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
# partial serve (`server/scope.py`), which a relay without `sync-scope-v1`
# strips, answering the full serve.

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


# --- relay↔relay replication messages (extension — no reference
# equivalent; the reference relay is a single node). Same hand-rolled
# proto3 subset, same decoder error contract (ValueError only), and the
# same E2EE-blindness: nothing here ever carries plaintext — owners are
# ids, trees are JSON digests of timestamps, messages stay
# (timestamp, ciphertext). See server/replicate.py. ---
#
#     OwnerTree           { userId=1 merkleTree=2 }
#     ReplicaSummary      { owners=1 (repeated OwnerTree) replicaId=2 }
#     OwnerPull           { userId=1 since=2 }
#     ReplicaPull         { pulls=1 (repeated OwnerPull) replicaId=2 }
#     OwnerMessages       { userId=1 messages=2 (repeated
#                           EncryptedCrdtMessage) merkleTree=3 }
#     ReplicaPullResponse { chunks=1 (repeated OwnerMessages) }


@dataclass(frozen=True)
class ReplicaSummary:
    """One side of a gossip exchange: every owner this relay stores,
    with its serialized Merkle tree. Sent as the `/replicate/summary`
    request body (the caller's summary) AND returned as its response
    (the callee's) — divergence is computable from either side.

    `peer_url` (field 3, fleet extension): the CALLER's advertised base
    URL. A fleet relay (server/fleet.py) scopes its response to owners
    placed on that URL, dropping gossip traffic from O(fleet) to O(R).
    Empty (the pre-fleet wire and non-fleet relays) means "answer
    everything" — old and new peers interoperate unchanged. Like
    `replica_id` it is untrusted input: it selects a SUBSET of the
    response and is never minted into metric labels."""

    trees: Tuple[Tuple[str, str], ...]  # (owner id, merkle tree string)
    replica_id: str
    peer_url: str = ""


@dataclass(frozen=True)
class ReplicaPull:
    """Ranged fetch: per owner, every message strictly after `since`
    (a 46-char sync timestamp at the diverged minute). No node
    exclusion — a relay is not a message author; it needs all rows."""

    pulls: Tuple[Tuple[str, str], ...]  # (owner id, since timestamp string)
    replica_id: str


@dataclass(frozen=True)
class OwnerMessages:
    user_id: str
    messages: Tuple[EncryptedCrdtMessage, ...]
    merkle_tree: str  # the serving relay's tree at fetch time


@dataclass(frozen=True)
class ReplicaPullResponse:
    chunks: Tuple[OwnerMessages, ...]


def encode_replica_summary(s: ReplicaSummary) -> bytes:
    out = b"".join(
        _len_delimited(1, _string(1, uid) + _string(2, tree)) for uid, tree in s.trees
    )
    out += _string(2, s.replica_id)
    if s.peer_url:
        out += _string(3, s.peer_url)
    return out


@_wire_decoder
def _decode_owner_tree(data: bytes) -> Tuple[str, str]:
    uid = tree = ""
    pos = 0
    while pos < len(data):
        num, wt, v, pos = _read_field(data, pos)
        if num == 1:
            uid = v.decode("utf-8")
        elif num == 2:
            tree = v.decode("utf-8")
    return uid, tree


@_wire_decoder
def decode_replica_summary(data: bytes) -> ReplicaSummary:
    trees: List[Tuple[str, str]] = []
    replica_id = peer_url = ""
    pos = 0
    while pos < len(data):
        num, wt, v, pos = _read_field(data, pos)
        if num == 1:
            if wt != 2:
                raise ValueError(f"owner tree field has wire type {wt}")
            trees.append(_decode_owner_tree(v))
        elif num == 2:
            replica_id = v.decode("utf-8")
        elif num == 3:
            peer_url = v.decode("utf-8")
    return ReplicaSummary(tuple(trees), replica_id, peer_url)


def encode_replica_pull(p: ReplicaPull) -> bytes:
    out = b"".join(
        _len_delimited(1, _string(1, uid) + _string(2, since)) for uid, since in p.pulls
    )
    return out + _string(2, p.replica_id)


@_wire_decoder
def decode_replica_pull(data: bytes) -> ReplicaPull:
    pulls: List[Tuple[str, str]] = []
    replica_id = ""
    pos = 0
    while pos < len(data):
        num, wt, v, pos = _read_field(data, pos)
        if num == 1:
            if wt != 2:
                raise ValueError(f"owner pull field has wire type {wt}")
            pulls.append(_decode_owner_tree(v))  # same (string=1, string=2) shape
        elif num == 2:
            replica_id = v.decode("utf-8")
    return ReplicaPull(tuple(pulls), replica_id)


def encode_owner_messages(om: OwnerMessages) -> bytes:
    out = _string(1, om.user_id)
    out += b"".join(_len_delimited(2, encode_encrypted_message(m)) for m in om.messages)
    return out + _string(3, om.merkle_tree)


@_wire_decoder
def decode_owner_messages(data: bytes) -> OwnerMessages:
    uid = tree = ""
    messages: List[EncryptedCrdtMessage] = []
    pos = 0
    while pos < len(data):
        num, wt, v, pos = _read_field(data, pos)
        if num == 1:
            uid = v.decode("utf-8")
        elif num == 2:
            if wt != 2:
                raise ValueError(f"messages field has wire type {wt}")
            messages.append(decode_encrypted_message(v))
        elif num == 3:
            tree = v.decode("utf-8")
    return OwnerMessages(uid, tuple(messages), tree)


def encode_replica_pull_response(r: ReplicaPullResponse) -> bytes:
    return b"".join(_len_delimited(1, encode_owner_messages(c)) for c in r.chunks)


@_wire_decoder
def decode_replica_pull_response(data: bytes) -> ReplicaPullResponse:
    chunks: List[OwnerMessages] = []
    pos = 0
    while pos < len(data):
        num, wt, v, pos = _read_field(data, pos)
        if num == 1:
            if wt != 2:
                raise ValueError(f"owner messages field has wire type {wt}")
            chunks.append(decode_owner_messages(v))
    return ReplicaPullResponse(tuple(chunks))


# --- snapshot checkpoint & peer bootstrap messages (extension — no
# reference equivalent; see server/snapshot.py). Same
# hand-rolled proto3 subset, same ValueError-only decoder contract,
# same E2EE-blindness (the framed row stream carries exactly what the
# relay already stores: plaintext timestamps + ciphertext blobs). ---
#
#     SnapshotRequest      { replicaId=1 chunkBytes=2 owners=3 (repeated) }
#     SnapshotOwner        { userId=1 rootHash=2 treeCrc=3 }
#     SnapshotManifest     { snapshotId=1 chunkSizes=2 (repeated)
#                            chunkCrcs=3 (repeated)
#                            owners=4 (repeated SnapshotOwner)
#                            messageCount=5 totalBytes=6 }
#     SnapshotChunkRequest { snapshotId=1 index=2 replicaId=3 }
#     SnapshotChunk        { snapshotId=1 index=2 crc=3 payload=4 }


@dataclass(frozen=True)
class SnapshotRequest:
    """Asks a donor relay for a consistent snapshot manifest.
    `chunk_bytes` is the puller's preferred chunk size (0 = donor
    default; the donor clamps it under its body cap either way).
    `owners` (field 3, fleet extension): non-empty scopes the capture
    to exactly those owners — the O(moved-owners) transfer the fleet
    rebalance needs instead of a full-store ship. Empty = everything
    (the whole-store bootstrap, and what pre-fleet donors — whose
    decoders skip the unknown field — always serve; pullers keep a
    client-side record filter for exactly that downgrade).

    `watermark_millis` (field 4) + `tags` (field 5, partial-replication
    extension): a non-zero watermark / non-empty tag set
    scopes the capture to the matching slice — rows at or after the
    watermark minute whose lane is requested or unknown — and the
    manifest trees are recomputed from the SHIPPED rows, so the
    installer's byte-identity verify holds for the slice. A scoped
    snapshot bootstraps a thin client, never a full replica
    (docs/PARTIAL_SYNC.md). Pre-scope donors skip the unknown fields
    and ship everything: serving more is always sound."""

    replica_id: str
    chunk_bytes: int = 0
    owners: Tuple[str, ...] = ()
    watermark_millis: int = 0
    tags: Tuple[str, ...] = ()


@dataclass(frozen=True)
class SnapshotManifest:
    """The snapshot contract: chunk sizes + crc32s for resumable ranged
    fetches, and per-owner watermarks — the Merkle ROOT hash (JS signed
    int32) plus a crc32 of the owner's serialized tree text at capture
    time. After install the puller recomputes every owner's tree from
    the shipped rows and verifies byte-identity against the shipped
    tree text AND these digests; gossip then resumes from exactly this
    watermark (trees equal ⇒ the first summary exchange diffs only
    post-snapshot writes)."""

    snapshot_id: str
    chunk_sizes: Tuple[int, ...]
    chunk_crcs: Tuple[int, ...]
    owners: Tuple[Tuple[str, int, int], ...]  # (owner, root_hash, tree_crc)
    message_count: int
    total_bytes: int


@dataclass(frozen=True)
class SnapshotChunkRequest:
    snapshot_id: str
    index: int
    replica_id: str = ""


@dataclass(frozen=True)
class SnapshotChunk:
    snapshot_id: str
    index: int
    crc: int  # crc32 of payload — checked against the manifest too
    payload: bytes


def encode_snapshot_request(r: SnapshotRequest) -> bytes:
    out = _string(1, r.replica_id)
    if r.chunk_bytes:
        out += _tag(2, 0) + _varint(r.chunk_bytes)
    for uid in r.owners:
        out += _string(3, uid)
    if r.watermark_millis:
        out += _tag(4, 0) + _varint(r.watermark_millis)
    for t in r.tags:
        out += _string(5, t)
    return out


@_wire_decoder
def decode_snapshot_request(data: bytes) -> SnapshotRequest:
    replica_id, chunk_bytes, watermark = "", 0, 0
    owners: List[str] = []
    tags: List[str] = []
    pos = 0
    while pos < len(data):
        num, wt, v, pos = _read_field(data, pos)
        if num == 1:
            replica_id = v.decode("utf-8")
        elif num == 2:
            chunk_bytes = int(v)
        elif num == 3:
            if wt != 2:
                raise ValueError(f"owners field has wire type {wt}")
            owners.append(v.decode("utf-8"))
        elif num == 4:
            watermark = int(v)
            if watermark < 0:
                raise ValueError("snapshot watermark must be non-negative")
        elif num == 5:
            _decode_scope_tag(v, wt, tags, "tag")
    return SnapshotRequest(replica_id, chunk_bytes, tuple(owners),
                           watermark, tuple(tags))


def encode_snapshot_manifest(m: SnapshotManifest) -> bytes:
    out = _string(1, m.snapshot_id)
    out += b"".join(_tag(2, 0) + _varint(s) for s in m.chunk_sizes)
    out += b"".join(_tag(3, 0) + _varint(c) for c in m.chunk_crcs)
    for uid, root_hash, tree_crc in m.owners:
        inner = _string(1, uid) + _tag(2, 0) + _varint(root_hash)
        inner += _tag(3, 0) + _varint(tree_crc)
        out += _len_delimited(4, inner)
    out += _tag(5, 0) + _varint(m.message_count)
    out += _tag(6, 0) + _varint(m.total_bytes)
    return out


@_wire_decoder
def _decode_snapshot_owner(data: bytes) -> Tuple[str, int, int]:
    uid, root_hash, tree_crc = "", 0, 0
    pos = 0
    while pos < len(data):
        num, wt, v, pos = _read_field(data, pos)
        if num == 1:
            uid = v.decode("utf-8")
        elif num == 2:
            # Merkle root hashes are JS signed int32 (core/merkle.py);
            # negatives ride as 10-byte two's-complement varints like
            # the int32 value field — truncate identically on decode.
            root_hash = ((int(v) & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000
        elif num == 3:
            tree_crc = int(v) & 0xFFFFFFFF
    return uid, root_hash, tree_crc


@_wire_decoder
def decode_snapshot_manifest(data: bytes) -> SnapshotManifest:
    snapshot_id = ""
    chunk_sizes: List[int] = []
    chunk_crcs: List[int] = []
    owners: List[Tuple[str, int, int]] = []
    message_count = total_bytes = 0
    pos = 0
    while pos < len(data):
        num, wt, v, pos = _read_field(data, pos)
        if num == 1:
            snapshot_id = v.decode("utf-8")
        elif num == 2:
            chunk_sizes.append(int(v))
        elif num == 3:
            chunk_crcs.append(int(v) & 0xFFFFFFFF)
        elif num == 4:
            if wt != 2:
                raise ValueError(f"snapshot owner field has wire type {wt}")
            owners.append(_decode_snapshot_owner(v))
        elif num == 5:
            message_count = int(v)
        elif num == 6:
            total_bytes = int(v)
    if len(chunk_sizes) != len(chunk_crcs):
        raise ValueError(
            f"snapshot manifest chunk sizes ({len(chunk_sizes)}) and crcs "
            f"({len(chunk_crcs)}) disagree"
        )
    return SnapshotManifest(
        snapshot_id, tuple(chunk_sizes), tuple(chunk_crcs), tuple(owners),
        message_count, total_bytes,
    )


def encode_snapshot_chunk_request(r: SnapshotChunkRequest) -> bytes:
    return (
        _string(1, r.snapshot_id)
        + _tag(2, 0) + _varint(r.index)
        + _string(3, r.replica_id)
    )


@_wire_decoder
def decode_snapshot_chunk_request(data: bytes) -> SnapshotChunkRequest:
    snapshot_id = replica_id = ""
    index = 0
    pos = 0
    while pos < len(data):
        num, wt, v, pos = _read_field(data, pos)
        if num == 1:
            snapshot_id = v.decode("utf-8")
        elif num == 2:
            index = int(v)
        elif num == 3:
            replica_id = v.decode("utf-8")
    return SnapshotChunkRequest(snapshot_id, index, replica_id)


def encode_snapshot_chunk(c: SnapshotChunk) -> bytes:
    return (
        _string(1, c.snapshot_id)
        + _tag(2, 0) + _varint(c.index)
        + _tag(3, 0) + _varint(c.crc)
        + _len_delimited(4, c.payload)
    )


@_wire_decoder
def decode_snapshot_chunk(data: bytes) -> SnapshotChunk:
    snapshot_id = ""
    index = crc = 0
    payload = b""
    pos = 0
    while pos < len(data):
        num, wt, v, pos = _read_field(data, pos)
        if num == 1:
            snapshot_id = v.decode("utf-8")
        elif num == 2:
            index = int(v)
        elif num == 3:
            crc = int(v) & 0xFFFFFFFF
        elif num == 4:
            if wt != 2:
                # A varint here would make bytes(v) ALLOCATE v zero
                # bytes — same remote memory-DoS shape as the content
                # field of EncryptedCrdtMessage.
                raise ValueError(f"payload field has wire type {wt}")
            payload = bytes(v)
    return SnapshotChunk(snapshot_id, index, crc, payload)


# --- fleet routing envelope (extension — no reference equivalent; see
# server/fleet.py). A relay in forward mode wraps a sync POST
# body it is not placed for and relays it to the authoritative peer's
# `POST /fleet/forward`; the response is the raw sync response bytes,
# relayed back verbatim. `hops` is the loop guard, enforced at both
# ends: forwarders send hops=1, the serving handler 400-rejects any
# other value AND never forwards again (ring disagreement during a
# config reload must degrade to local service + gossip heal, not a
# forward cycle).
# Same ValueError-only decoder contract; the payload stays E2EE-blind
# (it IS the client's encrypted SyncRequest, untouched). ---
#
#     FleetForward { payload=1 origin=2 hops=3 }


@dataclass(frozen=True)
class FleetForward:
    payload: bytes  # the original encoded SyncRequest body, verbatim
    origin: str  # forwarding relay's base URL (observability only)
    hops: int = 1


def encode_fleet_forward(f: FleetForward) -> bytes:
    return (
        _len_delimited(1, f.payload)
        + _string(2, f.origin)
        + _tag(3, 0) + _varint(f.hops)
    )


@_wire_decoder
def decode_fleet_forward(data: bytes) -> FleetForward:
    payload = b""
    origin = ""
    hops = 0
    pos = 0
    while pos < len(data):
        num, wt, v, pos = _read_field(data, pos)
        if num == 1:
            if wt != 2:
                # A varint here would make bytes(v) ALLOCATE v zero
                # bytes — same remote memory-DoS shape as the content
                # field of EncryptedCrdtMessage.
                raise ValueError(f"payload field has wire type {wt}")
            payload = bytes(v)
        elif num == 2:
            origin = v.decode("utf-8")
        elif num == 3:
            hops = int(v)
    return FleetForward(payload, origin, hops)
