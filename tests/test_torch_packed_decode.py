"""The relay front's packed decode of a sync POST (`sync.wire_scan`).

- Decode equivalence: over a corpus of bodies (canonical ones, and each
  way a body can leave the canonical shape), `decode_sync_post` gives the
  request `protocol.decode_sync_request` gives, or the same ValueError,
  and the expected route. The front's per-message walks (`_batchable`,
  `count_v2`, the push hub's author nodes) agree on the two forms.
- Engine equivalence (CPU device): `run_batch_wire` over the packed
  requests and over the same requests as objects gives byte-identical
  answers, identical `message` rows and `merkleTree` strings and the same
  conservation-ledger terminals: in-request duplicates, rows already
  stored, a mixed batch, two requests of one owner (the object loop), and
  a write-behind pass.
- Relay: a batching relay, a per-request relay and a relay whose scanner
  is unavailable (the object route alone) answer the same bytes over HTTP,
  a malformed body included, and `evolu_relay_decode_total{route}` counts
  each body's route.

Tolerance: exact."""

import urllib.error
import urllib.request

import pytest

from evolu_tpu_torch.core.timestamp import Timestamp, timestamp_to_string
from evolu_tpu_torch.obs import ledger, metrics
from evolu_tpu_torch.server import push, scheduler
from evolu_tpu_torch.server.engine import BatchReconciler
from evolu_tpu_torch.server.relay import RelayServer, RelayStore
from evolu_tpu_torch.storage.write_behind import WriteBehindQueue
from evolu_tpu_torch.sync import aead, protocol, wire_scan
from evolu_tpu_torch.sync.protocol import EncryptedCrdtMessage, ScopeClause, SyncRequest

BASE = 1_700_000_000_000
NODE = "0123456789abcdef"


def _ts(i: int, node: str = NODE) -> str:
    return timestamp_to_string(Timestamp(BASE + i * 997, i % 5, node))


def _msgs(n: int, start: int = 0, node: str = NODE, v2_every: int = 3):
    """n messages; every `v2_every`-th content carries the v2 record magic,
    the others vary in length (0 included) and hold NULs."""
    return tuple(
        EncryptedCrdtMessage(_ts(start + i, node),
                             aead.MAGIC + b"r%d" % i if i % v2_every == 0 else b"\x00ct" * (i % 4))
        for i in range(n))


def _body(msgs, user="owner-1", node=NODE, tree="{}", caps=(), scope=None) -> bytes:
    return protocol.encode_sync_request(SyncRequest(tuple(msgs), user, node, tree, caps, scope))


def _entry(inner: bytes) -> bytes:
    return protocol._len_delimited(1, inner)


def _tail(user="owner-1") -> bytes:
    return protocol._string(2, user) + protocol._string(3, NODE) + protocol._string(4, "{}")


def _ts_field(raw: bytes) -> bytes:
    return protocol._len_delimited(1, raw)


TS0 = _ts(0).encode()
CONTENT = protocol._len_delimited(2, b"ct")

# (name, body, route): each way off the canonical shape takes the object route.
CORPUS = [
    ("canonical_0", _body(()), "packed"),
    ("canonical_1", _body(_msgs(1)), "packed"),
    ("canonical_4096", _body(_msgs(4096)), "packed"),
    ("in_request_duplicates", _body(_msgs(5) + _msgs(3) + _msgs(2, start=1)), "packed"),
    ("unordered_distinct", _body(tuple(reversed(_msgs(9)))), "packed"),
    ("capabilities", _body(_msgs(3), caps=(protocol.CAP_AEAD_BATCH, "x-unknown")), "packed"),
    ("sixty_four_capabilities", _body(_msgs(2), caps=tuple(f"c{i}" for i in range(64))), "packed"),
    ("repeated_user_id", _body(_msgs(2)) + protocol._string(2, "owner-2"), "packed"),
    ("fields_before_messages", _tail() + b"".join(_entry(protocol.encode_encrypted_message(m))
                                                  for m in _msgs(3)), "packed"),
    ("timestamp_45", _body([EncryptedCrdtMessage(_ts(0)[:45], b"ct")]), "object"),
    ("timestamp_47", _body([EncryptedCrdtMessage(_ts(0) + "0", b"ct")]), "object"),
    ("timestamp_non_ascii", _body([EncryptedCrdtMessage(_ts(0)[:44] + "é", b"ct")]), "object"),
    ("timestamp_invalid_utf8", _entry(_ts_field(TS0[:45] + b"\xff") + CONTENT) + _tail(), "object"),
    ("content_wire_type_0", _entry(_ts_field(TS0) + protocol._tag(2, 0) + protocol._varint(7)) + _tail(),
     "object"),
    ("content_before_timestamp", _entry(CONTENT + _ts_field(TS0)) + _tail(), "object"),
    ("repeated_timestamp_field", _entry(_ts_field(TS0) + _ts_field(TS0) + CONTENT) + _tail(), "object"),
    ("unknown_message_field", _entry(_ts_field(TS0) + CONTENT + protocol._string(3, "x")) + _tail(), "object"),
    ("message_without_content", _entry(_ts_field(TS0)) + _tail(), "object"),
    ("unknown_request_field", _body(_msgs(2)) + protocol._string(9, "x"), "object"),
    ("message_field_wire_type_0", protocol._tag(1, 0) + protocol._varint(5) + _tail(), "object"),
    ("long_varint", _entry(_ts_field(TS0) + protocol._tag(2, 2) + b"\x82\x80\x80\x80\x80\x00ct") + _tail(),
     "object"),
    ("truncated", _body(_msgs(3))[:100], "object"),
    ("user_id_invalid_utf8", _body(_msgs(1)) + protocol._len_delimited(2, b"\xc3"), "object"),
    ("sixty_five_capabilities", _body(_msgs(1), caps=tuple(f"c{i}" for i in range(65))), "object"),
    ("scope", _body(_msgs(2), scope=ScopeClause(5, ("a",), ("a", "b"))), "object"),
    ("scope_push_tags_mismatch", _body(_msgs(2), scope=ScopeClause(0, (), ("a",))), "object"),
]


@pytest.mark.parametrize("name,body,route", CORPUS, ids=[c[0] for c in CORPUS])
def test_decode_post_equals_the_object_decoder(name, body, route):
    assert wire_scan.load_library() is not None
    try:
        want = protocol.decode_sync_request(body)
    except ValueError as e:
        with pytest.raises(ValueError) as got_err:
            wire_scan.decode_sync_post(body)
        assert type(got_err.value) is type(e) and str(got_err.value) == str(e)
        assert route == "object"
        return
    got, got_route = wire_scan.decode_sync_post(body)
    assert got_route == route
    assert got == want and hash(got) == hash(want)
    assert len(got.messages) == len(want.messages)
    assert tuple(got.messages) == want.messages and got.messages == want.messages
    assert (got.user_id, got.node_id, got.merkle_tree, got.capabilities, got.scope) == \
        (want.user_id, want.node_id, want.merkle_tree, want.capabilities, want.scope)
    if route == "packed" and want.messages:
        packed = got.messages
        assert isinstance(packed, wire_scan.PackedMessages)
        assert [packed[i] for i in range(-len(packed), len(packed))] == list(want.messages) * 2
        assert packed[1:4] == want.messages[1:4]
        assert packed.distinct == (len({m.timestamp for m in want.messages}) == len(want.messages))
        assert scheduler._batchable(got) == scheduler._batchable(want)
        assert aead.count_v2(packed) == aead.count_v2(want.messages)
        assert push._author_nodes(packed) == push._author_nodes([m.timestamp for m in want.messages])


def test_without_the_scanner_every_body_takes_the_object_route(monkeypatch):
    monkeypatch.setattr(wire_scan, "load_library", lambda: None)
    body = _body(_msgs(4))
    got, route = wire_scan.decode_sync_post(body)
    assert route == "object" and isinstance(got.messages, tuple)
    assert got == protocol.decode_sync_request(body)


# -- the engine on packed and on object requests --


def _packed(request: SyncRequest) -> SyncRequest:
    got, route = wire_scan.decode_sync_post(protocol.encode_sync_request(request))
    assert route == "packed"
    return got


def _dump(store):
    rows = sorted((r["userId"], r["timestamp"], r["content"])
                  for r in store.db.exec_sql_query('SELECT "timestamp", "userId", "content" FROM "message"'))
    trees = sorted((r["userId"], r["merkleTree"])
                   for r in store.db.exec_sql_query('SELECT "userId", "merkleTree" FROM "merkleTree"'))
    return rows, trees


def _preload(store):
    """Stored history: owner-1's first 4 rows and owner-3's first 2."""
    store.add_messages("owner-1", _msgs(4))
    store.add_messages("owner-3", _msgs(2, node="fedcba9876543210"))


def _batches(case):
    """Request batches (objects), each one engine pass. In the packed run
    every request goes through the front's decoder, but the mixed batch's
    last, which stays an object as a non-canonical body would."""
    o3 = "fedcba9876543210"
    if case == "distinct_owners":
        return [[SyncRequest(_msgs(10) + _msgs(3, start=2), "owner-1", NODE, "{}"),  # stored rows + dups
                 SyncRequest(_msgs(7, start=100), "owner-2", NODE, "{}"),
                 SyncRequest(_msgs(5, node=o3), "owner-3", o3, "{}"),
                 SyncRequest((), "owner-4", NODE, "{}")]]  # a pull
    if case == "two_requests_of_one_owner":
        return [[SyncRequest(_msgs(6), "owner-1", NODE, "{}"),
                 SyncRequest(_msgs(6, start=3) + _msgs(2), "owner-1", NODE, "{}"),
                 SyncRequest(_msgs(3, start=50), "owner-2", NODE, "{}")]]
    if case == "mixed_routes":
        return [[SyncRequest(_msgs(8, start=2) + _msgs(2, start=3), "owner-1", NODE, "{}"),
                 SyncRequest(_msgs(4, start=20) + _msgs(1, start=20), "owner-2", NODE, "{}")]]
    raise AssertionError(case)


def _run(store, case, packed, write_behind=False):
    ledger.reset()
    wb = WriteBehindQueue(store) if write_behind else None
    eng = BatchReconciler(store, device="cpu", write_behind=wb)
    answers = []
    try:
        for batch in _batches(case):
            reqs = [_packed(r) for r in batch] if packed else batch
            if packed and case == "mixed_routes":
                reqs[-1] = batch[-1]
            answers.append(eng.run_batch_wire(reqs))
        if wb is not None:
            wb.flush()
    finally:
        if wb is not None:
            wb.close()
        eng.close()
    return answers, _dump(store), ledger.totals(), ledger.snapshot()["owners"]


@pytest.mark.parametrize("case,write_behind", [("distinct_owners", False), ("two_requests_of_one_owner", False),
                                               ("mixed_routes", False), ("distinct_owners", True)])
def test_engine_pass_equal_on_packed_and_object_requests(case, write_behind):
    got_store, want_store = RelayStore(backend="native"), RelayStore(backend="native")
    try:
        for s in (got_store, want_store):
            _preload(s)
        got = _run(got_store, case, packed=True, write_behind=write_behind)
        want = _run(want_store, case, packed=False, write_behind=write_behind)
    finally:
        got_store.close()
        want_store.close()
    assert got[0] == want[0]  # the answers' bytes
    assert got[1] == want[1]  # rows and trees
    assert got[2] == want[2] and got[3] == want[3]  # ledger terminals, per owner too
    assert got[2].get(ledger.STORE_DUPLICATE, 0) > 0 and got[2].get(ledger.STORE_INSERTED, 0) > 0


# -- the relay over HTTP --


def _post(url: str, body: bytes):
    req = urllib.request.Request(url + "/", data=body, method="POST",
                                 headers={"Content-Type": "application/octet-stream"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


RELAY_BODIES = [
    _body(_msgs(40), user="relay-a"),
    _body(_msgs(40, start=20) + _msgs(3, start=25), user="relay-b"),  # in-request duplicates
    _body(_msgs(12, start=5), user="relay-a"),  # rows the first push stored
    _body((), user="relay-a"),  # a pull
    _body(_msgs(6, start=300), user="relay-c") + protocol._string(9, "x"),  # not canonical
    _body(_msgs(3), user="relay-d")[:90],  # malformed: truncated
]
ROUTES = ["packed", "packed", "packed", "packed", "object", None]


def _drive(monkeypatch, batching: bool, scanner: bool):
    with monkeypatch.context() as m:
        if not scanner:
            m.setattr(wire_scan, "load_library", lambda: None)
        metrics.reset()
        server = RelayServer(RelayStore(backend="native"), batching=batching, device="cpu").start()
        try:
            out = [_post(server.url, b) for b in RELAY_BODIES]
        finally:
            server.stop()
        counts = {r: metrics.get_counter("evolu_relay_decode_total", route=r) for r in ("packed", "object")}
    return out, counts


def test_relays_answer_the_same_bytes_on_both_routes(monkeypatch):
    batched, batched_counts = _drive(monkeypatch, batching=True, scanner=True)
    single, single_counts = _drive(monkeypatch, batching=False, scanner=True)
    today, today_counts = _drive(monkeypatch, batching=False, scanner=False)
    assert batched == single == today
    assert [code for code, _ in today] == [200] * 5 + [500]
    want = {"packed": ROUTES.count("packed"), "object": ROUTES.count("object")}
    assert batched_counts == single_counts == want
    assert today_counts == {"packed": 0, "object": len(RELAY_BODIES) - 1}
