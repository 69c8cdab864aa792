"""The yardstick's frozen arithmetic against its scalar forms and, as a
witness, against the program's own (the tests may import the program;
the yardstick never does)."""

import json

import numpy as np
import pytest

from portbench.reference import merkle, wire

GOLDEN = b"1970-01-01T00:00:00.000Z-0000-0000000000000000"


def _ordered(tree):
    out = {k: _ordered(tree[k]) for k in ("0", "1", "2") if k in tree}
    if "hash" in tree:
        out["hash"] = tree["hash"]
    return out


def _rows(n, seed=0):
    rng = np.random.default_rng(seed)
    millis = 1_700_000_000_000 + np.sort(rng.integers(0, 10**9, n))
    counter = rng.integers(0, 1 << 16, n)
    nodes = merkle.node_rows(f"{x:016x}" for x in rng.integers(0, 1 << 62, n).tolist())
    return millis, counter, nodes


def test_murmur3_golden_and_vectorised():
    assert merkle.murmur3_32(GOLDEN) == 4179357717
    millis, counter, nodes = _rows(300)
    ts = merkle.ts_rows(millis, counter, nodes)
    want = [merkle.murmur3_32(bytes(r)) for r in ts]
    assert merkle.murmur3_rows(ts).tolist() == want


def test_timestamp_rows_match_the_string_form():
    millis, counter, nodes = _rows(50, 1)
    ts = merkle.ts_rows(millis, counter, nodes)
    for r, m, c, n in zip(ts, millis.tolist(), counter.tolist(), nodes):
        assert bytes(r).decode() == merkle.ts_string(m, c, bytes(n).decode())


@pytest.mark.parametrize("n", [0, 1, 7, 300, 3000])
def test_level_built_tree_equals_path_inserts(n):
    millis, counter, nodes = _rows(n, 2)
    h = merkle.murmur3_rows(merkle.ts_rows(millis, counter, nodes)) if n else np.zeros(0, np.uint32)
    fast = merkle.tree_from_rows(millis, h)
    slow = merkle.apply_deltas({}, merkle.minute_deltas(millis, h))
    assert fast == slow
    assert merkle.tree_to_string(fast) == json.dumps(_ordered(fast), separators=(",", ":"))


def test_frozen_merkle_matches_the_program():
    from evolu_tpu_torch.core import merkle as pm
    from evolu_tpu_torch.core.murmur import murmur3_32

    millis, counter, nodes = _rows(500, 3)
    ts = merkle.ts_rows(millis, counter, nodes)
    strings = [bytes(r).decode() for r in ts]
    assert merkle.murmur3_rows(ts).tolist() == [murmur3_32(s.encode()) for s in strings]
    deltas, _ = pm.minute_deltas_host(strings)
    tree = pm.apply_prefix_xors({}, deltas)
    mine = merkle.tree_from_rows(millis, merkle.murmur3_rows(ts))
    assert merkle.tree_to_string(mine) == pm.merkle_tree_to_string(tree)
    half = merkle.tree_from_rows(millis[:250], merkle.murmur3_rows(ts[:250]))
    assert merkle.diff(mine, half) == pm.diff_merkle_trees(tree, pm.apply_prefix_xors({}, pm.minute_deltas_host(strings[:250])[0]))


def test_wire_matches_the_program():
    from evolu_tpu_torch.sync import protocol

    millis, counter, nodes = _rows(20, 4)
    ts = merkle.ts_rows(millis, counter, nodes)
    contents = np.random.default_rng(5).integers(0, 256, (20, 116), dtype=np.uint8)
    body = wire.request(wire.messages_field(ts, contents), "owner0007", "00000000000a0001", '{"hash":1}')
    req = protocol.decode_sync_request(body)
    assert [m.timestamp for m in req.messages] == [bytes(r).decode() for r in ts]
    assert [m.content for m in req.messages] == [bytes(c) for c in contents]
    assert (req.user_id, req.node_id, req.merkle_tree) == ("owner0007", "00000000000a0001", '{"hash":1}')
    rows = [(m.timestamp, m.content) for m in req.messages]
    out = wire.response(wire.messages_field_rows(rows), '{"hash":2}')
    assert out == protocol.encode_sync_response(protocol.SyncResponse(req.messages, '{"hash":2}'))
    assert protocol.decode_sync_response(out).merkle_tree == '{"hash":2}'
    assert wire.count_messages(out) == 20 and wire.count_messages(body) == 20
