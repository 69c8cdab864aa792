"""Port parity: the relay store and the batched sync pass.

The JAX side is `BatchReconciler(RelayStore(backend="python"),
create_mesh(1))`, which takes the same generic ingest as the port (temp
table set-diff, one device Merkle pass, bulk insert) and the same
object-path respond. Responses must be byte-identical and the `message`
and `merkleTree` tables equal, row for row."""

import numpy as np
import pytest

import evolu_tpu.sync.protocol as jp
import evolu_tpu_torch.sync.protocol as pp
from evolu_tpu.core.merkle import apply_prefix_xors, merkle_tree_to_string, minute_deltas_host
from evolu_tpu.core.timestamp import Timestamp, timestamp_to_string
from evolu_tpu.parallel.mesh import create_mesh
from evolu_tpu.server.engine import BatchReconciler as JaxReconciler
from evolu_tpu.server.relay import RelayStore as JaxStore
from evolu_tpu.server.relay import ShardedRelayStore as JaxSharded
from evolu_tpu.server.relay import serve_single_request as jax_serve
from evolu_tpu_torch.core.types import NonCanonicalStoreError
from evolu_tpu_torch.server import engine as pe
from evolu_tpu_torch.server.relay import RelayStore, ShardedRelayStore, serve_single_request
from evolu_tpu_torch.storage.sqlite import configure_shared_file_db

BASE = 1_700_000_000_000


def _owner_rows(seed, owners=12, per_owner=150, span_ms=900_000):
    """{owner: [(timestamp, content)]}: several nodes an owner, stamps
    unique per owner."""
    rng = np.random.default_rng(seed)
    out = {}
    for o in range(owners):
        nodes = [f"{int(x):016x}" for x in rng.integers(0, 2**63, 3)]
        stamps = set()
        while len(stamps) < int(rng.integers(1, per_owner)):
            stamps.add(timestamp_to_string(Timestamp(
                BASE + int(rng.integers(0, span_ms)), int(rng.integers(0, 16)),
                nodes[int(rng.integers(0, 3))])))
        out[f"owner{o:03d}"] = [(t, bytes(rng.integers(0, 256, 20, dtype=np.uint8))) for t in sorted(stamps)]
    return out


def _tree_of(rows):
    deltas, _ = minute_deltas_host(t for t, _ in rows)
    return merkle_tree_to_string(apply_prefix_xors({}, deltas))


def _requests(m, spec):
    """`spec`: [(owner, [(timestamp, content)], node_id, tree)] → requests of
    package `m`."""
    return [m.SyncRequest(tuple(m.EncryptedCrdtMessage(t, c) for t, c in rows), o, node, tree)
            for o, rows, node, tree in spec]


def _dump(store):
    stores = store.shards if hasattr(store, "shards") else [store]
    out = []
    for s in stores:
        out.append(s.db.exec('SELECT "userId", "timestamp", "content" FROM "message" ORDER BY 1, 2'))
        out.append(s.db.exec('SELECT "userId", "merkleTree" FROM "merkleTree" ORDER BY 1'))
    return out


def _batches(seed):
    """Three batches over one store: a first delivery (each owner with its
    post-apply tree, duplicates inside a request), a re-delivery (new
    rows, rows already stored, some owners with a stale tree, one owner
    with two requests), then cold syncs with empty trees."""
    rng = np.random.default_rng(seed + 100)
    rows = _owner_rows(seed)
    owners = sorted(rows)
    first, second = {}, {}
    for o in owners:
        r = rows[o]
        cut = max(1, len(r) * 2 // 3)
        first[o], second[o] = r[:cut], r[cut:]
    b1 = []
    for o in owners:
        dup = [first[o][int(i)] for i in rng.integers(0, len(first[o]), 3)]
        b1.append((o, first[o] + dup, "f" * 16, _tree_of(first[o])))
    b2 = []
    for i, o in enumerate(owners):
        stored = [first[o][int(j)] for j in rng.integers(0, len(first[o]), 5)]
        stale = i % 2 == 0
        tree = _tree_of(first[o]) if stale else _tree_of(first[o] + second[o])
        node = first[o][0][0][-16:] if i % 3 == 0 else "f" * 16  # the owner's own node excluded
        b2.append((o, second[o] + stored + second[o][:2], node, tree))
    b2.append((owners[1], second[owners[1]][:1], "e" * 16, "{}"))  # a second request of one owner
    b3 = [(o, [], "e" * 16, "{}") for o in owners[:4]]
    return [b1, b2, b3]


@pytest.mark.parametrize("entry", ["run_batch_wire", "reconcile"])
def test_batched_pass_matches_jax(entry):
    jax_store, store = JaxStore(backend="python"), RelayStore(backend="python")
    jax_engine = JaxReconciler(jax_store, create_mesh(1))
    engine = pe.BatchReconciler(store, device="cpu")
    before = dict(pe.counts)
    for spec in _batches(3):
        want = getattr(jax_engine, entry)(_requests(jp, spec))
        got = getattr(engine, entry)(_requests(pp, spec))
        if entry == "reconcile":
            want = [jp.encode_sync_response(r) for r in want]
            got = [pp.encode_sync_response(r) for r in got]
        assert got == want
        assert _dump(store) == _dump(jax_store)
    assert any(pp.decode_sync_response(b).messages for b in got)  # cold syncs carry history
    assert pe.counts["delta"] - before["delta"] == 2  # two batches with new rows


def test_batched_pass_matches_the_per_request_serve():
    """The batch against `serve_single_request` request by request on a
    second port store: same bytes and tables where no owner repeats."""
    store, oracle = RelayStore(backend="python"), RelayStore(backend="python")
    engine = pe.BatchReconciler(store, device="cpu")
    for spec in _batches(4):
        spec = list({o: (o, r, n, t) for o, r, n, t in spec}.values())  # one request an owner
        reqs = _requests(pp, spec)
        assert engine.run_batch_wire(reqs) == [serve_single_request(oracle, r) for r in reqs]
        assert _dump(store) == _dump(oracle)


def test_sharded_store_takes_the_per_request_route():
    jax_store, store = JaxSharded(shards=3, backend="python"), ShardedRelayStore(shards=3, backend="python")
    jax_engine = JaxReconciler(jax_store, create_mesh(1))
    engine = pe.BatchReconciler(store, device="cpu")
    before = dict(pe.counts)
    for spec in _batches(5):
        assert engine.run_batch_wire(_requests(pp, spec)) == jax_engine.run_batch_wire(_requests(jp, spec))
        assert _dump(store) == _dump(jax_store)
    assert pe.counts == before  # no device dispatch: add_messages hashes on the host
    assert [s["messages"] for s in store.stats()] == [s["messages"] for s in jax_store.stats()]


def test_store_surface_matches_jax():
    rows = _owner_rows(6, owners=5)
    jax_store, store = JaxStore(backend="python"), RelayStore(backend="python")
    for o, r in rows.items():
        req = (o, r[: len(r) // 2], "0" * 16, "{}")
        assert serve_single_request(store, _requests(pp, [req])[0]) == \
            jax_serve(jax_store, _requests(jp, [req])[0])
        pt = store.add_messages(o, _requests(pp, [(o, r, "", "")])[0].messages)
        jt = jax_store.add_messages(o, _requests(jp, [(o, r, "", "")])[0].messages)
        assert pt == jt
    assert sorted(store.owner_trees()) == sorted(jax_store.owner_trees())
    assert sorted(store.user_ids()) == sorted(jax_store.user_ids())
    assert store.stats() == jax_store.stats()
    o = sorted(rows)[2]
    since = rows[o][len(rows[o]) // 3][0]
    for limit in (None, 4):
        got = store.replica_messages(o, since, limit)
        want = jax_store.replica_messages(o, since, limit)
        assert [(m.timestamp, m.content) for m in got] == [(m.timestamp, m.content) for m in want]
    assert store.get_merkle_tree_string("nobody") == jax_store.get_merkle_tree_string("nobody") == "{}"


def test_shared_file_store_takes_the_write_lock_at_begin(tmp_path):
    store = RelayStore(str(tmp_path / "relay.db"), backend="python")
    assert store.db.exec("PRAGMA journal_mode") == [("wal",)]
    assert store.db._begin_sql == "BEGIN IMMEDIATE"
    memory = RelayStore(backend="python")
    configure_shared_file_db(memory.db)
    assert memory.db._begin_sql == "BEGIN"
    rows = _owner_rows(7, owners=1)
    (o, r), = rows.items()
    serve_single_request(store, _requests(pp, [(o, r, "f" * 16, "{}")])[0])
    again = RelayStore(str(tmp_path / "relay.db"), backend="python")
    assert _dump(again) == _dump(store)


def test_unported_routes_raise_before_any_side_effect():
    """Scoped requests (on every ingest route, the streaming one included)
    and the write-behind mode are refused on a Python and on a native
    store, before any side effect."""
    (o, r), = _owner_rows(8, owners=1).items()
    plain = _requests(pp, [(o, r, "f" * 16, "{}")])[0]
    scoped = pp.SyncRequest(plain.messages, o, "f" * 16, "{}", (pp.CAP_SYNC_SCOPE,),
                            pp.ScopeClause(watermark_millis=BASE))
    for backend in ("python", "native"):
        store = RelayStore(backend=backend)
        engine = pe.BatchReconciler(store, device="cpu")
        for call in (lambda: engine.run_batch_wire([plain, scoped]), lambda: engine.reconcile([scoped]),
                     lambda: serve_single_request(store, scoped),
                     lambda: engine.start_batch([plain, scoped]),
                     lambda: engine.reconcile_stream([[plain, scoped]]),
                     lambda: pe.BatchReconciler(store, device="cpu", write_behind=object())):
            with pytest.raises(NotImplementedError):
                call()
        assert _dump(store) == [[], []]


def test_entry_points_default_to_the_card():
    """Here there is no card: the defaults raise rather than fall back."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pe.BatchReconciler(RelayStore(backend="python"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pe.owner_minute_deltas({"a": [timestamp_to_string(Timestamp(BASE, 0, "a" * 16))]})


class _WireDb:
    """`PySqliteDatabase` plus a one-call messages stream, as a native
    database serves it: the route `sync_wire` and `_respond_wire` take
    where the database has one."""

    def __init__(self, db):
        self._db = db

    def __getattr__(self, name):
        return getattr(self._db, name)

    def fetch_relay_messages_wire(self, user_id, since, node_id):
        rows = self._db.exec_sql_query(
            'SELECT "timestamp", "content" FROM "message" WHERE "userId" = ? AND "timestamp" > ? '
            'AND "timestamp" NOT LIKE \'%\' || ? ORDER BY "timestamp"', (user_id, since, node_id))
        if any(len(r["timestamp"]) != 46 for r in rows):
            raise NonCanonicalStoreError("non-canonical stored timestamp")
        msgs = [pp.EncryptedCrdtMessage(r["timestamp"], r["content"]) for r in rows]
        return b"".join(pp._len_delimited(1, pp.encode_encrypted_message(m)) for m in msgs), len(msgs)


def test_wire_stream_route_matches_the_object_route():
    """A store whose database serves the messages stream in one call:
    `run_batch_wire` and `serve_single_request` take the stream route, and
    a malformed stored row sends its request back to the object path; the
    bytes equal those of plain stores."""
    wire, wire_oracle, plain = (RelayStore(backend="python") for _ in range(3))
    wire.db, wire_oracle.db = _WireDb(wire.db), _WireDb(wire_oracle.db)
    engine, plain_engine = pe.BatchReconciler(wire, device="cpu"), pe.BatchReconciler(plain, device="cpu")
    bad_owner = None
    for k, spec in enumerate(_batches(9)):
        if k == 2:  # before the cold syncs: one malformed row in each store
            bad_owner = spec[0][0]
            for s in (wire, wire_oracle, plain):
                s.db.run('INSERT INTO "message" VALUES (?, ?, ?)', ("2023-11-14T22:20:00.000Z-0000-ab", bad_owner, b"x"))
        reqs = _requests(pp, spec)
        got = engine.run_batch_wire(reqs)
        assert got == plain_engine.run_batch_wire(reqs)
        twice = owners_twice(spec)
        served = [serve_single_request(wire_oracle, r) for r in reqs]
        assert [s for r, s in zip(reqs, served) if r.user_id != twice] == [
            b for r, b in zip(reqs, got) if r.user_id != twice]
        assert _dump(wire_oracle) == _dump(wire) == _dump(plain)
    assert bad_owner is not None and any(b"-ab" in b for b in got)


def owners_twice(spec):
    """The owner with two requests in a batch, if any (a batch answers both
    after the whole batch, the per-request serve each after itself)."""
    seen = set()
    for o, *_ in spec:
        if o in seen:
            return o
        seen.add(o)
    return None


@pytest.mark.parametrize("pre1970", [False, True])
def test_merkle_minute_deltas_matches_jax(pre1970):
    """The masked per-minute fold of one owner's batch (the relay's scoped
    fold runs it): host columns in, the same deltas out."""
    import jax

    from evolu_tpu.ops.merkle_ops import merkle_minute_deltas as jax_fold
    from evolu_tpu.ops.merkle_ops import minute_deltas_to_dict as jax_to_dict
    from evolu_tpu_torch.ops.merkle_ops import merkle_minute_deltas, minute_deltas_to_dict

    rng = np.random.default_rng(10)
    n = 3000
    millis = BASE + rng.integers(0, 3_600_000, n)
    if pre1970:
        millis[::3] = -rng.integers(1, 10**10, len(millis[::3]))
    counter = rng.integers(0, 65536, n).astype(np.int32)
    node = rng.integers(0, 2**64, n, dtype=np.uint64)
    mask = rng.random(n) < 0.7
    with jax.enable_x64(True):
        want = jax_to_dict(*jax_fold(millis, counter, node, mask))
    got = minute_deltas_to_dict(*merkle_minute_deltas(millis, counter, node, mask, device="cpu"))
    assert got == want and len(got) > 10


# ---- the pipelined streaming ingest (start_batch / finish_batch) ----


def _xor_zero_stamps(minute_millis, node="0123456789abcdef"):
    """Four distinct timestamps in one minute whose hashes XOR to 0 (two
    pairs with equal XOR, found by a birthday search over counters)."""
    from evolu_tpu_torch.core.timestamp import timestamp_from_string, timestamp_to_hash

    stamps = [timestamp_to_string(Timestamp(minute_millis + i % 50_000, i // 50_000, node)) for i in range(1500)]
    h = np.array([timestamp_to_hash(timestamp_from_string(t)) & 0xFFFFFFFF for t in stamps], np.uint64)
    i, j = np.triu_indices(len(h), 1)
    x = h[i] ^ h[j]
    order = np.argsort(x, kind="stable")
    xs = x[order]
    for k in np.flatnonzero(xs[1:] == xs[:-1]):
        a, b = order[k], order[k + 1]
        quad = {int(i[a]), int(j[a]), int(i[b]), int(j[b])}
        if len(quad) == 4:
            return [stamps[q] for q in sorted(quad)]
    raise AssertionError("no zero-XOR quadruple")


def _stream_batches(seed):
    """`_batches` (in-batch duplicates, rows already stored, one owner
    twice in a batch, cold syncs), then a batch with a minute whose new
    hashes XOR to 0: for a new owner (the device deltas) and for an owner
    that re-sends stored rows beside them (the host recompute)."""
    batches = _batches(seed)
    owners = sorted(o for o, *_ in batches[0])
    zero = _xor_zero_stamps(BASE + 7_200_000 - (BASE % 60_000))
    stored = [(t, c) for t, c in _owner_rows(seed)[owners[0]][:2]]
    rows = [(t, bytes([k])) for k, t in enumerate(zero)]
    batches.append([("xz-new", rows, "f" * 16, "{}"), (owners[0], rows + stored, "f" * 16, "{}"),
                    ("xz-new", [], "e" * 16, "{}")])
    return batches


def _stores(shards, jax_side):
    if shards:
        return (JaxSharded(shards=shards, backend="native") if jax_side
                else ShardedRelayStore(shards=shards, backend="native"))
    return JaxStore(backend="native") if jax_side else RelayStore(backend="native")


@pytest.mark.parametrize("shards", [None, 3])
@pytest.mark.parametrize("entry", ["reconcile_stream", "run_batch_wire"])
def test_streaming_ingest_matches_jax_and_the_one_shot_ingest(entry, shards):
    """`reconcile_stream` and `run_batch_wire` (which take start_batch /
    finish_batch on native stores) against the JAX engine's on native and
    sharded native stores: the same bytes and tables after every batch,
    and the same as the port's one-shot `_ingest_packed` (`reconcile_wire`)."""
    batches = _stream_batches(11)
    jax_store, store, one_shot = _stores(shards, True), _stores(shards, False), _stores(shards, False)
    jax_engine = JaxReconciler(jax_store, create_mesh(1))
    engine, one_shot_engine = pe.BatchReconciler(store, device="cpu"), pe.BatchReconciler(one_shot, device="cpu")
    zero_key = None
    try:
        if entry == "reconcile_stream":
            want = jax_engine.reconcile_stream([_requests(jp, b) for b in batches])
            got = engine.reconcile_stream([_requests(pp, b) for b in batches])
            assert [[pp.encode_sync_response(r) for r in g] for g in got] == \
                [[jp.encode_sync_response(r) for r in w] for w in want]
            assert [[pp.encode_sync_response(r) for r in g] for g in got] == \
                [one_shot_engine.reconcile_wire(_requests(pp, b)) for b in batches]
            assert _dump(store) == _dump(jax_store) == _dump(one_shot)
        else:
            for b in batches:
                got = engine.run_batch_wire(_requests(pp, b))
                assert got == jax_engine.run_batch_wire(_requests(jp, b))
                assert got == one_shot_engine.reconcile_wire(_requests(pp, b))
                assert _dump(store) == _dump(jax_store) == _dump(one_shot)
        from evolu_tpu_torch.core.merkle import merkle_tree_from_string, minutes_base3

        tree = merkle_tree_from_string(store.get_merkle_tree_string("xz-new"))
        zero_key = minutes_base3(BASE + 7_200_000 - (BASE % 60_000))
        node = tree
        for ch in zero_key:
            node = node[ch]
        assert node["hash"] == 0  # the zero-XOR minute is present, its hash 0
    finally:
        engine.close(), one_shot_engine.close(), jax_engine.close()
    assert zero_key is not None


def test_streamed_duplicates_take_the_host_recompute():
    """An owner re-sending stored rows beside new ones in the streaming
    ingest gets its deltas from the host fold of its new rows; the bytes
    equal the one-shot ingest's."""
    calls = []
    orig = pe.minute_deltas_host
    store, one_shot = RelayStore(backend="native"), RelayStore(backend="native")
    engine, one = pe.BatchReconciler(store, device="cpu"), pe.BatchReconciler(one_shot, device="cpu")
    try:
        pe.minute_deltas_host = lambda stamps: calls.append(1) or orig(stamps)
        for b in _stream_batches(12):
            assert engine.run_batch_wire(_requests(pp, b)) == one.reconcile_wire(_requests(pp, b))
    finally:
        pe.minute_deltas_host = orig
        engine.close(), one.close()
    assert calls  # the second batch's re-sent rows
    assert _dump(store) == _dump(one_shot)


def test_reconcile_stream_bad_batch_lands_the_prior_batch_as_jax():
    """A malformed batch k+1 raising in start_batch does not drop batch k,
    already dispatched: the stream lands it (as sequential reconcile would
    before raising), and the engine keeps working: on the port as on JAX."""
    def run(m, store, engine):
        good = _requests(m, [("uA", _owner_rows(13, owners=1)["owner000"][:20], "f" * 16, "{}")])
        bad = [m.SyncRequest((m.EncryptedCrdtMessage("not-46-chars", b"c"),), "uB", "f" * 16, "{}")]
        with pytest.raises(ValueError):
            engine.reconcile_stream([good, bad])
        first = sum(s.db.exec('SELECT COUNT(*) FROM "message"')[0][0] for s in store.shards)
        engine.reconcile(_requests(m, [("uC", _owner_rows(14, owners=1)["owner000"][:5], "f" * 16, "{}")]))
        return first, _dump(store)

    jax_store, store = JaxSharded(shards=2, backend="native"), ShardedRelayStore(shards=2, backend="native")
    engine = pe.BatchReconciler(store, device="cpu")
    want = run(jp, jax_store, JaxReconciler(jax_store, create_mesh(1)))
    got = run(pp, store, engine)
    engine.close()
    assert got == want
    assert got[0] == min(20, len(_owner_rows(13, owners=1)["owner000"]))


def test_streaming_pull_waits_on_its_own_thread():
    """The pull of a streamed batch runs on the engine's pull thread, and
    `deltas_finish` takes its Future; `close` stops that thread."""
    import threading

    store = RelayStore(backend="native")
    engine = pe.BatchReconciler(store, device="cpu")
    names = []
    orig = pe._pull_outputs
    pe._pull_outputs = lambda *a: names.append(threading.current_thread().name) or orig(*a)
    try:
        st = engine.start_batch(_requests(pp, _batches(15)[0]))
        assert hasattr(st["dev"][3], "result")
        engine.finish_batch(st, wire=True)
    finally:
        pe._pull_outputs = orig
    assert names and names[0].startswith("evolu-pull")
    engine.close()
    assert engine._pull_pool is None
