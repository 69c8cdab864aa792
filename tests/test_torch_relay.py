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
    """Scoped requests, the write-behind mode and the pipelined streaming
    ingest are refused on a Python and on a native store, before any
    side effect."""
    (o, r), = _owner_rows(8, owners=1).items()
    plain = _requests(pp, [(o, r, "f" * 16, "{}")])[0]
    scoped = pp.SyncRequest(plain.messages, o, "f" * 16, "{}", (pp.CAP_SYNC_SCOPE,),
                            pp.ScopeClause(watermark_millis=BASE))
    for backend in ("python", "native"):
        store = RelayStore(backend=backend)
        engine = pe.BatchReconciler(store, device="cpu")
        for call in (lambda: engine.run_batch_wire([plain, scoped]), lambda: engine.reconcile([scoped]),
                     lambda: serve_single_request(store, scoped),
                     lambda: engine.start_batch([plain]), lambda: engine.finish_batch(None),
                     lambda: engine.reconcile_stream([[plain]]),
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
