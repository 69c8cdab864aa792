"""Port parity: the packed receive on the client and the relay's packed
ingest.

Client: one command stream goes to the JAX `DbWorker` and to the
port's (`device="cpu"`), each on its package's C++ SQLite backend, and
every Receive carries the `PackedReceive` that each package's
`decrypt_response_columns` makes from one response the JAX package
encrypted. Cases: the winner cache on and off, a chunked receive, an
upper-case-hex batch and a typed-cell batch (both bounce to the object
path), and a malformed timestamp (the sequential fold's first-failure
error). Outputs, pushes, every table and the Merkle tree must be equal,
and the port's route counts must show the packed route and the bounces
where the reference takes them. The batches stay far below the JAX
planner's hot-owner size (2^18 rows).

Relay: `BatchReconciler` on a native `RelayStore` and on four native
shards (the port's `_ingest_packed`) against the JAX engine's packed
ingest on native stores, and against the port's per-request serve on a
Python store: the same response bytes and tables, pre-1970 rows
included. Every output is integer, bytes or SQLite text: exact."""

import jax
import numpy as np
import pytest

import evolu_tpu.runtime.messages as jmsg
import evolu_tpu.sync.protocol as jp
from evolu_tpu.core.merkle import apply_prefix_xors, merkle_tree_to_string, minute_deltas_host
from evolu_tpu.core.timestamp import Timestamp, timestamp_to_string
from evolu_tpu.core.types import CrdtMessage as JaxMessage
from evolu_tpu.core.types import TableDefinition as JaxTable
from evolu_tpu.parallel.mesh import create_mesh
from evolu_tpu.runtime.worker import DbWorker as JaxWorker
from evolu_tpu.server.engine import BatchReconciler as JaxReconciler
from evolu_tpu.server.relay import RelayStore as JaxStore
from evolu_tpu.server.relay import ShardedRelayStore as JaxSharded
from evolu_tpu.storage import native as jn
from evolu_tpu.sync import native_crypto as jnc
from evolu_tpu.utils.config import Config as JaxConfig

import evolu_tpu_torch.runtime.messages as pmsg
import evolu_tpu_torch.sync.protocol as pp
from evolu_tpu_torch.core.types import NewCrdtMessage, TableDefinition
from evolu_tpu_torch.runtime.worker import DbWorker
from evolu_tpu_torch.server import engine as pe
from evolu_tpu_torch.server.relay import RelayStore, ShardedRelayStore, serve_single_request
from evolu_tpu_torch.storage import apply as papply
from evolu_tpu_torch.storage import native as pn
from evolu_tpu_torch.sync import native_crypto as pnc
from evolu_tpu_torch.utils.config import Config

MN = "legal winner thank year wave sausage worth useful legal winner thank yellow"
NOW = 1_700_000_000_000
NODES = ("00000000000000a1", "00000000000000b2", "c3c3c3c3c3c3c3c3", "fedcba9876543210")
SCHEMA = {"todo": ("title", "isCompleted"), "todoCategory": ("name",)}


@pytest.fixture(autouse=True)
def same_node_id(monkeypatch):
    import evolu_tpu.core.timestamp
    import evolu_tpu_torch.core.timestamp

    for mod in (evolu_tpu.core.timestamp, evolu_tpu_torch.core.timestamp):
        monkeypatch.setattr(mod, "create_node_id", lambda: "0f1e2d3c4b5a6978")


def _remote(rng, n, n_rows=40, base=NOW - 600_000, span=500_000, schema=SCHEMA):
    """n remote messages as tuples: unique timestamps from four foreign
    nodes, contention over `n_rows` rows."""
    out, stamps = [], set()
    tables = list(schema)
    while len(out) < n:
        ts = timestamp_to_string(Timestamp(base + int(rng.integers(0, span)), int(rng.integers(0, 4)),
                                           NODES[int(rng.integers(0, 4))]))
        if ts in stamps:
            continue
        stamps.add(ts)
        table = tables[int(rng.integers(0, len(tables)))]
        col = schema[table][int(rng.integers(0, len(schema[table])))].split(":")[0]
        value = (None, "x", int(rng.integers(0, 100)), 2.5, "ü\x00")[int(rng.integers(0, 5))]
        out.append((ts, table, f"row{int(rng.integers(0, n_rows))}", col, value))
    return out


def _server_tree(tuples):
    deltas, _ = minute_deltas_host(t[0] for t in tuples)
    return merkle_tree_to_string(apply_prefix_xors({}, deltas))


class Side:
    """One package's worker on its native backend, recorded."""

    def __init__(self, port, config, schema=SCHEMA):
        self.port = port
        self.msg = pmsg if port else jmsg
        self.outputs, self.pushes = [], []
        ticks = iter(range(NOW, NOW + 10**9, 1000))
        self.db = (pn if port else jn).CppSqliteDatabase()
        kw = {"device": "cpu"} if port else {}
        self.worker = (DbWorker if port else JaxWorker)(
            self.db, config, on_output=self.outputs.append, post_sync=self.pushes.append,
            now=lambda: next(ticks), **kw)
        self.worker.start(MN)
        table = TableDefinition if port else JaxTable
        self.post("UpdateDbSchema", tuple(table.of(t, c) for t, c in schema.items()))

    def post(self, name, *args, **kw):
        self.worker.post(getattr(self.msg, name)(*args, **kw))

    def receive(self, body, previous_diff=None):
        packed, tree = (pnc if self.port else jnc).decrypt_response_columns(body, MN)
        self.post("Receive", packed, tree, previous_diff)


def _response(tuples, tree):
    enc = jnc.encrypt_batch([JaxMessage(*t) for t in tuples], MN)
    return jp.encode_sync_response(jp.SyncResponse(tuple(enc), tree))


def _norm_output(o):
    name = type(o).__name__
    if name == "OnInit":
        return (name, o.owner.id)
    if name == "OnQuery":
        return (name, o.queries_patches, o.on_complete_ids)
    if name == "OnError":
        return (name, type(o.error).__name__, str(o.error))
    return (name,)


def _norm_push(r):
    return ([(m.timestamp, m.table, m.row, m.column, m.value) for m in r.messages],
            r.clock_timestamp, r.merkle_tree, r.owner.id, r.previous_diff)


def _dump(db):
    names = [r[0] for r in db.exec("SELECT name FROM sqlite_schema WHERE type='table' ORDER BY name")]
    return {t: sorted(db.exec(f'SELECT * FROM "{t}"'), key=repr) for t in names}


def _finish(sides):
    out = []
    for s in sides:
        s.worker.flush()
        s.worker.stop()
        out.append(([_norm_output(o) for o in s.outputs], [_norm_push(r) for r in s.pushes], _dump(s.db)))
    return out


CONFIGS = {
    "winner cache": (dict(backend="tpu", hot_owner_min_batch=None), dict(backend="cuda")),
    "winner cache off": (dict(backend="tpu", hot_owner_min_batch=None, winner_cache=False),
                         dict(backend="cuda", winner_cache=False)),
    "chunked receive": (dict(backend="tpu", hot_owner_min_batch=None, receive_chunk_size=96),
                        dict(backend="cuda", receive_chunk_size=96)),
    "auto, small batches on the host": (dict(backend="auto", min_device_batch=200, hot_owner_min_batch=None),
                                        dict(backend="auto", min_device_batch=200)),
}


@pytest.mark.parametrize("case", list(CONFIGS))
def test_packed_receive_matches_jax(case):
    jkw, pkw = CONFIGS[case]
    sides = (Side(False, JaxConfig(**jkw)), Side(True, Config(**pkw)))
    rng = np.random.default_rng(sorted(CONFIGS).index(case))
    q_todo = jmsg.serialize_query('SELECT * FROM "todo" ORDER BY "id"')
    q_cat = jmsg.serialize_query('SELECT "id", "name" FROM "todoCategory" ORDER BY "id"')
    b1 = _remote(rng, 300)
    b2 = _remote(rng, 150) + b1[::3]  # new rows and re-deliveries
    upper = _remote(rng, 60)
    upper[7] = (upper[7][0][:30] + upper[7][0][30:].upper(),) + upper[7][1:]
    small = _remote(rng, 40)
    bad = _remote(rng, 30)
    bad[4] = (bad[4][0][:5] + "13" + bad[4][0][7:],) + bad[4][1:]  # month 13: the fold's first failure
    before = dict(papply.counts)
    for s in sides:
        s.post("Query", (q_todo, q_cat))
    bodies = [(_response(b1, _server_tree(b1)), None), (_response(b2, "{}"), None),
              (_response(upper, _server_tree(b1 + b2 + upper)), None),
              (_response(small, _server_tree(b1 + b2 + upper + small)), None),
              (_response(bad, "{}"), None)]
    for k, (body, diff) in enumerate(bodies):
        for s in sides:
            s.receive(body, diff)
            s.post("Query", (q_todo, q_cat))
            if k == 1:
                s.post("Send", (NewCrdtMessage("todo", "row1", "title", "local") if s.port else
                                jmsg.NewCrdtMessage("todo", "row1", "title", "local"),), (q_todo,))
    jax_side, port_side = _finish(sides)
    assert port_side[0] == jax_side[0]  # outputs, OnError included
    assert port_side[1] == jax_side[1]  # pushes
    assert port_side[2] == jax_side[2]  # every table, __clock included
    assert any(o[0] == "OnError" and o[1] == "TimestampParseError" for o in port_side[0])
    routes = {k: papply.counts[k] - before[k] for k in before}
    device = case != "auto, small batches on the host"
    chunks = 2 if case == "chunked receive" else 1
    # b1 and b2 go packed (in chunks where chunked); `upper` bounces on its
    # hex case; `small` goes packed on the device planners and bounces to
    # the host oracle under "auto"; the malformed batch never plans.
    assert routes["packed"] >= (2 * chunks + 1 if device else 2)
    assert routes["packed_bounces"] == (1 if device else 2) and routes["typed_bounces"] == 0


def test_typed_cells_bounce_before_any_side_effect():
    typed = {"board": ("title", "votes:counter", "tags:awset")}
    sides = (Side(False, JaxConfig(backend="tpu", hot_owner_min_batch=None), typed),
             Side(True, Config(backend="cuda"), typed))
    rng = np.random.default_rng(11)
    batch = []
    for t in _remote(rng, 200, schema={"board": ("title", "votes", "tags")}):
        ts, table, row, col, _v = t
        value = {"title": f"t{len(batch)}", "votes": int(rng.integers(-5, 6)),
                 "tags": '["a",' + ('"x"]' if rng.integers(0, 2) else '"y"]')}[col]
        batch.append((ts, table, row, col, value))
    lww = _remote(rng, 50, schema={"board": ("title",)})
    before = dict(papply.counts)
    for s in sides:
        s.receive(_response(batch, "{}"))
        s.receive(_response(lww, _server_tree(batch + lww)))
    jax_side, port_side = _finish(sides)
    assert port_side == jax_side
    routes = {k: papply.counts[k] - before[k] for k in before}
    # The typed batch bounces; the LWW-only batch after it goes packed.
    assert routes["typed_bounces"] == 1 and routes["packed_bounces"] == 1 and routes["packed"] == 1
    assert port_side[2]["__crdt_counter"] and port_side[2]["__crdt_set"]  # the typed folds ran


# --- the relay's packed ingest ---


def _owner_rows(seed, owners=10, per_owner=120, span_ms=900_000, base=NOW):
    rng = np.random.default_rng(seed)
    out = {}
    for o in range(owners):
        nodes = [f"{int(x):016x}" for x in rng.integers(0, 2**63, 3)]
        stamps = set()
        while len(stamps) < int(rng.integers(1, per_owner)):
            stamps.add(timestamp_to_string(Timestamp(base + int(rng.integers(0, span_ms)),
                                                     int(rng.integers(0, 16)), nodes[int(rng.integers(0, 3))])))
        out[f"owner{o:03d}"] = [(t, bytes(rng.integers(0, 256, 20, dtype=np.uint8))) for t in sorted(stamps)]
    return out


def _requests(m, spec):
    return [m.SyncRequest(tuple(m.EncryptedCrdtMessage(t, c) for t, c in rows), o, node, tree)
            for o, rows, node, tree in spec]


def _store_dump(store):
    out = []
    for s in (store.shards if hasattr(store, "shards") else [store]):
        out.append(s.db.exec('SELECT "userId", "timestamp", "content" FROM "message" ORDER BY 1, 2'))
        out.append(s.db.exec('SELECT "userId", "merkleTree" FROM "merkleTree" ORDER BY 1'))
    return out


def _batches(seed, base=NOW):
    """A first delivery with in-batch duplicates and each owner's
    post-apply tree, a re-delivery (new rows, stored rows, stale trees,
    one owner twice, the owner's own node excluded), then cold syncs."""
    rng = np.random.default_rng(seed + 100)
    rows = _owner_rows(seed, base=base)
    owners = sorted(rows)
    b1, b2 = [], []
    for i, o in enumerate(owners):
        r = rows[o]
        cut = max(1, len(r) * 2 // 3)
        first, second = r[:cut], r[cut:]
        dup = [first[int(j)] for j in rng.integers(0, len(first), 3)]
        b1.append((o, first + dup, "f" * 16, _server_tree(first)))
        stored = [first[int(j)] for j in rng.integers(0, len(first), 5)]
        tree = _server_tree(first) if i % 2 == 0 else _server_tree(first + second)
        node = first[0][0][-16:] if i % 3 == 0 else "f" * 16
        b2.append((o, second + stored + second[:2], node, tree))
    b2.append((owners[1], rows[owners[1]][-1:], "e" * 16, "{}"))
    b3 = [(o, [], "e" * 16, "{}") for o in owners[:4]]
    return [b1, b2, b3]


def _pre1970_batches():
    """Rows before 1970 and after: the engine's u64 k1 packing, kept from
    the reference (its device deltas differ from the host fold)."""
    rows = [(timestamp_to_string(Timestamp(m, c, "00000000000000bb")), b"x%d" % i)
            for i, (m, c) in enumerate([(-1, 0), (-60_001, 3), (-86_400_000, 0), (NOW, 1)])]
    return [[("old", rows[:3], "f" * 16, "{}"), ("new", rows[3:], "f" * 16, "{}")]]


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("data", ["owners", "pre-1970"])
def test_packed_ingest_matches_jax(shards, data):
    def stores(m_store, m_sharded, backend):
        return m_store(backend=backend) if shards == 1 else m_sharded(shards=shards, backend=backend)

    port, jax_store = stores(RelayStore, ShardedRelayStore, "native"), stores(JaxStore, JaxSharded, "native")
    oracle = RelayStore(backend="python")
    engine = pe.BatchReconciler(port, device="cpu")
    jax_engine = JaxReconciler(jax_store, create_mesh(1))
    assert all(hasattr(s.db, "relay_insert_packed") for s in engine._shards()[0])
    batches = _batches(3) if data == "owners" else _pre1970_batches()
    before = dict(pe.counts)
    try:
        for spec in batches:
            got = engine.run_batch_wire(_requests(pp, spec))
            with jax.enable_x64(True):
                want = jax_engine.reconcile_wire(_requests(jp, spec))
            assert got == want
            d = _store_dump(port)
            assert d == _store_dump(jax_store)
            # The per-request serve on a Python store (the host fold): the
            # same tables, and the same bytes where no owner repeats in
            # the batch. Pre-1970 rows split the engine from the host
            # fold, as in the reference.
            served = [serve_single_request(oracle, r) for r in _requests(pp, spec)]
            union = [sorted(sum(d[k::2], [])) for k in (0, 1)]
            assert (union == _store_dump(oracle)) == (data == "owners")
            if data == "owners" and len({o for o, *_r in spec}) == len(spec):
                assert got == served
    finally:
        engine.close()
        jax_engine.close()
    dispatches = sum(pe.counts[k] - before[k] for k in ("delta", "full"))
    assert dispatches == (2 if data == "owners" else 1)  # one a batch with new rows
