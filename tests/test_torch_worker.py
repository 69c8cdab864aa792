"""Port parity: the client `DbWorker` against the JAX package's.

One scripted command stream goes to the JAX `DbWorker` and to the
port's (`device="cpu"`), for three backend pairs: the device planner on
every batch (JAX "tpu", port "cuda"), "auto" with a small
`min_device_batch`, and the host oracle ("cpu"). After the stream the
outputs (`OnError` by type and message), the `post_sync` pushes, every
table dump (`__clock` and `__owner` included) and the winner-cache slots
must be equal."""

import numpy as np
import pytest
from _torch_jax_state import jax_process_state  # noqa: F401  (the JAX package's native libraries and ledger)

import evolu_tpu.core.types as jt
import evolu_tpu.runtime.messages as jmsg
from evolu_tpu.core.merkle import diff_merkle_trees, insert_into_merkle_tree, merkle_tree_to_string
from evolu_tpu.core.timestamp import Timestamp, timestamp_from_string, timestamp_to_string
from evolu_tpu.runtime.worker import DbWorker as JaxWorker
from evolu_tpu.storage.clock import read_clock as jax_read_clock
from evolu_tpu.storage.sqlite import PySqliteDatabase as JaxDb
from evolu_tpu.utils.config import Config as JaxConfig

import evolu_tpu_torch.core.types as pt
import evolu_tpu_torch.runtime.messages as pmsg
from evolu_tpu_torch.runtime.worker import DbWorker
from evolu_tpu_torch.storage.sqlite import PySqliteDatabase
from evolu_tpu_torch.utils.config import Config

NOW = 1_700_000_000_000
MNEMONIC = "legal winner thank year wave sausage worth useful legal winner thank yellow"
MNEMONIC2 = "letter advice cage absurd amount doctor acoustic avoid letter advice cage above"
SCHEMA = {"todo": ("title", "isCompleted"), "todoCategory": ("name",)}
PAIRS = {
    "device planner always": (dict(backend="tpu", hot_owner_min_batch=None), dict(backend="cuda")),
    "auto": (dict(backend="auto", min_device_batch=32, hot_owner_min_batch=None),
             dict(backend="auto", min_device_batch=32)),
    "host oracle": (dict(backend="cpu"), dict(backend="cpu")),
}


@pytest.fixture(autouse=True)
def same_node_id(monkeypatch):
    import evolu_tpu.core.timestamp
    import evolu_tpu_torch.core.timestamp

    for mod in (evolu_tpu.core.timestamp, evolu_tpu_torch.core.timestamp):
        monkeypatch.setattr(mod, "create_node_id", lambda: "0f1e2d3c4b5a6978")


def _remote(rng, n, n_rows=12, base=NOW - 600_000, span=500_000):
    """n remote messages as tuples: unique timestamps from four foreign
    nodes, cell contention over `n_rows` rows."""
    out, stamps = [], set()
    nodes = ["00000000000000a1", "00000000000000b2", "c3c3c3c3c3c3c3c3", "fedcba9876543210"]
    while len(out) < n:
        ts = timestamp_to_string(Timestamp(base + int(rng.integers(0, span)), int(rng.integers(0, 4)),
                                           nodes[int(rng.integers(0, 4))]))
        if ts in stamps:
            continue
        stamps.add(ts)
        table = ("todo", "todoCategory")[int(rng.integers(0, 2))]
        col = SCHEMA[table][int(rng.integers(0, len(SCHEMA[table])))]
        value = (None, "x", int(rng.integers(0, 100)), 2.5)[int(rng.integers(0, 4))]
        out.append((ts, table, f"row{int(rng.integers(0, n_rows))}", col, value))
    return out


class Side:
    """One package's worker with its recorded outputs and pushes."""

    def __init__(self, worker_cls, db_cls, config, msgs, types, **kw):
        self.msg, self.types = msgs, types
        self.outputs, self.pushes = [], []
        ticks = iter(range(NOW, NOW + 10**9, 1000))
        self.db = db_cls()
        self.worker = worker_cls(self.db, config, on_output=self.outputs.append,
                                 post_sync=self.pushes.append, now=lambda: next(ticks), **kw)

    def post(self, name, *args, **kw):
        self.worker.post(getattr(self.msg, name)(*args, **kw))

    def messages(self, tuples):
        return tuple(self.types.CrdtMessage(*t) for t in tuples)

    def new_messages(self, tuples):
        return tuple(self.types.NewCrdtMessage(*t) for t in tuples)

    def tables(self, names):
        return tuple(self.types.TableDefinition.of(t, c) for t, c in names.items())


def _norm_output(o):
    name = type(o).__name__
    if name == "OnInit":
        return (name, o.owner.id, o.owner.mnemonic)
    if name == "OnQuery":
        return (name, o.queries_patches, o.on_complete_ids)
    if name == "OnError":
        return (name, type(o.error).__name__, str(o.error))
    return (name,)


def _norm_push(r):
    return ([(m.timestamp, m.table, m.row, m.column, m.value) for m in r.messages],
            r.clock_timestamp, r.merkle_tree, r.owner.id, r.owner.mnemonic, r.previous_diff)


def _dump(db):
    names = [r[0] for r in db.exec("SELECT name FROM sqlite_schema WHERE type='table' ORDER BY name")]
    return {t: db.exec(f'SELECT * FROM "{t}" ORDER BY 1, 2') for t in names}


def _livelock_tree(db, tuples):
    """A server tree = this client's tree after `tuples` + one phantom
    hash it never receives, and the diff that tree gives: a Receive of
    `tuples` with that diff as previous_diff raises the livelock
    SyncError after its apply."""
    local = jax_read_clock(db).merkle_tree
    for t in tuples:
        local = insert_into_merkle_tree(timestamp_from_string(t[0]), local)
    server = insert_into_merkle_tree(Timestamp(NOW + 10**9, 0, "8" * 16), local)
    return merkle_tree_to_string(server), diff_merkle_trees(server, local)


def _script(jax, port):
    """The command stream, posted to both sides in step."""
    rng = np.random.default_rng(5)
    sides = (jax, port)
    q_todo = jmsg.serialize_query('SELECT * FROM "todo" ORDER BY "id"')
    q_cat = jmsg.serialize_query('SELECT "id", "name" FROM "todoCategory" ORDER BY "id"')
    q_row = jmsg.serialize_query('SELECT * FROM "todo" WHERE "id" = ?', ["row3"])
    queries = (q_todo, q_cat, q_row)

    def both(name, *args, **kw):
        for s in sides:
            s.post(name, *args, **kw)

    def receive(tuples, tree="{}", prev=None):
        for s in sides:
            s.post("Receive", s.messages(tuples), tree, prev)

    def send(tuples, ids=()):
        for s in sides:
            s.post("Send", s.new_messages(tuples), ids, queries)

    for s in sides:
        s.post("UpdateDbSchema", s.tables(SCHEMA))
    send([("todo", "row1", "title", "local one"), ("todo", "row3", "isCompleted", 1)], ("c1",))
    receive(_remote(rng, 20))                  # below min_device_batch
    both("Query", queries)
    receive(_remote(rng, 45))                  # above it, one chunk
    both("Query", queries)
    chunked = _remote(rng, 180, n_rows=30)     # chunk size 50, cells across chunks
    receive(chunked)
    receive(chunked[::4])                      # re-delivery
    both("Query", queries)
    send([("todoCategory", "cat1", "name", "work"), ("todo", "row3", "title", "mine")])
    for s in sides:
        s.worker.flush()
    fresh = [(t, "todo", f"fresh{i}", "title", f"f{i}")
             for i, t in enumerate(timestamp_to_string(Timestamp(NOW + 5000 + i, 0, "00000000000000b2"))
                                   for i in range(8))]
    tree, prev = _livelock_tree(jax.db, fresh)
    receive(fresh, tree, prev)                 # applies, then SyncError: rolled back
    receive(fresh, tree, None)                 # applies; the server tree differs: a push
    both("Query", queries)
    both("EvictQueries", (q_cat,))
    both("Sync", (q_todo, q_cat))
    send([("todo", "row9", "title", b"bytes")])  # not wire-encodable: OnError, rolled back
    send([("todo", f"row{i}", "isCompleted", i) for i in range(40)])
    for k in range(4):                         # a steady population: the gate goes back to cached
        receive(_remote(rng, 40, n_rows=4, base=NOW + 10_000 * (k + 1), span=9000))
    both("ResetOwner")
    both("RestoreOwner", MNEMONIC2)
    for s in sides:
        s.post("UpdateDbSchema", s.tables(SCHEMA))
    receive(_remote(rng, 60, base=NOW - 1000, span=900))
    both("Query", queries)


@pytest.mark.parametrize("pair", list(PAIRS))
def test_worker_matches_jax(pair):
    jcfg, pcfg = PAIRS[pair]
    jax = Side(JaxWorker, JaxDb, JaxConfig(receive_chunk_size=50, **jcfg), jmsg, jt)
    port = Side(DbWorker, PySqliteDatabase, Config(receive_chunk_size=50, **pcfg), pmsg, pt,
                device="cpu")
    try:
        for s in (jax, port):
            s.worker.start(MNEMONIC)
        _script(jax, port)
        for s in (jax, port):
            s.worker.flush()
        got, want = [_norm_output(o) for o in port.outputs], [_norm_output(o) for o in jax.outputs]
        assert got == want
        kinds = {o[0] for o in got} | {o[1] for o in got if o[0] == "OnError"}
        assert {"OnInit", "OnQuery", "OnReceive", "ReloadAllTabs", "SyncError", "TypeError"} <= kinds
        assert [_norm_push(r) for r in port.pushes] == [_norm_push(r) for r in jax.pushes]
        assert any(r.previous_diff is not None for r in port.pushes)
        assert _dump(port.db) == _dump(jax.db)
        pc, jc = (getattr(s.worker._planner, "cache", None) for s in (port, jax))
        assert (pc is None) == (jc is None) == (pcfg["backend"] == "cpu")
        if pc is not None:
            assert pc._slots == jc._slots and pc._free == jc._free
            pw1, pw2 = pc.slot_values()
            assert np.array_equal(pw1, np.asarray(jc._w1)) and np.array_equal(pw2, np.asarray(jc._w2))
            assert port.worker.verify_winner_cache() == jax.worker.verify_winner_cache()
            # The stream took the cached route (slots gathered and
            # scattered) and the streamed one, and reset the cache.
            assert pc.counts["hits"] and pc.counts["streamed_cells"] and pc.counts["resets"], pc.counts
    finally:
        for s in (jax, port):
            s.worker.stop()


TYPED_PAIRS = {
    "device planner": (dict(backend="tpu", hot_owner_min_batch=None), dict(backend="cuda")),
    "host oracle": (dict(backend="cpu"), dict(backend="cpu")),
}


@pytest.mark.parametrize("fold_min", [4096, 1])
@pytest.mark.parametrize("pair", list(TYPED_PAIRS))
def test_typed_worker_matches_jax(pair, fold_min, monkeypatch):
    """The DbWorker on a typed schema (counter, AW-set, RGA list, tensor
    sum, mean and max, LWW title; malformed ops among them): Receives
    chunked by 64 with a re-delivery last, then a Send of typed ops and a
    malformed counter op, with the device planner (`device="cpu"`) and
    the host oracle, the folds on their host route (4096) and on their
    device route (1). Outputs, pushes and every table exactly equal."""
    from evolu_tpu.core import crdt_types as jct
    from evolu_tpu_torch.core import crdt_types as pct

    from _torch_port_data import TYPED_COLUMNS, TYPED_TABLE, typed_batches

    monkeypatch.setattr(jct, "DEVICE_FOLD_MIN", fold_min)
    monkeypatch.setattr(pct, "DEVICE_FOLD_MIN", fold_min)
    jcfg, pcfg = TYPED_PAIRS[pair]
    jax = Side(JaxWorker, JaxDb, JaxConfig(receive_chunk_size=64, **jcfg), jmsg, jt)
    port = Side(DbWorker, PySqliteDatabase, Config(receive_chunk_size=64, **pcfg), pmsg, pt, device="cpu")
    query = jmsg.serialize_query(f'SELECT * FROM "{TYPED_TABLE}" ORDER BY "id"')
    try:
        for s in (jax, port):
            s.worker.now = lambda ticks=iter(range(NOW + 10**7, NOW + 10**10, 1000)): next(ticks)
            s.worker.start(MNEMONIC)
            s.post("UpdateDbSchema", s.tables({TYPED_TABLE: TYPED_COLUMNS}))
            s.post("Query", (query,))
        for batch in typed_batches(3):
            for s in (jax, port):
                s.post("Receive", s.messages(batch), "{}")
        local = [(TYPED_TABLE, "row1", "votes", '["c",5]'), (TYPED_TABLE, "row1", "votes", "not an op"),
                 (TYPED_TABLE, "row2", "tags", '["a","x"]'), (TYPED_TABLE, "row2", "title", "mine")]
        for s in (jax, port):
            s.post("Send", s.new_messages(local), ("sent",), (query,))
            s.worker.flush()
        assert [_norm_output(o) for o in port.outputs] == [_norm_output(o) for o in jax.outputs]
        assert [_norm_push(r) for r in port.pushes] == [_norm_push(r) for r in jax.pushes]
        got, want = ({t: sorted(rows, key=repr) for t, rows in _typed_dump(s.db).items()} for s in (port, jax))
        assert got == want
        assert got["__crdt_counter"] and got["__crdt_list"] and got["__crdt_tensor"] and got["__crdt_kill"]
    finally:
        for s in (jax, port):
            s.worker.stop()


def _typed_dump(db):
    names = [r[0] for r in db.exec("SELECT name FROM sqlite_schema WHERE type='table' ORDER BY name")]
    return {t: db.exec(f'SELECT * FROM "{t}"') for t in names}


def test_unported_routes_raise():
    """Scoped sync, refused until it was ported, is accepted as the JAX
    package accepts it: a scoped `DbWorker` starts, a `WidenSyncScope`
    on a full replica answers nothing, and on a scoped one it widens; a
    scoped `SyncTransport` constructs. Still refused: an unknown planner
    backend. The relay push leg, ported, is
    accepted by `connect`."""
    from evolu_tpu.sync.client import SyncTransport as JaxTransport
    from evolu_tpu.sync.scope import SyncScope as JaxScope
    from evolu_tpu_torch.runtime.client import Evolu
    from evolu_tpu_torch.runtime.worker import select_planner
    from evolu_tpu_torch.sync.client import SyncTransport, connect
    from evolu_tpu_torch.sync.scope import SyncScope

    with pytest.raises(ValueError, match="backend"):
        select_planner(Config(backend="tpu"), device="cpu")
    runs = []
    for widen in (pmsg.WidenSyncScope(full=True), pmsg.WidenSyncScope(watermark_millis=0, tables=("todoCategory",))):
        for scoped in (False, True):
            pair = []
            for side in (Side(JaxWorker, JaxDb, JaxConfig(sync_scope=JaxScope(tables=("todo",)) if scoped else None),
                              jmsg, jt),
                         Side(DbWorker, PySqliteDatabase, Config(sync_scope=SyncScope(tables=("todo",)) if scoped
                                                                 else None), pmsg, pt, device="cpu")):
                side.worker.start(MNEMONIC)
                try:
                    side.post("WidenSyncScope", widen.watermark_millis, widen.tables, widen.full)
                    side.worker.flush()
                finally:
                    side.worker.stop()
                scope = side.worker.config.sync_scope
                pair.append(([_norm_output(o) for o in side.outputs], None if scope is None else scope.tables))
            assert pair[1] == pair[0]
            runs.append(pair[1])
    assert [r[1] for r in runs] == [None, None, None, ("todo", "todoCategory")]
    assert runs[1][0][-1] == ("OnReceive",) and runs[0][0] == [runs[0][0][0]]  # only a scoped worker widens
    for transport in (SyncTransport(Config(sync_scope=SyncScope(tables=("todo",))), on_receive=lambda *a: None),
                      JaxTransport(JaxConfig(sync_scope=JaxScope(tables=("todo",))), on_receive=lambda *a: None)):
        assert transport.config.sync_scope.tables == ("todo",)
        transport.stop()
    e = Evolu(config=Config(backend="cpu"), mnemonic=MNEMONIC, device="cpu", backend="python")
    try:
        t = connect(e, Config(push_subscribe=True, sync_url="http://127.0.0.1:9"))
        assert t.push_subscriber is not None and e._transport is t
    finally:
        e.dispose()


def _scoped_script(jax, port):
    """A scoped worker's stream (scope: the `todo` table): local writes to
    both tables put cells of both in the winner cache; a Receive then
    defers a newer foreign write to a cached `todoCategory` cell (the
    cache must drop that slot), queries answer `ScopeDeferred` for the
    deferred table, chunked receives split each chunk, a re-delivery does
    not inflate the frontier, and a widening re-materializes the table
    from the log before more writes land in it."""
    rng = np.random.default_rng(13)
    sides = (jax, port)
    q_todo = jmsg.serialize_query('SELECT * FROM "todo" ORDER BY "id"')
    q_cat = jmsg.serialize_query('SELECT "id", "name" FROM "todoCategory" ORDER BY "id"')
    q_join = jmsg.serialize_query('SELECT t."id", c."name" FROM "todo" t JOIN "todoCategory" c ON 1 ORDER BY 1, 2')
    queries = (q_todo, q_cat, q_join)

    def each(fn):
        for s in sides:
            fn(s)

    def receive(tuples, tree="{}"):
        each(lambda s: s.post("Receive", s.messages(tuples), tree, None))

    def send(tuples):
        each(lambda s: s.post("Send", s.new_messages(tuples), (), queries))

    frontiers = []

    def check_cache():
        for s in sides:
            s.worker.flush()
        assert port.worker.verify_winner_cache() == jax.worker.verify_winner_cache()
        frontiers.append(port.worker._deferred_frontier())
        assert frontiers[-1] == jax.worker._deferred_frontier()

    each(lambda s: s.post("UpdateDbSchema", s.tables(SCHEMA)))
    for k in range(6):  # a steady population: the cache settles on these cells
        send([("todoCategory", "row1", "name", f"mine{k}"), ("todo", "row1", "title", f"local{k}")])
    for s in sides:
        s.worker.flush()
    cache = getattr(port.worker._planner, "cache", None)
    cached_before = cache is not None and ("todoCategory", "row1", "name") in cache._slots
    newer = timestamp_to_string(Timestamp(NOW + 40_000, 0, "00000000000000a1"))
    receive([(newer, "todoCategory", "row1", "name", "theirs"),
             (timestamp_to_string(Timestamp(NOW + 41_000, 0, "00000000000000a1")), "todo", "row1", "title", "t")])
    check_cache()
    receive(_remote(rng, 30))
    each(lambda s: s.post("Query", queries))
    chunked = _remote(rng, 160, n_rows=30)
    receive(chunked)
    receive(chunked[::3])                      # re-delivery: the frontier stays exact
    check_cache()
    each(lambda s: s.post("Query", queries))
    each(lambda s: s.post("WidenSyncScope", None, ("todoCategory",)))
    each(lambda s: s.post("Query", queries))
    send([("todoCategory", "row1", "name", "again"), ("todoCategory", "row2", "name", "new")])
    receive(_remote(rng, 60, base=NOW + 5_000, span=40_000))
    check_cache()
    each(lambda s: s.post("Query", queries))
    return frontiers, cached_before


@pytest.mark.parametrize("pair", list(PAIRS))
def test_scoped_worker_matches_jax(pair):
    """The scoped stream on the JAX and the port worker, for each backend
    pair: equal outputs (`ScopeDeferred` by tables and rows), pushes, table
    dumps (`__scope_deferred` included), winner-cache slots, and the
    cache's audit against SQLite after every deferred batch."""
    from evolu_tpu.sync.scope import SyncScope as JaxScope
    from evolu_tpu_torch.sync.scope import SyncScope

    jcfg, pcfg = PAIRS[pair]
    jax = Side(JaxWorker, JaxDb, JaxConfig(receive_chunk_size=50, sync_scope=JaxScope(tables=("todo",)), **jcfg),
               jmsg, jt)
    port = Side(DbWorker, PySqliteDatabase, Config(receive_chunk_size=50, sync_scope=SyncScope(tables=("todo",)),
                                                   **pcfg), pmsg, pt, device="cpu")
    try:
        for s in (jax, port):
            s.worker.start(MNEMONIC)
        frontiers, cached_before = _scoped_script(jax, port)
        for s in (jax, port):
            s.worker.flush()
        got, want = [_norm_output(o) for o in port.outputs], [_norm_output(o) for o in jax.outputs]
        assert got == want
        # The foreign write and the remote todoCategory rows, re-delivery not counted.
        assert frontiers[0] == {"todoCategory": 1}
        assert frontiers[0]["todoCategory"] < frontiers[1]["todoCategory"] and frontiers[2] == {}
        assert [_norm_push(r) for r in port.pushes] == [_norm_push(r) for r in jax.pushes]
        assert _dump(port.db) == _dump(jax.db)
        assert port.worker.config.sync_scope.tables == ("todo", "todoCategory")
        assert port.worker._deferred_frontier() == jax.worker._deferred_frontier() == {}
        assert port.worker.scope_counts["widen_materialized"] > 0
        pc, jc = (getattr(s.worker._planner, "cache", None) for s in (port, jax))
        assert (pc is None) == (jc is None) == (pcfg["backend"] == "cpu")
        if pc is not None:
            assert pc._slots == jc._slots and pc._free == jc._free
            if pair == "device planner always":
                # The deferred foreign write dropped the cached todoCategory slot.
                assert cached_before and pc.counts["invalidated_cells"] > 0
    finally:
        for s in (jax, port):
            s.worker.stop()


def test_owner_change_drops_aead_sessions_as_jax():
    """RestoreOwner and ResetOwner drop the cached aead-batch-v1 sessions
    in both packages: after every command each package holds as many
    sessions as the other, and the outputs are equal."""
    import evolu_tpu.sync.aead as jaead

    import evolu_tpu_torch.sync.aead as paead

    jax = Side(JaxWorker, JaxDb, JaxConfig(backend="cpu"), jmsg, jt)
    port = Side(DbWorker, PySqliteDatabase, Config(backend="cpu"), pmsg, pt, device="cpu")
    try:
        for s in (jax, port):
            s.worker.start(MNEMONIC)
            s.worker.flush()
        held = []
        for name, args in (("RestoreOwner", (MNEMONIC2,)), ("ResetOwner", ())):
            for aead in (jaead, paead):
                for m in (MNEMONIC, MNEMONIC2):
                    aead.get_session(m, 1)
            held.append((len(jaead._sessions), len(paead._sessions)))
            for s in (jax, port):
                s.post(name, *args)
                s.worker.flush()
            held.append((len(jaead._sessions), len(paead._sessions)))
        assert held == [(2, 2), (0, 0), (2, 2), (0, 0)]
        got, want = [_norm_output(o) for o in port.outputs], [_norm_output(o) for o in jax.outputs]
        assert got == want
        assert [o[0] for o in got] == ["OnInit", "ReloadAllTabs", "ReloadAllTabs"]
    finally:
        for s in (jax, port):
            s.worker.stop()
        for aead in (jaead, paead):
            aead.reset_sessions()
