"""Port parity: the mesh-sharded engine, winner cache, worker routes and
relay wiring against the JAX package's `tests/test_mesh_engine.py`
episodes, the JAX side on the 8-device CPU mesh of `tests/conftest.py`
and the port on 8 CPU shards (`MeshContext(create_mesh(devices=["cpu"] *
8))`).

- the sharded `run_batch_wire` (synchronous and write-behind) serves the
  JAX sharded engine's bytes and the port's one-shard engine's over 3
  rounds, with equal store dumps;
- stable placement and `reconcile_owner_batches` under it;
- `MeshShardedWinnerCache` against JAX's: slots, per-shard free lists and
  next slots, capacity growth, slot arrays bit for bit, the audit,
  `shard_slot_counts`, every table and the tree; the packed (receive)
  flow through a worker on the C++ backend;
- the worker's planner selection and its hot-owner route;
- the relay's default-off and environment switch, the /stats `mesh`
  section's keys and counts (against the JAX metrics' deltas; quantiles
  are null in the port until it has metrics), and a non-canonical batch
  bouncing before any side effect.

Tolerance: exact everywhere."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
from _torch_jax_state import jax_process_state  # noqa: F401  (the JAX package's native libraries and ledger)

import evolu_tpu.core.types as jt
import evolu_tpu.parallel.mesh as jmesh
import evolu_tpu.runtime.messages as jmsg
import evolu_tpu.sync.protocol as jp
from evolu_tpu.core.merkle import apply_prefix_xors, merkle_tree_to_string, minute_deltas_host
from evolu_tpu.core.timestamp import Timestamp, timestamp_to_string
from evolu_tpu.obs import metrics as jmetrics
from evolu_tpu.server import relay as jrelay
from evolu_tpu.server.engine import BatchReconciler as JaxReconciler
from evolu_tpu.storage import native as jn
from evolu_tpu.sync import native_crypto as jnc
from evolu_tpu.utils.config import Config as JaxConfig

import evolu_tpu_torch.core.types as pt
import evolu_tpu_torch.runtime.messages as pmsg
import evolu_tpu_torch.sync.protocol as pp
from evolu_tpu_torch.core.merkle import merkle_tree_to_string as port_tree_string
from evolu_tpu_torch.parallel.mesh import MeshContext, create_mesh
from evolu_tpu_torch.server import relay as prelay
from evolu_tpu_torch.server.engine import BatchReconciler
from evolu_tpu_torch.storage import native as pn
from evolu_tpu_torch.sync import native_crypto as pnc
from evolu_tpu_torch.utils.config import Config

from _torch_port_data import within

BASE = 1_700_000_000_000
MN = "legal winner thank year wave sausage worth useful legal winner thank yellow"
NODES = ("00000000000000a1", "00000000000000b2", "c3c3c3c3c3c3c3c3", "fedcba9876543210")
SCHEMA = {"todo": ("title", "isCompleted"), "todoCategory": ("name",)}
LIMIT_S = 120


def cpu_ctx(n=8):
    return MeshContext(create_mesh(devices=["cpu"] * n))


@pytest.fixture(autouse=True)
def same_node_id(monkeypatch):
    import evolu_tpu.core.timestamp
    import evolu_tpu_torch.core.timestamp

    for mod in (evolu_tpu.core.timestamp, evolu_tpu_torch.core.timestamp):
        monkeypatch.setattr(mod, "create_node_id", lambda: "0f1e2d3c4b5a6978")


def _msgs(proto, node, start, n, step_ms=1000):
    return tuple(proto.EncryptedCrdtMessage(
        timestamp_to_string(Timestamp(BASE + (start + i) * step_ms, 0, node)), b"ct-%d" % (start + i))
        for i in range(n))


def _request_rounds(proto, owners, rounds):
    """Per round every owner pushes a partly overlapping window (stored
    duplicates take the was-new correction) and pulls against an empty
    client tree; owner 0 pushes far more rows than the rest (the
    hot-owner row split)."""
    out = []
    for rnd in range(rounds):
        reqs = []
        for i in range(owners):
            node = f"{i + 1:016x}"
            n = 300 if i == 0 else 6 + (i % 5)
            reqs.append(proto.SyncRequest(_msgs(proto, node, rnd * 4, n), f"mesh-u{i:03d}", node, "{}"))
        out.append(tuple(reqs))
    return out


def _store_dump(store):
    return [(s.db.exec('SELECT * FROM "message" ORDER BY "timestamp", "userId"'),
             s.db.exec('SELECT * FROM "merkleTree" ORDER BY "userId"')) for s in store.shards]


@pytest.mark.parametrize("write_behind", [False, True])
def test_sharded_run_batch_wire_matches_jax_and_one_shard(write_behind):
    from evolu_tpu.storage.write_behind import WriteBehindQueue as JaxQueue

    from evolu_tpu_torch.storage.write_behind import WriteBehindQueue

    stores = {"jax": jrelay.ShardedRelayStore(shards=4, backend="native"),
              "port": prelay.ShardedRelayStore(shards=4, backend="native"),
              "one": prelay.ShardedRelayStore(shards=4, backend="native")}
    queues = {}
    if write_behind:
        queues = {"jax": JaxQueue(stores["jax"]), "port": WriteBehindQueue(stores["port"]),
                  "one": WriteBehindQueue(stores["one"])}
    ctx = cpu_ctx()
    engines = {"jax": JaxReconciler(stores["jax"], write_behind=queues.get("jax"),
                                    mesh_ctx=jmesh.MeshContext()),
               "port": BatchReconciler(stores["port"], device="cpu", write_behind=queues.get("port"),
                                       mesh_ctx=ctx),
               "one": BatchReconciler(stores["one"], device="cpu", write_behind=queues.get("one"))}
    assert engines["port"].mesh.size == 8 and engines["one"].mesh.size == 1
    try:
        for jreqs, preqs in zip(_request_rounds(jp, 13, 3), _request_rounds(pp, 13, 3)):
            want = engines["jax"].run_batch_wire(jreqs)
            assert engines["port"].run_batch_wire(preqs) == want
            assert engines["one"].run_batch_wire(preqs) == want
        for q in queues.values():
            q.flush()
        assert _store_dump(stores["port"]) == _store_dump(stores["jax"]) == _store_dump(stores["one"])
        assert ctx.counts["dispatches"] == 3 and ctx.counts["xdev_reduce"]["digest"] == 3
        assert ctx.counts["xdev_reduce"]["owner_delta_partials"] == 3  # owner 0 split every round
    finally:
        for e in engines.values():
            e.close()
        for q in queues.values():
            q.close()
        for s in stores.values():
            s.close()


def test_stable_placement_is_stable_and_owner_sharded():
    ctx, jctx = cpu_ctx(), jmesh.MeshContext()
    for o in ("alice", "bob", "user-123"):
        assert ctx.place(o) == jctx.place(o) == cpu_ctx().place(o)
    units = {("hot", 0): 10, ("hot", 1): 10, ("cold", 0): 1}
    shards = ctx.assign_stable(units)
    assert shards == jctx.assign_stable(units)
    home = ctx.place("hot")
    assert ("hot", 0) in shards[home] and ("hot", 1) in shards[(home + 1) % 8]
    assert ("cold", 0) in shards[ctx.place("cold")]


def test_reconcile_owner_batches_stable_placement_parity():
    """The multi-owner reconcile under stable placement gives LPT's plans,
    deltas and digest, and JAX's."""
    from evolu_tpu.parallel.reconcile import reconcile_owner_batches as jax_reconcile

    from evolu_tpu_torch.parallel.reconcile import reconcile_owner_batches

    batches = {f"own{o}": [(timestamp_to_string(Timestamp(BASE + i * 1000, 0, f"{o + 1:016x}")), "todo",
                            f"r{i % 3}", "title", f"v{o}-{i}") for i in range(5 + o)] for o in range(10)}
    ctx = cpu_ctx()
    lpt = reconcile_owner_batches({o: [pt.CrdtMessage(*t) for t in b] for o, b in batches.items()}, {},
                                  mesh=ctx.mesh)
    stable = reconcile_owner_batches({o: [pt.CrdtMessage(*t) for t in b] for o, b in batches.items()}, {},
                                     mesh_ctx=ctx)
    jmesh_ = jmesh.create_mesh()
    want = jax_reconcile(jmesh_, {o: [jt.CrdtMessage(*t) for t in b] for o, b in batches.items()}, {},
                         mesh_ctx=jmesh.MeshContext(jmesh_))
    assert lpt[1] == stable[1] == want[1]
    for o in batches:
        for got in (lpt[0][o], stable[0][o]):
            assert got[0] == want[0][o][0] and got[2] == want[0][o][2]
            assert [(m.timestamp, m.value) for m in got[1]] == [(m.timestamp, m.value) for m in want[0][o][1]]
    assert ctx.counts["dispatches"] == 1 and ctx.counts["shard_rows"] == 8


# -- the mesh-sharded winner cache --


def _client_db(mod):
    from evolu_tpu.storage.schema import init_db_model as jax_init

    from evolu_tpu_torch.storage.schema import init_db_model

    db = mod.PySqliteDatabase()
    (init_db_model if mod.__name__.startswith("evolu_tpu_torch") else jax_init)(db, MN)
    db.exec('CREATE TABLE "todo" ("id" TEXT PRIMARY KEY, "title" BLOB, "done" BLOB)')
    return db


def _mk(i, node="a1b2c3d4e5f60718", row=None):
    return (timestamp_to_string(Timestamp(BASE + i * 977, i % 4, node)), "todo", row or f"r{i % 23}",
            "title", f"v{i}")


@pytest.mark.parametrize("adaptive", [False, True])
def test_mesh_sharded_winner_cache_matches_jax(adaptive):
    """Both packages' sharded caches plan the same overlapping batches
    (growth forced by capacity 16) with equal slots, per-shard free lists
    and next slots, slot arrays, audits, tables and trees; invalidation
    returns slots to their own shard."""
    import evolu_tpu.storage.sqlite as jsql
    from evolu_tpu.ops.winner_cache import MeshShardedWinnerCache as JaxSharded
    from evolu_tpu.storage.apply import apply_messages as jax_apply

    import evolu_tpu_torch.storage.sqlite as psql
    from evolu_tpu_torch.ops.winner_cache import MeshShardedWinnerCache
    from evolu_tpu_torch.storage.apply import apply_messages

    rng = np.random.default_rng(12)
    pdb, jdb = _client_db(psql), _client_db(jsql)
    port = MeshShardedWinnerCache(pdb, mesh_ctx=cpu_ctx(), capacity=16, adaptive=adaptive)
    jax = JaxSharded(jdb, mesh_ctx=jmesh.MeshContext(), capacity=16, adaptive=adaptive)
    trees = [{}, {}]

    def dump(db):
        return (db.exec('SELECT * FROM "__message" ORDER BY "timestamp"'),
                db.exec('SELECT * FROM "todo" ORDER BY "id"'))

    def check():
        assert port._slots == jax._slots
        assert port._free_by_shard == jax._free_by_shard
        assert port._next_by_shard == jax._next_by_shard
        assert (port.capacity, port._streaming) == (jax.capacity, jax._streaming)
        pw1, pw2 = port.slot_values()
        assert np.array_equal(pw1, np.asarray(jax._w1)) and np.array_equal(pw2, np.asarray(jax._w2))
        assert port.verify_against_db() == jax.verify_against_db() == len(port._slots)
        assert port.shard_slot_counts() == jax.shard_slot_counts()
        assert dump(pdb) == dump(jdb)
        assert port_tree_string(trees[0]) == merkle_tree_to_string(trees[1])

    def apply(batch):
        trees[0] = apply_messages(pdb, trees[0], tuple(pt.CrdtMessage(*m) for m in batch),
                                  planner=port.plan_batch)
        trees[1] = jax_apply(jdb, trees[1], tuple(jt.CrdtMessage(*m) for m in batch), planner=jax.plan_batch)
        check()

    try:
        for batch_no in range(4):
            apply([_mk(int(i) + batch_no * 40) for i in rng.permutation(130)])
        apply([_mk(3000 + j, row=f"g{j % 200}") for j in range(260)])  # 200 new cells: growth
        if not adaptive:
            assert port.capacity > 16 and sum(1 for c in port.shard_slot_counts() if c) >= 4
            assert port.counts["cached_plans"] == 5
        victims = list(port._slots)[:4]
        port.invalidate(victims)
        jax.invalidate(victims)
        check()
        apply([_mk(int(i)) for i in range(50)])
        port.invalidate(list(port._slots))
        jax.invalidate(list(jax._slots))
        assert port._has_slot_state() == jax._has_slot_state()
        check()
    finally:
        pdb.close(), jdb.close()


class Side:
    """One package's worker on its C++ backend, recorded."""

    def __init__(self, port, config, **kw):
        self.port = port
        self.msg = pmsg if port else jmsg
        self.outputs, self.pushes = [], []
        ticks = iter(range(BASE, BASE + 10**9, 1000))
        self.db = (pn if port else jn).CppSqliteDatabase()
        from evolu_tpu.runtime.worker import DbWorker as JaxWorker

        from evolu_tpu_torch.runtime.worker import DbWorker

        self.worker = (DbWorker if port else JaxWorker)(
            self.db, config, on_output=self.outputs.append, post_sync=self.pushes.append,
            now=lambda: next(ticks), **kw)
        self.worker.start(MN)
        table = pt.TableDefinition if port else jt.TableDefinition
        self.post("UpdateDbSchema", tuple(table.of(t, c) for t, c in SCHEMA.items()))

    def post(self, name, *args, **kw):
        self.worker.post(getattr(self.msg, name)(*args, **kw))

    def receive_packed(self, body):
        packed, tree = (pnc if self.port else jnc).decrypt_response_columns(body, MN)
        self.post("Receive", packed, tree, None)

    def receive_objects(self, tuples, tree):
        types = pt if self.port else jt
        self.post("Receive", tuple(types.CrdtMessage(*t) for t in tuples), tree, None)

    def dump(self):
        self.worker.flush()
        names = [r[0] for r in self.db.exec("SELECT name FROM sqlite_schema WHERE type='table' ORDER BY name")]
        return {t: self.db.exec(f'SELECT * FROM "{t}" ORDER BY 1, 2') for t in names}


def _remote(rng, n, n_rows=40, base=BASE - 600_000, span=500_000):
    out, stamps = [], set()
    while len(out) < n:
        ts = timestamp_to_string(Timestamp(base + int(rng.integers(0, span)), int(rng.integers(0, 4)),
                                           NODES[int(rng.integers(0, 4))]))
        if ts in stamps:
            continue
        stamps.add(ts)
        table = ("todo", "todoCategory")[int(rng.integers(0, 2))]
        col = SCHEMA[table][int(rng.integers(0, len(SCHEMA[table])))]
        value = (None, "x", int(rng.integers(0, 100)), 2.5)[int(rng.integers(0, 4))]
        out.append((ts, table, f"row{int(rng.integers(0, n_rows))}", col, value))
    return out


def _tree(tuples):
    deltas, _ = minute_deltas_host(t[0] for t in tuples)
    return merkle_tree_to_string(apply_prefix_xors({}, deltas))


def _body(tuples, tree):
    enc = jnc.encrypt_batch([jt.CrdtMessage(*t) for t in tuples], MN)
    return jp.encode_sync_response(jp.SyncResponse(tuple(enc), tree))


def _pair(jcfg, pcfg):
    return (Side(False, JaxConfig(**jcfg)),
            Side(True, Config(**pcfg), device="cpu", mesh_ctx=cpu_ctx()))


def test_packed_flow_through_the_sharded_cache_matches_jax():
    """Receives on the C++ backend with `mesh_engine`: the packed plan
    goes through `MeshShardedWinnerCache.plan_packed` on both sides, with
    equal outputs, pushes, tables and audits."""
    from evolu_tpu_torch.storage import apply as papply

    jax, port = _pair(dict(backend="tpu", mesh_engine=True, hot_owner_min_batch=None),
                      dict(backend="cuda", mesh_engine=True))
    try:
        assert type(port.worker._planner.cache).__name__ == "MeshShardedWinnerCache"
        assert type(jax.worker._planner.cache).__name__ == "MeshShardedWinnerCache"
        rng = np.random.default_rng(3)
        before = dict(papply.counts)
        history = []
        for k in range(5):
            batch = _remote(rng, 120, n_rows=6, base=BASE - 600_000 + k * 10_000, span=9_000)
            history += batch
            body = _body(batch, _tree(history))
            for s in (jax, port):
                s.receive_packed(body)
            assert port.dump() == jax.dump()
        assert [type(o).__name__ for o in port.outputs] == [type(o).__name__ for o in jax.outputs]
        assert len(port.pushes) == len(jax.pushes)
        cache = port.worker._planner.cache
        assert cache.counts["cached_plans"] >= 2 and papply.counts["packed"] > before.get("packed", 0)
        assert cache.verify_against_db() == jax.worker._planner.cache.verify_against_db() > 0
        assert cache.shard_slot_counts() == jax.worker._planner.cache.shard_slot_counts()
    finally:
        for s in (jax, port):
            s.worker.stop()
            s.db.close()


def test_worker_selects_sharded_cache_only_when_configured():
    from evolu_tpu.runtime.worker import select_planner as jax_select

    from evolu_tpu_torch.ops.winner_cache import DeviceWinnerCache, MeshShardedWinnerCache
    from evolu_tpu_torch.runtime.worker import select_planner

    db, jdb = pn.CppSqliteDatabase(), jn.CppSqliteDatabase()
    try:
        ctx = cpu_ctx()
        assert type(select_planner(Config(backend="cuda"), db, "cpu", ctx).cache) is DeviceWinnerCache
        assert type(select_planner(Config(backend="cuda", mesh_engine=True), db, "cpu", ctx).cache) \
            is MeshShardedWinnerCache
        # One shard (no context on a CPU planner): neither the sharded cache
        # nor the hot route, as the reference on one device.
        one = select_planner(Config(backend="cuda", mesh_engine=True), db, "cpu")
        assert type(one.cache) is DeviceWinnerCache and one.mesh_ctx is None
        assert type(select_planner(Config(backend="cuda", mesh_engine=True), db, "cpu", cpu_ctx(1)).cache) \
            is DeviceWinnerCache
        assert type(jax_select(JaxConfig(backend="tpu"), jdb).cache).__name__ == "DeviceWinnerCache"
        assert type(jax_select(JaxConfig(backend="tpu", mesh_engine=True), jdb).cache).__name__ \
            == "MeshShardedWinnerCache"
    finally:
        db.close(), jdb.close()


@pytest.mark.parametrize("winner_cache", [True, False])
def test_worker_hot_owner_route_matches_jax(winner_cache, monkeypatch):
    """A batch at or above `hot_owner_min_batch` (64 here) takes the
    cell-range-sharded plan on both sides, objects and packed alike
    (the packed route bounces to objects for it); outputs and tables
    equal JAX's, the cache invalidated where the route bypassed it."""
    import evolu_tpu_torch.parallel.hot_owner as hot

    calls = []
    orig = hot.reconcile_hot_owner
    monkeypatch.setattr(hot, "reconcile_hot_owner", lambda *a, **k: (calls.append(len(a[1])), orig(*a, **k))[1])
    jax, port = _pair(dict(backend="tpu", hot_owner_min_batch=64, winner_cache=winner_cache),
                      dict(backend="cuda", hot_owner_min_batch=64, winner_cache=winner_cache))
    try:
        rng = np.random.default_rng(8)
        small = _remote(rng, 30, base=BASE - 900_000, span=100_000)
        big = _remote(rng, 600, n_rows=97, base=BASE - 700_000, span=100_000)
        packed = _remote(rng, 200, n_rows=50, base=BASE - 500_000, span=100_000)
        for s in (jax, port):
            s.receive_objects(small, _tree(small))
            s.receive_objects(big, _tree(small + big))
            s.receive_packed(_body(packed, _tree(small + big + packed)))
        assert port.dump() == jax.dump()
        assert calls == [600, 200]
        assert [type(o).__name__ for o in port.outputs] == [type(o).__name__ for o in jax.outputs]
        if winner_cache:
            assert port.worker._planner.cache.verify_against_db() == \
                jax.worker._planner.cache.verify_against_db()
    finally:
        for s in (jax, port):
            s.worker.stop()
            s.db.close()


# -- relay wiring --


def test_relay_mesh_engine_default_off_and_env_override(monkeypatch):
    def flags(make):
        server = make()
        try:
            return server.mesh_engine, server.scheduler is not None
        finally:
            if server.scheduler is not None:
                server.scheduler.stop()
            server.store.close()

    cases = [(None, (False, False)), ("1", (True, True)), ("0", (False, False))]
    for env, want in cases:
        if env is None:
            monkeypatch.delenv("EVOLU_MESH_ENGINE", raising=False)
        else:
            monkeypatch.setenv("EVOLU_MESH_ENGINE", env)
        assert flags(lambda: jrelay.RelayServer(jrelay.ShardedRelayStore(shards=1))) == want
        assert flags(lambda: prelay.RelayServer(prelay.ShardedRelayStore(shards=1), device="cpu")) == want


def _post(url, body):
    try:
        with urllib.request.urlopen(urllib.request.Request(
                url, data=body, headers={"Content-Type": "application/octet-stream"}), timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, b""


def _jax_mesh_metrics():
    occ = jmetrics.registry.get_histogram("evolu_mesh_shard_rows")
    waste = jmetrics.registry.get_histogram("evolu_mesh_padding_waste_rows")
    return {"dispatches_total": jmetrics.get_counter("evolu_mesh_dispatches_total"),
            "xdev": {k: jmetrics.get_counter("evolu_mesh_xdev_reduce_total", kind=k)
                     for k in ("digest", "owner_delta_partials", "winner_minute_partials")},
            "shard_rows": (occ or (None, None, 0.0, 0))[3], "padding_waste_rows": (waste or (None, None, 0.0, 0))[3]}


def test_mesh_stats_section_matches_jax():
    """POSTs through a mesh relay on each side: equal bytes, and the
    `mesh` section's keys, devices and counts equal the JAX metrics'
    growth over the same traffic; its quantiles are the port registry's."""
    bodies = [pp.encode_sync_request(pp.SyncRequest(_msgs(pp, "d" * 16, 0, 9), "obs-u", "d" * 16, "{}")),
              pp.encode_sync_request(pp.SyncRequest(_msgs(pp, "e" * 16, 0, 400), "obs-hot", "e" * 16, "{}"))]

    def drive(server):
        server.start()
        try:
            out = [_post(server.url, b) for b in bodies]
            with urllib.request.urlopen(server.url + "/stats", timeout=30) as r:
                return out, json.loads(r.read())
        finally:
            server.stop()

    before = _jax_mesh_metrics()
    want, jstats = within(LIMIT_S, lambda: drive(jrelay.RelayServer(
        jrelay.ShardedRelayStore(shards=2, backend="native"), mesh_ctx=jmesh.MeshContext(),
        capabilities=prelay.DEFAULT_CAPABILITIES)))
    after = _jax_mesh_metrics()
    got, pstats = within(LIMIT_S, lambda: drive(prelay.RelayServer(
        prelay.ShardedRelayStore(shards=2, backend="native"), mesh_ctx=cpu_ctx(), device="cpu")))
    assert got == want and all(code == 200 for code, _ in got)
    mesh, jm = pstats["mesh"], jstats["mesh"]
    assert set(mesh) == set(jm) and set(mesh["xdev_reduce_total"]) == set(jm["xdev_reduce_total"])
    assert mesh["devices"] == jm["devices"] == 8
    assert mesh["dispatches_total"] == after["dispatches_total"] - before["dispatches_total"] > 0
    assert mesh["xdev_reduce_total"] == {k: after["xdev"][k] - before["xdev"][k] for k in after["xdev"]}
    from evolu_tpu_torch.obs import metrics as port_metrics

    assert mesh["shard_rows"] == {"count": after["shard_rows"] - before["shard_rows"],
                                  "p50": port_metrics.quantile("evolu_mesh_shard_rows", 0.50),
                                  "p99": port_metrics.quantile("evolu_mesh_shard_rows", 0.99)}
    assert mesh["shard_rows"]["p50"] is not None
    assert mesh["padding_waste_rows"]["count"] == after["padding_waste_rows"] - before["padding_waste_rows"]
    assert set(mesh["shard_rows"]) == set(jm["shard_rows"])


def test_non_canonical_batch_bounces_before_side_effect_on_sharded_path():
    good = timestamp_to_string(Timestamp(BASE, 0, "e" * 16))

    def drive(server, proto):
        server.start()
        try:
            body = proto.encode_sync_request(proto.SyncRequest(
                (proto.EncryptedCrdtMessage(good + "Z", b"x"),), "nc-u", "e" * 16, "{}"))
            code = _post(server.url, body)[0]
            rows = [s.db.exec_sql_query('SELECT COUNT(*) AS n FROM "message"', ())[0]["n"]
                    for s in server.store.shards]
            return code, rows
        finally:
            server.stop()

    want = within(LIMIT_S, lambda: drive(jrelay.RelayServer(
        jrelay.ShardedRelayStore(shards=2, backend="native"), mesh_ctx=jmesh.MeshContext()), jp))
    got = within(LIMIT_S, lambda: drive(prelay.RelayServer(
        prelay.ShardedRelayStore(shards=2, backend="native"), mesh_ctx=cpu_ctx(), device="cpu"), pp))
    assert got == want == (500, [0, 0])
