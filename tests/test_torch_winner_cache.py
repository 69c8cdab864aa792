"""Port parity: the device-resident winner cache.

The port's `DeviceWinnerCache(db, device="cpu")` and the JAX package's
`DeviceWinnerCache` plan the same batches over their own in-memory
databases. After every batch these must be equal: the `_slots` dicts,
the free lists, the next slot and capacity, the gate's mode and EWMA,
both slot arrays bit for bit, the audit of every live slot against
SQLite (`verify_against_db`), every table dump and the Merkle tree
string."""

import functools

import numpy as np
import pytest
from _torch_jax_state import jax_process_state  # noqa: F401  (the JAX package's native libraries and ledger)

import evolu_tpu.core.types as jt
from evolu_tpu.core.merkle import merkle_tree_to_string as jax_tree_string
from evolu_tpu.core.timestamp import Timestamp as JaxTimestamp
from evolu_tpu.core.timestamp import timestamp_to_string as jax_ts_string
from evolu_tpu.ops.merge import plan_batch_device_full as jax_streamed
from evolu_tpu.ops.winner_cache import DeviceWinnerCache as JaxCache
from evolu_tpu.storage.apply import ChunkedApplyError as JaxChunkedApplyError
from evolu_tpu.storage.apply import apply_messages as jax_apply
from evolu_tpu.storage.apply import apply_messages_chunked as jax_apply_chunked
from evolu_tpu.storage.schema import init_db_model as jax_init
from evolu_tpu.storage.sqlite import PySqliteDatabase as JaxDb

import evolu_tpu_torch.core.types as pt
from evolu_tpu_torch.core.merkle import merkle_tree_to_string
from evolu_tpu_torch.ops.merge import plan_batch_device_full
from evolu_tpu_torch.ops.winner_cache import DeviceWinnerCache
from evolu_tpu_torch.storage.apply import ChunkedApplyError, apply_messages, apply_messages_chunked
from evolu_tpu_torch.storage.schema import init_db_model
from evolu_tpu_torch.storage.sqlite import PySqliteDatabase

BASE = 1_700_000_000_000
MNEMONIC = "legal winner thank year wave sausage worth useful legal winner thank yellow"
TODO = 'CREATE TABLE "todo" ("id" TEXT PRIMARY KEY, "title" BLOB, "done" BLOB)'


def _ts(millis, counter, node):
    return jax_ts_string(JaxTimestamp(millis, counter, node))


def _mk(i, node="a1b2c3d4e5f60718", row=None, col="title", value=None, millis=None):
    """One message as a (timestamp, table, row, column, value) tuple."""
    return (_ts(BASE + i * 977 if millis is None else millis, i % 4, node),
            "todo", row or f"r{i % 23}", col, value if value is not None else f"v{i}")


def _init(port, jax):
    init_db_model(port, MNEMONIC)
    jax_init(jax, MNEMONIC)
    for db in (port, jax):
        db.exec(TODO)


class Twin:
    """The port's cache and the JAX cache over twin databases, applying
    the same batches and compared after each."""

    def __init__(self, path_port=":memory:", path_jax=":memory:", **kw):
        self.pdb, self.jdb = PySqliteDatabase(path_port), JaxDb(path_jax)
        _init(self.pdb, self.jdb)
        self.port = DeviceWinnerCache(self.pdb, device="cpu", **kw)
        self.jax = JaxCache(self.jdb, **kw)
        self.ptree, self.jtree = {}, {}
        self.modes = []

    def apply(self, batch, streamed=False):
        """Apply one batch through both caches (or, with `streamed`,
        through each package's streamed-winner planner), then compare."""
        pb = tuple(pt.CrdtMessage(*m) for m in batch)
        jb = tuple(jt.CrdtMessage(*m) for m in batch)
        if streamed:
            self.ptree = apply_messages(self.pdb, self.ptree, pb,
                                        planner=functools.partial(plan_batch_device_full, device="cpu"))
            self.jtree = jax_apply(self.jdb, self.jtree, jb, planner=jax_streamed)
        else:
            self.ptree = apply_messages(self.pdb, self.ptree, pb, planner=self.port.plan_batch)
            self.jtree = jax_apply(self.jdb, self.jtree, jb, planner=self.jax.plan_batch)
        self.modes.append(self.port._streaming)
        self.check()

    def check(self):
        p, j = self.port, self.jax
        assert p._slots == j._slots
        assert p._free == j._free
        assert (p._next_slot, p.capacity, p._streaming) == (j._next_slot, j.capacity, j._streaming)
        assert p._seed_ewma == j._seed_ewma
        pw1, pw2 = p.slot_values()
        assert np.array_equal(pw1, np.asarray(j._w1)) and np.array_equal(pw2, np.asarray(j._w2))
        assert p.verify_against_db() == j.verify_against_db() == len(p._slots)
        assert dump(self.pdb) == dump(self.jdb)
        assert merkle_tree_to_string(self.ptree) == jax_tree_string(self.jtree)

    def both(self, name, *args):
        getattr(self.port, name)(*args)
        getattr(self.jax, name)(*args)
        self.check()

    def close(self):
        self.pdb.close(), self.jdb.close()


def dump(db):
    return {t: db.exec(f'SELECT * FROM "{t}" ORDER BY 1, 2')
            for t in ("__message", "todo", "__clock", "__owner")}


@pytest.fixture(autouse=True)
def same_node_id(monkeypatch):
    """`init_db_model` seeds `__clock` with a random node id: both
    packages draw the same one here."""
    import evolu_tpu.core.timestamp
    import evolu_tpu_torch.core.timestamp

    for mod in (evolu_tpu.core.timestamp, evolu_tpu_torch.core.timestamp):
        monkeypatch.setattr(mod, "create_node_id", lambda: "0f1e2d3c4b5a6978")


@pytest.fixture
def twin_factory():
    made = []

    def make(**kw):
        made.append(Twin(**kw))
        return made[-1]

    yield make
    for t in made:
        t.close()


def _steady(rng, base, n=120, rows=23):
    order = rng.permutation(n)
    return [_mk(base + int(i), row=f"s{int(i) % rows}") for i in order]


def _bit63(rng, n=80):
    """Keys with bit 63 set: millis ≥ 2^47 (k1 ≥ 2^63) and nodes ≥ 2^63,
    beside small keys in the same cells."""
    out = []
    for j in range(n):
        big = j % 2 == 0
        millis = (1 << 47) + int(rng.integers(0, 10**9)) if big else BASE + int(rng.integers(0, 10**9))
        node = f"{int(rng.integers(1 << 63, 2**64, dtype=np.uint64)):016x}" if j % 3 else "0123456789abcdef"
        out.append((_ts(millis, j % 4, node), "todo", f"b{j % 9}", "title", f"v{j}"))
    return out


def _scenario(name):
    """(cache kwargs, batches) for the batch-stream scenarios."""
    rng = np.random.default_rng(11)
    if name == "growth from capacity 64":
        return {"capacity": 64, "adaptive": False}, [[_mk(int(i) + b * 40) for i in rng.permutation(120)]
                                  for b in range(3)] + [[_mk(2000 + j, row=f"g{j}") for j in range(100)]]
    if name == "steady population, adaptive":
        return {"capacity": 64}, [_steady(rng, b * 40) for b in range(5)]
    if name == "adaptive gate crosses modes":
        burst = [[_mk(b * 200 + j, row=f"burst{b}_{j % 40}") for j in range(120)] for b in range(3)]
        steady = [_steady(rng, 1000 + b * 40) for b in range(5)]
        burst2 = [[_mk(3000 + b * 200 + j, row=f"b2_{b}_{j % 40}") for j in range(120)] for b in range(3)]
        return {"capacity": 64}, burst + steady + burst2
    if name == "max_slots cap":
        rotate = [[_mk(i + b * 23, row=f"cap{b}-{i}") for i in range(23)] for b in range(6)]
        big = [_mk(500 + i, row=f"big{i}") for i in range(50)]  # alone over the cap: streamed
        return {"capacity": 16, "adaptive": False, "max_slots": 40}, rotate + [big]
    if name == "keys with bit 63 set":
        return {"capacity": 64, "adaptive": False}, [_bit63(rng) for _ in range(3)]
    raise KeyError(name)


@pytest.mark.parametrize("name", ["growth from capacity 64", "steady population, adaptive",
                                  "adaptive gate crosses modes", "max_slots cap",
                                  "keys with bit 63 set"])
def test_cache_matches_jax_batch_by_batch(name, twin_factory):
    kw, batches = _scenario(name)
    twin = twin_factory(**kw)
    for batch in batches:
        twin.apply(batch)
        if "max_slots" in kw:
            assert len(twin.port._slots) <= kw["max_slots"]
    if name == "adaptive gate crosses modes":
        assert any(twin.modes[:3]) and not twin.modes[7] and any(twin.modes[8:]), twin.modes
    if name == "growth from capacity 64":
        assert twin.port.capacity > 64
    if name == "steady population, adaptive":
        assert twin.modes[0] and not twin.modes[-1], twin.modes
    if name == "max_slots cap":
        assert twin.port.counts["evictions"] >= 1


def test_lazy_seeding_over_a_prepopulated_store(twin_factory):
    twin = twin_factory(adaptive=False)
    twin.apply([_mk(50, row="rX")], streamed=True)  # history the cache never saw
    older = (_ts(BASE + 1, 0, "b" * 16), "todo", "rX", "title", "OLD")
    newer = (_ts(BASE + 10**9, 0, "b" * 16), "todo", "rX", "title", "NEW")
    twin.apply([older])
    assert twin.pdb.exec('SELECT "title" FROM "todo"') == [("v50",)]
    twin.apply([newer])
    assert twin.pdb.exec('SELECT "title" FROM "todo"') == [("NEW",)]


def test_non_canonical_batch_falls_back_and_invalidates(twin_factory):
    twin = twin_factory()
    twin.apply([_mk(1, row="rw"), _mk(2, row="rv")])
    weird = [("2023-09-01T10:00:00.000Z-0000-ABCDEF0123456789", "todo", "rw", "title", "U"),
             ("2023-09-01T10:00:00.000Z-0000-abcdef0123456789", "todo", "rw", "title", "L")]
    twin.apply(weird)
    assert ("todo", "rw", "title") not in twin.port._slots
    assert twin.port.last_route == "host"
    twin.apply([_mk(900, row="rw"), _mk(901, row="rv")])


def test_slot_reuse_never_leaks_stale_keys(twin_factory):
    twin = twin_factory(adaptive=False)
    twin.apply([_mk(10**6, row="rA")])
    slot_a = twin.port._slots[("todo", "rA", "title")]
    twin.both("invalidate", [("todo", "rA", "title")])
    assert slot_a in twin.port._free
    twin.apply([(_ts(BASE, 0, "c" * 16), "todo", "rNEW", "title", "first")])
    assert twin.port._slots[("todo", "rNEW", "title")] == slot_a
    assert twin.pdb.exec('SELECT "title" FROM "todo" WHERE "id" = \'rNEW\'') == [("first",)]
    assert twin.port._free == []


def _explode_first_message_insert(db):
    real = db.run_many
    state = {"armed": True}

    def run_many(sql, rows):
        if state["armed"] and sql.startswith('INSERT INTO "__message"'):
            state["armed"] = False
            raise RuntimeError("disk full")
        return real(sql, rows)

    db.run_many = run_many


def test_transaction_failure_resets_cache(twin_factory):
    twin = twin_factory(adaptive=False)
    twin.apply([_mk(3, row="rE")])
    for db in (twin.pdb, twin.jdb):
        _explode_first_message_insert(db)
    msg = _mk(7, row="rF")
    with pytest.raises(Exception, match="disk full"):
        apply_messages(twin.pdb, twin.ptree, (pt.CrdtMessage(*msg),), planner=twin.port.plan_batch)
    with pytest.raises(Exception, match="disk full"):
        jax_apply(twin.jdb, twin.jtree, (jt.CrdtMessage(*msg),), planner=twin.jax.plan_batch)
    assert not twin.port._slots
    twin.check()
    twin.apply([msg])
    assert twin.pdb.exec('SELECT "title" FROM "todo" WHERE "id" = \'rF\'') == [("v7",)]


def test_chunked_on_chunk_failure_fires_cache_resync(twin_factory):
    twin = twin_factory(adaptive=False)
    msgs = [_mk(i, row=f"c{i}") for i in range(6)]

    def fail(tree, n):
        raise RuntimeError("persist failed")

    with pytest.raises(ChunkedApplyError):
        apply_messages_chunked(twin.pdb, {}, tuple(pt.CrdtMessage(*m) for m in msgs), chunk_size=3,
                               planner=twin.port.plan_batch, on_chunk=fail)
    with pytest.raises(JaxChunkedApplyError):
        jax_apply_chunked(twin.jdb, {}, tuple(jt.CrdtMessage(*m) for m in msgs), chunk_size=3,
                          planner=twin.jax.plan_batch, on_chunk=fail)
    assert not twin.port._slots, "cache kept winners SQLite never committed"
    twin.check()
    twin.apply(msgs)
    assert twin.pdb.exec('SELECT COUNT(*) FROM "todo"') == [(6,)]


def test_foreign_write_resets_cache(tmp_path, twin_factory):
    pa, ja = str(tmp_path / "port.db"), str(tmp_path / "jax.db")
    twin = twin_factory(path_port=pa, path_jax=ja, adaptive=False)
    twin.apply([_mk(5, row="rF")])
    assert ("todo", "rF", "title") in twin.port._slots
    newer = (_ts(BASE + 10**9, 0, "f" * 16), "todo", "rF", "title", "FOREIGN")
    foreign_p, foreign_j = PySqliteDatabase(pa), JaxDb(ja)
    apply_messages(foreign_p, {}, (pt.CrdtMessage(*newer),))
    jax_apply(foreign_j, {}, (jt.CrdtMessage(*newer),))
    foreign_p.close(), foreign_j.close()
    # Older than the foreign winner, newer than the local one: it must lose.
    loser = (_ts(BASE + 10**6, 0, "c" * 16), "todo", "rF", "title", "LOSER")
    pb, jb = (pt.CrdtMessage(*loser),), (jt.CrdtMessage(*loser),)
    apply_messages(twin.pdb, twin.ptree, pb, planner=twin.port.plan_batch)
    jax_apply(twin.jdb, twin.jtree, jb, planner=twin.jax.plan_batch)
    assert twin.pdb.exec('SELECT "title" FROM "todo"') == [("FOREIGN",)]
    assert twin.port.counts["foreign_write_drops"] == 1
    assert twin.port._slots == twin.jax._slots
    assert twin.port.verify_against_db() == twin.jax.verify_against_db() == 1
    assert dump(twin.pdb) == dump(twin.jdb)


def test_reset_reseed_is_not_churn(twin_factory):
    rng = np.random.default_rng(33)
    twin = twin_factory(capacity=64)
    for b in range(4):
        twin.apply(_steady(rng, b * 40))
    assert not twin.port._streaming
    ewma_before = twin.port._seed_ewma
    twin.both("on_transaction_failed")
    for b in range(4, 6):
        twin.apply(_steady(rng, b * 40))
        assert not twin.port._streaming, "the re-seed batch was scored as churn"
    assert twin.port._seed_ewma <= ewma_before + 1e-9


def test_disable_adaptive_while_streaming_reseeds(twin_factory):
    twin = twin_factory()
    twin.apply([_mk(i, row=f"s{i}") for i in range(6)])
    assert twin.port._streaming  # a fresh cache streams its first batch
    twin.port.adaptive = twin.jax.adaptive = False
    twin.apply([_mk(100 + i, row=f"s{i}") for i in range(6)])
    assert not twin.port._streaming and twin.port._slots
