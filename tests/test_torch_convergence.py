"""Port twin of `tests/test_convergence.py`: N-replica convergence and the
high-contention HLC tie-breaks, on port objects (`device="cpu"` where a
device planner runs), at the reference tests' own sizes. Where an
episode ends in a database, the JAX package applies the same messages
and the port's end state (`todo` rows, `__message`, the Merkle tree) must
equal it byte for byte.

| JAX test | port test |
|---|---|
| `test_config4_high_contention_64_replicas_100_rows` | `test_config4_high_contention_64_replicas_100_rows_matches_jax` |
| `test_convergence_under_partitioned_delivery` | `test_convergence_under_partitioned_delivery_matches_jax` |
| `test_device_planner_matches_oracle_under_contention` | `test_device_planner_matches_oracle_under_contention` |
| `test_config1_two_replicas_1k_messages_full_stack` | `test_config1_two_port_replicas_1k_messages_full_stack` |
| `test_chunked_apply_matches_single_batch` | `test_chunked_apply_matches_single_batch_and_jax` |
| `test_chunked_apply_callback_failure_rolls_back_chunk_atomically` | `test_chunked_apply_callback_failure_rolls_back_chunk_atomically` |
| `test_chunked_apply_failure_carries_partial_tree` | `test_chunked_apply_failure_carries_partial_tree` |

Tolerance: exact."""

import random

import pytest
from _torch_jax_state import jax_process_state  # noqa: F401  (the JAX package's native libraries and ledger)

import evolu_tpu.core.merkle as jmerkle
import evolu_tpu.core.types as jt
import evolu_tpu.storage.apply as japply
import evolu_tpu.storage.native as jnative
import evolu_tpu.storage.schema as jschema
from evolu_tpu_torch.core.merkle import merkle_tree_to_string
from evolu_tpu_torch.core.timestamp import receive_timestamp, send_timestamp, timestamp_to_string
from evolu_tpu_torch.core.types import CrdtMessage, Timestamp
from evolu_tpu_torch.storage.apply import apply_messages, apply_messages_sequential
from evolu_tpu_torch.storage.native import native_available, open_database
from evolu_tpu_torch.storage.schema import init_db_model

_DDL = 'CREATE TABLE IF NOT EXISTS "todo" ("id" TEXT PRIMARY KEY, "title" BLOB, "n" BLOB)'


def fresh_db(backend="python"):
    db = open_database(backend=backend)
    init_db_model(db, mnemonic=None)
    db.exec(_DDL)
    return db


def jax_db():
    db = jnative.open_database(backend="python")
    jschema.init_db_model(db, mnemonic=None)
    db.exec(_DDL)
    return db


def dump(db):
    return {
        "todo": db.exec('SELECT * FROM "todo" ORDER BY "id"'),
        "__message": db.exec('SELECT * FROM "__message" ORDER BY "timestamp"'),
    }


def make_contention_workload(n_replicas=64, n_rows=100, writes_per_replica=40, seed=4):
    """Config 4: every replica hammers the same rows; HLC clocks advance
    per replica with receive() merges so counters collide."""
    rng = random.Random(seed)
    base = 1_700_000_000_000
    clocks = [Timestamp(base, 0, f"{i:016x}") for i in range(n_replicas)]
    messages = []
    for step in range(writes_per_replica):
        order = list(range(n_replicas))
        rng.shuffle(order)
        for r in order:
            now = base + (step // 8)
            clocks[r] = send_timestamp(clocks[r], now=now)
            row = f"row{rng.randrange(n_rows)}"
            messages.append(CrdtMessage(timestamp_to_string(clocks[r]), "todo", row,
                                        rng.choice(["title", "n"]), f"r{r}s{step}"))
            if rng.random() < 0.1:
                other = rng.randrange(n_replicas)
                if other != r:
                    clocks[other] = receive_timestamp(clocks[other], clocks[r], now=now)
    return messages


def jax_messages(messages):
    return [jt.CrdtMessage(m.timestamp, m.table, m.row, m.column, m.value) for m in messages]


def lww_oracle(messages):
    winners = {}
    for m in messages:
        cell = (m.table, m.row, m.column)
        cur = winners.get(cell)
        if cur is None or cur.timestamp < m.timestamp:
            winners[cell] = m
    return {cell: m.value for cell, m in winners.items()}


def db_cells(db):
    out = {}
    for row in db.exec_sql_query('SELECT "id", "title", "n" FROM "todo"'):
        for col in ("title", "n"):
            if row[col] is not None:
                out[("todo", row["id"], col)] = row[col]
    return out


def jax_end_state(messages):
    db = jax_db()
    try:
        tree = japply.apply_messages(db, {}, jax_messages(messages))
        return dump(db), jmerkle.merkle_tree_to_string(tree)
    finally:
        db.close()


def test_config4_high_contention_64_replicas_100_rows_matches_jax():
    messages = make_contention_workload()
    oracle = lww_oracle(messages)
    want_dump, want_tree = jax_end_state(messages)
    rng = random.Random(99)
    orders = [list(messages), list(reversed(messages)), rng.sample(messages, len(messages))]
    backends = ["python"] + (["native"] if native_available() else [])
    assert backends == ["python", "native"]
    for backend in backends:
        for order in orders:
            db = fresh_db(backend)
            tree = apply_messages(db, {}, order)
            assert db_cells(db) == oracle
            assert dump(db) == want_dump, backend
            assert merkle_tree_to_string(tree) == want_tree, backend
            db.close()


def test_convergence_under_partitioned_delivery_matches_jax():
    messages = make_contention_workload(n_replicas=8, n_rows=20, writes_per_replica=25)
    oracle = lww_oracle(messages)
    want_dump, want_tree = jax_end_state(messages)
    rng = random.Random(5)
    for trial in range(4):
        order = rng.sample(messages, len(messages))
        db = fresh_db()
        tree = {}
        i = 0
        while i < len(order):
            k = rng.randrange(1, 60)
            tree = apply_messages(db, tree, order[i: i + k])
            i += k
        assert db_cells(db) == oracle, trial
        assert dump(db) == want_dump, trial
        assert merkle_tree_to_string(tree) == want_tree, trial
        db.close()


def test_device_planner_matches_oracle_under_contention():
    from evolu_tpu_torch.ops.merge import plan_batch_device

    messages = make_contention_workload(n_replicas=16, n_rows=10, writes_per_replica=12)
    a = fresh_db()
    with a.transaction():
        apply_messages_sequential(a, {}, messages)
    b = fresh_db()
    apply_messages(b, {}, messages, planner=lambda m, w: plan_batch_device(m, w, device="cpu"))
    assert dump(a) == dump(b) == jax_end_state(messages)[0]
    a.close(), b.close()


def test_config1_two_port_replicas_1k_messages_full_stack(tmp_path):
    """Config 1: two port clients, todo schema, ~1k messages through a
    live port relay; byte-identical SQLite end state on both replicas. (The
    clients' Merkle trees may differ: a re-delivered loser is XORed again,
    ROADMAP queue 3 item 2, in both packages.)"""
    from evolu_tpu_torch.runtime.client import Evolu
    from evolu_tpu_torch.server.relay import RelayServer, RelayStore
    from evolu_tpu_torch.sync.client import connect
    from evolu_tpu_torch.utils.config import Config

    server = RelayServer(RelayStore(str(tmp_path / "relay.db")), device="cpu").start()
    try:
        cfg = Config(sync_url=server.url + "/")
        schema = {"todo": ("title", "n")}
        a = Evolu(db_path=str(tmp_path / "a.db"), config=cfg, device="cpu")
        a.update_db_schema(schema)
        connect(a)
        b = Evolu(db_path=str(tmp_path / "b.db"), config=cfg, mnemonic=a.owner.mnemonic, device="cpu")
        b.update_db_schema(schema)
        connect(b)

        rng = random.Random(11)
        ids = []
        for i in range(180):
            client = a if rng.random() < 0.5 else b
            with client.batching():
                ids.append(client.create("todo", {"title": f"t{i}", "n": i}))

        def settle():
            for _ in range(6):
                for c in (a, b):
                    c.sync()
                    c.worker.flush(); c._transport.flush(); c.worker.flush()
        settle()
        for i in range(200):
            client = a if rng.random() < 0.5 else b
            client.update("todo", rng.choice(ids), {"n": 1000 + i})
        settle()

        dump_a = a.db.exec('SELECT * FROM "__message" ORDER BY "timestamp"')
        dump_b = b.db.exec('SELECT * FROM "__message" ORDER BY "timestamp"')
        assert len(dump_a) >= 900
        assert dump_a == dump_b, "replicas not byte-identical"
        assert a.db.exec('SELECT * FROM "todo" ORDER BY "id"') == b.db.exec('SELECT * FROM "todo" ORDER BY "id"')
        a.dispose(), b.dispose()
    finally:
        server.stop()


def test_chunked_apply_matches_single_batch_and_jax():
    from evolu_tpu_torch.storage.apply import apply_messages_chunked

    messages = make_contention_workload(n_replicas=6, n_rows=15, writes_per_replica=20)
    a, b = fresh_db(), fresh_db()
    tree_a = apply_messages(a, {}, messages)
    tree_b = apply_messages_chunked(b, {}, messages, chunk_size=37)
    assert dump(a) == dump(b)
    assert merkle_tree_to_string(tree_a) == merkle_tree_to_string(tree_b)
    j = jax_db()
    try:
        tree_j = japply.apply_messages_chunked(j, {}, jax_messages(messages), chunk_size=37)
        assert dump(j) == dump(b)
        assert jmerkle.merkle_tree_to_string(tree_j) == merkle_tree_to_string(tree_b)
    finally:
        j.close()
    a.close(), b.close()


def test_chunked_apply_callback_failure_rolls_back_chunk_atomically():
    from evolu_tpu_torch.storage.apply import ChunkedApplyError, apply_messages_chunked

    msgs = make_contention_workload(n_replicas=4, n_rows=5, writes_per_replica=5)
    half = len(msgs) // 2
    db = fresh_db()
    calls = []

    def persist_then_crash(tree, n):
        calls.append(n)
        if len(calls) == 2:
            raise RuntimeError("crash before clock persist")

    with pytest.raises(ChunkedApplyError) as ei:
        apply_messages_chunked(db, {}, msgs, chunk_size=half, on_chunk=persist_then_crash)
    err = ei.value
    assert calls == [half, len(msgs)] and err.applied == half
    fresh = fresh_db()
    expect_tree = apply_messages(fresh, {}, msgs[:half])
    assert dump(db) == dump(fresh)
    assert merkle_tree_to_string(err.partial_tree) == merkle_tree_to_string(expect_tree)
    db.close(), fresh.close()


def test_chunked_apply_failure_carries_partial_tree():
    from evolu_tpu_torch.storage.apply import ChunkedApplyError, apply_messages_chunked

    good = make_contention_workload(n_replicas=4, n_rows=5, writes_per_replica=5)
    bad = CrdtMessage("not-a-timestamp", "todo", "r", "title", "x")
    db = fresh_db()
    seen = []
    with pytest.raises(ChunkedApplyError) as ei:
        apply_messages_chunked(db, {}, good + [bad], chunk_size=len(good),
                               on_chunk=lambda tree, n: seen.append(n))
    err = ei.value
    assert seen == [len(good)] and err.applied == len(good)
    fresh = fresh_db()
    expect = apply_messages(fresh, {}, good)
    assert merkle_tree_to_string(err.partial_tree) == merkle_tree_to_string(expect)
    db.close(), fresh.close()
