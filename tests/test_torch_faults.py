"""Port twin of `tests/test_faults.py`: failure detection and fault
injection on port objects (`device="cpu"`), at the reference tests' own
sizes — livelock surfacing as `SyncError`, convergence under a flaky
transport, thread safety under concurrent mutators, a whole-batch
rollback on a poisoned message (both storage backends), and the
reconnect probe's immediate round after a partition heals. The rollback
episode runs the JAX package's apply on the same batch beside the port's.

| JAX test | port test |
|---|---|
| `test_sync_livelock_raises_sync_error` | `test_sync_livelock_raises_sync_error` |
| `test_convergence_with_flaky_transport` | `test_convergence_with_flaky_transport` |
| `test_concurrent_mutators_thread_safety` | `test_concurrent_mutators_thread_safety` |
| `test_transaction_rollback_on_mid_batch_failure` | `test_transaction_rollback_on_mid_batch_failure_as_jax` |
| `test_reconnect_probe_fires_immediate_sync` | `test_reconnect_probe_fires_immediate_sync` (and `tests/test_torch_sync_client.py::test_offline_then_reconnect_probe_matches_jax`, the transport's event order against JAX's) |

Tolerance: exact."""

import os
import random
import threading

import pytest

from _torch_jax_state import jax_process_state  # noqa: F401  (the JAX package's native libraries and ledger)

from evolu_tpu_torch.core.types import SyncError
from evolu_tpu_torch.runtime.client import Evolu, create_evolu
from evolu_tpu_torch.server.relay import RelayServer, RelayStore
from evolu_tpu_torch.sync import client as sync_client
from evolu_tpu_torch.utils.config import Config


def test_sync_livelock_raises_sync_error():
    """A server diff identical to previous_diff must surface SyncError
    (receive.ts:99-104, types.ts:371-378) instead of looping forever."""
    evolu = create_evolu({"todo": ("title",)}, device="cpu")
    try:
        errors = []
        evolu.subscribe_error(errors.append)
        evolu.create("todo", {"title": "x"})
        evolu.worker.flush()

        # A server tree that differs from ours (empty) produces a diff D.
        # Replaying the same response with previous_diff=D simulates the
        # server still diverged at the same minute => livelock.
        from evolu_tpu_torch.core.merkle import (
            create_initial_merkle_tree,
            diff_merkle_trees,
            insert_into_merkle_tree,
            merkle_tree_to_string,
        )
        from evolu_tpu_torch.core.types import Timestamp

        server_tree = insert_into_merkle_tree(
            Timestamp(1_700_000_000_000, 0, "b" * 16), create_initial_merkle_tree()
        )
        from evolu_tpu_torch.storage.clock import read_clock

        local = read_clock(evolu.db).merkle_tree
        diff = diff_merkle_trees(server_tree, local)
        assert diff is not None

        evolu.receive((), merkle_tree_to_string(server_tree), previous_diff=diff)
        evolu.worker.flush()
        assert errors and isinstance(errors[0], SyncError)
    finally:
        evolu.dispose()


def test_convergence_with_flaky_transport(tmp_path):
    """30% of HTTP posts fail (connection errors): clients stay up
    (offline tolerance, sync.worker.ts:217-227) and converge once
    enough rounds get through."""
    server = RelayServer(RelayStore(str(tmp_path / "relay.db")), device="cpu").start()
    try:
        cfg = Config(sync_url=server.url + "/")
        rng = random.Random(17)
        real_post = sync_client._http_post

        def flaky_post(url, body):
            if rng.random() < 0.3:
                raise OSError("injected network failure")
            return real_post(url, body)

        def mk(path, mnemonic=None):
            e = Evolu(db_path=str(tmp_path / path), config=cfg, mnemonic=mnemonic, device="cpu")
            e.update_db_schema({"todo": ("title",)})
            t = sync_client.SyncTransport(
                cfg, on_receive=e.receive, sync_lock=e.worker.sync_lock,
                http_post=flaky_post,
            )
            e.attach_transport(t)
            return e, t

        a, ta = mk("a.db")
        b, tb = mk("b.db", a.owner.mnemonic)
        for i in range(30):
            (a if i % 2 else b).create("todo", {"title": f"t{i}"})

        # Injected failures make any fixed round count probabilistic:
        # poll until both replicas converge (or a generous deadline).
        import time as _time

        deadline = _time.time() + 60
        while _time.time() < deadline:
            for c, t in ((a, ta), (b, tb)):
                c.sync()
                c.worker.flush(); t.flush(); c.worker.flush()
            rows_a = a.db.exec('SELECT * FROM "__message" ORDER BY "timestamp"')
            rows_b = b.db.exec('SELECT * FROM "__message" ORDER BY "timestamp"')
            if len(rows_a) == len(rows_b) == 90 and rows_a == rows_b:
                break
        assert len(rows_a) == len(rows_b) == 90  # 30 creates x 3 columns
        assert rows_a == rows_b
        a.dispose(), b.dispose()
    finally:
        server.stop()


def test_concurrent_mutators_thread_safety():
    """16 threads hammer one client: every mutation must land exactly
    once and the worker's single-writer discipline must hold."""
    evolu = create_evolu({"todo": ("title", "n")}, device="cpu")
    try:
        n_threads, per_thread = 16, 25
        errors = []
        evolu.subscribe_error(errors.append)

        def writer(t):
            for i in range(per_thread):
                evolu.create("todo", {"title": f"t{t}-{i}", "n": t * 1000 + i})

        threads = [threading.Thread(target=writer, args=(t,)) for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        evolu.worker.flush()

        rows = evolu.query_once('SELECT "title" FROM "todo"')
        assert len(rows) == n_threads * per_thread
        assert len({r["title"] for r in rows}) == n_threads * per_thread
        assert not errors, errors[:3]
    finally:
        evolu.dispose()


def test_transaction_rollback_on_mid_batch_failure_as_jax():
    """A batch containing a poisoned message rolls back whole (the
    reference's per-command dbTransaction): no partial rows, no partial
    __message, on both backends, and the JAX package raises and rolls
    back the same batch alike."""
    import evolu_tpu.core.types as jt
    import evolu_tpu.storage.apply as japply
    import evolu_tpu.storage.native as jnative
    import evolu_tpu.storage.schema as jschema
    from evolu_tpu_torch.core.types import CrdtMessage
    from evolu_tpu_torch.storage.apply import apply_messages
    from evolu_tpu_torch.storage.native import open_database
    from evolu_tpu_torch.storage.schema import init_db_model

    good = ("2024-01-01T00:00:00.000Z-0000-" + "a" * 16, "todo", "r1", "title", "ok")
    bad = ("garbage-timestamp", "todo", "r2", "title", "boom")
    raised = []
    for pkg, open_db, init, apply, msg in (
            ("port", open_database, init_db_model, apply_messages, CrdtMessage),
            ("jax", jnative.open_database, jschema.init_db_model, japply.apply_messages, jt.CrdtMessage)):
        for backend in ("python", "native"):
            db = open_db(backend=backend)
            init(db, mnemonic=None)
            db.exec('CREATE TABLE "todo" ("id" TEXT PRIMARY KEY, "title" BLOB)')
            with pytest.raises(Exception) as ei:
                apply(db, {}, [msg(*good), msg(*bad)])
            raised.append((backend, type(ei.value).__name__))
            assert db.exec('SELECT COUNT(*) FROM "__message"') == [(0,)], (pkg, backend)
            assert db.exec('SELECT COUNT(*) FROM "todo"') == [(0,)], (pkg, backend)
            db.close()
    assert raised[:2] == raised[2:]


def test_reconnect_probe_fires_immediate_sync(tmp_path):
    """Partition, mutate (push swallowed), heal — WITHOUT any manual or
    interval sync, the transport's /ping probe must notice the healed
    network, fire the app reconnect hook, and run an immediate round
    that lands the pending state on the relay (the reference re-syncs
    on online/focus/visibilitychange, db.ts:390-412)."""
    import time


    server = RelayServer(RelayStore(str(tmp_path / "relay.db")), device="cpu").start()
    try:
        cfg = Config(sync_url=server.url + "/", reconnect_probe_interval=0.05)
        partitioned = threading.Event()
        real_post, real_ping = sync_client._http_post, sync_client._http_ping

        def post(url, body):
            if partitioned.is_set():
                raise OSError("partitioned")
            return real_post(url, body)

        def probe(url):
            if partitioned.is_set():
                raise OSError("partitioned")
            real_ping(url)

        a = Evolu(db_path=str(tmp_path / "a.db"), config=cfg, device="cpu")
        a.update_db_schema({"todo": ("title",)})
        reconnects = []
        a.subscribe_reconnect(lambda: reconnects.append(True))

        def on_reconnect():
            a._fire_reconnect()
            a.sync(refresh_queries=False)

        ta = sync_client.SyncTransport(
            cfg, on_receive=a.receive, sync_lock=a.worker.sync_lock,
            http_post=post, http_probe=probe, on_reconnect=on_reconnect,
        )
        a.attach_transport(ta)

        partitioned.set()
        a.create("todo", {"title": "offline-born"})
        a.worker.flush()
        ta.flush()
        assert not reconnects  # swallowed, still offline

        # Heal. The probe (50ms cadence) must do the rest on its own.
        partitioned.clear()
        deadline = time.time() + 10
        while time.time() < deadline and not reconnects:
            time.sleep(0.02)
        assert reconnects, "reconnect hook never fired after heal"

        # The immediate round must push the offline-born mutation: a
        # fresh replica of the same owner pulls it from the relay.
        b = Evolu(db_path=str(tmp_path / "b.db"), config=cfg, mnemonic=a.owner.mnemonic, device="cpu")
        b.update_db_schema({"todo": ("title",)})
        tb = sync_client.SyncTransport(
            cfg, on_receive=b.receive, sync_lock=b.worker.sync_lock,
        )
        b.attach_transport(tb)
        deadline = time.time() + 10
        rows = []
        while time.time() < deadline:
            b.sync()
            b.worker.flush(); tb.flush(); b.worker.flush()
            rows = b.db.exec('SELECT "title" FROM "todo"')
            if rows:
                break
        assert rows == [("offline-born",)]
        a.dispose(), b.dispose()
    finally:
        server.stop()
