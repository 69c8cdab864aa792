"""Port parity: the continuous-batching `SyncScheduler` and the batching
`RelayServer`, against the JAX package's.

Each workload of `tests/test_scheduler.py` runs twice on the same traffic:
once through the JAX `SyncScheduler` / `RelayServer(batching=True)` on
its stores, once through the port's on `device="cpu"`. The wire
responses must be byte-identical between the packages (and to the
per-request serve where the workload has one answer a request), and the
`message` and `merkleTree` tables equal, row for row. Port-only cases: a
kernel error, or an error torch raises on the engine pass's device leg,
fails every member of its batch (the relay answers 500) and is never
retried as singletons.

Tolerance: exact everywhere. Every threaded test runs inside its own
time limit (`within`)."""

import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest

import evolu_tpu.server.engine as jengine
import evolu_tpu.server.relay as jrelay
import evolu_tpu.server.scheduler as jsched
import evolu_tpu.sync.client as jclient
import evolu_tpu.sync.protocol as jproto
import evolu_tpu_torch.server.engine as pengine
import evolu_tpu_torch.server.relay as prelay
import evolu_tpu_torch.server.scheduler as psched
import evolu_tpu_torch.sync.client as pclient
import evolu_tpu_torch.sync.protocol as pproto
from evolu_tpu_torch.core.timestamp import timestamp_to_string
from evolu_tpu_torch.core.types import Timestamp
from evolu_tpu_torch.ops.cuda_lib import KernelError

from _torch_port_data import within

BASE = 1_700_000_000_000
FRESH_NODE = "f" * 16  # no message carries it: the own-message exclusion is a no-op
LIMIT_S = 120

JAX = SimpleNamespace(
    proto=jproto, relay=jrelay, sched=jsched, http_post=jclient._http_post,
    engine=lambda store: jengine.BatchReconciler(store),
    scheduler=lambda store, **kw: jsched.SyncScheduler(store, **kw),
    server=lambda store, **kw: jrelay.RelayServer(store, **kw),
    sharded=lambda backend="native", shards=2: jrelay.ShardedRelayStore(shards=shards, backend=backend),
)
PORT = SimpleNamespace(
    proto=pproto, relay=prelay, sched=psched, http_post=pclient._http_post,
    engine=lambda store: pengine.BatchReconciler(store, device="cpu"),
    scheduler=lambda store, **kw: psched.SyncScheduler(store, device="cpu", **kw),
    server=lambda store, **kw: prelay.RelayServer(store, device="cpu", **kw),
    sharded=lambda backend="native", shards=2: prelay.ShardedRelayStore(shards=shards, backend=backend),
)


def _stamps(node, start, n):
    return [timestamp_to_string(Timestamp(BASE + (start + i) * 1000, 0, node)) for i in range(n)]


def _msgs(pkg, node, start, n):
    return tuple(pkg.proto.EncryptedCrdtMessage(t, b"ct-%d" % (start + i))
                 for i, t in enumerate(_stamps(node, start, n)))


def _req(pkg, node, start, n, user, req_node=None):
    return pkg.proto.SyncRequest(_msgs(pkg, node, start, n), user, req_node or node, "{}")


def _post_raw(url, req, proto):
    body = proto.encode_sync_request(req)
    with urllib.request.urlopen(urllib.request.Request(
            url, data=body, headers={"Content-Type": "application/octet-stream"}), timeout=60) as r:
        return r.read()


def _run_threads(workers, timeout=LIMIT_S):
    barrier = threading.Barrier(len(workers))
    errors = []

    def wrap(fn):
        try:
            barrier.wait(timeout=30)
            fn()
        except Exception as e:  # noqa: BLE001 - collected and re-raised
            errors.append(e)

    threads = [threading.Thread(target=wrap, args=(fn,)) for fn in workers]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in threads), "scheduler test thread hung"
    if errors:
        raise errors[0]


def _dump(store):
    stores = store.shards if hasattr(store, "shards") else [store]
    out = []
    for s in stores:
        out.append(s.db.exec_sql_query('SELECT "userId", "timestamp", "content" FROM "message" ORDER BY 1, 2'))
        out.append(s.db.exec_sql_query('SELECT "userId", "merkleTree" FROM "merkleTree" ORDER BY 1'))
    return [[tuple(r.values()) for r in rows] for rows in out]


def _serial(pkg, requests):
    """The per-request serve of `requests` in order on a fresh store of
    `pkg`: the oracle of a workload with one answer a request."""
    oracle = pkg.relay.RelayStore(backend="python")
    try:
        return [pkg.relay.serve_single_request(oracle, r) for r in requests]
    finally:
        oracle.close()


def _both(workload):
    """Run `workload(pkg)` on the JAX package, then on the port, each in its
    time limit; → (jax result, port result)."""
    return within(LIMIT_S, lambda: workload(JAX)), within(LIMIT_S, lambda: workload(PORT))


def _slowed(pkg, store, delay):
    eng = pkg.engine(store)
    orig = eng.run_batch_wire

    def slow(reqs):
        time.sleep(delay)
        return orig(reqs)

    eng.run_batch_wire = slow
    return eng


@pytest.mark.parametrize("backend", ["native", "python"])
def test_32_concurrent_mixed_owners_match_jax(backend):
    """32 concurrent clients, 4 rounds each over two nodes an owner, through
    a batching relay over HTTP (its scheduler injected): responses
    byte-identical to the JAX relay's and to the per-request serve, tables
    equal, in at least 4x fewer engine passes than requests."""
    clients, rounds, per_round = 32, 4, 12
    users = [f"user{i:02d}" for i in range(clients)]
    nodes = [(f"{2 * i + 1:016x}", f"{2 * i + 2:016x}") for i in range(clients)]

    def plan(pkg):
        return {u: [_req(pkg, pair[rnd % 2], rnd * per_round, per_round, u) for rnd in range(rounds)]
                for u, pair in zip(users, nodes)}

    def workload(pkg):
        store = pkg.sharded(backend, shards=4)
        # A coalescing window wide enough that the pass count does not
        # depend on how loaded the host is.
        server = pkg.server(store, scheduler=pkg.scheduler(store, max_wait_s=0.1)).start()
        reqs = plan(pkg)
        results = {u: [None] * rounds for u in users}
        try:
            def client(u):
                def run():
                    for rnd in range(rounds):
                        results[u][rnd] = _post_raw(server.url, reqs[u][rnd], pkg.proto)
                return run

            _run_threads([client(u) for u in users])
            counts = dict(server.scheduler.counts) if pkg is PORT else None
            return results, _dump(store), counts
        finally:
            server.stop()

    (jres, jdump, _), (pres, pdump, counts) = _both(workload)
    assert pres == jres
    assert pdump == jdump
    want = plan(PORT)
    for u in users:
        assert pres[u] == _serial(PORT, want[u]), u
    n = clients * rounds
    assert counts["coalesced"] == n and counts["singles"] == 0 and counts["poisoned_batches"] == 0
    assert counts["batches"] * 4 <= n, counts


def test_duplicate_owner_in_one_batch_matches_jax():
    """A push and a cold pull of one owner in one coalescing window: the
    pull is deferred to a second pass and sees the push's rows, as a
    sequential server answers."""
    user = "dup-owner"

    def workload(pkg):
        store = pkg.sharded()
        sched = pkg.scheduler(store, max_batch=8, max_wait_s=0.3)
        push = _req(pkg, "a" * 16, 0, 6, user)
        pull = pkg.proto.SyncRequest((), user, FRESH_NODE, "{}")
        got = {}
        try:
            def submit(name, req):
                def run():
                    got[name] = sched.submit(req)
                return run

            t1 = threading.Thread(target=submit("push", push))
            t1.start()
            time.sleep(0.05)  # the push is queued first, the window still open
            t2 = threading.Thread(target=submit("pull", pull))
            t2.start()
            t1.join(30), t2.join(30)
            return got, _dump(store), getattr(sched, "counts", None)
        finally:
            sched.stop()
            store.close()

    (jgot, jdump, _), (pgot, pdump, counts) = _both(workload)
    assert pgot == jgot and pdump == jdump
    assert [pgot["push"], pgot["pull"]] == _serial(
        PORT, [_req(PORT, "a" * 16, 0, 6, user), pproto.SyncRequest((), user, FRESH_NODE, "{}")])
    assert counts["batches"] == 2, "the same-owner pair must split across two passes"
    assert [m.timestamp for m in pproto.decode_sync_response(pgot["pull"]).messages] == _stamps("a" * 16, 0, 6)


def test_queue_full_answers_503_with_retry_after_as_jax():
    def workload(pkg):
        store = pkg.sharded()
        sched = pkg.scheduler(store, max_queue=0, retry_after_s=3)
        server = pkg.server(store, scheduler=sched).start()
        try:
            with pytest.raises(urllib.error.HTTPError) as e:
                _post_raw(server.url, _req(pkg, "b" * 16, 0, 3, "bp-user"), pkg.proto)
            with urllib.request.urlopen(server.url + "/ping", timeout=10) as r:
                ping = r.read()
            return e.value.code, e.value.headers["Retry-After"], ping, _dump(store), getattr(sched, "counts", None)
        finally:
            sched.stop()
            server.stop()

    (*jout, _), (*pout, counts) = _both(workload)
    assert pout == jout
    assert pout[:3] == [503, "3", b"ok"]
    assert counts["rejected"] == 1 and counts["batches"] == 0


def test_backoff_recovers_without_data_loss_as_jax():
    """A tiny queue in front of a slowed engine: simultaneous clients
    bounce with 503 and Retry-After, and `_http_post`'s backoff carries
    every message through exactly once."""
    users = [f"bo{i:02d}" for i in range(8)]
    nodes = [f"{i + 0x10:016x}" for i in range(8)]

    def workload(pkg):
        store = pkg.sharded()
        eng = _slowed(pkg, store, 0.05)
        sched = pkg.scheduler(store, engine=eng, max_batch=8, max_queue=2, retry_after_s=0.02)
        server = pkg.server(store, scheduler=sched).start()
        try:
            sched.submit(_req(pkg, "c" * 16, 0, 4, "bo-warm"))

            def client(u, node):
                def run():
                    for rnd in range(2):
                        pkg.http_post(server.url, pkg.proto.encode_sync_request(_req(pkg, node, rnd * 5, 5, u)),
                                      retries=30)
                return run

            _run_threads([client(u, n) for u, n in zip(users, nodes)])
            return _dump(store), getattr(sched, "counts", None)
        finally:
            sched.stop()
            eng.close()
            server.stop()

    (jdump, _), (pdump, counts) = _both(workload)
    assert pdump == jdump
    assert counts["rejected"] > 0, "the tiny queue must have bounced someone"
    assert counts["singles"] == 0 and counts["poisoned_batches"] == 0
    oracle = prelay.RelayStore(backend="python")
    for u, node in zip(users, nodes):
        oracle.add_messages(u, _msgs(PORT, node, 0, 10))
    oracle.add_messages("bo-warm", _msgs(PORT, "c" * 16, 0, 4))
    want = _dump(oracle)
    assert sorted(r for part in pdump[0::2] for r in part) == [(u, t, bytes(c)) for u, t, c in want[0]]
    assert sorted(r for part in pdump[1::2] for r in part) == want[1]


def test_poisoned_batch_retried_as_singletons_as_jax():
    users = [("pz-a", "1" * 16), ("pz-b", "2" * 16), ("pz-c", "3" * 16)]

    def workload(pkg):
        store = pkg.sharded()
        eng = pkg.engine(store)
        orig = eng.run_batch_wire
        state = {"boom": 1}

        def poisoned(reqs):
            if state["boom"]:
                state["boom"] -= 1
                raise RuntimeError("injected failure")
            return orig(reqs)

        eng.run_batch_wire = poisoned
        sched = pkg.scheduler(store, engine=eng, max_batch=8, max_wait_s=0.2)
        got = {}
        try:
            def submit(u, node):
                def run():
                    got[u] = sched.submit(_req(pkg, node, 0, 4, u))
                return run

            _run_threads([submit(u, n) for u, n in users])
            got["after"] = sched.submit(_req(pkg, "4" * 16, 0, 2, "pz-d"))
            return got, _dump(store), dict(getattr(sched, "counts", {}))
        finally:
            sched.stop()
            eng.close()
            store.close()

    (jgot, jdump, _), (pgot, pdump, counts) = _both(workload)
    assert pgot == jgot and pdump == jdump
    for u, node in users:
        assert [pgot[u]] == _serial(PORT, [_req(PORT, node, 0, 4, u)]), u
    assert counts["poisoned_batches"] == 1 and counts["poison_retries"] == len(users)
    assert counts["coalesced"] == 1, "the batch after the poison rides the engine again"


def test_non_canonical_width_prescreens_to_the_host_path_as_jax():
    """A malformed-width timestamp never enters a batch: it dispatches
    alone on the per-request path and fails there, with no side effect;
    a concurrent canonical request succeeds."""
    def workload(pkg):
        store = pkg.sharded()
        sched = pkg.scheduler(store, max_batch=8, max_wait_s=0.2)
        bad = pkg.proto.SyncRequest((pkg.proto.EncryptedCrdtMessage("not-a-timestamp", b"x"),),
                                    "nc-bad", "9" * 16, "{}")
        results = {}

        def submit_bad():
            try:
                sched.submit(bad)
            except Exception as e:  # noqa: BLE001 - the expected failure
                results["bad"] = type(e).__name__
            else:
                results["bad"] = "served"

        def submit_ok():
            results["ok"] = sched.submit(_req(pkg, "8" * 16, 0, 3, "nc-good"))

        try:
            _run_threads([submit_bad, submit_ok])
            return results, _dump(store), getattr(sched, "counts", None)
        finally:
            sched.stop()
            store.close()

    (jres, jdump, _), (pres, pdump, counts) = _both(workload)
    assert pres == jres and pdump == jdump
    assert pres["bad"] != "served"
    assert [pres["ok"]] == _serial(PORT, [_req(PORT, "8" * 16, 0, 3, "nc-good")])
    assert not any(r[0] == "nc-bad" for part in pdump for r in part)
    assert counts["singles"] == 1


def test_stop_drains_inflight_batches_as_jax():
    users = [(f"dr{i}", f"{i + 0x30:016x}") for i in range(6)]

    def workload(pkg):
        store = pkg.sharded()
        eng = _slowed(pkg, store, 0.08)
        sched = pkg.scheduler(store, engine=eng, max_batch=2, max_wait_s=0.0)
        got, errs = {}, []
        try:
            def submit(u, node):
                def run():
                    try:
                        got[u] = sched.submit(_req(pkg, node, 0, 3, u))
                    except Exception as e:  # noqa: BLE001
                        errs.append((u, e))
                return run

            threads = [threading.Thread(target=submit(u, n)) for u, n in users]
            for t in threads:
                t.start()
            time.sleep(0.05)  # all queued; the first slow batch in flight
            sched.stop()  # must drain, not drop
            for t in threads:
                t.join(30)
            with pytest.raises(pkg.sched.SchedulerQueueFull):
                sched.submit(_req(pkg, "7" * 16, 0, 1, "late"))
            return got, errs, _dump(store)
        finally:
            eng.close()
            store.close()

    (jgot, jerrs, jdump), (pgot, perrs, pdump) = _both(workload)
    assert perrs == [] and jerrs == []
    assert pgot == jgot and pdump == jdump and len(pgot) == len(users)


def test_singleton_never_inside_an_open_engine_pass(monkeypatch):
    """A non-batchable request arriving mid-pass is served after the pass,
    never beside it (a write on the shared connection would join the
    pass's open transaction): on the port as on JAX."""
    def workload(pkg):
        store = pkg.sharded()
        eng = pkg.engine(store)
        orig = eng.run_batch_wire
        in_pass = threading.Event()

        def slow(reqs):
            in_pass.set()
            try:
                time.sleep(0.15)
                return orig(reqs)
            finally:
                in_pass.clear()

        eng.run_batch_wire = slow
        orig_serve = pkg.relay.serve_single_request
        overlap = []

        def spying_serve(store_, request):
            overlap.append(in_pass.is_set())
            return orig_serve(store_, request)

        monkeypatch.setattr(pkg.relay, "serve_single_request", spying_serve)
        sched = pkg.scheduler(store, engine=eng, max_batch=4, max_wait_s=0.0)
        bad = pkg.proto.SyncRequest((pkg.proto.EncryptedCrdtMessage("short", b"x"),), "ser-bad", "6" * 16, "{}")
        outcome = {}
        try:
            t1 = threading.Thread(target=lambda: outcome.setdefault(
                "ok", sched.submit(_req(pkg, "5" * 16, 0, 2, "ser-ok"))))
            t1.start()
            in_pass.wait(10)  # the engine pass is open now

            def submit_bad():
                try:
                    sched.submit(bad)
                except Exception as e:  # noqa: BLE001 - the expected failure
                    outcome["bad"] = type(e).__name__

            t2 = threading.Thread(target=submit_bad)
            t2.start()
            t1.join(30), t2.join(30)
            return overlap, outcome, _dump(store)
        finally:
            sched.stop()
            eng.close()
            store.close()

    jout, pout = _both(workload)
    assert pout == jout
    assert pout[0] == [False], "the singleton ran while an engine pass was open"


def test_kernel_error_fails_the_batch_with_500_and_no_singleton(monkeypatch):
    """Port only: a kernel error raised inside the engine pass is no
    poison. Every member of the batch gets a 500, nothing is stored, and
    no singleton retry serves them on the host path."""
    def broken(*_a, **_kw):
        raise KernelError("evolu_tpu_torch: seg_xor_scan launch failed: cudaError_t 700")

    monkeypatch.setattr(pengine, "deltas_dispatch", broken)
    users = [(f"ke{i}", f"{i + 0x40:016x}") for i in range(3)]

    def run():
        store = prelay.RelayStore(backend="native")
        server = prelay.RelayServer(store, scheduler=psched.SyncScheduler(
            store, device="cpu", max_batch=8, max_wait_s=0.2)).start()
        codes = {}
        try:
            def post(u, node):
                def go():
                    try:
                        _post_raw(server.url, _req(PORT, node, 0, 3, u), pproto)
                        codes[u] = 200
                    except urllib.error.HTTPError as e:
                        codes[u] = e.code
                return go

            _run_threads([post(u, n) for u, n in users])
            with urllib.request.urlopen(server.url + "/stats", timeout=10) as r:
                stats = r.read()
            return codes, dict(server.scheduler.counts), _dump(store), stats
        finally:
            server.stop()

    codes, counts, dump, stats = within(LIMIT_S, run)
    assert codes == {u: 500 for u, _ in users}
    assert counts["singles"] == 0 and counts["poison_retries"] == 0 and counts["poisoned_batches"] == 0
    assert counts["batches"] >= 1 and counts["coalesced"] == 0
    assert dump == [[], []]
    assert b'"errors_total": 3' in stats


# Where torch raises on the device leg of an engine pass → (the engine
# name the fault is injected at, the store backend). Every request spreads
# its rows over one minute each, so the compact outputs overflow their cap
# and the full-width rerun runs (and pulls) on the dispatcher thread.
DEVICE_FAULTS = {
    "upload": ("columns_to_device", "native"),  # a sticky CUDA error from .to(device)
    "overflow rerun pull": ("to_host_many", "native"),  # the streaming path's rerun
    "one-shot pull": ("to_host_many", "python"),  # reconcile_wire on a Python store
}


@pytest.mark.parametrize("fault", list(DEVICE_FAULTS))
def test_device_fault_fails_the_batch_with_no_singleton(fault, monkeypatch):
    """Port only: an error torch raises on the device leg of an engine pass
    (here an out-of-memory) leaves the engine as a KernelError, so it is no
    poison either: every member of the batch fails, nothing is stored, and
    no singleton retry serves the requests on the host path."""
    import torch

    name, backend = DEVICE_FAULTS[fault]

    def broken(*_a, **_kw):
        raise torch.OutOfMemoryError("CUDA out of memory (injected)")

    monkeypatch.setattr(pengine, name, broken)
    users = [(f"df{i}", f"{i + 0x50:016x}") for i in range(3)]

    def request(user, node):
        msgs = tuple(PORT.proto.EncryptedCrdtMessage(
            timestamp_to_string(Timestamp(BASE + i * 60_000, 0, node)), b"ct-%d" % i) for i in range(30))
        return PORT.proto.SyncRequest(msgs, user, node, "{}")

    def run():
        store = prelay.RelayStore(backend=backend)
        sched = psched.SyncScheduler(store, device="cpu", max_batch=8, max_wait_s=0.2)
        errors = {}
        try:
            def submit(u, node):
                def go():
                    try:
                        sched.submit(request(u, node))
                    except Exception as e:  # noqa: BLE001 - the outcome under test
                        errors[u] = e
                return go

            _run_threads([submit(u, n) for u, n in users])
            return errors, dict(sched.counts), _dump(store)
        finally:
            sched.stop()
            store.close()

    errors, counts, dump = within(LIMIT_S, run)
    assert sorted(errors) == sorted(u for u, _ in users)
    for e in errors.values():
        assert isinstance(e, KernelError) and isinstance(e.__cause__, torch.OutOfMemoryError), repr(e)
    assert counts["singles"] == 0 and counts["poison_retries"] == 0 and counts["poisoned_batches"] == 0
    assert counts["batches"] >= 1 and counts["coalesced"] == 0
    assert dump == [[], []]


def test_batching_without_a_card_raises_at_construction():
    """No card and no device="cpu": the scheduler and a batching relay
    raise when they are made, not at the first batch."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    store = prelay.RelayStore(backend="native")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        psched.SyncScheduler(store)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prelay.RelayServer(store, batching=True)
    assert _dump(store) == [[], []]
    store.close()


def test_counts_lose_no_update_under_thread_switches():
    """The engine's route `counts` (bumped by every engine in the process)
    and a scheduler's `counts` (bumped by handler threads and the
    dispatcher) take a lock: 16 threads with a tiny switch interval lose
    no increment."""
    import sys

    store = prelay.RelayStore(backend="native")
    sched = psched.SyncScheduler(store, device="cpu", max_queue=0)
    before = pengine.counts["host_owners"]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                pengine._count("host_owners")
                try:
                    sched.submit(_req(PORT, "9" * 16, 0, 1, "busy"))
                except psched.SchedulerQueueFull:
                    pass

        within(LIMIT_S, lambda: _run_threads([work] * 16))
    finally:
        sys.setswitchinterval(interval)
        sched.stop()
        store.close()
    assert pengine.counts["host_owners"] - before == 16 * 2000
    assert sched.counts["rejected"] == 16 * 2000
