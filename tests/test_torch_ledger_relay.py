"""Port parity: the conservation ledger's stations on the relay, the
engine, the scheduler, write-behind and the client's apply, the twins of
tests/test_ledger.py's relay-level tests.

Each test runs one episode on a JAX relay and on a port relay (its
engine passes on `device="cpu"`) over the same seeded requests, and
demands the reference's checks on the port's ledger and exactly equal
station totals in both packages. Where timing decides a count (none of
these episodes), only the equations would be compared. The negative test
mis-wires `_ledger_store_apply` in each package and demands the same
violation.

Tolerance: exact everywhere."""

import json
import types
import urllib.error
import urllib.request

import pytest
from _torch_jax_state import jax_process_state  # noqa: F401  (the JAX package's native libraries and ledger)

import evolu_tpu.obs.ledger as jledger
import evolu_tpu.obs.metrics as jmetrics
import evolu_tpu.server.engine as jengine
import evolu_tpu.server.relay as jrelay
import evolu_tpu.server.scheduler as jsched
import evolu_tpu.sync.protocol as jproto
import evolu_tpu_torch.obs.ledger as pledger
import evolu_tpu_torch.obs.metrics as pmetrics
import evolu_tpu_torch.server.engine as pengine
import evolu_tpu_torch.server.relay as prelay
import evolu_tpu_torch.server.scheduler as psched
import evolu_tpu_torch.sync.protocol as pproto
from evolu_tpu_torch.core.timestamp import Timestamp, timestamp_to_string

BASE = 1700000000000

JAX = types.SimpleNamespace(name="jax", relay=jrelay, engine=jengine, sched=jsched, proto=jproto,
                            ledger=jledger, metrics=jmetrics, extra={})
PORT = types.SimpleNamespace(name="port", relay=prelay, engine=pengine, sched=psched, proto=pproto,
                             ledger=pledger, metrics=pmetrics, extra={"device": "cpu"})
PKGS = (JAX, PORT)


def setup_function(_fn):
    for pkg in PKGS:
        pkg.ledger.reset()
        pkg.ledger.set_enabled(True)
    pmetrics.reset()


def _ts(i, node="89e3b4f11a2c5d70"):
    return timestamp_to_string(Timestamp(BASE + i * 1000, 0, node))


def _sync_req(pkg, user, node, n_msgs, start=0, ts_list=None, tree="{}"):
    stamps = ts_list if ts_list is not None else [_ts(start + i, node) for i in range(n_msgs)]
    msgs = tuple(pkg.proto.EncryptedCrdtMessage(t, b"ct-%d" % i) for i, t in enumerate(stamps))
    return pkg.proto.SyncRequest(msgs, user, node, tree)


def _post(pkg, url, req, expect_error=None):
    body = pkg.proto.encode_sync_request(req)
    try:
        r = urllib.request.urlopen(
            urllib.request.Request(url, data=body, headers={"Content-Type": "application/octet-stream"}),
            timeout=30)
        return r.read()
    except urllib.error.HTTPError as e:
        if expect_error is not None and e.code == expect_error:
            return None
        raise


def _get_json(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read().decode("utf-8"))


def _server(pkg, store, **kw):
    return pkg.relay.RelayServer(store, **kw, **pkg.extra).start()


def _both(episode):
    """The episode on the JAX package, then on the port, each from a reset
    ledger → {name: (totals, episode result)}; the port's station totals
    must equal the JAX package's."""
    out = {}
    for pkg in PKGS:
        pkg.ledger.reset()
        res = episode(pkg)
        out[pkg.name] = (pkg.ledger.totals(), res)
    assert out["port"][0] == out["jax"][0]
    return out


def test_per_request_relay_conserves_and_classifies_like_jax():
    def episode(pkg):
        server = _server(pkg, pkg.relay.ShardedRelayStore(shards=2))
        try:
            _post(pkg, server.url, _sync_req(pkg, "alice", "a" * 16, 3))
            _post(pkg, server.url, _sync_req(pkg, "alice", "a" * 16, 3))  # exact redelivery
            _post(pkg, server.url, _sync_req(pkg, "bob", "b" * 16, 2, start=50))
            _post(pkg, server.url, _sync_req(pkg, "carol", "c" * 16, 0))  # pull-only
            return pkg.ledger.ledger.owner_totals("alice"), pkg.ledger.audit()
        finally:
            server.stop()

    out = _both(episode)
    t, (alice, violations) = out["port"]
    assert t[pledger.INGRESS_SYNC] == 8
    assert t[pledger.STORE_INSERTED] == 5
    assert t[pledger.STORE_DUPLICATE] == 3
    assert violations == []
    assert alice == {pledger.INGRESS_SYNC: 6, pledger.STORE_INSERTED: 3, pledger.STORE_DUPLICATE: 3}
    assert alice == out["jax"][1][0]


def test_batching_relay_conserves_across_engine_pass_like_jax():
    def episode(pkg):
        server = _server(pkg, pkg.relay.ShardedRelayStore(shards=2), batching=True)
        try:
            _post(pkg, server.url, _sync_req(pkg, "alice", "a" * 16, 4))
            _post(pkg, server.url, _sync_req(pkg, "bob", "b" * 16, 3, start=50))
            _post(pkg, server.url, _sync_req(pkg, "alice", "a" * 16, 4))  # redelivery
            return pkg.ledger.audit()
        finally:
            server.stop()

    out = _both(episode)
    t, violations = out["port"]
    assert t[pledger.INGRESS_SYNC] == 11
    assert t[pledger.STORE_INSERTED] == 7
    assert t[pledger.STORE_DUPLICATE] == 4
    assert violations == []


def test_non_canonical_batch_routes_singleton_and_conserves_like_jax():
    """A 45-character timestamp (a 3-digit counter): the scheduler serves
    the request alone, the bounce tally records it, and the singleton's
    500 classifies every message as reject.invalid."""
    def episode(pkg):
        server = _server(pkg, pkg.relay.RelayStore(), batching=True)
        try:
            req = _sync_req(pkg, "nc-owner", "d" * 16, 0,
                            ts_list=[_ts(1, "d" * 16), "1970-01-01T00:00:00.001Z-001-deadbeefdeadbeef"])
            return _post(pkg, server.url, req, expect_error=500), pkg.ledger.audit()
        finally:
            server.stop()

    out = _both(episode)
    t, (answer, violations) = out["port"]
    assert answer is None and out["jax"][1][0] is None
    assert t[pledger.BOUNCE_NON_CANONICAL] == 2
    assert t[pledger.INGRESS_SYNC] == 2
    assert t[pledger.REJECT_INVALID] == 2
    assert t.get(pledger.STORE_INSERTED, 0) == 0
    assert violations == []


def test_scheduler_poison_retry_does_not_double_count_like_jax(monkeypatch):
    state = {}

    def episode(pkg):
        orig = pkg.engine.BatchReconciler.run_batch_wire
        state[pkg.name] = 0

        def flaky(self, requests):
            if state[pkg.name] == 0:
                state[pkg.name] += 1
                raise RuntimeError("injected poison")
            return orig(self, requests)

        monkeypatch.setattr(pkg.engine.BatchReconciler, "run_batch_wire", flaky)
        server = _server(pkg, pkg.relay.RelayStore(), batching=True)
        try:
            _post(pkg, server.url, _sync_req(pkg, "alice", "a" * 16, 3))
            return pkg.metrics.get_counter("evolu_sched_poisoned_batches_total"), pkg.ledger.audit()
        finally:
            server.stop()
            monkeypatch.setattr(pkg.engine.BatchReconciler, "run_batch_wire", orig)

    out = _both(episode)
    assert state == {"jax": 1, "port": 1}, "injected poison never fired"
    t, (poisoned, violations) = out["port"]
    assert poisoned >= 1
    # Exactly once despite the failed engine pass and the singleton retry.
    assert t[pledger.INGRESS_SYNC] == 3
    assert t[pledger.STORE_INSERTED] == 3
    assert t.get(pledger.STORE_DUPLICATE, 0) == 0
    assert violations == []


def test_backpressure_shed_is_a_terminal_like_jax():
    def episode(pkg):
        store = pkg.relay.RelayStore()
        kw = {"device": "cpu"} if pkg is PORT else {}
        sched = pkg.sched.SyncScheduler(store, max_queue=0, **kw)  # every submit sheds
        server = pkg.relay.RelayServer(store, scheduler=sched).start()
        try:
            answer = _post(pkg, server.url, _sync_req(pkg, "alice", "a" * 16, 4), expect_error=503)
            return answer, pkg.ledger.audit(), pkg.metrics.get_counter("evolu_relay_backpressure_total")
        finally:
            server.stop()

    out = _both(episode)
    t, (answer, violations, shed) = out["port"]
    assert answer is None
    assert t[pledger.INGRESS_SYNC] == 4
    assert t[pledger.SHED_BACKPRESSURE] == 4
    assert violations == []
    assert shed == 1


def test_relay_500_is_a_reject_terminal_like_jax(monkeypatch):
    def episode(pkg):
        store = pkg.relay.RelayStore()

        def boom(request):
            raise RuntimeError("injected serve failure")

        server = _server(pkg, store)
        monkeypatch.setattr(store, "sync_wire", boom, raising=False)
        monkeypatch.setattr(store, "sync", boom)
        try:
            return _post(pkg, server.url, _sync_req(pkg, "alice", "a" * 16, 2), expect_error=500), \
                pkg.ledger.audit()
        finally:
            server.stop()

    out = _both(episode)
    t, (answer, violations) = out["port"]
    assert answer is None
    assert t[pledger.INGRESS_SYNC] == 2
    assert t[pledger.REJECT_INVALID] == 2
    assert violations == []


def test_commit_then_raise_serve_posts_single_terminal_like_jax():
    """A serve that commits add_messages and then fails before answering
    (a garbage client tree, parsed after the insert) posts ONE terminal,
    the 500's reject.invalid; the retry classifies the committed row as a
    duplicate."""
    def episode(pkg):
        server = _server(pkg, pkg.relay.RelayStore())
        try:
            req = _sync_req(pkg, "ctr-owner", "a" * 16, 1, tree="not-a-merkle-tree")
            answer = _post(pkg, server.url, req, expect_error=500)
            mid = dict(pkg.ledger.totals()), pkg.ledger.audit()
            _post(pkg, server.url, _sync_req(pkg, "ctr-owner", "a" * 16, 1))
            return answer, mid, pkg.ledger.audit()
        finally:
            server.stop()

    out = _both(episode)
    t, (answer, (mid, mid_violations), violations) = out["port"]
    assert answer is None
    assert mid[pledger.INGRESS_SYNC] == 1 and mid[pledger.REJECT_INVALID] == 1
    assert mid.get(pledger.STORE_INSERTED, 0) == 0 and mid_violations == []
    assert mid == out["jax"][1][1][0]
    assert t[pledger.STORE_DUPLICATE] == 1
    assert violations == []


def test_non_canonical_store_fallback_classifies_once_like_jax():
    """A malformed STORED timestamp bounces the fused wire path to the
    object path, which re-runs add_messages: the serve scope's first-wins
    latch keeps one set of terminals a request."""
    def episode(pkg):
        store = pkg.relay.RelayStore()
        server = _server(pkg, store)
        try:
            _post(pkg, server.url, _sync_req(pkg, "fb-owner", "a" * 16, 2))
            store.db.run('INSERT INTO "message" ("timestamp", "userId", "content") VALUES (?, ?, ?)',
                         ("1970-01-01T00:00:00.009Z-001-aaaaaaaaaaaaaaaa", "fb-owner", b"bad"))
            base = dict(pkg.ledger.totals())
            _post(pkg, server.url, _sync_req(pkg, "fb-owner", "b" * 16, 1, start=90))
            t = pkg.ledger.totals()
            new_terms = sum(t.get(s, 0) - base.get(s, 0) for s in (pledger.STORE_INSERTED, pledger.STORE_DUPLICATE))
            return new_terms, pkg.ledger.audit()
        finally:
            server.stop()

    out = _both(episode)
    _t, (new_terms, violations) = out["port"]
    assert new_terms == 1, f"fallback double-classified: {new_terms}"
    assert violations == []


def test_miswired_route_is_caught_by_the_audit_like_jax(monkeypatch):
    """THE negative test: silence the object store path's terminals and the
    audit names server-flow with the ingressed messages as its delta, in
    both packages alike."""
    def episode(pkg):
        monkeypatch.setattr(pkg.relay, "_ledger_store_apply", lambda *_a, **_kw: None)
        server = _server(pkg, pkg.relay.RelayStore())
        try:
            _post(pkg, server.url, _sync_req(pkg, "alice", "a" * 16, 3))
            return pkg.ledger.audit()
        finally:
            server.stop()

    out = _both(episode)
    violations = out["port"][1]
    assert violations, "audit missed the silenced store route"
    v = violations[0]
    assert v["equation"] == "server-flow"
    assert v["delta"] == 3  # 3 ingressed, 0 reached a terminal
    assert v["lhs"][pledger.INGRESS_SYNC] == 3
    assert violations == out["jax"][1]


def test_write_behind_queue_balances_at_drain_barrier_like_jax(tmp_path):
    def episode(pkg):
        d = tmp_path / pkg.name
        d.mkdir()
        server = _server(pkg, pkg.relay.ShardedRelayStore(str(d / "wb.db"), shards=2), write_behind=True,
                         write_behind_log=str(d / "wb.wblog"))
        try:
            _post(pkg, server.url, _sync_req(pkg, "alice", "a" * 16, 5))
            _post(pkg, server.url, _sync_req(pkg, "bob", "b" * 16, 3, start=50))
            _post(pkg, server.url, _sync_req(pkg, "alice", "a" * 16, 5))  # redelivery
            server.write_behind.flush()
            audit = pkg.ledger.audit(at_barrier=True)
            # GET /ledger runs the audit under the drain barrier itself.
            return audit, _get_json(server.url + "/ledger")
        finally:
            server.stop()

    out = _both(episode)
    t, (violations, payload) = out["port"]
    assert t[pledger.WB_QUEUED] == t[pledger.WB_DRAINED] == 13
    assert t[pledger.INGRESS_SYNC] == 13
    assert t[pledger.STORE_INSERTED] + t[pledger.STORE_DUPLICATE] == 13
    assert t[pledger.STORE_INSERTED] == 8
    assert violations == []
    assert payload["violations"] == []
    assert payload["stations"][pledger.WB_QUEUED] == 13
    assert set(payload) == set(out["jax"][1][1])


def test_ledger_endpoint_and_stats_section_like_jax():
    def episode(pkg):
        server = _server(pkg, pkg.relay.RelayStore())
        try:
            _post(pkg, server.url, _sync_req(pkg, "alice", "a" * 16, 2))
            return _get_json(server.url + "/ledger"), _get_json(server.url + "/stats")
        finally:
            server.stop()

    out = _both(episode)
    _t, (payload, stats) = out["port"]
    jpayload, jstats = out["jax"][1]
    assert payload["stations"][pledger.INGRESS_SYNC] == 2
    assert payload["owners"]["alice"][pledger.STORE_INSERTED] == 2
    assert payload["violations"] == []
    assert any(e["name"] == "server-flow" for e in payload["equations"])
    assert payload == jpayload
    assert stats["ledger"]["stations"][pledger.INGRESS_SYNC] == 2
    assert stats["ledger"]["violations"] == []
    assert stats["ledger"] == jstats["ledger"]


def test_client_apply_plane_conserves_like_jax():
    from evolu_tpu.runtime.client import create_evolu as jcreate
    from evolu_tpu_torch.runtime.client import create_evolu as pcreate

    def episode(pkg):
        evolu = jcreate({"todo": ("title", "isCompleted")}) if pkg is JAX else \
            pcreate({"todo": ("title", "isCompleted")}, device="cpu")
        try:
            for i in range(5):
                evolu.create("todo", {"title": f"t{i}", "isCompleted": False})
            evolu.worker.flush()
            return pkg.ledger.audit()
        finally:
            evolu.dispose()

    out = _both(episode)
    t, violations = out["port"]
    assert t[pledger.APPLY_INGRESS] >= 10  # 2 columns x 5 rows
    routed = sum(t.get(s, 0) for s in (pledger.ROUTE_PACKED, pledger.ROUTE_OBJECT, pledger.ROUTE_SEQUENTIAL))
    assert routed == t[pledger.APPLY_INGRESS]
    assert violations == []


@pytest.mark.parametrize("backend", ["python", "native"])
def test_apply_rollback_counts_rejected_like_jax(backend):
    import evolu_tpu.core.types as jtypes
    import evolu_tpu.storage as jstorage
    import evolu_tpu_torch.core.types as ptypes
    import evolu_tpu_torch.storage as pstorage

    mnemonic = "legal winner thank year wave sausage worth useful legal winner thank yellow"

    def episode(pkg):
        storage, types_ = (jstorage, jtypes) if pkg is JAX else (pstorage, ptypes)
        db = storage.open_database(":memory:", backend)
        storage.init_db_model(db, mnemonic)
        storage.update_db_schema(db, [types_.TableDefinition.of("todo", ["title"])])
        bad = [types_.CrdtMessage(_ts(1), "todo", "r1", "title", "x"),
               types_.CrdtMessage("not-a-timestamp", "todo", "r1", "title", "y")]
        with pytest.raises(Exception):
            storage.apply_messages(db, {}, bad)
        return pkg.ledger.audit()

    out = _both(episode)
    t, violations = out["port"]
    assert t[pledger.APPLY_INGRESS] == 2
    assert t[pledger.APPLY_REJECTED] == 2
    assert violations == []
