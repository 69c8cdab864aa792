"""Port parity: the relay tier's trace legs and ledger stations across a
two-relay fleet, the twins of tests/test_trace.py's fleet episodes.

- The acceptance episode: one client mutation drives forward routing →
  the scheduler's coalesced engine pass → gossip, and ONE trace id
  covers every hop on both relays (`fleet.forward` → `fleet.forward.serve`
  → `sched.queue` / `engine.batch` → `relay.respond`, then `repl.round`,
  its `repl.summary` / `repl.pull` legs, the peer's `repl.serve` and
  `repl.ingest`), with the responses and SQLite end state byte-identical
  to an untraced per-request oracle, and the convergence plane's
  freshness gauge and write-visible exemplar on the pulling replica.
- The redirect leg: the 307 bounce and the authoritative serve land in
  the mutation's trace.

Each episode runs on port relays (their engines on `device="cpu"`) and
on JAX relays; the hop names each package records must be the same, and
the ledger's forward stations (`egress.forward` at the forwarding relay,
`ingress.forward` at the target) must equal the messages forwarded in
both. Counts that gossip timing decides (`ingress.replication`) are held
by the equations only: the audit at the barrier is empty.

Tolerance: exact everywhere."""

import json
import threading
import time
import types
import urllib.error
import urllib.request

import pytest
from _torch_jax_state import jax_process_state  # noqa: F401  (the JAX package's native libraries and ledger)

import evolu_tpu.obs.ledger as jledger
import evolu_tpu.obs.metrics as jmetrics
import evolu_tpu.obs.trace as jtrace
import evolu_tpu.server.relay as jrelay
import evolu_tpu.server.scheduler as jsched
import evolu_tpu.sync.aead as jaead
import evolu_tpu.sync.client as jclient
import evolu_tpu.sync.protocol as jproto
import evolu_tpu.utils.config as jconfig
import evolu_tpu.utils.log as jlog
import evolu_tpu_torch.obs.ledger as pledger
import evolu_tpu_torch.obs.metrics as pmetrics
import evolu_tpu_torch.obs.trace as ptrace
import evolu_tpu_torch.server.relay as prelay
import evolu_tpu_torch.server.scheduler as psched
import evolu_tpu_torch.sync.aead as paead
import evolu_tpu_torch.sync.client as pclient
import evolu_tpu_torch.sync.protocol as pproto
import evolu_tpu_torch.utils.config as pconfig
import evolu_tpu_torch.utils.log as plog
from evolu_tpu_torch.core.timestamp import Timestamp, timestamp_to_string

BASE = 1_700_000_000_000

JAX = types.SimpleNamespace(name="jax", relay=jrelay, sched=jsched, proto=jproto, aead=jaead, trace=jtrace,
                            metrics=jmetrics, ledger=jledger, config=jconfig, log=jlog,
                            http_post=jclient._http_post, extra={})
PORT = types.SimpleNamespace(name="port", relay=prelay, sched=psched, proto=pproto, aead=paead, trace=ptrace,
                             metrics=pmetrics, ledger=pledger, config=pconfig, log=plog,
                             http_post=pclient._http_post, extra={"device": "cpu"})
PKGS = (JAX, PORT)

# The hops of the acceptance episode's trace.
HOPS = {"client.mutate", "relay.sync", "fleet.forward", "fleet.forward.serve", "sched.queue", "engine.batch",
        "relay.respond", "repl.round", "repl.summary", "repl.pull", "repl.serve", "repl.ingest"}


@pytest.fixture(autouse=True)
def _clean_slate():
    for pkg in PKGS:
        pkg.log.logger.clear()  # resets metrics, the flight ring and the trace ring
        pkg.trace.set_enabled(True)
        pkg.trace.set_sample_rate(1.0)
        pkg.ledger.reset()
        pkg.ledger.set_enabled(True)
    yield
    for pkg in PKGS:
        pkg.trace.set_enabled(True)
        pkg.trace.set_sample_rate(1.0)
        pkg.log.logger.clear()


def _msgs(pkg, k, n, t0=0, content=b"ct-%d"):
    node = f"{k + 1:016x}"
    return tuple(
        pkg.proto.EncryptedCrdtMessage(timestamp_to_string(Timestamp(BASE + (t0 + j) * 1000, 0, node)),
                                       content % (t0 + j) if b"%d" in content else content)
        for j in range(n))


def _sync_request(pkg, owner, messages=(), tree="{}"):
    return pkg.proto.SyncRequest(messages, owner, "00000000000000bb", tree)


def _owner_for(ring, url, prefix="o"):
    i = 0
    while True:
        uid = f"{prefix}{i:04d}"
        if ring.primary(uid) == url.rstrip("/"):
            return uid
        i += 1


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read()


def _fleet_pair(pkg, forward: bool, scheduler=None, store_b=None):
    """Two fleet relays with hour-long gossip intervals (every round rides
    the hint chain), replication unscoped from placement so one trace can
    cross routing and gossip."""
    a = pkg.relay.RelayServer(pkg.relay.RelayStore(), peers=[], replication_interval_s=3600, **pkg.extra)
    b = pkg.relay.RelayServer(store_b or pkg.relay.RelayStore(), peers=[], replication_interval_s=3600,
                              scheduler=scheduler, **pkg.extra)
    cfg = pkg.config.FleetConfig(relays=(a.url, b.url), replication_factor=1, version=1, forward=forward)
    a.enable_fleet(cfg)
    b.enable_fleet(cfg)
    a.replication.fleet = None
    b.replication.fleet = None
    a.start()
    b.start()
    return a, b


def _wait(pred, what, deadline_s):
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _acceptance_episode(pkg):
    a = b = None
    try:
        store_b = pkg.relay.RelayStore()
        sched = pkg.sched.SyncScheduler(store_b, max_batch=8, max_wait_s=0.4, **pkg.extra)
        a, b = _fleet_pair(pkg, forward=True, scheduler=sched, store_b=store_b)
        owner_fwd = _owner_for(a.fleet.ring, b.url, prefix="fw")
        owner_direct = _owner_for(b.fleet.ring, b.url, prefix="dx")
        # A v1-shaped and a v2 (aead magic) record: both opaque to every hop.
        msgs_fwd = _msgs(pkg, 0, 1) + _msgs(pkg, 0, 1, t0=1, content=pkg.aead.MAGIC + b"\x00" * 44)
        msgs_direct = _msgs(pkg, 7, 2)
        req_fwd = _sync_request(pkg, owner_fwd, msgs_fwd)
        req_direct = _sync_request(pkg, owner_direct, msgs_direct)
        root = pkg.trace.start_span("client.mutate")
        hdr = {pkg.trace.TRACEPARENT_HEADER: pkg.trace.format_traceparent(root.context)}
        results = {}

        def post_forwarded():
            # Client → A; A is not placed for owner_fwd and proxies the
            # untouched body to B through /fleet/forward.
            results["fwd"] = pkg.http_post(a.url + "/", pkg.proto.encode_sync_request(req_fwd), headers=hdr)

        def post_direct():
            results["direct"] = pkg.http_post(b.url + "/", pkg.proto.encode_sync_request(req_direct))

        threads = [threading.Thread(target=post_forwarded), threading.Thread(target=post_direct)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        root.end()
        assert set(results) == {"fwd", "direct"}
        assert sorted(b.store.user_ids()) == sorted([owner_fwd, owner_direct])
        assert a.store.user_ids() == []
        assert pkg.metrics.get_counter("evolu_sched_batches_total") == 1
        led = pkg.ledger.ledger
        forward_stations = (led.total(pledger.EGRESS_FORWARD), led.total(pledger.INGRESS_FORWARD))

        # Byte identity with tracing on, against an untraced oracle.
        pkg.trace.set_enabled(False)
        oracle = pkg.relay.RelayStore()
        with pkg.ledger.quarantine():
            expect = (pkg.relay.serve_single_request(oracle, req_fwd),
                      pkg.relay.serve_single_request(oracle, req_direct))
        pkg.trace.set_enabled(True)
        assert (results["fwd"], results["direct"]) == expect
        for uid in (owner_fwd, owner_direct):
            assert b.store.get_merkle_tree_string(uid) == oracle.get_merkle_tree_string(uid)
            assert b.store.replica_messages(uid, "") == oracle.replica_messages(uid, "")
        oracle.close()

        # Gossip: B's manager holds both writes' origins; pin the forwarded
        # one first. B's summary POST carries it to A, whose round pulls
        # and ingests into the same trace.
        with b.replication._cv:
            b.replication._hint_origins.sort(key=lambda o: o.trace_id != root.trace_id)
        b.replication.add_peer(a.url)
        _wait(lambda: bool(a.replication._hint_origins), "the origin context at A", 10)
        assert a.replication._hint_origins[0].trace_id == root.trace_id
        a.replication.add_peer(b.url)
        _wait(lambda: sorted(a.store.user_ids()) == sorted([owner_fwd, owner_direct]), "A's pull", 20)
        for uid in (owner_fwd, owner_direct):
            assert a.store.get_merkle_tree_string(uid) == b.store.get_merkle_tree_string(uid)

        names = {}
        for url in (a.url, b.url):
            got = json.loads(_get(url + f"/trace/{root.trace_id}"))
            names[url] = {s["name"] for s in got["spans"]}
            assert HOPS <= names[url], f"missing hops: {sorted(HOPS - names[url])}"
        (batch,) = [s for s in pkg.trace.recorder.dump() if s.name == "engine.batch"]
        assert batch.attrs["requests"] == 2 and batch.attrs["owners"] == 2
        assert len({t for t, _ in batch.links}) == 2
        assert any(t == root.trace_id for t, _ in batch.links)
        spans = pkg.trace.spans_for(root.trace_id)
        (fwd,) = [s for s in spans if s.name == "fleet.forward"]
        (fws,) = [s for s in spans if s.name == "fleet.forward.serve"]
        (a_sync,) = [s for s in spans if s.name == "relay.sync"]
        assert fws.parent_id == fwd.span_id and fwd.parent_id == a_sync.span_id

        # The convergence plane on the pulling replica A.
        peer = b.url.rstrip("/")
        for uid, msgs in ((owner_fwd, msgs_fwd), (owner_direct, msgs_direct)):
            assert pkg.metrics.registry.get_gauge("evolu_conv_owner_freshness_millis",
                                                  replica=a.replication.replica_id, peer=peer,
                                                  owner=uid) == BASE + (len(msgs) - 1) * 1000
        hist = pkg.metrics.registry.get_histogram("evolu_conv_write_visible_ms",
                                                  replica=a.replication.replica_id, peer=peer)
        assert hist is not None and hist[3] >= 2
        exemplar = pkg.metrics.registry.get_exemplar("evolu_conv_write_visible_ms",
                                                     replica=a.replication.replica_id, peer=peer)
        assert exemplar is not None and exemplar[0] == root.trace_id
        stats = json.loads(_get(a.url + "/stats"))
        return {
            "hops": {n for n in names[a.url] if n in HOPS},
            "forward": forward_stations,
            "audit": pkg.ledger.audit(at_barrier=True),
            "lag_p99_set": stats["replication"]["peers"][0]["convergence_lag_p99_ms"] is not None,
        }
    finally:
        for s in (a, b):
            if s is not None:
                s.stop()


def test_single_trace_id_covers_every_hop_across_the_2relay_fleet_like_jax():
    want = _acceptance_episode(JAX)
    got = _acceptance_episode(PORT)
    assert got["hops"] == want["hops"] == HOPS
    # Relay A forwarded the 2 messages it was not placed for; B took them in.
    assert got["forward"] == want["forward"] == (2, 2)
    assert got["audit"] == want["audit"] == []
    assert got["lag_p99_set"] and want["lag_p99_set"]


def _redirect_episode(pkg):
    a = b = None
    try:
        a, b = _fleet_pair(pkg, forward=False)
        owner_b = _owner_for(a.fleet.ring, b.url, prefix="rd")
        body = pkg.proto.encode_sync_request(_sync_request(pkg, owner_b, _msgs(pkg, 3, 2)))
        root = pkg.trace.start_span("client.mutate")
        hdr = {pkg.trace.TRACEPARENT_HEADER: pkg.trace.format_traceparent(root.context)}
        with pytest.raises(urllib.error.HTTPError) as e:
            pkg.http_post(a.url + "/", body, headers=hdr)
        assert e.value.code == 307
        pkg.http_post(e.value.headers["Location"], body, headers=hdr)
        root.end()
        names = [s.name for s in pkg.trace.spans_for(root.trace_id)]
        assert "fleet.redirect" in names  # the bounce, at A
        # Two relay.sync spans in one trace: the 307'd arrival and the
        # authoritative serve.
        assert names.count("relay.sync") == 2
        return sorted(n for n in names if not n.startswith(("kernel:", "sched.", "engine.", "repl."))), \
            pkg.ledger.totals(), pkg.ledger.audit(at_barrier=False)
    finally:
        for s in (a, b):
            if s is not None:
                s.stop()


def test_redirect_leg_joins_the_same_trace_like_jax():
    want = _redirect_episode(JAX)
    got = _redirect_episode(PORT)
    assert got[0] == want[0]
    # The bounce is its 2 messages' terminal at A (egress.redirect); the
    # follow is a fresh delivery at B.
    assert got[1][pledger.EGRESS_REDIRECT] == 2 and got[1][pledger.INGRESS_SYNC] == 4
    assert {k: got[1].get(k, 0) for k in (pledger.INGRESS_SYNC, pledger.EGRESS_REDIRECT,
                                          pledger.STORE_INSERTED)} == \
        {k: want[1].get(k, 0) for k in (pledger.INGRESS_SYNC, pledger.EGRESS_REDIRECT, pledger.STORE_INSERTED)}
    assert got[2] == want[2] == []
