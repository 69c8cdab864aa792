"""Port parity: relay↔relay Merkle anti-entropy (`server/replicate.py`,
the replica codecs of `sync/protocol.py`, the `/replicate/*` surface and
`peers` of `RelayServer`) against the JAX package's.

- Every replica codec encodes byte-equal to the JAX codec and decodes the
  other package's bytes; on truncations, bit flips and garbage both
  decoders give the same value or both raise ValueError, and nothing else.
- The episodes of `tests/test_replication.py` (two-relay convergence,
  the write hint, the hint chain, the three-relay partition heal, capped
  catch-up, backoff, scheduler coalescing) run on port relays and on JAX
  relays and end in the same tree strings and rows; the port's own counts
  hold what the reference's metrics hold.
- A port relay and a JAX relay replicate with each other over HTTP, both
  ways, and end byte-identical.

Tolerance: exact everywhere. Each drive runs inside its own time limit;
waits poll with their own timeouts."""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest
from _torch_jax_state import jax_process_state  # noqa: F401  (the JAX package's native libraries and ledger)

import evolu_tpu.sync.client as jclient
import evolu_tpu_torch.sync.client as pclient
from _torch_port_data import within
from _torch_relay_tier import (
    JAX, LIMIT_S, PKGS, PORT, decode_both, fast_post, hostile_cases, msgs, seed, server, state,
    stop_all, store, wait_converged, wait_for, write,
)


def _replica_vectors(p):
    return {
        "summary": p.ReplicaSummary(
            (("alice", '{"0":{"hash":7},"hash":7}'), ("b\x00ob", "{}"), ("", "")), "replica-1"),
        "summary_peer_url": p.ReplicaSummary((("o1", "{}"),), "r1", "http://me:4000"),
        "pull": p.ReplicaPull((("alice", "2023-11-14T22:13:20.000Z-0000-0000000000000000"),), "replica-2"),
        "pull_response": p.ReplicaPullResponse((
            p.OwnerMessages("alice", (p.EncryptedCrdtMessage("t" * 46, b"\x00\xff\x80 raw\x00"),
                                      p.EncryptedCrdtMessage("u" * 46, b"")), '{"hash":2}'),
            p.OwnerMessages("empty-owner", (), "{}"),
        )),
        "owner_messages": p.OwnerMessages("bob", (p.EncryptedCrdtMessage("v" * 46, b"\x01"),), "{}"),
    }


_CODECS = {
    "summary": ("encode_replica_summary", "decode_replica_summary"),
    "summary_peer_url": ("encode_replica_summary", "decode_replica_summary"),
    "pull": ("encode_replica_pull", "decode_replica_pull"),
    "pull_response": ("encode_replica_pull_response", "decode_replica_pull_response"),
    "owner_messages": ("encode_owner_messages", "decode_owner_messages"),
}


@pytest.mark.parametrize("kind", list(_CODECS))
def test_replica_codecs_encode_byte_equal_and_cross_decode(kind):
    enc, dec = _CODECS[kind]
    jv, pv = _replica_vectors(JAX.proto)[kind], _replica_vectors(PORT.proto)[kind]
    jb, pb = getattr(JAX.proto, enc)(jv), getattr(PORT.proto, enc)(pv)
    assert pb == jb
    assert getattr(PORT.proto, dec)(jb) == pv
    assert getattr(JAX.proto, dec)(pb) == jv


@pytest.mark.parametrize("decoder", ["decode_replica_summary", "decode_replica_pull",
                                     "decode_replica_pull_response", "decode_owner_messages"])
def test_replica_decoders_agree_and_raise_valueerror_only(decoder):
    vectors = _replica_vectors(JAX.proto)
    valid = [getattr(JAX.proto, _CODECS[k][0])(v) for k, v in vectors.items()]
    for data in hostile_cases(valid, 7, 7):
        got, want = decode_both(decoder, data)
        assert got == want, data


def test_accepts_headers_matches_jax():
    import functools

    def two(url, body):
        return body

    def kw(url, body, **extra):
        return body

    for mod in (jclient, pclient):
        fns = [two, kw, mod._http_post, functools.partial(mod._http_post, retries=0), print, 3]
        assert [mod._accepts_headers(f) for f in fns] == [False, True, True, True, False, False]
        assert mod._accepts_headers_probe(two) is False


def _post_code(url, body):
    try:
        with urllib.request.urlopen(urllib.request.Request(url, data=body), timeout=30) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def _raw_code(url, path, content_length):
    import socket
    from urllib.parse import urlsplit

    parts = urlsplit(url)
    with socket.create_connection((parts.hostname, parts.port), timeout=10) as s:
        s.sendall((f"POST {path} HTTP/1.1\r\nHost: {parts.netloc}\r\nContent-Length: {content_length}\r\n"
                   "Content-Type: application/octet-stream\r\n\r\n").encode("ascii"))
        line = s.makefile("rb").readline()
    return int(line.split()[1])


def test_replicate_surface_status_codes_match_jax():
    """Unconfigured relays 404 on /replicate/*; a listener answers 400 to
    malformed bodies and to hostile Content-Lengths, 413 past the cap, 404
    on an unknown sub-path, and keeps serving."""
    paths = ("/replicate/summary", "/replicate/pull", "/replicate/snapshot", "/replicate/snapshot/chunk")

    def drive(pkg):
        codes = []
        plain = server(pkg, store(pkg)).start()
        try:
            codes += [_post_code(plain.url + p, b"") for p in paths]
        finally:
            plain.stop()
        listener = server(pkg, store(pkg), peers=[]).start()
        try:
            codes += [_post_code(listener.url + p, b"\xff\xff\xff") for p in paths]
            codes.append(_post_code(listener.url + "/replicate/nope", b""))
            codes += [_raw_code(listener.url, p, h) for p in ("/", "/replicate/summary")
                      for h in ("banana", "-1", "-999999999", "12abc", "", 20 * 1024 * 1024 + 1)]
            ok = pkg.proto.decode_replica_summary(pkg.http_post(
                listener.url + "/replicate/summary",
                pkg.proto.encode_replica_summary(pkg.proto.ReplicaSummary((), "probe"))))
            codes.append(ok.trees)
        finally:
            listener.stop()
        return codes

    want = within(LIMIT_S, lambda: drive(JAX))
    got = within(LIMIT_S, lambda: drive(PORT))
    assert got == want
    assert got[:4] == [404] * 4 and got[4:8] == [400] * 4 and got[8] == 404


def _pulled(pkg, mgr, url):
    if pkg is PORT:
        return mgr.peer_counts.get(url, {}).get("messages_pulled", 0)
    return JAX.rep.metrics.get_counter("evolu_repl_messages_pulled_total", replica=mgr.replica_id, peer=url)


def test_two_relay_convergence_and_stats_match_jax():
    """A fresh relay B peering a seeded listener A pulls everything; both
    end byte-identical, in the JAX episode and the port episode alike, and
    the port's /stats replication section has the reference's keys."""
    n1, n2 = "1" * 16, "2" * 16

    def drive(pkg):
        a = server(pkg, store(pkg), peers=[]).start()
        b = None
        try:
            write(pkg, a.url, "alice", n1, msgs(pkg, n1, 0, 0, 40))
            write(pkg, a.url, "bob", n2, msgs(pkg, n2, 0, 0, 30))
            b = server(pkg, store(pkg), peers=[a.url], replication_interval_s=0.1).start()
            final = wait_converged([a.store, b.store], {"alice", "bob"})
            with urllib.request.urlopen(b.url + "/stats", timeout=10) as r:
                stats = json.loads(r.read())["replication"]
            return final, stats, a.url
        finally:
            stop_all([b, a])

    want, jstats, _ = within(LIMIT_S, lambda: drive(JAX))
    got, pstats, a_url = within(LIMIT_S, lambda: drive(PORT))
    assert got == want
    (jp,), (pp,) = jstats["peers"], pstats["peers"]
    assert set(pp) == set(jp) and set(pstats) == set(jstats)
    assert set(pstats["snapshot"]) == set(jstats["snapshot"])
    assert pp["url"] == a_url and pp["healthy"] is True and pp["messages_pulled"] >= 70
    assert pp["rounds_ok"] >= 1 and pp["rounds_error"] == 0
    assert pp["convergence_lag_p99_ms"] is None and pstats["snapshot"]["install_p99_ms"] is None


@pytest.mark.parametrize("topology", ["pair", "chain"])
def test_hints_propagate_without_the_interval_like_jax(topology):
    """Hour-long intervals: a write reaches every relay on debounced hints
    alone, across a pair (the summary POST arms the peer's hint) and along
    a chain A↔B↔C with no A↔C edge (a round that pulls re-arms its own
    hint). Every relay ends byte-identical, equal to the JAX episode."""
    node = "3" * 16

    def drive(pkg):
        n = 2 if topology == "pair" else 3
        stores = [store(pkg) for _ in range(n)]
        mgrs = [pkg.rep.ReplicationManager(s, [], replica_id=f"{topology}-{pkg.name}-{i}", interval_s=3600,
                                           debounce_s=0.02, http_post=fast_post(pkg))
                for i, s in enumerate(stores)]
        servers = [server(pkg, s, replication=m).start() for s, m in zip(stores, mgrs)]
        try:
            edges = [(0, 1), (1, 0)] if n == 2 else [(0, 1), (1, 2), (1, 0), (2, 1)]
            for i, j in edges:
                mgrs[i].add_peer(servers[j].url)
            # The initial (empty) rounds first; the next periodic round is an hour out.
            wait_for(lambda: all(pkg.rounds_ok(mgrs[i], servers[j].url) >= 1 for i, j in edges),
                     "the initial rounds")
            write(pkg, servers[0].url, "carol", node, msgs(pkg, node, 1, 0, 20))
            return wait_converged(stores, {"carol"})
        finally:
            stop_all(servers)

    want = within(LIMIT_S, lambda: drive(JAX))
    assert within(LIMIT_S, lambda: drive(PORT)) == want


class FaultyTransport:
    """A partition: POSTs to blocked URL prefixes raise URLError before any
    byte moves."""

    def __init__(self, post):
        self._post, self._blocked, self._lock = post, set(), threading.Lock()

    def post(self, url, body):
        with self._lock:
            blocked = any(url.startswith(b) for b in self._blocked)
        if blocked:
            raise urllib.error.URLError("partitioned (fault injection)")
        return self._post(url, body)

    def block(self, *urls):
        with self._lock:
            self._blocked.update(urls)

    def heal(self):
        with self._lock:
            self._blocked.clear()


def test_three_relay_partition_heal_matches_jax():
    """Full mesh A/B/C (C sharded) with disjoint and overlapping owners; C
    is partitioned both ways while A and B take more writes and converge;
    after the heal all three are byte-identical, C's pull moved only the 25
    partition-era rows, and the end state equals the JAX episode's."""
    n1, n2, n3 = "1" * 16, "2" * 16, "3" * 16

    def drive(pkg):
        stores = [store(pkg), store(pkg), store(pkg, shards=2)]
        faults = [FaultyTransport(fast_post(pkg)) for _ in range(3)]
        mgrs = [pkg.rep.ReplicationManager(s, [], replica_id=f"part-{pkg.name}-{k}", interval_s=0.1,
                                           debounce_s=0.02, backoff_base_s=0.05, backoff_max_s=0.5,
                                           http_post=f.post)
                for k, (s, f) in enumerate(zip(stores, faults))]
        servers = [server(pkg, s, replication=m).start() for s, m in zip(stores, mgrs)]
        a, b, c = servers
        try:
            for i, m in enumerate(mgrs):
                for j, srv in enumerate(servers):
                    if i != j:
                        m.add_peer(srv.url)
            write(pkg, a.url, "alice", n1, msgs(pkg, n1, 0, 0, 30))
            write(pkg, c.url, "alice", n3, msgs(pkg, n3, 0, 0, 20))
            write(pkg, b.url, "bob", n2, msgs(pkg, n2, 0, 0, 25))
            wait_converged(stores, {"alice", "bob"})
            faults[0].block(c.url)
            faults[1].block(c.url)
            faults[2].block(a.url, b.url)
            write(pkg, a.url, "alice", n1, msgs(pkg, n1, 5, 0, 15))
            write(pkg, b.url, "dave", n2, msgs(pkg, n2, 5, 0, 10))
            wait_converged(stores[:2], {"alice", "bob", "dave"})
            assert set(state(stores[2])) == {"alice", "bob"}
            before = sum(_pulled(pkg, mgrs[2], s.url) for s in (a, b))
            for f in faults:
                f.heal()
            final = wait_converged(stores, {"alice", "bob", "dave"})
            delta = sum(_pulled(pkg, mgrs[2], s.url) for s in (a, b)) - before
            return final, delta
        finally:
            stop_all(servers)

    want = within(LIMIT_S, lambda: drive(JAX))
    got = within(LIMIT_S, lambda: drive(PORT))
    assert got == want
    assert got[1] == 25 and sum(len(rows) for _t, rows in got[0].values()) == 100


def test_capped_pull_catches_up_incrementally_like_jax(monkeypatch):
    """serve_pull's caps (40 an owner, 60 a response, monkeypatched in both
    packages): successive rounds resume from the advanced diff minute, each
    within the budget, exactly 240 rows in all, the same rounds as JAX."""
    for pkg in PKGS:
        monkeypatch.setattr(pkg.rep, "PULL_MESSAGES_PER_OWNER", 40)
        monkeypatch.setattr(pkg.rep, "PULL_MESSAGES_PER_RESPONSE", 60)

    def drive(pkg):
        src = server(pkg, store(pkg), peers=[]).start()
        dest = store(pkg)
        mgr = None
        try:
            for u, node in (("deep-a", "1" * 16), ("deep-b", "2" * 16)):
                for minute in range(6):
                    src.store.add_messages(u, msgs(pkg, node, minute, 0, 20))
            mgr = pkg.rep.ReplicationManager(dest, [src.url], replica_id=f"capped-{pkg.name}",
                                             http_post=fast_post(pkg))
            per_round = []
            for _ in range(12):
                before = _pulled(pkg, mgr, src.url)
                mgr.run_once()
                per_round.append(_pulled(pkg, mgr, src.url) - before)
                if state(dest) == state(src.store):
                    break
            return state(dest), per_round
        finally:
            if mgr is not None:
                mgr.stop()
            dest.close()
            src.stop()

    want = within(LIMIT_S, lambda: drive(JAX))
    got = within(LIMIT_S, lambda: drive(PORT))
    assert got == want
    assert max(got[1]) <= 60 and sum(got[1]) == 240 and len([p for p in got[1] if p]) >= 4


def test_peer_failure_backoff_is_bounded_exponential_like_jax():
    """Consecutive failures grow the delay exponentially under the cap
    (jitter pinned); the first good round resets the failures. The port's
    delays are the JAX manager's, within a millisecond of clock."""

    def drive(pkg):
        target = server(pkg, store(pkg), peers=[]).start()
        st = store(pkg)
        fault = FaultyTransport(fast_post(pkg))
        fault.block(target.url)
        mgr = pkg.rep.ReplicationManager(st, [target.url], replica_id=f"backoff-{pkg.name}", interval_s=60,
                                         backoff_base_s=0.05, backoff_max_s=1.0, http_post=fault.post,
                                         rng=lambda: 1.0)
        peer = mgr._peers[0]
        try:
            delays = []
            for _ in range(7):
                mgr.run_once()
                delays.append(peer.next_due - time.monotonic())
            failures = peer.failures
            health = mgr.stats_payload()["peers"][0]
            fault.heal()
            mgr.run_once()
            after = mgr.stats_payload()["peers"][0]
            return delays, failures, (health["healthy"], health["rounds_error"]), \
                (peer.failures, after["healthy"], after["rounds_ok"])
        finally:
            mgr.stop()
            target.stop()
            st.close()

    jd, *jrest = within(LIMIT_S, lambda: drive(JAX))
    pd, *prest = within(LIMIT_S, lambda: drive(PORT))
    assert prest == jrest == [7, (False, 7), (0, True, 1)]
    assert pd[0] < pd[1] < pd[2] and all(d <= 1.0 + 1e-6 for d in pd)
    assert all(abs(p - j) < 0.05 for p, j in zip(pd, jd)), (pd, jd)


def test_replication_ingest_coalesces_through_the_scheduler_like_jax():
    """On a batching relay the pulled messages go through the scheduler:
    every request rides a fused engine pass, in fewer passes than requests
    (the port's `device="cpu"` scheduler counts), and the end state equals
    the JAX episode's."""

    def drive(pkg):
        src = server(pkg, store(pkg, shards=2), peers=[]).start()
        dst_store = store(pkg, shards=2)
        dst = server(pkg, dst_store, batching=True).start()
        mgr = None
        try:
            owners = {f"sched-u{i}": f"{i + 1:016x}" for i in range(10)}
            for u, node in owners.items():
                src.store.add_messages(u, msgs(pkg, node, 0, 0, 20))
            mgr = pkg.rep.ReplicationManager(dst_store, [src.url], replica_id=f"sched-{pkg.name}",
                                             scheduler=dst.scheduler, http_post=fast_post(pkg))
            mgr.run_once()
            final = wait_converged([src.store, dst_store], set(owners))
            counts = dict(dst.scheduler.counts) if pkg is PORT else None
            return final, counts
        finally:
            if mgr is not None:
                mgr.stop()
            stop_all([dst, src])

    want, _ = within(LIMIT_S, lambda: drive(JAX))
    got, counts = within(LIMIT_S, lambda: drive(PORT))
    assert got == want
    assert counts["coalesced"] == 10 and 1 <= counts["batches"] <= 10
    assert counts["singles"] == counts["poisoned_batches"] == counts["rejected"] == 0


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_port_and_jax_relays_replicate_with_each_other(direction):
    """A JAX relay and a port relay peer each other over HTTP, each seeded
    with its own owners and one shared owner written on both; both pull and
    end byte-identical. `direction` picks which one starts the gossip."""
    n1, n2 = "a" * 16, "b" * 16

    def drive():
        first, second = (JAX, PORT) if direction == "jax_to_port" else (PORT, JAX)
        x = server(first, store(first), peers=[], replication_interval_s=0.1).start()
        y = None
        try:
            seed(first, x.store, owners=3, per_minute=7, minutes=2)
            write(first, x.url, "shared", n1, msgs(first, n1, 3, 0, 9))
            y_store = store(second)
            y_store.add_messages("shared", msgs(second, n2, 3, 0, 6))
            y_store.add_messages("only-second", msgs(second, n2, 4, 0, 5))
            y = server(second, y_store, peers=[x.url], replication_interval_s=0.1).start()
            x.replication.add_peer(y.url)
            owners = {"owner000", "owner001", "owner002", "shared", "only-second"}
            return wait_converged([x.store, y.store], owners)
        finally:
            stop_all([y, x])

    final = within(LIMIT_S, drive)
    assert len(final["shared"][1]) == 15 and len(final["only-second"][1]) == 5
