"""Port parity: the event-loop connection tier (`server/conn.py`) against
the JAX package's.

- Byte identity: one raw request sequence, with pushes, pulls, errors and
  immediate push polls, goes to a port event-tier relay, a port threaded
  relay and a JAX relay; every raw response (status line, headers, body)
  is equal with the `Date` header masked, and the three SQLite end states
  are equal.
- `/stats` carries the `push` section on both of the port's tiers and the
  `conn` section on the event tier only, with the JAX relay's keys; the
  observability endpoints (`/metrics`, `/ledger`, `/trace`, `/profile`)
  answer 404 on both of the port's tiers until that tier is ported.
- Slow-client hardening, on a port and a JAX event-tier relay with the
  same knobs: a partial header, a partial body and a byte-a-tick trickle
  are closed at the absolute read budget; a 20 KB header answers 431; the
  dispatch bound and a full hub answer 503 + Retry-After (the latter byte
  for byte on both tiers of both packages); a hangup mid-response is
  cleaned up; a parked connection cannot buffer without bound; a push poll
  with an absurd Content-Length parks in the loop; hundreds of idle
  long-polls add no thread and all wake.
- A batching relay on the event tier serves concurrent posts byte-equal to
  the per-request oracle.

Tolerance: exact everywhere."""

import json
import socket
import threading
import time
import urllib.request

import pytest
from _torch_jax_state import jax_process_state  # noqa: F401  (the JAX package's native libraries and ledger)

from _torch_push import (FRESH, JAX, NODE_A, NODE_B, PORT, addr, config, dump_store, exchange, msgs,
                         normalize, raw_request, server, subscriptions, sync_body, wait_for)


def _twin_requests(pkg):
    proto = pkg.proto
    from evolu_tpu_torch.core.timestamp import timestamp_to_string
    from evolu_tpu_torch.core.types import Timestamp

    return [
        raw_request("GET", "/ping"),
        raw_request("GET", "/health"),
        raw_request("POST", "/", sync_body(pkg, "ow-1", NODE_A, msgs(pkg, NODE_A, 0, 8))),
        raw_request("POST", "/", sync_body(pkg, "ow-2", NODE_B, msgs(pkg, NODE_B, 100, 5))),
        raw_request("POST", "/", sync_body(pkg, "ow-1", FRESH, ())),
        raw_request("POST", "/", sync_body(pkg, "ow-1", NODE_A, msgs(pkg, NODE_A, 0, 8))),
        raw_request("POST", "/", sync_body(pkg, "ow-1", FRESH, ())
                    + proto.encode_request_capabilities(("aead-batch-v1",))),
        raw_request("POST", "/", b"\xff\xfe\xfd"),
        b"POST / HTTP/1.0\r\nContent-Length: nope\r\n\r\n",
        b"POST / HTTP/1.0\r\nContent-Length: -5\r\n\r\n",
        b"POST / HTTP/1.0\r\nContent-Length: " + str(pkg.relay.MAX_BODY_BYTES + 1).encode() + b"\r\n\r\n",
        raw_request("GET", "/nope"),
        raw_request("PUT", "/"),
        raw_request("POST", "/replicate/summary", b"\xff\xff"),
        raw_request("POST", "/replicate/summary",
                    proto.encode_replica_summary(proto.ReplicaSummary((), "twin-peer"))),
        raw_request("POST", "/replicate/pull", proto.encode_replica_pull(proto.ReplicaPull(
            (("ow-1", timestamp_to_string(Timestamp(0, 0, "0" * 16))),), "twin-peer"))),
        raw_request("POST", "/replicate/nope", b""),
        raw_request("POST", "/fleet/forward", b""),
        raw_request("GET", "/fleet"),
        raw_request("GET", "/push/poll?owner=ow-1&node=zz&cursor=0"),
        raw_request("GET", "/push/poll?owner=ow-1&node=" + FRESH + "&cursor=0&timeout=0"),
        raw_request("GET", "/push/poll?owner=ow-1&node=" + FRESH + "&cursor=-999&timeout=0"),
        raw_request("GET", "/push/poll?owner=ow-2&node=" + NODE_B + "&cursor=1&timeout=0"),
        raw_request("GET", "/push/poll?owner=ow-9&node=" + NODE_B + "&cursor=0&timeout=0"),
    ]


def _twin(pkg, tier):
    store = pkg.relay.RelayStore(backend="native")
    # A pinned replica id: the gossip surface echoes it.
    repl = pkg.rep.ReplicationManager(store, [], replica_id="twin-relay")
    return server(pkg, store, replication=repl, connection_tier=tier).start()


def test_twin_relay_oracle_byte_identity():
    """One request sequence at the port's event tier, the port's threaded
    tier and a JAX relay: every response byte-identical (modulo Date), the
    three stores equal."""
    relays = [_twin(PORT, "eventloop"), _twin(PORT, "threaded"), _twin(JAX, "threaded")]
    try:
        for i, (p_raw, j_raw) in enumerate(zip(_twin_requests(PORT), _twin_requests(JAX))):
            assert p_raw == j_raw
            got = [normalize(exchange(addr(s), p_raw)) for s in relays]
            assert got[0] == got[1] == got[2], f"request #{i} diverged: {[g[:300] for g in got]!r}"
        dumps = [dump_store(s.store) for s in relays]
        assert dumps[0] == dumps[1] == dumps[2]
        assert len(dumps[0][0]) == 13 and len(dumps[0][1]) == 2  # 8 + 5 rows, 2 owners
        pushes = [s.push_hub.stats_payload() for s in relays[:2]]
        assert pushes[0] == pushes[1] and pushes[0]["channels"] == 2
    finally:
        for s in relays:
            s.stop()


def test_stats_sections_and_observability_404s_on_both_tiers():
    """/stats: the push section on both tiers and the conn section on the
    event tier, with the JAX relay's keys; on both of the port's tiers the
    observability reads answer 200 and `/ledger` (not wired yet) 404."""
    relays = [server(PORT, connection_tier=t).start() for t in ("threaded", "eventloop")]
    jax = server(JAX, connection_tier="eventloop").start()
    try:
        stats = []
        for srv in relays + [jax]:
            body = sync_body(PORT, "ow-s", NODE_A, msgs(PORT, NODE_A, 0, 3))
            with urllib.request.urlopen(urllib.request.Request(srv.url + "/", data=body), timeout=10) as r:
                assert r.status == 200
            with urllib.request.urlopen(srv.url + "/stats", timeout=10) as r:
                stats.append(json.loads(r.read()))
        for st in stats:
            assert st["messages"] == 3 and st["users"] == 1
        assert stats[0]["push"] == stats[1]["push"]
        assert set(stats[0]["push"]) == set(stats[2]["push"])
        assert set(stats[0]["push"]["wakeups_total"]) == set(stats[2]["push"]["wakeups_total"])
        assert "conn" not in stats[0] and stats[1]["conn"]["tier"] == "eventloop"
        assert set(stats[1]["conn"]) == set(stats[2]["conn"])
        assert set(stats[1]["conn"]["closed_total"]) == set(stats[2]["conn"]["closed_total"])
        for srv in relays:
            for path in ("/metrics", "/trace", "/trace/" + "0" * 32, "/profile?ms=10"):
                resp = exchange(addr(srv), raw_request("GET", path))
                assert resp.startswith(b"HTTP/1.0 200"), (srv.connection_tier, path)
            resp = exchange(addr(srv), raw_request("GET", "/ledger"))
            assert resp.startswith(b"HTTP/1.0 404"), (srv.connection_tier, "/ledger")
    finally:
        for s in relays + [jax]:
            s.stop()


# -- slow-client hardening (raw sockets), port and JAX side by side --

FAST = dict(conn_read_timeout_s=0.5, conn_write_timeout_s=0.5, conn_max_header_bytes=2048)


def _hardened(pkg, episode):
    with config(pkg, **FAST):
        srv = server(pkg, connection_tier="eventloop").start()
    try:
        out = episode(srv)
        with urllib.request.urlopen(srv.url + "/ping", timeout=5) as r:  # still healthy
            return out, r.read()
    finally:
        srv.stop()


def _both(episode):
    got, want = _hardened(PORT, episode), _hardened(JAX, episode)
    assert got == want
    return got[0]


def _closed_within(s, lo, hi):
    s.settimeout(5)
    t0 = time.monotonic()
    data = s.recv(100)
    return data, lo < time.monotonic() - t0 < hi


def test_partial_header_and_body_time_out():
    def episode(srv):
        out = []
        for raw in (b"GET /ping HT", b"POST / HTTP/1.0\r\nContent-Length: 1000\r\n\r\nonly-a-bit"):
            with socket.create_connection(addr(srv), timeout=10) as s:
                s.sendall(raw)
                out.append(_closed_within(s, 0.3, 4.0))
        return out

    assert _both(episode) == [(b"", True), (b"", True)]


def test_slow_trickle_cannot_slide_the_deadline():
    """The read budget is ABSOLUTE: byte-a-tick progress does not keep the
    connection past it."""
    def episode(srv):
        with socket.create_connection(addr(srv), timeout=10) as s:
            s.settimeout(0.1)
            t0 = time.monotonic()
            closed_at, i = None, 0
            payload = b"GET /ping HTTP/1.0\r\nX-Slow: " + b"x" * 500
            while time.monotonic() - t0 < 4.0:
                try:
                    s.sendall(payload[i:i + 1])
                    i = min(i + 1, len(payload) - 1)
                except OSError:
                    closed_at = time.monotonic() - t0
                    break
                try:
                    if s.recv(100) == b"":
                        closed_at = time.monotonic() - t0
                        break
                except socket.timeout:
                    pass
                except OSError:  # a reset: the relay closed with a byte unread
                    closed_at = time.monotonic() - t0
                    break
        return closed_at is not None and closed_at < 3.0

    assert _both(episode) is True


def test_header_overflow_answers_431():
    def episode(srv):
        return normalize(exchange(addr(srv), b"GET /ping HTTP/1.0\r\nX-Big: " + b"x" * 20480 + b"\r\n\r\n", 10))

    assert _both(episode).startswith(b"HTTP/1.0 431 Request Header Fields Too Large\r\n")


def test_mid_response_hangup_is_cleaned_up():
    def episode(srv):
        for _ in range(8):
            s = socket.create_connection(addr(srv), timeout=10)
            s.sendall(raw_request("GET", "/ping"))
            s.close()  # hang up before reading
        end = time.monotonic() + 5
        while time.monotonic() < end:
            with urllib.request.urlopen(srv.url + "/stats", timeout=5) as r:
                open_now = json.loads(r.read())["conn"]["open_connections"]
            if open_now == 1:  # just this scrape
                break
            time.sleep(0.05)
        return open_now

    assert _both(episode) == 1


def test_dispatch_admission_sheds_503():
    """Past `conn_max_pending` in-flight dispatches the loop answers 503 +
    Retry-After itself, byte-identical between the packages."""
    def episode(pkg):
        with config(pkg, conn_handler_threads=1, conn_max_pending=2):
            srv = server(pkg, connection_tier="eventloop").start()
        try:
            results, lock = [], threading.Lock()

            def one(i):
                raw = raw_request("POST", "/", sync_body(pkg, f"ow-{i}", NODE_A, msgs(pkg, NODE_A, i * 10, 4)))
                resp = normalize(exchange(addr(srv), raw, timeout=30))
                with lock:
                    results.append(resp)

            threads = [threading.Thread(target=one, args=(i,)) for i in range(24)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            shed = {r for r in results if r.startswith(b"HTTP/1.0 503")}
            return (sum(r.startswith(b"HTTP/1.0 200") for r in results) >= 1,
                    all(r.startswith((b"HTTP/1.0 200", b"HTTP/1.0 503")) for r in results), shed)
        finally:
            srv.stop()

    got, want = episode(PORT), episode(JAX)
    assert got[:2] == want[:2] == (True, True)
    shed_frames = got[2] | want[2]
    assert len(shed_frames) <= 1  # every shed answer is the one frame, in both packages
    for frame in shed_frames:
        assert b"Retry-After: 1\r\n" in frame


def test_parked_connection_cannot_buffer_unbounded_bytes():
    def episode(srv):
        s = socket.create_connection(addr(srv), timeout=10)
        s.sendall(raw_request("GET", f"/push/poll?owner=ow&node={NODE_B}&cursor=0&timeout=30"))
        wait_for(lambda: subscriptions(srv) == 1, "the parked poll")
        try:
            for _ in range(16):
                s.sendall(b"x" * 65536)
                time.sleep(0.01)
        except OSError:
            pass  # send may fail into the reset
        wait_for(lambda: subscriptions(srv) == 0, "the flooding poll cancelled")
        s.close()
        return srv.push_hub.stats_payload()["subscriptions"]

    assert _both(episode) == 0


def test_push_poll_with_huge_content_length_does_not_pin_the_pool():
    def episode(pkg):
        with config(pkg, conn_handler_threads=1):
            srv = server(pkg, connection_tier="eventloop").start()
        try:
            socks = []
            for _ in range(4):  # more than the single pool thread
                s = socket.create_connection(addr(srv), timeout=10)
                s.sendall(b"GET /push/poll?owner=ow&node=" + NODE_B.encode()
                          + b"&cursor=0&timeout=20 HTTP/1.0\r\nContent-Length: 99999999999\r\n\r\n")
                socks.append(s)
            wait_for(lambda: subscriptions(srv) == 4, "four parked polls")
            with urllib.request.urlopen(srv.url + "/ping", timeout=5) as r:
                ping = r.read()
            with urllib.request.urlopen(urllib.request.Request(
                    srv.url + "/", data=sync_body(pkg, "ow", NODE_A, msgs(pkg, NODE_A, 0, 1))), timeout=10) as r:
                assert r.status == 200
            answers = []
            for s in socks:
                s.settimeout(10)
                resp = bytearray()
                while chunk := s.recv(65536):
                    resp += chunk
                answers.append(normalize(bytes(resp)))
                s.close()
            return ping, answers
        finally:
            srv.stop()

    got, want = episode(PORT), episode(JAX)
    assert got == want
    assert got[0] == b"ok" and all(a.endswith(b'{"wake": true, "cursor": 1}') for a in got[1])


def test_idle_connections_do_not_grow_threads():
    """Hundreds of parked long-polls add no thread, and every one of them
    gets its wakeup, on the port's tier as on the JAX one."""
    def episode(pkg):
        srv = server(pkg, connection_tier="eventloop").start()
        socks = []
        try:
            for _ in range(3):  # warm the pool
                with urllib.request.urlopen(srv.url + "/ping", timeout=5):
                    pass
            baseline = threading.active_count()
            n = 256
            for _ in range(n):
                s = socket.create_connection(addr(srv), timeout=10)
                s.sendall(raw_request("GET", f"/push/poll?owner=ow-idle&node={NODE_B}&cursor=0&timeout=30"))
                socks.append(s)
            wait_for(lambda: subscriptions(srv) == n, f"{n} parked polls")
            grown = threading.active_count() - baseline
            with urllib.request.urlopen(urllib.request.Request(
                    srv.url + "/", data=sync_body(pkg, "ow-idle", NODE_A, msgs(pkg, NODE_A, 0, 1))), timeout=10) as r:
                assert r.status == 200
            bodies = set()
            for s in socks:
                s.settimeout(10)
                resp = bytearray()
                while chunk := s.recv(65536):
                    resp += chunk
                head, _, payload = bytes(resp).partition(b"\r\n\r\n")
                assert head.startswith(b"HTTP/1.0 200")
                bodies.add(payload)
            return grown <= 0, bodies
        finally:
            for s in socks:
                s.close()
            srv.stop()

    assert episode(PORT) == episode(JAX) == (True, {b'{"wake": true, "cursor": 1}'})


def test_scheduler_batching_rides_the_event_tier():
    """A batching port relay on the event tier serves concurrent
    distinct-owner posts byte-equal to a per-request JAX relay's answers,
    and ends in the same store."""
    oracle = server(JAX, connection_tier="threaded").start()
    srv = server(PORT, batching=True, connection_tier="eventloop").start()
    try:
        bodies = {f"ow-{i}": sync_body(PORT, f"ow-{i}", NODE_A, msgs(PORT, NODE_A, i * 100, 6)) for i in range(12)}
        expect = {}
        for owner, body in bodies.items():
            with urllib.request.urlopen(urllib.request.Request(oracle.url + "/", data=body), timeout=30) as r:
                expect[owner] = r.read()
        got, lock = {}, threading.Lock()

        def post(owner, body):
            with urllib.request.urlopen(urllib.request.Request(srv.url + "/", data=body), timeout=30) as r:
                data = r.read()
            with lock:
                got[owner] = data

        threads = [threading.Thread(target=post, args=kv) for kv in bodies.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert got == expect
        assert dump_store(srv.store) == dump_store(oracle.store)
        assert srv.scheduler.counts["batches"] >= 1
    finally:
        srv.stop()
        oracle.stop()


@pytest.mark.parametrize("tier", ["threaded", "eventloop"])
def test_stop_returns_promptly_with_a_parked_poll(tier):
    """`RelayServer.stop()` closes the hub before the server, so a parked
    long-poll (a handler thread on the threaded tier) answers wake=false
    and never holds `stop()` for its timeout."""
    srv = server(PORT, connection_tier=tier).start()
    box = {}

    def poll():
        with urllib.request.urlopen(srv.url + f"/push/poll?owner=o&node={NODE_B}&cursor=0&timeout=30",
                                    timeout=40) as r:
            box["body"] = r.read()

    th = threading.Thread(target=poll)
    th.start()
    wait_for(lambda: subscriptions(srv) == 1, "the parked poll")
    t0 = time.monotonic()
    srv.stop()
    took = time.monotonic() - t0
    th.join(timeout=5)
    assert took < 2.0 and box["body"] == b'{"wake": false, "cursor": 0}'


def test_hub_full_answers_503_alike_on_both_tiers_and_jax():
    """A poll past `push_max_subscriptions` answers 503 + Retry-After: the
    event tier frames it in the loop, the threaded tier in the handler,
    and both equal a JAX relay's answer byte for byte (Date masked)."""
    def episode(pkg, tier):
        with config(pkg, push_max_subscriptions=1):
            srv = server(pkg, connection_tier=tier).start()
        try:
            s = socket.create_connection(addr(srv), timeout=10)
            s.sendall(raw_request("GET", f"/push/poll?owner=a&node={NODE_B}&cursor=0&timeout=1"))
            wait_for(lambda: subscriptions(srv) == 1, "the first poll parked")
            full = normalize(exchange(addr(srv), raw_request("GET", f"/push/poll?owner=b&node={NODE_B}&cursor=0")))
            s.close()
            return full
        finally:
            srv.stop()

    answers = [episode(PORT, "eventloop"), episode(PORT, "threaded"), episode(JAX, "eventloop"),
               episode(JAX, "threaded")]
    assert answers[0] == answers[1] == answers[2] == answers[3]
    assert answers[0].startswith(b"HTTP/1.0 503 Service Unavailable\r\n") and b"\r\nRetry-After: 1\r\n" in answers[0]
