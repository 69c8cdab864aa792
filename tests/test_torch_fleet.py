"""Port parity: the owner-sharded relay fleet (`server/fleet.py`,
`utils.config.FleetConfig`, the fleet envelope of `sync/protocol.py`, the
`/fleet*` surface and `enable_fleet` of `RelayServer`) against the JAX
package's.

- `HashRing` places 10,000 owners exactly as the JAX ring does under
  three configs; `FleetConfig` JSON and its refusals match; the
  `FleetForward` codec is byte-equal and its decoders agree.
- The episodes of `tests/test_fleet.py` run on port relays and on JAX
  relays bound to the same ports (so the rings agree): the 307, the
  forward, the not-ready 503, the reload gates (stale, malformed, token),
  `/health` while installing, scoped gossip, the scoped summary, join and
  rebalance at the watermark, the rebalance beside ACKed writes, failover,
  the hop guard and the 502. Each ends in the JAX episode's answers, tree
  strings and rows; the port's `counts` hold what the reference's metrics
  hold.
- A port client follows one 307 and caches the route; a fleet of one
  port relay and one JAX relay routes and gossips across the packages;
  `python -m evolu_tpu_torch.server.fleet` serves as a fleet member.

Tolerance: exact everywhere."""

import errno
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, HTTPServer

import pytest
from _torch_jax_state import jax_process_state  # noqa: F401  (the JAX package's native libraries and ledger)

from _torch_port_data import within
from _torch_relay_tier import (
    JAX, LIMIT_S, PKGS, PORT, decode_both, fast_post, free_ports, hostile_cases, server, state, stop_all, store,
    wait_for,
)

BASE = 1_700_000_000_000
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _msgs(pkg, k, n, t0=0):
    from evolu_tpu_torch.core.timestamp import timestamp_to_string
    from evolu_tpu_torch.core.types import Timestamp

    node = f"{k + 1:016x}"
    return tuple(pkg.proto.EncryptedCrdtMessage(timestamp_to_string(Timestamp(BASE + (t0 + j) * 1000, 0, node)),
                                                b"ct-%d-%d" % (k, t0 + j)) for j in range(n))


def _sync_body(pkg, owner, messages=(), tree="{}"):
    return pkg.proto.encode_sync_request(pkg.proto.SyncRequest(messages, owner, "00000000000000bb", tree))


def _owner_for(ring, url, prefix="o", avoid=()):
    i = 0
    while True:
        uid = f"{prefix}{i:04d}"
        if uid not in avoid and ring.primary(uid) == url.rstrip("/"):
            return uid
        i += 1


def _call(fn):
    """fn() → ("ok", value) or ("http", code, Location, Retry-After > 0)."""
    try:
        return ("ok", fn())
    except urllib.error.HTTPError as e:
        retry = e.headers.get("Retry-After") if e.headers else None
        return ("http", e.code, e.headers.get("Location") if e.headers else None,
                retry is not None and float(retry) > 0)


def _reload(url, cfg_json, headers=None):
    req = urllib.request.Request(url + "/fleet/reload", data=json.dumps(cfg_json).encode(), method="POST",
                                 headers=headers or {})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _paired(drive, n):
    """Run `drive(pkg, ports)` on JAX, then the port, with the relays bound
    to the same `n` ports (the same URLs, so the same ring). A port taken
    in between retries both on fresh ports."""
    for attempt in range(3):
        ports = free_ports(n)
        try:
            want = within(LIMIT_S, lambda: drive(JAX, ports))
            got = within(LIMIT_S, lambda: drive(PORT, ports))
            return got, want
        except OSError as e:
            if e.errno != errno.EADDRINUSE or attempt == 2:
                raise


def _joiner(pkg, port, donor):
    """A joining relay whose own hint-armed rounds wait 30 s, so a test's
    rebalance sweep, not a race with ranged pulls, moves the owners; its
    first round against `donor` (which finds nothing placed on it yet) is
    waited out by `joined`."""
    st = store(pkg)
    mgr = pkg.rep.ReplicationManager(st, [], replica_id=f"joiner-{pkg.name}", interval_s=30, debounce_s=30,
                                     http_post=fast_post(pkg))
    return server(pkg, st, port=port, replication=mgr)


def joined(pkg, b, donor):
    wait_for(lambda: pkg.rounds_ok(b.replication, donor.url) >= 1, "the joiner's first round")


def _fleet_count(pkg, relay_server, key):
    """The port's per-relay fleet count; None on the JAX side, whose
    counters are process-wide and so depend on the tests run before."""
    return relay_server.fleet.counts[key] if pkg is PORT else None


# --- placement ring ---


RING_CONFIGS = {
    "three_r2_seed7": dict(relays=("http://a:1", "http://b:2", "http://c:3"), replication_factor=2, seed=7),
    "five_r3_vnodes16": dict(relays=tuple(f"http://127.0.0.1:{4000 + i}" for i in range(5)),
                             replication_factor=3, virtual_nodes=16, seed=0),
    "dup_urls_r1_vnodes200": dict(relays=("http://x:9/", "http://y:9", "http://x:9", "http://z:9"),
                                  replication_factor=1, virtual_nodes=200, seed=123456789),
}


@pytest.mark.parametrize("name", list(RING_CONFIGS))
def test_ring_placements_match_jax(name):
    kw = RING_CONFIGS[name]
    jring = JAX.fleet.HashRing(JAX.config.FleetConfig(**kw))
    pring = PORT.fleet.HashRing(PORT.config.FleetConfig(**kw))
    owners = [f"owner{i:05d}" for i in range(10_000)]
    assert pring.relays == jring.relays
    assert [pring.placement(u) for u in owners] == [jring.placement(u) for u in owners]
    assert PORT.fleet._h64("owner|x", 7) == JAX.fleet._h64("owner|x", 7)


def test_ring_properties_match_jax():
    """Determinism, R distinct and clamped, balance, seed sensitivity, and a
    3→4 join moving only owners onto the joiner."""
    def props(pkg):
        F, H = pkg.config.FleetConfig, pkg.fleet.HashRing
        cfg = F(relays=("http://a:1", "http://b:2", "http://c:3"), replication_factor=2, seed=7)
        ps = [H(cfg).placement(f"owner{i}") for i in range(200)]
        assert ps == [H(cfg).placement(f"owner{i}") for i in range(200)]
        assert all(len(set(p)) == 2 for p in ps)
        urls = tuple(f"http://relay{i}:400{i}" for i in range(3))
        ring = H(F(relays=urls, replication_factor=1))
        owners = [f"owner{i:05d}" for i in range(3000)]
        counts = {u: sum(1 for o in owners if ring.primary(o) == u) for u in urls}
        after = H(F(relays=urls + ("http://relay3:4003",), replication_factor=1))
        moved = [o for o in owners if after.primary(o) != ring.primary(o)]
        other = H(F(relays=urls, replication_factor=1, seed=1))
        seeded = sum(1 for o in owners if other.primary(o) != ring.primary(o))
        return (H(F(relays=("http://a:1",), replication_factor=3)).placement("x"), counts, seeded,
                len(moved), all(after.primary(o) == "http://relay3:4003" for o in moved))

    got = props(PORT)
    assert got == props(JAX)
    clamped, counts, seeded, moved, onto_joiner = got
    assert clamped == ("http://a:1",) and all(500 <= n <= 2000 for n in counts.values())
    assert seeded > 1000 and moved / 3000 < 0.45 and onto_joiner


BAD_CONFIGS = {
    "bare_string": {"relays": "http://a:4000", "version": 5},
    "vnodes_dos": {"relays": ["http://a:1"], "version": 5, "virtual_nodes": 10**8},
    "vnodes_zero": {"relays": ["http://a:1"], "virtual_nodes": 0},
    "too_many_relays": {"relays": [f"http://r{i}:1" for i in range(2000)], "version": 5},
    "no_relays_key": {"version": 5},
    "empty_relays": {"relays": []},
    "not_a_dict": ["http://a:1"],
    "bad_int": {"relays": ["http://a:1"], "seed": "x"},
    "none_r": {"relays": ["http://a:1"], "replication_factor": None},
}


@pytest.mark.parametrize("name", list(BAD_CONFIGS))
def test_fleet_config_refusals_match_jax(name):
    for pkg in PKGS:
        with pytest.raises(ValueError):
            pkg.config.FleetConfig.from_json(BAD_CONFIGS[name])


def test_fleet_config_json_round_trips_like_jax():
    d = {"relays": ["http://a:1/", "http://b:2"], "replication_factor": 3, "virtual_nodes": 7, "seed": 9,
         "version": 4, "forward": 1}
    j, p = JAX.config.FleetConfig.from_json(d), PORT.config.FleetConfig.from_json(d)
    assert p.to_json() == j.to_json() and p.relays == ("http://a:1", "http://b:2")
    assert PORT.config.FleetConfig.from_json(p.to_json()) == p
    assert PORT.config.FleetConfig.from_json({"relays": ["u"]}).to_json() == \
        JAX.config.FleetConfig.from_json({"relays": ["u"]}).to_json()


def test_fleet_forward_codec_matches_jax():
    jb = JAX.proto.encode_fleet_forward(JAX.proto.FleetForward(b"\x00payload\xffbytes", "http://a:1", 1))
    pv = PORT.proto.FleetForward(b"\x00payload\xffbytes", "http://a:1", 1)
    assert PORT.proto.encode_fleet_forward(pv) == jb and PORT.proto.decode_fleet_forward(jb) == pv
    two = PORT.proto.encode_fleet_forward(PORT.proto.FleetForward(b"", "o", 2))
    for data in hostile_cases([jb, two], 1234, 3):
        got, want = decode_both("decode_fleet_forward", data)
        assert got == want, data
    with pytest.raises(ValueError):
        PORT.proto.decode_fleet_forward(PORT.proto._tag(1, 0) + PORT.proto._varint(1 << 40))


def test_owner_scoped_snapshot_serves_only_wanted_owners_like_jax():
    """A SnapshotRequest naming owners gets a manifest and chunks covering
    exactly those; a full request afterwards is a different snapshot."""

    def drive(pkg):
        donor = server(pkg, store(pkg), peers=[], replication_interval_s=30).start()
        post = pkg.http_post
        try:
            owners = [f"z{i:04d}" for i in range(6)]
            for k, uid in enumerate(owners):
                donor.store.add_messages(uid, _msgs(pkg, k, 4))
            wanted = tuple(owners[:2])
            manifest = pkg.proto.decode_snapshot_manifest(post(
                donor.url + "/replicate/snapshot",
                pkg.proto.encode_snapshot_request(pkg.proto.SnapshotRequest("probe", 0, wanted))))
            seen = []
            for i in range(len(manifest.chunk_sizes)):
                chunk = pkg.proto.decode_snapshot_chunk(post(
                    donor.url + "/replicate/snapshot/chunk",
                    pkg.proto.encode_snapshot_chunk_request(pkg.proto.SnapshotChunkRequest(manifest.snapshot_id, i))))
                seen += list(pkg.snap.iter_records(chunk.payload))
            full = pkg.proto.decode_snapshot_manifest(post(
                donor.url + "/replicate/snapshot",
                pkg.proto.encode_snapshot_request(pkg.proto.SnapshotRequest("probe"))))
            return (manifest.owners, manifest.message_count, manifest.chunk_crcs, seen,
                    full.snapshot_id != manifest.snapshot_id, len(full.owners))
        finally:
            donor.stop()

    got = within(LIMIT_S, lambda: drive(PORT))
    assert got == within(LIMIT_S, lambda: drive(JAX))
    assert tuple(u for u, _r, _c in got[0]) == ("z0000", "z0001") and got[1] == 8 and got[4:] == (True, 6)


# --- routing through real relays ---


def _two_relay_fleet(pkg, ports, forward=False):
    a = server(pkg, store(pkg), port=ports[0], peers=[], replication_interval_s=30).start()
    b = server(pkg, store(pkg), port=ports[1], peers=[], replication_interval_s=30).start()
    cfg = pkg.config.FleetConfig(relays=(a.url, b.url), replication_factor=1, version=1, forward=forward)
    a.enable_fleet(cfg)
    b.enable_fleet(cfg)
    return a, b, cfg


def test_redirect_and_forward_match_jax():
    """A non-placed owner's POST answers 307 to its primary with nothing
    stored; after a reload to forward mode it is proxied and served on the
    primary only, its response equal to asking the primary directly."""

    def drive(pkg, ports):
        a, b, cfg = _two_relay_fleet(pkg, ports)
        try:
            owner_b = _owner_for(a.fleet.ring, b.url)
            out = [_call(lambda: pkg.http_post(a.url + "/", _sync_body(pkg, owner_b, _msgs(pkg, 0, 2)))),
                   a.store.user_ids()]
            served = pkg.http_post(b.url + "/", _sync_body(pkg, owner_b, _msgs(pkg, 0, 2)))
            out.append(pkg.proto.decode_sync_response(served).merkle_tree)
            fwd = pkg.config.FleetConfig(relays=cfg.relays, replication_factor=1, version=2, forward=True)
            out += [_reload(s.url, fwd.to_json()) for s in (a, b)]
            owner_b2 = _owner_for(a.fleet.ring, b.url, avoid=(owner_b,))
            proxied = pkg.http_post(a.url + "/", _sync_body(pkg, owner_b2, _msgs(pkg, 1, 3)))
            direct = pkg.http_post(b.url + "/", _sync_body(pkg, owner_b2, _msgs(pkg, 1, 3)))
            out += [proxied, direct, sorted(b.store.user_ids()), a.store.user_ids(), state(b.store),
                    _fleet_count(pkg, a, "redirects"), _fleet_count(pkg, a, "forwards"),
                    _fleet_count(pkg, b, "forwarded_served"), _fleet_count(pkg, a, "reloads")]
            return out
        finally:
            stop_all([a, b])

    got, want = _paired(drive, 2)
    assert got[:-4] == want[:-4]
    assert got[0][:2] == ("http", 307) and got[0][2].endswith("/") and got[1] == []
    assert got[-4:] == [1, 1, 1, 1]


def test_not_ready_owner_and_reload_gates_match_jax(monkeypatch):
    """An owner mid-install answers 503 + Retry-After and is served once
    ready; a stale reload and malformed or DoS configs answer 400, a reload
    without the token 403 and with it 200, the ring untouched until then."""

    def drive(pkg, ports):
        a, _b, cfg = _two_relay_fleet(pkg, ports)
        try:
            owner_a = _owner_for(a.fleet.ring, a.url)
            with a.fleet._lock:
                a.fleet._installing.add(owner_a)
            out = [_call(lambda: pkg.http_post(a.url + "/", _sync_body(pkg, owner_a), retries=0))]
            with a.fleet._lock:
                a.fleet._installing.discard(owner_a)
            pkg.http_post(a.url + "/", _sync_body(pkg, owner_a, _msgs(pkg, 1, 1)))
            out.append(a.store.user_ids())
            stale = pkg.config.FleetConfig(relays=cfg.relays, replication_factor=1, version=0)
            out.append(_call(lambda: _reload(a.url, stale.to_json())))
            for bad in ("bare_string", "vnodes_dos", "too_many_relays", "no_relays_key"):
                out.append(_call(lambda: _reload(a.url, BAD_CONFIGS[bad])))
            same_version = pkg.config.FleetConfig(relays=cfg.relays, replication_factor=2, version=1)
            out.append(_call(lambda: _reload(a.url, same_version.to_json())))
            monkeypatch.setenv("EVOLU_FLEET_RELOAD_TOKEN", "s3cret")
            new = pkg.config.FleetConfig(relays=cfg.relays, replication_factor=1, version=3)
            out.append(_call(lambda: _reload(a.url, new.to_json())))
            out.append(a.fleet.config.version)
            out.append(_call(lambda: _reload(a.url, new.to_json(), {"X-Evolu-Fleet-Token": "s3cret"})))
            monkeypatch.delenv("EVOLU_FLEET_RELOAD_TOKEN")
            return out
        finally:
            stop_all([a, _b])

    got, want = _paired(drive, 2)
    assert got == want
    assert got[0] == ("http", 503, None, True) and got[2][1] == 400 and got[-3][1] == 403 and got[-2] == 1
    assert got[-1][0] == "ok" and got[-1][1]["ring_version"] == 3


def test_health_reports_install_in_progress_like_jax():
    def drive(pkg):
        def health(srv):
            try:
                with urllib.request.urlopen(srv.url + "/health", timeout=10) as r:
                    return r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())

        srv = server(pkg, store(pkg)).start()
        try:
            out = [health(srv)]
            inst = pkg.snap.SnapshotInstaller(srv.store)
            inst.begin(pkg.proto.SnapshotManifest("snap1", (), (), (), 0, 0), "peer")
            out.append(health(srv))
            inst.abort()
            out.append(health(srv))
        finally:
            srv.stop()
        batching = server(pkg, store(pkg), batching=True).start()
        try:
            out.append(health(batching))
        finally:
            batching.stop()
        return out

    got = within(LIMIT_S, lambda: drive(PORT))
    assert got == within(LIMIT_S, lambda: drive(JAX))
    assert got[1] == (503, {"status": "installing", "install_phase": "fetch"}) and got[3][1]["queue_depth"] == 0


def test_fleet_get_and_health_detail_match_jax():
    """GET /fleet answers the fleet's stats (404 without a fleet), and a fleet
    relay's /health carries the ring detail."""

    def drive(pkg, ports):
        a, b, _cfg = _two_relay_fleet(pkg, ports)
        plain = server(pkg, store(pkg)).start()
        try:
            with urllib.request.urlopen(a.url + "/fleet", timeout=10) as r:
                fleet = json.loads(r.read())
            with urllib.request.urlopen(a.url + "/health", timeout=10) as r:
                health = json.loads(r.read())
            with urllib.request.urlopen(a.url + "/stats", timeout=10) as r:
                stats_fleet = json.loads(r.read())["fleet"]
            # The counters are process-wide on the JAX side: compared as keys.
            placement = {k: v for k, v in fleet.items() if not isinstance(v, int) or k.startswith(
                ("ring_", "replication_", "owners_", "installing_"))}
            return placement, sorted(fleet), health, set(stats_fleet), \
                _call(lambda: urllib.request.urlopen(plain.url + "/fleet"))[:2]
        finally:
            stop_all([a, b, plain])

    got, want = _paired(drive, 2)
    assert got == want and got[4] == ("http", 404) and got[2]["members"] == 2


# --- client transport: follow one 307 + route cache ---


class _Status404(BaseHTTPRequestHandler):
    def do_POST(self):
        self.rfile.read(int(self.headers.get("Content-Length", "0")))
        self.send_error(404)

    def log_message(self, *a):
        pass


def test_port_client_follows_one_redirect_caches_and_invalidates():
    from evolu_tpu_torch.runtime.client import create_evolu
    from evolu_tpu_torch.sync.client import connect
    from evolu_tpu_torch.utils.config import Config

    def round_(e):
        e.worker.flush()
        e.sync()
        e.worker.flush()
        e._transport.flush()
        e.worker.flush()

    def drive():
        a = server(PORT, store(PORT), peers=[], replication_interval_s=30).start()
        b = server(PORT, store(PORT), peers=[], replication_interval_s=30).start()
        cfg = PORT.config.FleetConfig(relays=(a.url, b.url), replication_factor=1, version=1)
        a.enable_fleet(cfg)
        b.enable_fleet(cfg)
        stub = HTTPServer(("127.0.0.1", 0), _Status404)
        threading.Thread(target=stub.serve_forever, daemon=True).start()
        evolu = None
        try:
            evolu = create_evolu({"todo": ("title", "isCompleted")},
                                 config=Config(sync_url=a.url, backend="cuda"), device="cpu")
            connect(evolu)
            owner = evolu.get_owner().id
            home = a if a.fleet.ring.primary(owner) == a.url else b
            away = b if home is a else a
            evolu.config.sync_url = away.url
            evolu._transport.config.sync_url = away.url
            t = evolu._transport
            evolu.create("todo", {"title": "t1", "isCompleted": False})
            round_(evolu)
            first = (t.counts.get("redirects", 0), t._routes.get(owner) == home.url + "/", home.store.user_ids())
            evolu.create("todo", {"title": "t2", "isCompleted": False})
            round_(evolu)
            second = t.counts.get("redirects", 0)
            t._routes[owner] = f"http://127.0.0.1:{stub.server_address[1]}/"
            errors = []
            evolu.subscribe_error(errors.append)
            evolu.create("todo", {"title": "t3", "isCompleted": False})
            round_(evolu)
            n = home.store.db.exec_sql_query('SELECT COUNT(*) AS n FROM "message"')[0]["n"]
            return owner, first, second, errors, n, away.store.user_ids()
        finally:
            if evolu is not None:
                evolu.dispose()
            stub.shutdown()
            stub.server_close()
            stop_all([a, b])

    owner, first, second, errors, n, away_owners = within(LIMIT_S, drive)
    assert first == (1, True, [owner]) and second == 1
    assert not errors and n >= 3 and away_owners == []


# --- placement-scoped gossip ---


def _fleet_of(pkg, ports, r=2, version=1):
    relays = [server(pkg, store(pkg), port=p, peers=[], replication_interval_s=30).start() for p in ports]
    cfg = pkg.config.FleetConfig(relays=tuple(s.url for s in relays), replication_factor=r, version=version)
    for s in relays:
        s.enable_fleet(cfg)
    return relays, cfg


def test_gossip_is_scoped_to_placement_like_jax():
    """R=2 over 3 relays: A advertises each peer exactly the owners placed
    on it, with its URL; after the peers' rounds every owner lives on its
    placed relays only, byte-identical, as in the JAX episode."""

    def drive(pkg, ports):
        relays, _cfg = _fleet_of(pkg, ports)
        try:
            for s in relays:
                for t in relays:
                    if t is not s:
                        s.replication.add_peer(t.url)
            a = relays[0]
            owners = [f"g{i:04d}" for i in range(24)]
            for k, uid in enumerate(owners):
                a.store.add_messages(uid, _msgs(pkg, k, 3))
            sent = {}
            orig = a.replication._post

            def recording_post(url, body):
                if url.endswith("/replicate/summary"):
                    s = pkg.proto.decode_replica_summary(body)
                    sent[url.rsplit("/replicate/", 1)[0]] = (sorted(u for u, _t in s.trees), s.peer_url)
                return orig(url, body)

            a.replication._post = recording_post
            a.replication.run_once()
            for s in relays[1:]:
                s.replication.run_once()
            placed = {uid: a.fleet.placement(uid) for uid in owners}
            return sent, placed, {s.url: state(s.store) for s in relays}, relays[0].url
        finally:
            stop_all(relays)

    got, want = _paired(drive, 3)
    assert got == want
    sent, placed, states, a_url = got
    assert len(sent) == 2
    for peer_url, (advertised, peer_field) in sent.items():
        assert advertised == sorted(u for u, p in placed.items() if peer_url in p) and peer_field == a_url
    assert sum(len(v[0]) for v in sent.values()) < 2 * 24
    for url, st in states.items():
        if url != a_url:  # a peer holds exactly its placed owners, byte-identical to A
            assert set(st) == {u for u, p in placed.items() if url in p}
            assert all(st[u] == states[a_url][u] for u in st)


def test_serve_summary_scopes_its_answer_to_the_caller_like_jax():
    def drive(pkg, ports):
        (a, b), _cfg = _fleet_of(pkg, ports, r=1)
        try:
            owners = [f"s{i:04d}" for i in range(16)]
            for k, uid in enumerate(owners):
                a.store.add_messages(uid, _msgs(pkg, k, 2))
            out = []
            for peer_url in (b.url, ""):
                resp = pkg.proto.decode_replica_summary(pkg.http_post(
                    a.url + "/replicate/summary",
                    pkg.proto.encode_replica_summary(pkg.proto.ReplicaSummary((), "probe", peer_url))))
                out.append((sorted(u for u, _t in resp.trees), resp.peer_url))
            return out, sorted(u for u in owners if a.fleet.placed_on(u, b.url)), a.url
        finally:
            stop_all([a, b])

    got, want = _paired(drive, 2)
    assert got == want
    (scoped, full), on_b, a_url = got
    assert scoped == (on_b, a_url) and len(full[0]) == 16


# --- rebalancing ---


def test_join_rebalance_moves_owners_at_the_watermark_like_jax():
    """A joins alone; B joins with the grown config (A reloads first): B's
    sweep installs exactly the moved owners from A's owner-scoped snapshot,
    each cut over at the watermark, byte-identical to A; A then redirects
    them to B; a second sweep moves nothing."""

    def drive(pkg, ports):
        a = server(pkg, store(pkg), port=ports[0], peers=[], replication_interval_s=30).start()
        b = None
        try:
            a.enable_fleet(pkg.config.FleetConfig(relays=(a.url,), replication_factor=1, version=1))
            owners = [f"m{i:04d}" for i in range(20)]
            for k, uid in enumerate(owners):
                a.store.add_messages(uid, _msgs(pkg, k, 10))
            b = _joiner(pkg, ports[1], a)
            cfg2 = pkg.config.FleetConfig(relays=(a.url, b.url), replication_factor=1, version=2)
            fb = b.enable_fleet(cfg2)
            b.start()
            joined(pkg, b, a)
            moved = [uid for uid in owners if fb.ring.primary(uid) == b.url]
            reload = _reload(a.url, cfg2.to_json())
            n = fb.rebalance_once()
            out = [moved, reload, n, state(b.store), {u: state(a.store)[u] for u in moved},
                   _call(lambda: pkg.http_post(a.url + "/", _sync_body(pkg, moved[0]))),
                   fb.rebalance_once(), _fleet_count(pkg, b, "cutovers_verified"),
                   _fleet_count(pkg, b, "rebalanced_owners"), _fleet_count(pkg, b, "rebalanced_messages")]
            return out
        finally:
            stop_all([b, a])

    got, want = _paired(drive, 2)
    assert got[:-3] == want[:-3]
    moved, reload, n, b_state, a_moved, redirect, again, verified, owners, messages = got
    assert moved and reload["rebalancing"] is True and n == len(moved) and b_state == a_moved
    assert redirect[:2] == ("http", 307) and again == 0
    assert verified == owners == len(moved) and messages == 10 * len(moved)


def test_rebalance_beside_acked_writes_loses_nothing_like_jax():
    """A write the donor ACKs while the joiner's install runs reaches the
    joiner by scoped gossip: every moved owner ends byte-identical."""

    def drive(pkg, ports):
        a = server(pkg, store(pkg), port=ports[0], peers=[], replication_interval_s=30).start()
        b = None
        try:
            a.enable_fleet(pkg.config.FleetConfig(relays=(a.url,), replication_factor=1, version=1))
            owners = [f"w{i:04d}" for i in range(12)]
            for k, uid in enumerate(owners):
                a.store.add_messages(uid, _msgs(pkg, k, 6))
            b = _joiner(pkg, ports[1], a)
            cfg2 = pkg.config.FleetConfig(relays=(a.url, b.url), replication_factor=1, version=2)
            fb = b.enable_fleet(cfg2)
            b.start()
            joined(pkg, b, a)
            moved = [uid for uid in owners if fb.ring.primary(uid) == b.url]
            straggler = moved[0]
            orig = fb._post

            def post_with_straggler(url, body):
                if url.endswith("/replicate/snapshot"):
                    a.store.add_messages(straggler, _msgs(pkg, owners.index(straggler), 2, t0=100))
                return orig(url, body)

            fb._post = post_with_straggler
            a.fleet.apply_config(cfg2, rebalance=False)
            n = fb.rebalance_once()
            b.replication.add_peer(a.url)

            def healed():
                b.replication.run_once()
                return all(b.store.get_merkle_tree_string(u) == a.store.get_merkle_tree_string(u) for u in moved)

            wait_for(healed, "the post-capture tail", 10)
            return moved, n, state(b.store), {u: state(a.store)[u] for u in moved}
        finally:
            stop_all([b, a])

    got, want = _paired(drive, 2)
    assert got == want
    moved, n, b_state, a_moved = got
    assert n == len(moved) and b_state == a_moved and len(b_state[moved[0]][1]) == 8


# --- failover and the forward guards ---


def test_down_primary_fails_over_to_the_next_replica_like_jax():
    def drive(pkg, ports):
        relays, _cfg = _fleet_of(pkg, ports)
        try:
            ring = relays[0].fleet.ring
            i = 0
            while len(ring.placement(f"f{i:04d}")) != 2:
                i += 1
            uid = f"f{i:04d}"
            p = ring.placement(uid)
            primary = next(s for s in relays if s.url == p[0])
            replica = next(s for s in relays if s.url == p[1])
            third = next(s for s in relays if s.url not in p)
            out = [third.fleet.route(uid)]
            primary.stop()
            relays.remove(primary)
            third.fleet._probe_cache.clear()
            out.append(third.fleet.route(uid))
            out.append(_fleet_count(pkg, third, "failovers"))
            served = pkg.http_post(replica.url + "/", _sync_body(pkg, uid, _msgs(pkg, 9, 2)))
            out.append(pkg.proto.decode_sync_response(served).merkle_tree)
            return out, p
        finally:
            stop_all(relays)

    got, want = _paired(drive, 3)
    assert (got[0][:2], got[0][3:], got[1]) == (want[0][:2], want[0][3:], want[1])
    (first, second, failovers, tree), p = got
    assert first == ("redirect", p[0]) and second == ("redirect", p[1]) and failovers == 1 and tree != "{}"


def test_forward_guards_match_jax():
    """Forward mode with no ready placed relay sheds 503; a /fleet/forward
    envelope is served locally, never re-forwarded; a multi-hop envelope
    answers 400; a peer without a fleet answers the forward 404, relayed as
    502."""

    def drive(pkg, ports):
        a = server(pkg, store(pkg), port=ports[0], peers=[], replication_interval_s=30).start()
        plain = server(pkg, store(pkg), port=ports[1]).start()
        try:
            a.enable_fleet(pkg.config.FleetConfig(relays=(a.url, "http://127.0.0.1:1"), replication_factor=1,
                                                  version=1, forward=True))
            uid = _owner_for(a.fleet.ring, "http://127.0.0.1:1", prefix="h")
            out = [_call(lambda: pkg.http_post(a.url + "/", _sync_body(pkg, uid), retries=0))]
            env = pkg.proto.encode_fleet_forward(
                pkg.proto.FleetForward(_sync_body(pkg, uid, _msgs(pkg, 3, 2)), "http://origin:1", 1))
            out.append(pkg.http_post(a.url + "/fleet/forward", env))
            out.append(a.store.user_ids())
            bad = pkg.proto.encode_fleet_forward(pkg.proto.FleetForward(_sync_body(pkg, uid), "http://origin:1", 2))
            out.append(_call(lambda: pkg.http_post(a.url + "/fleet/forward", bad)))
            a.fleet.apply_config(pkg.config.FleetConfig(relays=(a.url, plain.url), replication_factor=1,
                                                        version=2, forward=True), rebalance=False)
            uid2 = _owner_for(a.fleet.ring, plain.url, prefix="p")
            out.append(_call(lambda: pkg.http_post(a.url + "/", _sync_body(pkg, uid2, _msgs(pkg, 5, 1)),
                                                   retries=0)))
            out.append(plain.store.user_ids())
            return out, uid
        finally:
            stop_all([a, plain])

    got, want = _paired(drive, 2)
    assert got == want
    (shed, served, stored, hops, relayed, plain_owners), uid = got
    assert shed == ("http", 503, None, True) and stored == [uid] and hops[:2] == ("http", 400)
    assert relayed[:2] == ("http", 502) and plain_owners == []


def test_mixed_fleet_of_a_port_relay_and_a_jax_relay():
    """One port relay and one JAX relay share a FleetConfig (R=1): each
    redirects the other's owners to it, and scoped gossip drains owners
    written on the wrong member to their placement, byte-identical."""

    def drive():
        p = server(PORT, store(PORT), peers=[], replication_interval_s=30).start()
        j = server(JAX, store(JAX), peers=[], replication_interval_s=30).start()
        try:
            for srv, pkg in ((p, PORT), (j, JAX)):
                srv.enable_fleet(pkg.config.FleetConfig(relays=(p.url, j.url), replication_factor=1, version=1))
            on_j = _owner_for(p.fleet.ring, j.url)
            on_p = _owner_for(j.fleet.ring, p.url)
            codes = [_call(lambda: PORT.http_post(p.url + "/", _sync_body(PORT, on_j)))[:2],
                     _call(lambda: JAX.http_post(j.url + "/", _sync_body(JAX, on_p)))[:2]]
            # Strays written straight into the wrong member's store drain.
            p.store.add_messages(on_j, _msgs(PORT, 1, 5))
            j.store.add_messages(on_p, _msgs(JAX, 2, 4))
            p.replication.add_peer(j.url)
            j.replication.add_peer(p.url)
            p.replication.run_once()
            j.replication.run_once()
            return codes, state(p.store)[on_p], state(j.store)[on_j], state(j.store).get(on_p), \
                state(p.store).get(on_j)
        finally:
            stop_all([p, j])

    codes, p_has, j_has, j_stray, p_stray = within(LIMIT_S, drive)
    assert codes == [("http", 307), ("http", 307)]
    assert p_has == j_stray and j_has == p_stray and len(p_has[1]) == 4 and len(j_has[1]) == 5


def test_fleet_worker_process_serves_as_a_member(tmp_path):
    """`python -m evolu_tpu_torch.server.fleet` starts a fleet relay that
    answers GET /fleet and redirects an owner placed elsewhere."""
    port, other = free_ports(2)
    url = f"http://127.0.0.1:{port}"
    cfg = PORT.config.FleetConfig(relays=(url, f"http://127.0.0.1:{other}"), replication_factor=1, version=1)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "evolu_tpu_torch.server.fleet", "--port", str(port), "--self-url", url,
         "--config-json", json.dumps(cfg.to_json()), "--backend", "native", "--replication-interval-s", "30"],
        env=env, stdout=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 40
        line = ""
        while time.time() < deadline and "READY" not in line:
            line = proc.stdout.readline()
            assert line or proc.poll() is None, "the fleet worker exited"
        assert "READY" in line
        with urllib.request.urlopen(url + "/fleet", timeout=10) as r:
            fleet = json.loads(r.read())
        assert fleet["members"] == list(cfg.relays) and fleet["ring_version"] == 1
        uid = _owner_for(PORT.fleet.HashRing(cfg), cfg.relays[1])
        assert _call(lambda: PORT.http_post(url + "/", _sync_body(PORT, uid)))[:2] == ("http", 307)
    finally:
        proc.terminate()
        proc.wait(timeout=30)
