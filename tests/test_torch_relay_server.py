"""Port parity: the HTTP relay (`RelayServer`, `_Handler`,
`MultiprocessRelay`) against the JAX package's.

- POST `/` answers a v1 body, a capability-advertising body and a scoped
  body (served its slice: both relays advertise `sync-scope-v1`, the
  reference's default) with the JAX relay's bytes, both relays built with
  the same capability tuple, on the per-request path and batching
  (`device="cpu"`); a relay with `sync-scope-v1` answers scoped POSTs
  (lane pushes, lane and watermark pulls, own-row trees) as a JAX relay
  does, and one without it strips the clause as the JAX relay does.
- `/ping`, `/health` and the store section of `/stats` equal the JAX
  relay's; a bad Content-Length answers 400, an oversized body 413, and
  the relay tier's endpoints 404 on a relay without replication, a
  fleet or a push hub; the observability endpoints 404 on both tiers.
- Each mesh-engine option (mesh_engine, mesh_ctx, EVOLU_MESH_ENGINE)
  builds a batching relay that serves the JAX relay's bytes; the replication half's options (peers,
  replication, bootstrap_lag_owners, checkpoints), the push and
  connection-tier options (push, connection_tier, EVOLU_CONN_TIER) and the
  write-behind options (write_behind, EVOLU_WRITE_BEHIND, Config.
  write_behind with write_behind_log) build a relay that serves.
- Two port clients converge over real HTTP through a batching port relay
  with `aead-batch-v1` negotiated.
- The four workloads of `tests/test_relay_concurrency.py` on a port
  `MultiprocessRelay`, held against the JAX store's sequential serve.

Tolerance: exact everywhere. Every threaded test runs inside its own
time limit (`within`)."""

import json
import socket
import threading
import urllib.error
import urllib.request

import pytest
from _torch_jax_state import jax_process_state  # noqa: F401  (the JAX package's native libraries and ledger)

import evolu_tpu.server.relay as jrelay
import evolu_tpu.sync.aead as jaead
import evolu_tpu.sync.protocol as jproto
import evolu_tpu_torch.server.relay as prelay
import evolu_tpu_torch.server.scheduler as psched
import evolu_tpu_torch.sync.protocol as pproto
from evolu_tpu_torch.core.timestamp import timestamp_to_string
from evolu_tpu_torch.core.types import Timestamp

from _torch_port_data import within

BASE = 1_700_000_000_000
FRESH_NODE = "f" * 16
LIMIT_S = 120
SCHEMA = {"todo": ("title", "isCompleted")}


def _stamps(node, start, n, step=1000):
    return [timestamp_to_string(Timestamp(BASE + (start + i) * step, 0, node)) for i in range(n)]


def _msgs(proto, node, start, n, content=None):
    return tuple(proto.EncryptedCrdtMessage(t, content or b"ct-%d" % (start + i))
                 for i, t in enumerate(_stamps(node, start, n)))


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, b""


def _post(url, body):
    try:
        with urllib.request.urlopen(urllib.request.Request(
                url, data=body, headers={"Content-Type": "application/octet-stream"}), timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, b""


def _raw(url, head):
    """Send raw request head bytes, → the status code of the answer."""
    host, port = url[len("http://"):].split(":")
    with socket.create_connection((host, int(port)), timeout=30) as s:
        s.sendall(head)
        line = s.makefile("rb").readline()
    return int(line.split()[1])


def _bodies():
    """A v1 push, a push advertising capabilities (an unknown one among
    them), a scoped request, then a cold pull of each kind, as encoded
    request bytes."""
    caps = (pproto.CAP_CRDT_TYPES, pproto.CAP_AEAD_BATCH, "zz-unknown-v9", pproto.CAP_SYNC_SCOPE)
    reqs = [
        pproto.SyncRequest(_msgs(pproto, "a" * 16, 0, 40), "owner-v1", "a" * 16, "{}"),
        pproto.SyncRequest(_msgs(pproto, "b" * 16, 0, 40), "owner-caps", "b" * 16, "{}", caps),
        pproto.SyncRequest(_msgs(pproto, "c" * 16, 0, 40), "owner-scoped", "c" * 16, "{}", caps,
                           pproto.ScopeClause(watermark_millis=BASE + 20_000)),
        pproto.SyncRequest((), "owner-v1", FRESH_NODE, "{}"),
        pproto.SyncRequest((), "owner-caps", FRESH_NODE, "{}", caps),
        pproto.SyncRequest((), "owner-scoped", FRESH_NODE, "{}", caps,
                           pproto.ScopeClause(watermark_millis=BASE + 20_000)),
    ]
    return [pproto.encode_sync_request(r) for r in reqs]


def _store_section(stats):
    return ([{k: s[k] for k in ("index", "messages", "users")} for s in stats["shards"]],
            stats["messages"], stats["users"])


@pytest.mark.parametrize("batching", [False, True])
def test_post_and_get_endpoints_match_jax(batching):
    """The same bodies POSTed to a port and a JAX relay with the same
    capabilities: byte-identical answers; equal /ping, /health and store
    section of /stats."""
    def drive(make):
        server = make().start()
        try:
            out = [_post(server.url, b) for b in _bodies()]
            out += [_get(server.url + p) for p in ("/ping", "/health")]
            code, stats = _get(server.url + "/stats")
            return out, code, json.loads(stats)
        finally:
            server.stop()

    caps = prelay.DEFAULT_CAPABILITIES
    want = within(LIMIT_S, lambda: drive(lambda: jrelay.RelayServer(
        jrelay.RelayStore(backend="native"), batching=batching, capabilities=caps)))
    got = within(LIMIT_S, lambda: drive(lambda: prelay.RelayServer(
        prelay.RelayStore(backend="native"), batching=batching, device="cpu")))
    assert got[0] == want[0] and got[1] == want[1] == 200
    assert all(code == 200 for code, _ in got[0])
    assert _store_section(got[2]) == _store_section(want[2]) == ([{"index": 0, "messages": 120, "users": 3}],
                                                                 120, 3)
    assert got[2]["requests_total"] == 6 and got[2]["errors_total"] == 0
    assert got[2]["shards"][0]["requests"] == 6
    responses = [pproto.decode_sync_response(b) for _, b in got[0][:6]]
    assert responses[1].capabilities == (pproto.CAP_CRDT_TYPES, pproto.CAP_AEAD_BATCH, pproto.CAP_SYNC_SCOPE)
    assert responses[0].capabilities == () and responses[3].capabilities == ()
    # The reference's capability echo: the cold pull of the scoped owner gets
    # its slice, the 20 rows at or past the watermark.
    assert caps == pproto.KNOWN_CAPABILITIES
    assert len(responses[5].messages) == 20 and pproto.CAP_SYNC_SCOPE in responses[5].capabilities
    health = json.loads(got[0][7][1])
    assert health == {"status": "serving", "install_phase": None, **({"queue_depth": 0} if batching else {})}


def test_errors_and_404s_match_jax():
    """A bad Content-Length answers 400, an oversized one 413 (the body
    is never read), unknown and relay-tier endpoints 404; the relay keeps
    serving. The endpoints a JAX relay also answers 404 are compared."""
    heads = [b"POST / HTTP/1.1\r\nHost: x\r\nContent-Length: banana\r\n\r\n",
             b"POST / HTTP/1.1\r\nHost: x\r\nContent-Length: -1\r\n\r\n",
             b"POST / HTTP/1.1\r\nHost: x\r\nContent-Length: %d\r\n\r\n" % (prelay.MAX_BODY_BYTES + 1),
             b"GET /nope HTTP/1.1\r\nHost: x\r\n\r\n",
             b"GET /fleet HTTP/1.1\r\nHost: x\r\n\r\n",
             b"POST /replicate/summary HTTP/1.1\r\nHost: x\r\nContent-Length: 0\r\n\r\n",
             b"POST /fleet/reload HTTP/1.1\r\nHost: x\r\nContent-Length: 0\r\n\r\n"]

    def drive(server):
        server.start()
        try:
            codes = [_raw(server.url, h) for h in heads]
            return codes, _get(server.url + "/ping"), json.loads(_get(server.url + "/stats")[1])
        finally:
            server.stop()

    want = within(LIMIT_S, lambda: drive(jrelay.RelayServer(jrelay.RelayStore(backend="native"))))
    got = within(LIMIT_S, lambda: drive(prelay.RelayServer(prelay.RelayStore(backend="native"))))
    assert got[0] == want[0] == [400, 400, 413, 404, 404, 404, 404]
    assert got[1] == want[1] == (200, b"ok")
    assert got[2]["errors_total"] == 3 and got[2]["requests_total"] == 3

    poll = "/push/poll?owner=a&node=0000000000000000&cursor=0&timeout=0"
    port = prelay.RelayServer(prelay.RelayStore(backend="native"), push=False).start()
    try:
        # The observability reads answer, the conservation ledger's too.
        for path in ("/metrics", "/trace", "/trace/" + "0" * 32, "/profile?ms=10", "/ledger"):
            assert _get(port.url + path)[0] == 200, path
        for path in ("/fleet", poll):
            assert _get(port.url + path)[0] == 404, path
        for path in ("/replicate/summary", "/replicate/pull", "/fleet/forward", "/fleet/reload"):
            assert _post(port.url + path, b"")[0] == 404, path
    finally:
        port.stop()
    # The default relay has a push hub, as the reference's does: the poll
    # answers at once with timeout=0.
    port = prelay.RelayServer(prelay.RelayStore(backend="native")).start()
    try:
        assert port.push_hub is not None
        assert _get(port.url + poll) == (200, b'{"wake": false, "cursor": 0}')
    finally:
        port.stop()


MESH_OPTIONS = ("mesh_engine", "mesh_ctx", "EVOLU_MESH_ENGINE")


def _mesh_option(case, make_ctx):
    """→ (constructor kwargs, env) for one way of turning the mesh engine on."""
    if case == "mesh_engine":
        return {"mesh_engine": True}, {}
    if case == "mesh_ctx":
        return {"mesh_ctx": make_ctx()}, {}
    return {}, {"EVOLU_MESH_ENGINE": "on"}


@pytest.mark.parametrize("case", MESH_OPTIONS)
@pytest.mark.parametrize("batching", [False, True])
def test_mesh_options_serve_as_jax(case, batching, monkeypatch):
    """Each way of turning on the mesh-sharded engine (the argument, an
    explicit context of 8 CPU shards against the JAX package's 8-device
    mesh, the environment switch) builds a batching relay on both sides
    that answers the same POSTs with the JAX relay's bytes and carries
    the /stats `mesh` section."""
    from evolu_tpu.parallel.mesh import MeshContext as JaxMeshContext

    from evolu_tpu_torch.parallel.mesh import MeshContext

    def drive(make):
        server = make().start()
        try:
            assert server.mesh_engine is True and server.scheduler is not None
            out = [_post(server.url, b) for b in _bodies()]
            code, stats = _get(server.url + "/stats")
            return out, code, json.loads(stats)
        finally:
            server.stop()

    caps = prelay.DEFAULT_CAPABILITIES
    jkw, env = _mesh_option(case, JaxMeshContext)
    pkw, _ = _mesh_option(case, lambda: MeshContext(devices=["cpu"] * 8))
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    want = within(LIMIT_S, lambda: drive(lambda: jrelay.RelayServer(
        jrelay.RelayStore(backend="native"), batching=batching, capabilities=caps, **jkw)))
    got = within(LIMIT_S, lambda: drive(lambda: prelay.RelayServer(
        prelay.RelayStore(backend="native"), batching=batching, device="cpu", **pkw)))
    assert got[0] == want[0]
    assert all(code == 200 for code, _ in got[0])
    assert got[1] == want[1] == 200
    assert _store_section(got[2]) == _store_section(want[2])
    mesh = got[2]["mesh"]
    assert set(mesh) == set(want[2]["mesh"])
    assert set(mesh["xdev_reduce_total"]) == set(want[2]["mesh"]["xdev_reduce_total"])
    assert mesh["dispatches_total"] > 0 and mesh["xdev_reduce_total"]["digest"] > 0
    if case == "mesh_ctx":
        assert mesh["devices"] == 8


def _scoped_bodies():
    """Scoped POSTs: a tagged push of two lanes (rows authored by the
    pusher), a v1 push with no lanes, a pull of one lane from another node,
    a watermark pull, the pusher's own pull (its rows stay in its tree), and
    the lane pull again with the tree it was answered (nothing more)."""
    caps = (pproto.CAP_SYNC_SCOPE,)
    lane_a, lane_b = "a" * 16, "b" * 16
    push = pproto.SyncRequest(_msgs(pproto, "c" * 16, 0, 12), "owner-s", "c" * 16, "{}", caps,
                              pproto.ScopeClause(0, (lane_a,), (lane_a, lane_b) * 6))
    v1 = pproto.SyncRequest(_msgs(pproto, "d" * 16, 20, 6), "owner-s", "d" * 16, "{}")
    lane = pproto.ScopeClause(0, (lane_a,), ())
    return [push, v1,
            pproto.SyncRequest((), "owner-s", FRESH_NODE, "{}", caps, lane),
            pproto.SyncRequest((), "owner-s", FRESH_NODE, "{}", caps, pproto.ScopeClause(BASE + 6_000, (), ())),
            pproto.SyncRequest((), "owner-s", "c" * 16, "{}", caps, lane)]


@pytest.mark.parametrize("batching", [False, True])
def test_scope_capability_serves_scoped_posts_as_jax(batching):
    """A relay with `sync-scope-v1` (refused until scoped sync was ported)
    answers scoped POSTs with the JAX relay's bytes, records the same lanes
    and ends with the same tables; the slice converges (a pull with the
    tree it was answered gets nothing more). A relay built without the
    capability strips the clause and answers the full serve, as the JAX
    one does."""
    from evolu_tpu.server import scope as jscope
    from evolu_tpu_torch.server import scope as pscope

    def drive(make, scope_mod, caps):
        scope_mod.tree_cache.reset()
        server = make(caps).start()
        try:
            out = [_post(server.url, pproto.encode_sync_request(r)) for r in _scoped_bodies()]
            lane_pull = pproto.decode_sync_response(out[2][1])
            again = pproto.SyncRequest((), "owner-s", FRESH_NODE, lane_pull.merkle_tree, (pproto.CAP_SYNC_SCOPE,),
                                       pproto.ScopeClause(0, ("a" * 16,), ()))
            out.append(_post(server.url, pproto.encode_sync_request(again)))
            db = server.store.db
            lanes = (db.exec('SELECT * FROM "scopeLane" ORDER BY 1, 2')
                     if db.exec("SELECT name FROM sqlite_schema WHERE name='scopeLane'") else None)
            return out, lanes, db.exec('SELECT * FROM "message" ORDER BY 1, 2')
        finally:
            server.stop()

    for caps in (pproto.KNOWN_CAPABILITIES, ()):
        want = within(LIMIT_S, lambda: drive(lambda c: jrelay.RelayServer(
            jrelay.RelayStore(backend="native"), batching=batching, capabilities=c), jscope, caps))
        got = within(LIMIT_S, lambda: drive(lambda c: prelay.RelayServer(
            prelay.RelayStore(backend="native"), batching=batching, capabilities=c, device="cpu"), pscope, caps))
        assert got == want
        assert all(code == 200 for code, _ in got[0])
        answers = [pproto.decode_sync_response(b).messages for _, b in got[0]]
        if caps:
            # Lane a and the unknown-lane v1 rows; lane b withheld.
            assert len(answers[2]) == 6 + 6 and len(answers[3]) == 18 - 6 and answers[5] == ()
            assert len(answers[4]) == 6 and len(got[1]) == 12  # the pusher is served the v1 rows only
        else:
            assert len(answers[2]) == 18 and got[1] is None  # the full serve, no lanes recorded


# The relay tier's replication half and the push / connection-tier
# options, refused until ported, now accepted: (kwargs, environment).
ACCEPTED = {
    "peers": ({"peers": []}, {}),
    "replication": ({"replication": "manager"}, {}),
    "bootstrap_lag_owners": ({"peers": [], "bootstrap_lag_owners": 1}, {}),
    "checkpoint_interval_s": ({"checkpoint_interval_s": 3600.0, "checkpoint_path": "ckpt"}, {}),
    "replication_interval_s": ({"peers": [], "replication_interval_s": 0.1}, {}),
    "checkpoint_path": ({"checkpoint_path": "ckpt"}, {}),
    "push": ({"push": True}, {}),
    "eventloop": ({"connection_tier": "eventloop"}, {}),
    "EVOLU_CONN_TIER": ({}, {"EVOLU_CONN_TIER": "eventloop"}),
}


@pytest.mark.parametrize("case", list(ACCEPTED))
@pytest.mark.parametrize("batching", [False, True])
def test_relay_tier_options_are_accepted(case, batching, tmp_path, monkeypatch):
    """The options of the replication half and of push and the connection
    tier construct a relay that starts, serves /ping and /push/poll and
    stops, with the replication manager wired to the scheduler and to the
    push hub."""
    from evolu_tpu_torch.server.replicate import ReplicationManager

    kwargs, env = dict(ACCEPTED[case][0]), ACCEPTED[case][1]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    store = prelay.RelayStore(backend="native")
    if kwargs.get("replication") == "manager":
        kwargs["replication"] = ReplicationManager(store, [])
    if "checkpoint_path" in kwargs:
        kwargs["checkpoint_path"] = str(tmp_path / kwargs["checkpoint_path"])
    server = prelay.RelayServer(store, batching=batching, device="cpu", **kwargs).start()
    try:
        assert _get(server.url + "/ping") == (200, b"ok")
        poll = "/push/poll?owner=a&node=0000000000000000&cursor=0&timeout=0"
        assert _get(server.url + poll) == (200, b'{"wake": false, "cursor": 0}')
        assert server.connection_tier == ("eventloop" if case in ("eventloop", "EVOLU_CONN_TIER") else "threaded")
        if "peers" in kwargs or "replication" in kwargs:
            assert server.replication is not None
            assert server.replication.push_hub is server.push_hub
            if "peers" in kwargs:
                assert server.replication.scheduler is server.scheduler
        assert (server.checkpointer is not None) == ("checkpoint_interval_s" in kwargs)
    finally:
        server.stop()


# The write-behind options, refused until ported, now build a queue:
# (kwargs, environment, Config.write_behind). The `write_behind_log` case
# turns write-behind on through the Config.
WRITE_BEHIND = {
    "write_behind": ({"write_behind": True}, {}, False),
    "EVOLU_WRITE_BEHIND": ({}, {"EVOLU_WRITE_BEHIND": "1"}, False),
    "write_behind_log": ({"write_behind_log": "relay.wal"}, {}, True),
}


@pytest.mark.parametrize("case", list(WRITE_BEHIND))
@pytest.mark.parametrize("batching", [False, True])
def test_write_behind_options_build_a_queue(case, batching, tmp_path, monkeypatch):
    """Each way of turning write-behind on builds a queue and a scheduler
    over it; a POST answers the JAX relay's bytes, `/stats` has the
    `write_behind` section, and `stop()` drains and leaves an empty log."""
    from evolu_tpu_torch.storage.write_behind import LOG_MAGIC, WriteBehindQueue
    from evolu_tpu_torch.utils import config

    kwargs, env, cfg_on = dict(WRITE_BEHIND[case][0]), WRITE_BEHIND[case][1], WRITE_BEHIND[case][2]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if cfg_on:
        monkeypatch.setattr(config, "default_config", config.Config(write_behind=True))
    path = str(tmp_path / "relay.db")
    log = str(tmp_path / kwargs["write_behind_log"]) if "write_behind_log" in kwargs else path + ".wblog"
    if "write_behind_log" in kwargs:
        kwargs["write_behind_log"] = log
    server = prelay.RelayServer(prelay.RelayStore(path, backend="native"), batching=batching, device="cpu",
                                **kwargs).start()
    jax_store = jrelay.RelayStore()
    try:
        assert isinstance(server.write_behind, WriteBehindQueue) and server.write_behind.log_path == log
        assert server.scheduler is not None and server.scheduler._write_behind is server.write_behind
        req = pproto.SyncRequest(_msgs(pproto, "a" * 16, 0, 12), "uW", "a" * 16, "{}")
        jreq = jproto.SyncRequest(_msgs(jproto, "a" * 16, 0, 12), "uW", "a" * 16, "{}")
        assert _post(server.url + "/", pproto.encode_sync_request(req)) == (200, jax_store.sync_wire(jreq))
        status, body = _get(server.url + "/stats")
        section = json.loads(body)["write_behind"]
        assert status == 200 and section["enqueued_rows"] == 12 and section["drain_mode"] == "thread"
    finally:
        server.stop()
        jax_store.close()
    with open(log, "rb") as f:
        assert f.read() == LOG_MAGIC


def test_env_switched_off_and_defaults_serve(monkeypatch):
    """A switch set to off is honoured, as in the reference: the relay
    starts and serves; a scheduler with the mesh engine serves too."""
    monkeypatch.setenv("EVOLU_WRITE_BEHIND", "0")
    monkeypatch.setenv("EVOLU_MESH_ENGINE", "off")
    monkeypatch.setenv("EVOLU_CONN_TIER", "threaded")
    server = prelay.RelayServer(prelay.RelayStore(backend="native"), push=False).start()
    try:
        assert _get(server.url + "/ping") == (200, b"ok")
    finally:
        server.stop()
    with pytest.raises(ValueError):
        prelay.RelayServer(connection_tier="bogus")
    # The mesh engine (refused until the mesh was ported) serves: a context
    # of CPU shards, or `mesh_engine` resolving the process-wide one.
    from evolu_tpu_torch.parallel.mesh import MeshContext, create_mesh

    req = pproto.SyncRequest(_msgs(pproto, "a" * 16, 0, 5), "uM", "a" * 16, "{}")
    want = prelay.serve_single_request(prelay.RelayStore(backend="native"), req, device="cpu")
    for kw in ({"mesh_engine": True}, {"mesh_ctx": MeshContext(create_mesh(devices=["cpu"] * 2))}):
        sched = psched.SyncScheduler(prelay.RelayStore(backend="native"), device="cpu", **kw)
        try:
            assert sched.submit(req) == want and sched.mesh_ctx is not None
        finally:
            sched.stop()
            sched.store.close()
    # A scoped request under write-behind (refused until scoped sync was
    # ported) is served by the scheduler after its owner's drain, as the
    # JAX scheduler serves it: same bytes, same tables and lanes.
    from evolu_tpu.server.scheduler import SyncScheduler as JaxScheduler
    from evolu_tpu.storage.write_behind import WriteBehindQueue as JaxWriteBehind
    from evolu_tpu_torch.storage.write_behind import WriteBehindQueue

    def scoped_reqs(proto):
        push = proto.SyncRequest(_msgs(proto, "a" * 16, 0, 3), "uS", "a" * 16, "{}", (proto.CAP_SYNC_SCOPE,),
                                 proto.ScopeClause(watermark_millis=BASE, tags=("t" * 16,), push_tags=("t" * 16,) * 3))
        pull = proto.SyncRequest((), "uS", FRESH_NODE, "{}", (proto.CAP_SYNC_SCOPE,),
                                 proto.ScopeClause(watermark_millis=BASE + 1000, tags=("t" * 16,)))
        return [push, pull]

    def serve(store, wb, sched):
        try:
            out = [sched.submit(r) for r in scoped_reqs(pproto if isinstance(wb, WriteBehindQueue) else jproto)]
            wb.flush()
            return (out, wb.counts["queued"] if hasattr(wb, "counts") else None,
                    store.db.exec('SELECT * FROM "message" ORDER BY 1, 2'),
                    store.db.exec('SELECT * FROM "scopeLane" ORDER BY 1, 2'))
        finally:
            sched.stop()
            wb.close()
            store.close()

    jstore = jrelay.RelayStore(backend="native")
    jwb = JaxWriteBehind(jstore)
    want = serve(jstore, jwb, JaxScheduler(jstore, write_behind=jwb))
    store = prelay.RelayStore(backend="native")
    wb = WriteBehindQueue(store)
    got = serve(store, wb, psched.SyncScheduler(store, device="cpu", write_behind=wb))
    assert got[0] == want[0] and got[2:] == want[2:]
    assert got[1] == 3 and len(got[2]) == 3 and len(got[3]) == 3
    assert len(pproto.decode_sync_response(got[0][1]).messages) == 2  # past the watermark, lane t


def _converge(clients, n_rows, rounds=12):
    for _ in range(rounds):
        for c in clients:
            c.sync()
            c.worker.flush()
            c._transport.flush()
            c.worker.flush()
        rows = [c.db.exec('SELECT * FROM "__message" ORDER BY "timestamp"') for c in clients]
        if len(rows[0]) == n_rows and all(r == rows[0] for r in rows):
            return True
    return False


def test_two_port_clients_converge_over_http_with_v2_negotiated():
    from evolu_tpu_torch.runtime.client import create_evolu
    from evolu_tpu_torch.sync.client import connect
    from evolu_tpu_torch.utils.config import Config

    def run():
        server = prelay.RelayServer(prelay.RelayStore(backend="native"), batching=True, device="cpu").start()
        url = server.url + "/"
        a = b = None

        def stored():
            return [bytes(r["content"]) for r in server.store.db.exec_sql_query('SELECT content FROM "message"')]

        try:
            cfg = Config(sync_url=url, backend="cuda")
            a = create_evolu(SCHEMA, config=cfg, device="cpu")
            b = create_evolu(SCHEMA, config=cfg, mnemonic=a.owner.mnemonic, device="cpu")
            ta, tb = connect(a), connect(b)
            a.create("todo", {"title": "r1", "isCompleted": False})
            a.worker.flush(); ta.flush(); a.worker.flush()
            round1 = stored()
            for i in range(6):
                (a if i % 2 else b).create("todo", {"title": f"t{i}", "isCompleted": i % 3 == 0})
            ok = _converge([a, b], 7 * 4)  # title, isCompleted, createdAt, createdBy
            rows = [c.query_once('SELECT "title", "isCompleted" FROM "todo" ORDER BY "title"') for c in (a, b)]
            return (ok, round1, stored(), rows, ta.negotiated_capabilities.get(url, ()),
                    tb.negotiated_capabilities.get(url, ()), dict(server.scheduler.counts), ta.counts)
        finally:
            for c in (a, b):
                if c is not None:
                    c.dispose()
            server.stop()

    ok, round1, contents, rows, caps_a, caps_b, counts, ta_counts = within(LIMIT_S, run)
    assert ok, "the clients did not converge through the batching relay"
    assert rows[0] == rows[1] and len(rows[0]) == 7
    assert round1 and not any(jaead.is_v2_record(c) for c in round1), "round 1 must store OpenPGP only"
    assert pproto.CAP_AEAD_BATCH in caps_a and pproto.CAP_AEAD_BATCH in caps_b
    assert any(jaead.is_v2_record(c) for c in contents), "no v2 record after the echo"
    assert ta_counts.get("v2_push_legs", 0) >= 1
    assert counts["coalesced"] >= 4 and counts["singles"] == 0 and counts["poisoned_batches"] == 0


# ---- the workloads of tests/test_relay_concurrency.py on a port MultiprocessRelay ----


def _run_threads(workers):
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
        t.join(timeout=90)
    assert not any(t.is_alive() for t in threads), "stress thread hung"
    if errors:
        raise errors[0]


def _post_req(url, req):
    status, body = _post(url, pproto.encode_sync_request(req))
    assert status == 200
    return body


def _jax_serve(store, user, node, tree="{}"):
    return jrelay.serve_single_request(store, jproto.SyncRequest((), user, node, tree))


def test_multiprocess_25_concurrent_distinct_owners_match_jax(tmp_path):
    relay = prelay.MultiprocessRelay(str(tmp_path / "relay.db"), workers=2, shards=4).start()
    users = [f"user{i:02d}" for i in range(25)]
    nodes = [f"{i:016x}" for i in range(1, 26)]
    try:
        def client(u, node):
            def run():
                for rnd in range(3):
                    _post_req(relay.url, pproto.SyncRequest(_msgs(pproto, node, rnd * 30, 30), u, node, "{}"))
            return run

        within(LIMIT_S, lambda: _run_threads([client(u, n) for u, n in zip(users, nodes)]))
        oracle = jrelay.RelayStore(backend="python")
        for u, node in zip(users, nodes):
            oracle.add_messages(u, _msgs(jproto, node, 0, 90))
            got = _post_req(relay.url, pproto.SyncRequest((), u, FRESH_NODE, "{}"))
            assert got == _jax_serve(oracle, u, FRESH_NODE), u
        oracle.close()
    finally:
        relay.stop()


def test_multiprocess_single_owner_duplicates_race_matches_jax(tmp_path):
    relay = prelay.MultiprocessRelay(str(tmp_path / "relay.db"), workers=2, shards=1).start()
    user = "hot-owner"
    shared = _msgs(pproto, "a" * 16, 0, 20)
    try:
        def writer(i):
            node = f"{i + 1:016x}"
            own = _msgs(pproto, node, 100 + i * 20, 20)

            def run():
                _post_req(relay.url, pproto.SyncRequest(shared + own, user, node, "{}"))
                _post_req(relay.url, pproto.SyncRequest(shared, user, node, "{}"))
            return run

        within(LIMIT_S, lambda: _run_threads([writer(i) for i in range(8)]))
        oracle = jrelay.RelayStore(backend="python")
        oracle.add_messages(user, _msgs(jproto, "a" * 16, 0, 20) + tuple(
            m for i in range(8) for m in _msgs(jproto, f"{i + 1:016x}", 100 + i * 20, 20)))
        got = _post_req(relay.url, pproto.SyncRequest((), user, FRESH_NODE, "{}"))
        assert got == _jax_serve(oracle, user, FRESH_NODE)
        assert len(pproto.decode_sync_response(got).messages) == 180  # duplicates stored once
        oracle.close()
    finally:
        relay.stop()


def test_multiprocess_concurrent_clients_tables_match_jax(tmp_path):
    path = str(tmp_path / "relay.db")
    relay = prelay.MultiprocessRelay(path, workers=2, shards=4).start()

    def batch(i, rnd, proto):
        node = f"{i + 1:016x}"
        return tuple(proto.EncryptedCrdtMessage(
            timestamp_to_string(Timestamp(BASE + (i * 1000 + rnd * 100 + j) * 1000, 0, node)), b"ct" * 8)
            for j in range(40))

    try:
        def client(i):
            def run():
                for rnd in range(3):
                    _post_req(relay.url, pproto.SyncRequest(batch(i, rnd, pproto), f"user{i:02d}",
                                                            f"{i + 1:016x}", "{}"))
            return run

        within(LIMIT_S, lambda: _run_threads([client(i) for i in range(12)]))
    finally:
        relay.stop()
    store = prelay.ShardedRelayStore(path, shards=4)
    oracle = jrelay.ShardedRelayStore(shards=4, backend="python")
    try:
        for i in range(12):
            oracle.add_messages(f"user{i:02d}", tuple(m for rnd in range(3) for m in batch(i, rnd, jproto)))
        for mine, theirs in zip(store.shards, oracle.shards):
            for sql in ('SELECT "userId", "timestamp", "content" FROM "message" ORDER BY 1, 2',
                        'SELECT "userId", "merkleTree" FROM "merkleTree" ORDER BY 1'):
                assert [tuple(r.values()) for r in mine.db.exec_sql_query(sql)] == \
                    [tuple(r.values()) for r in theirs.db.exec_sql_query(sql)]
        assert sum(s["messages"] for s in store.stats()) == 12 * 120
    finally:
        store.close()
        oracle.close()


@pytest.mark.parametrize("device", ["cpu", None], ids=["cpu", "default"])
def test_multiprocess_scoped_post_folds_on_its_device(tmp_path, device):
    """A `MultiprocessRelay` worker folds a scoped pull's 1,100 canonical
    candidates (past `SCOPE_DEVICE_FOLD_MIN`, so kernels H and X) on the
    relay's `device`: "cpu" answers the JAX relay's bytes. The default is
    the card, so on a host without one the fold raises and the POST
    answers 500 (no fold falls back to the CPU); with a card it answers the
    JAX bytes too."""
    import torch

    user, node = "scoped-owner", "a" * 16
    clause = lambda proto: proto.ScopeClause(watermark_millis=BASE + 100 * 1000)  # noqa: E731
    pull = lambda proto: proto.SyncRequest((), user, FRESH_NODE, "{}", (proto.CAP_SYNC_SCOPE,), clause(proto))  # noqa: E731
    relay = prelay.MultiprocessRelay(str(tmp_path / "relay.db"), workers=2, shards=4, device=device).start()
    try:
        _post_req(relay.url, pproto.SyncRequest(_msgs(pproto, node, 0, 1200), user, node, "{}"))
        status, got = within(LIMIT_S, lambda: _post(relay.url, pproto.encode_sync_request(pull(pproto))))
    finally:
        relay.stop()
    oracle = jrelay.RelayStore(backend="python")
    try:
        oracle.add_messages(user, _msgs(jproto, node, 0, 1200))
        want = jrelay.serve_single_request(oracle, pull(jproto)) + \
            jproto.encode_response_capabilities((jproto.CAP_SYNC_SCOPE,))
    finally:
        oracle.close()
    if device is None and not torch.cuda.is_available():
        assert status == 500
    else:
        assert status == 200 and got == want
        assert len(pproto.decode_sync_response(got).messages) == 1100


def test_port_clients_converge_through_the_multiprocess_relay(tmp_path):
    from evolu_tpu_torch.runtime.client import create_evolu
    from evolu_tpu_torch.sync.client import connect
    from evolu_tpu_torch.utils.config import Config

    relay = prelay.MultiprocessRelay(str(tmp_path / "relay.db"), workers=2, shards=4).start()
    a = b = None
    try:
        cfg = Config(sync_url=relay.url + "/", backend="cuda")
        a = create_evolu(SCHEMA, config=cfg, device="cpu")
        b = create_evolu(SCHEMA, config=cfg, mnemonic=a.owner.mnemonic, device="cpu")
        connect(a)
        connect(b)
        for i in range(20):
            (a if i % 2 else b).create("todo", {"title": f"t{i}", "isCompleted": False})
        assert within(LIMIT_S, lambda: _converge([a, b], 20 * 4, rounds=20)), \
            "replicas did not converge through the multiprocess relay"
        store = prelay.ShardedRelayStore(str(tmp_path / "relay.db"), shards=4)
        try:
            tree = store.get_merkle_tree_string(a.owner.id)
        finally:
            store.close()
        from evolu_tpu_torch.core.merkle import merkle_tree_to_string
        from evolu_tpu_torch.storage.clock import read_clock

        assert merkle_tree_to_string(read_clock(a.db).merkle_tree) == tree
    finally:
        for c in (a, b):
            if c is not None:
                c.dispose()
        relay.stop()
