"""Coverage and family parity of the port's observability seams against the
JAX package.

- Static coverage: for each module pair below, both files are read as
  text (nothing is imported), and every conservation-ledger station the
  reference counts (`ledger.count(ledger.X` or a pending entry's
  `.count(ledger.X`) and every metric family it records
  (`metrics.inc|observe|set_gauge("evolu_…"`) must appear in the port's
  counterpart; a reference module that opens a transactional
  `ledger.pending()` entry needs one in the port too.
- Family parity: one small episode runs through each package from a
  clean registry and ledger: a write-behind relay's sync POSTs with a
  parked push poll woken, its flushes and drains; a replication round
  pulled from it; a scoped serve; a forward across a two-relay fleet; and
  a typed apply. Every counter family must be equal in name, labels and
  value, every histogram in name, labels and count, and the ledger's
  station totals equal. Three kinds of counter are held apart, each for
  a stated reason: wall-time totals (`*_seconds_total`, compared by name
  and labels; `evolu_stage_over_floor_total`, which a slow stage alone
  mints, left out), and the device-transfer bytes, which scale with the
  JAX session's 8 virtual devices against the port's one shard (the
  compact upload exactly 8x, the pull by name and labels). One family is
  the port's own, `evolu_relay_decode_total{route}` (the relay front's
  decode route): it is held apart and must count every sync POST the
  reference counts under `evolu_relay_requests_total{endpoint="/"}`.

Tolerance: exact."""

import re
import threading
import time
import types
import urllib.request
from pathlib import Path

import pytest
from _torch_jax_state import jax_process_state  # noqa: F401  (the JAX package's native libraries and ledger)

import evolu_tpu.obs.ledger as jledger
import evolu_tpu.obs.metrics as jmetrics
import evolu_tpu.server.relay as jrelay
import evolu_tpu.server.replicate as jrep
import evolu_tpu.storage as jstorage
import evolu_tpu.sync.client as jclient
import evolu_tpu.sync.protocol as jproto
import evolu_tpu.utils.config as jconfig
from evolu_tpu.core.types import TableDefinition as JaxTable
import evolu_tpu_torch.obs.ledger as pledger
import evolu_tpu_torch.obs.metrics as pmetrics
import evolu_tpu_torch.server.relay as prelay
import evolu_tpu_torch.server.replicate as prep
import evolu_tpu_torch.storage as pstorage
import evolu_tpu_torch.sync.client as pclient
import evolu_tpu_torch.sync.protocol as pproto
import evolu_tpu_torch.utils.config as pconfig
from _torch_port_data import TYPED_COLUMNS, TYPED_TABLE, jax_messages, port_messages, typed_batches
from _torch_relay_tier import free_ports
from evolu_tpu_torch.core.timestamp import Timestamp, timestamp_to_string
from evolu_tpu_torch.core.types import TableDefinition

ROOT = Path(__file__).resolve().parent.parent

# The module pairs whose seams the port carries: the relay's and
# engine's serving path, the scheduler, the planners, the apply plane,
# write-behind, the relay tier, push and the event-loop tier, the sync
# transport and its crypto, and the typed CRDT planes.
MODULES = (
    "server/relay", "server/engine", "server/scheduler", "ops/merge", "storage/apply",
    "storage/write_behind", "server/replicate", "server/fleet", "server/snapshot", "server/scope",
    "server/push", "server/conn", "sync/client", "sync/aead", "core/crdt_types", "core/crdt_list",
    "core/crdt_tensor", "ops/crdt_tensor_merge",
)
_FAMILY = re.compile(r'metrics\.(?:inc|observe|set_gauge)\(\s*"(evolu_\w+)"')
_STATION = re.compile(r'\.count\(\s*ledger\.([A-Z_]+)')


def _texts(module):
    return ((ROOT / "evolu_tpu" / f"{module}.py").read_text(),
            (ROOT / "evolu_tpu_torch" / f"{module}.py").read_text())


@pytest.mark.parametrize("module", MODULES)
def test_every_reference_station_and_family_is_in_the_port(module):
    ref, port = _texts(module)
    families = sorted(set(_FAMILY.findall(ref)))
    stations = sorted(set(_STATION.findall(ref)))
    missing = [f for f in families if f'"{f}"' not in port]
    missing += [f"ledger.{s}" for s in stations if f"ledger.{s}" not in port]
    if "ledger.pending()" in ref and "ledger.pending()" not in port:
        missing.append("ledger.pending()")
    assert not missing, f"{module}: {missing}"


def test_the_coverage_check_sees_the_seams():
    """The two patterns find what the reference holds: the relay's stations
    and the write-behind families, so an empty match cannot pass vacuously."""
    ref, _port = _texts("server/relay")
    assert {"INGRESS_SYNC", "SHED_BACKPRESSURE", "EGRESS_FORWARD", "REJECT_INVALID"} <= set(_STATION.findall(ref))
    ref, _port = _texts("storage/write_behind")
    assert {"evolu_wb_apply_lag_ms", "evolu_wb_queue_rows"} <= set(_FAMILY.findall(ref))
    assert {"WB_QUEUED", "WB_DRAINED", "STORE_INSERTED"} <= set(_STATION.findall(ref))


# --- family parity over one episode ---

BASE = 1_700_000_000_000
JAX = types.SimpleNamespace(name="jax", relay=jrelay, rep=jrep, proto=jproto, config=jconfig,
                            ledger=jledger, metrics=jmetrics, storage=jstorage, http_post=jclient._http_post,
                            table=JaxTable, typed_messages=jax_messages, extra={})
PORT = types.SimpleNamespace(name="port", relay=prelay, rep=prep, proto=pproto, config=pconfig,
                             ledger=pledger, metrics=pmetrics, storage=pstorage, http_post=pclient._http_post,
                             table=TableDefinition, typed_messages=port_messages, extra={"device": "cpu"})


def _msgs(pkg, node, start, n):
    return tuple(pkg.proto.EncryptedCrdtMessage(timestamp_to_string(Timestamp(BASE + (start + i) * 1000, 0, node)),
                                                b"ct-%d" % (start + i)) for i in range(n))


def _post(pkg, url, req):
    return pkg.http_post(url + "/", pkg.proto.encode_sync_request(req), retries=0)


def _wait(pred, what):
    deadline = time.time() + 20
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


def _episode(pkg, tmp, ports):
    pkg.metrics.reset()
    pkg.ledger.reset()
    servers = []
    try:
        # A write-behind relay (2 native shards) that is a replication
        # listener, with a push subscriber parked on alice.
        w = pkg.relay.RelayServer(pkg.relay.ShardedRelayStore(str(tmp / "w.db"), backend="native", shards=2),
                                  port=ports[0], write_behind=True, write_behind_log=str(tmp / "w.wblog"),
                                  peers=[], replication_interval_s=3600, **pkg.extra)
        w.replication.replica_id = "relay-w"
        # An hour-long debounce: the first hint arms the sweep and later ones
        # coalesce into it, so the hint count is not a race with the loop.
        w.replication.debounce_s = 3600.0
        servers.append(w.start())
        polled = {}

        def poll():
            url = f"{w.url}/push/poll?owner=alice&node={'f' * 16}&cursor=0&timeout=20"
            with urllib.request.urlopen(url, timeout=30) as r:
                polled["body"] = r.read()

        poller = threading.Thread(target=poll)
        poller.start()
        _wait(lambda: w.push_hub.stats_payload()["subscriptions"] == 1, "the parked poll")
        for user, node, start, n in (("alice", "a" * 16, 0, 6), ("bob", "b" * 16, 100, 4), ("alice", "a" * 16, 0, 6)):
            _post(pkg, w.url, pkg.proto.SyncRequest(_msgs(pkg, node, start, n), user, node, "{}"))
            w.write_behind.flush()
        poller.join(timeout=30)
        assert b'"wake": true' in polled["body"] or b'"wake":true' in polled["body"]

        # One replication round pulled from it.
        mgr = pkg.rep.ReplicationManager(pkg.relay.RelayStore(backend="native"), [w.url], replica_id="relay-m",
                                         interval_s=3600, http_post=lambda url, body, **kw: pkg.http_post(
                                             url, body, retries=0, **kw))
        mgr.run_once()
        assert sorted(mgr.store.user_ids()) == ["alice", "bob"]

        # A scoped serve: lanes recorded by a tagged push, then a pull of
        # one lane from another device.
        scoped = pkg.relay.RelayStore(backend="native")
        lane_a, lane_b = "aa" * 8, "bb" * 8
        push = pkg.proto.SyncRequest(_msgs(pkg, "c" * 16, 200, 2), "carol", "c" * 16, "{}",
                                     scope=pkg.proto.ScopeClause(0, (lane_a,), (lane_a, lane_b)))
        pkg.relay.serve_single_request(scoped, push, **pkg.extra)
        pull = pkg.proto.SyncRequest((), "carol", "d" * 16, "{}", scope=pkg.proto.ScopeClause(0, (lane_a,), ()))
        pkg.relay.serve_single_request(scoped, pull, **pkg.extra)
        scoped.close()

        # A forward across a two-relay fleet.
        f1 = pkg.relay.RelayServer(pkg.relay.RelayStore(backend="native"), port=ports[1], **pkg.extra)
        f2 = pkg.relay.RelayServer(pkg.relay.RelayStore(backend="native"), port=ports[2], **pkg.extra)
        cfg = pkg.config.FleetConfig(relays=(f1.url, f2.url), replication_factor=1, version=1, forward=True)
        f1.enable_fleet(cfg)
        f2.enable_fleet(cfg)
        servers += [f1.start(), f2.start()]
        owner = next(f"fw{i:04d}" for i in range(10_000) if f1.fleet.ring.primary(f"fw{i:04d}") == f2.url)
        _post(pkg, f1.url, pkg.proto.SyncRequest(_msgs(pkg, "e" * 16, 300, 3), owner, "e" * 16, "{}"))

        # A typed apply.
        db = pkg.storage.open_database(":memory:", "python")
        pkg.storage.init_db_model(db, "legal winner thank year wave sausage worth useful legal winner thank yellow")
        pkg.storage.update_db_schema(db, [pkg.table.of(TYPED_TABLE, TYPED_COLUMNS)], **pkg.extra)
        tree = {}
        for b in typed_batches(0):
            tree = pkg.storage.apply_messages(db, tree, pkg.typed_messages(b), **pkg.extra)
        db.close()
        audit = pkg.ledger.audit(at_barrier=False)
    finally:
        for s in reversed(servers):
            s.stop()
    snap = pkg.metrics.registry.snapshot()
    counters = {(name, tuple(sorted(e["labels"].items()))): e["value"]
                for name, fam in snap["counters"].items() for e in fam}
    hists = {(name, tuple(sorted(e["labels"].items()))): e["count"]
             for name, fam in snap["histograms"].items() for e in fam}
    return counters, hists, pkg.ledger.totals(), audit


# Counters whose value is a wall time: compared by name and labels only.
# `evolu_stage_over_floor_total` counts stage records slower than their
# recorded floor, so whether it appears at all is the host's timing.
_TIMED_OVER_FLOOR = "evolu_stage_over_floor_total"
# Device-transfer bytes scale with the mesh an engine pass lays out: the
# JAX package runs on the test session's 8 virtual CPU devices, the port's
# engine on one shard. The compact upload is exactly 8x; the pull adds a
# per-device digest, so it is compared by name and labels.
_MESH_SCALED = "evolu_engine_compact_upload_bytes_total"
_PULL_BYTES = ("evolu_pull_bytes_total", "evolu_stage_bytes_total")
# The port's own family: the relay front's decode by route.
_PORT_ONLY = "evolu_relay_decode_total"


def _sync_posts(counters) -> int:
    """The sync POSTs a relay counted (`evolu_relay_requests_total{endpoint="/"}`)."""
    return counters.get(("evolu_relay_requests_total", (("endpoint", "/"),)), 0)


def test_counter_and_histogram_families_equal_jax_over_one_episode(tmp_path):
    import jax

    ports = free_ports(3)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = _episode(JAX, tmp_path / "jax", ports)
    got = _episode(PORT, tmp_path / "port", ports)
    decoded = sum(v for k, v in got[0].items() if k[0] == _PORT_ONLY)
    assert decoded == _sync_posts(want[0]) > 0
    g_counters = {k: v for k, v in got[0].items() if k[0] not in (_TIMED_OVER_FLOOR, _PORT_ONLY)}
    w_counters = {k: v for k, v in want[0].items() if k[0] != _TIMED_OVER_FLOOR}
    assert set(g_counters) == set(w_counters), sorted(set(g_counters) ^ set(w_counters))
    for k in g_counters:
        if k[0].endswith("_seconds_total") or k[0] in _PULL_BYTES:
            continue
        if k[0] == _MESH_SCALED:
            assert g_counters[k] * jax.device_count() == w_counters[k], k
            continue
        assert g_counters[k] == w_counters[k], (k, g_counters[k], w_counters[k])
    diff = sorted((k, got[1].get(k), want[1].get(k)) for k in set(got[1]) | set(want[1])
                  if got[1].get(k) != want[1].get(k))
    assert not diff, f"histogram families differ (key, port, jax): {diff}"
    assert got[2] == want[2]
    assert got[3] == want[3] == []
    # The episode reached every plane it is meant to cover.
    names = {k[0] for k in got[0]}
    assert {"evolu_repl_rounds_total", "evolu_fleet_forwards_total", "evolu_scope_serves_total",
            "evolu_push_wakeups_total", "evolu_wb_flushes_total", "evolu_crdt_ops_total"} <= names
