"""The port's observability package (`evolu_tpu_torch.obs`), the twin of
tests/test_obs.py: registry semantics, the relay's /metrics and /stats
against driven traffic (one process and a MultiprocessRelay), the winner
cache's hit and miss counters under a scripted access pattern, the
host-fallback counter on a non-canonical batch, the sync transport's
counters, the flight recorder riding worker-boundary exceptions, and the
logger's integration. Then parity with the JAX package: the same seeded
events give byte-identical `render_prometheus()` and equal `snapshot()`,
and the same bodies POSTed to a JAX relay and a port relay give the same
/metrics families and deterministic counters."""

import json
import re
import urllib.request

import pytest
from _torch_jax_state import jax_process_state  # noqa: F401  (the JAX package's native libraries and ledger)

from evolu_tpu_torch.core.timestamp import Timestamp, timestamp_to_string
from evolu_tpu_torch.core.types import CrdtMessage
from evolu_tpu_torch.obs import flight, metrics
from evolu_tpu_torch.server.relay import (
    MultiprocessRelay,
    RelayServer,
    RelayStore,
    ShardedRelayStore,
)
from evolu_tpu_torch.sync import protocol
from evolu_tpu_torch.utils.log import logger

BASE = 1_700_000_000_000


@pytest.fixture(autouse=True)
def _clean_slate():
    logger.clear()  # resets ring + durations + metrics registry + flight
    yield
    logger.configure(False)
    logger.clear()


# --- registry semantics ---


def test_counter_gauge_histogram_roundtrip():
    metrics.inc("t_total", 3, kind="a")
    metrics.inc("t_total", kind="a")
    metrics.inc("t_total", kind="b")
    assert metrics.get_counter("t_total", kind="a") == 4
    assert metrics.get_counter("t_total", kind="b") == 1
    assert metrics.get_counter("t_total", kind="missing") == 0
    metrics.set_gauge("t_gauge", 7.5)
    assert metrics.registry.get_gauge("t_gauge") == 7.5
    for v in (0.1, 1.0, 100.0):
        metrics.observe("t_ms", v)
    edges, cum, total, count = metrics.registry.get_histogram("t_ms")
    assert count == 3 and total == pytest.approx(101.1)
    assert cum[-1] == 3  # +Inf cumulative = count
    assert all(b <= a for b, a in zip(cum, cum[1:]))  # monotone


def test_histogram_quantile_estimates_within_buckets():
    for _ in range(100):
        metrics.observe("q_ms", 1.0)
    q = metrics.quantile("q_ms", 0.5)
    # 1.0 lands in the (0.5, 1.0] bucket of the x2 latency family.
    assert 0.5 <= q <= 1.0


def test_reset_keeps_bucket_shape():
    metrics.observe("r_ms", 5.0, buckets=(1.0, 10.0))
    metrics.reset()
    metrics.observe("r_ms", 5.0)
    edges, _, _, count = metrics.registry.get_histogram("r_ms")
    assert edges == (1.0, 10.0) and count == 1


def test_quantile_clamps_overflow_to_top_finite_edge():
    """Registry hardening: mass in the overflow bucket — via
    the implicit +Inf bucket OR an explicitly registered inf edge —
    must estimate to the TOP FINITE bucket edge, never inf (dashboards
    need a plottable number)."""
    import math

    reg = metrics.MetricsRegistry()
    reg.observe("imp_ms", 1e9)  # far past the latency family's top edge
    q = reg.quantile("imp_ms", 0.99)
    assert q is not None and math.isfinite(q)
    assert q == metrics.LATENCY_MS_BUCKETS[-1]
    reg.observe("exp_ms", 50.0, buckets=(1.0, 10.0, float("inf")))
    reg.observe("exp_ms", 60.0)
    q = reg.quantile("exp_ms", 0.5)
    assert q == 10.0  # top FINITE edge, though mass sits in the inf bucket
    # Interpolation inside finite buckets is unchanged.
    reg.observe("mid_ms", 5.0, buckets=(1.0, 10.0, float("inf")))
    assert 1.0 <= reg.quantile("mid_ms", 0.5) <= 10.0


def test_snapshot_reset_hammer_loses_no_events():
    """Registry hardening: `snapshot(reset=True)` drains
    atomically — with writer threads hammering inc()/observe(), the sum
    across drained windows plus the final residue must equal exactly
    what the writers recorded. A separate snapshot();reset() pair loses
    whatever lands between the two calls; this pins the one-lock
    contract."""
    import threading

    reg = metrics.MetricsRegistry()
    N_THREADS, N_EVENTS = 4, 2000
    stop = threading.Event()

    def writer():
        for _ in range(N_EVENTS):
            reg.inc("h_total")
            reg.observe("h_ms", 1.0, buckets=(10.0,))

    threads = [threading.Thread(target=writer) for _ in range(N_THREADS)]
    drained_counter = 0.0
    drained_hist = 0
    for t in threads:
        t.start()
    try:
        while any(t.is_alive() for t in threads):
            snap = reg.snapshot(reset=True)
            for s in snap["counters"].get("h_total", []):
                drained_counter += s["value"]
            for s in snap["histograms"].get("h_ms", []):
                drained_hist += s["count"]
    finally:
        stop.set()
        for t in threads:
            t.join()
    final = reg.snapshot(reset=True)
    for s in final["counters"].get("h_total", []):
        drained_counter += s["value"]
    for s in final["histograms"].get("h_ms", []):
        drained_hist += s["count"]
    assert drained_counter == N_THREADS * N_EVENTS
    assert drained_hist == N_THREADS * N_EVENTS


def test_build_info_and_process_gauges(tmp_path):
    """`evolu_build_info` (facts in labels) and the
    uptime/RSS process gauges surface on /metrics so a fleet dashboard
    can tell relay topologies apart without SSH."""
    server = RelayServer(RelayStore()).start()
    try:
        text = _get(server.url + "/metrics")
        m = re.search(r"^evolu_build_info\{([^}]*)\} 1$", text, re.M)
        assert m, "evolu_build_info gauge missing from /metrics"
        labels = dict(
            kv.split("=", 1) for kv in re.findall(r'[a-z_]+="[^"]*"', m.group(1))
        )
        assert labels['version'].strip('"')
        assert labels['backend'].strip('"') in ("native", "python")
        assert labels['write_behind'].strip('"') == "0"
        assert labels['connection_tier'].strip('"') in ("threaded", "eventloop")
        assert "mesh_engine" in labels and "push" in labels
        parsed = _parse_prometheus(text)
        up = parsed[("evolu_process_uptime_seconds", frozenset())]
        assert up >= 0
        rss = parsed.get(("evolu_process_rss_bytes", frozenset()))
        assert rss is None or rss > 1 << 20  # >1MB if the probe worked
    finally:
        server.stop()


def test_prometheus_exposition_is_valid_and_escaped():
    metrics.inc("e_total", 2, path='we"ird\\x', note="a\nb")
    metrics.observe("e_ms", 3.0)
    text = metrics.render_prometheus()
    line_re = re.compile(
        r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? -?[0-9.eE+;inf]+$'
    )
    for line in text.strip().splitlines():
        if line.startswith("#"):
            assert re.match(r"^# (HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]* ", line)
        else:
            assert line_re.match(line), line
    assert 'path="we\\"ird\\\\x"' in text
    assert 'note="a\\nb"' in text
    assert "e_ms_bucket" in text and 'le="+Inf"' in text
    assert "e_ms_sum 3" in text and "e_ms_count 1" in text
    # snapshot carries the same data, JSON-serializably
    snap = json.loads(metrics.registry.snapshot_json())
    assert snap["counters"]["e_total"][0]["value"] == 2


def test_label_cardinality_bound_folds_into_overflow():
    """Data-driven label values (per-owner freshness gauges)
    must never grow the registry unboundedly — past the per-family
    cap, NEW label sets fold into "__overflow__" and are counted."""
    reg = metrics.MetricsRegistry()
    reg.label_cardinality_cap = 4
    for i in range(10):
        reg.set_gauge("t_fresh", i, owner=f"o{i}", peer="p")
    # 4 admitted + the one folded overflow series.
    assert len(reg._gauges["t_fresh"]) == 5
    assert reg.get_gauge("t_fresh", owner="o3", peer="p") == 3
    assert reg.get_gauge(
        "t_fresh", owner="__overflow__", peer="__overflow__") == 9  # last write
    assert reg.get_counter("evolu_obs_label_overflow_total",
                           family="t_fresh") == 6
    # Existing series keep updating in place — no new fold.
    reg.set_gauge("t_fresh", 33, owner="o3", peer="p")
    assert reg.get_gauge("t_fresh", owner="o3", peer="p") == 33
    assert reg.get_counter("evolu_obs_label_overflow_total",
                           family="t_fresh") == 6
    # Counters and histograms share the bound.
    for i in range(10):
        reg.inc("t_total", owner=f"o{i}")
        reg.observe("t_ms", 1.0, owner=f"o{i}")
    assert len(reg._counters["t_total"]) == 5
    assert len(reg._hists["t_ms"]) == 5
    assert reg.get_counter("t_total", owner="__overflow__") == 6
    # Unlabeled series never fold (one series can't explode).
    for _ in range(10):
        reg.inc("t_plain_total")
    assert reg.get_counter("t_plain_total") == 10
    # Exposition stays valid with the folded series present.
    assert 'owner="__overflow__"' in reg.render_prometheus()


def test_histogram_exemplars_latest_wins_and_render_opt_in():
    metrics.observe("ex_ms", 5.0, exemplar="a" * 32)
    metrics.observe("ex_ms", 7.0, exemplar="b" * 32)
    metrics.observe("ex_ms", 9.0)  # exemplar-less observe keeps the last
    tid, value, ts = metrics.registry.get_exemplar("ex_ms")
    assert tid == "b" * 32 and value == 7.0 and ts > 0
    snap = metrics.snapshot()
    (series,) = snap["histograms"]["ex_ms"]
    assert series["exemplar"][0] == "b" * 32
    # Default text exposition is plain 0.0.4; exemplars are opt-in.
    assert "trace_id" not in metrics.render_prometheus()
    assert '# {trace_id="' + "b" * 32 + '"}' in \
        metrics.registry.render_prometheus(exemplars=True)


def test_disabled_registry_records_nothing():
    metrics.set_enabled(False)
    try:
        metrics.inc("d_total")
        metrics.observe("d_ms", 1.0)
    finally:
        metrics.set_enabled(True)
    assert metrics.get_counter("d_total") == 0
    assert metrics.registry.get_histogram("d_ms") is None


# --- Logger integration ---


def test_span_feeds_histogram_and_duration_summary():
    for _ in range(4):
        with logger.span("kernel:merge", "unit"):
            pass
    summary = logger.duration_summary("kernel:merge")
    assert summary["count"] == 4
    assert summary["mean_ms"] == pytest.approx(summary["total_ms"] / 4)
    assert summary["max_ms"] >= summary["mean_ms"]
    assert "p50_ms" in summary and summary["p50_ms"] > 0
    _, _, _, count = metrics.registry.get_histogram(
        "evolu_kernel_span_ms", target="kernel:merge"
    )
    assert count == 4


def test_logger_clear_resets_registry_and_flight():
    metrics.inc("c_total")
    flight.record("dev", "before clear")
    logger.clear()
    assert metrics.get_counter("c_total") == 0
    assert flight.dump() == []


def test_flight_records_disabled_log_targets():
    """The recorder exists for events nobody was watching: a log() on a
    console-disabled target must still land in the flight ring."""
    logger.configure(False)
    logger.log("sync:request", "invisible", n=1)
    assert logger.recent_events() == []  # console ring stays gated
    evs = flight.dump()
    assert any(e.target == "sync:request" and e.message == "invisible" for e in evs)


def test_flight_attach_is_idempotent_and_noted():
    flight.record("dev", "breadcrumb", step=1)
    e = ValueError("boom")
    flight.attach(e)
    first = e.flight_records
    assert any(ev.message == "breadcrumb" for ev in first)
    flight.record("dev", "later")
    flight.attach(e)  # nested boundary: keeps the innermost dump
    assert e.flight_records is first


# --- winner-cache counters (scripted access pattern) ---


def _cache_db():
    from evolu_tpu_torch.storage.native import open_database
    from evolu_tpu_torch.storage.schema import init_db_model

    db = open_database(":memory:", "auto")
    init_db_model(db, mnemonic=None)
    db.exec('CREATE TABLE "todo" ("id" TEXT PRIMARY KEY, "title" BLOB)')
    return db


def _msg(i, row):
    return CrdtMessage(
        timestamp_to_string(Timestamp(BASE + i * 1000, 0, "a1b2c3d4e5f60718")),
        "todo", row, "title", f"v{i}",
    )


def test_winner_cache_hit_miss_counters_match_scripted_pattern():
    from evolu_tpu_torch.ops.winner_cache import DeviceWinnerCache
    from evolu_tpu_torch.storage.apply import apply_messages

    db = _cache_db()
    cache = DeviceWinnerCache(db, adaptive=False, device="cpu")  # pin the cached path
    tree = {}
    try:
        # Batch 1: 5 fresh cells -> 5 misses, 0 hits, 5 seeds.
        batch1 = [_msg(i, f"r{i}") for i in range(5)]
        tree = apply_messages(db, tree, batch1, planner=cache.plan_batch)
        assert metrics.get_counter("evolu_winner_cache_misses_total") == 5
        assert metrics.get_counter("evolu_winner_cache_hits_total") == 0
        assert metrics.get_counter("evolu_winner_cache_seeded_cells_total") == 5
        # Batch 2: the same 5 cells -> 5 hits, no new misses or seeds.
        batch2 = [_msg(10 + i, f"r{i}") for i in range(5)]
        tree = apply_messages(db, tree, batch2, planner=cache.plan_batch)
        assert metrics.get_counter("evolu_winner_cache_hits_total") == 5
        assert metrics.get_counter("evolu_winner_cache_misses_total") == 5
        assert metrics.get_counter("evolu_winner_cache_seeded_cells_total") == 5
        # Batch 3: 3 known + 2 fresh -> hits 5+3, misses 5+2.
        batch3 = [_msg(20 + i, f"r{i}") for i in range(3)] + [
            _msg(30 + i, f"new{i}") for i in range(2)
        ]
        tree = apply_messages(db, tree, batch3, planner=cache.plan_batch)
        assert metrics.get_counter("evolu_winner_cache_hits_total") == 8
        assert metrics.get_counter("evolu_winner_cache_misses_total") == 7
        # Invalidation accounting.
        cache.invalidate([("todo", "r0", "title"), ("todo", "absent", "title")])
        assert metrics.get_counter("evolu_winner_cache_invalidated_cells_total") == 1
    finally:
        db.close()


def test_host_fallback_counter_increments_exactly_on_noncanonical_batch():
    from evolu_tpu_torch.ops.merge import plan_batch_device

    canonical = [_msg(0, "r0"), _msg(1, "r1")]
    plan_batch_device(canonical, {}, device="cpu")
    assert metrics.get_counter("evolu_merge_host_fallbacks_total") == 0
    bad = [
        CrdtMessage("2023-09-01T10:00:00.000Z-0000-ABCDEF0123456789",
                    "todo", "rw", "title", "U"),
        _msg(2, "r2"),
    ]
    plan_batch_device(bad, {}, device="cpu")
    assert metrics.get_counter("evolu_merge_host_fallbacks_total") == 1
    assert metrics.get_counter("evolu_merge_host_fallback_messages_total") == 2
    plan_batch_device(canonical, {}, device="cpu")
    assert metrics.get_counter("evolu_merge_host_fallbacks_total") == 1


# --- sync transport wire counters ---


def test_sync_transport_counts_requests_and_bytes():
    from evolu_tpu_torch.core.types import Owner
    from evolu_tpu_torch.runtime.messages import SyncRequestInput
    from evolu_tpu_torch.sync.client import SyncTransport
    from evolu_tpu_torch.utils.config import Config

    ts = timestamp_to_string(Timestamp(BASE, 0, "89e3b4f11a2c5d70"))
    response = protocol.encode_sync_response(protocol.SyncResponse((), "{}"))
    posted = []

    def fake_post(url, body):
        posted.append(len(body))
        return response

    t = SyncTransport(Config(), on_receive=lambda *a: None, http_post=fake_post)
    try:
        t.request_sync(SyncRequestInput((), ts, "{}", Owner("o", "m")))
        t.flush()
    finally:
        t.stop()
    assert metrics.get_counter("evolu_sync_requests_total") == 1
    assert metrics.get_counter("evolu_sync_responses_total") == 1
    _, _, byte_sum, count = metrics.registry.get_histogram("evolu_sync_request_bytes")
    assert count == 1 and byte_sum == posted[0]
    _, _, resp_sum, _ = metrics.registry.get_histogram("evolu_sync_response_bytes")
    assert resp_sum == len(response)


# --- worker boundary: flight dump rides OnError ---


def test_worker_error_carries_flight_records():
    from evolu_tpu_torch.runtime.client import create_evolu

    evolu = create_evolu({"todo": ("title",)}, device="cpu")
    try:
        errors = []
        evolu.subscribe_error(errors.append)
        evolu.create("todo", {"title": "x"})  # leaves clock events in the ring
        evolu.worker.flush()
        evolu.worker.post(object())  # unknown command -> OnError(ValueError)
        evolu.worker.flush()
        assert errors, "unknown command must surface OnError"
        err = errors[0].error if hasattr(errors[0], "error") else errors[0]
        records = getattr(err, "flight_records", None)
        assert isinstance(records, list) and records, (
            "worker-boundary exceptions must carry the flight dump"
        )
        assert metrics.get_counter("evolu_worker_errors_total", command="object") == 1
    finally:
        evolu.dispose()


# --- relay endpoints ---


def _post(url, req):
    body = protocol.encode_sync_request(req)
    r = urllib.request.urlopen(
        urllib.request.Request(
            url, data=body, headers={"Content-Type": "application/octet-stream"}
        ),
        timeout=30,
    )
    return protocol.decode_sync_response(r.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.read().decode("utf-8")


def _sync_req(user, node, n_msgs, start=0):
    msgs = tuple(
        protocol.EncryptedCrdtMessage(
            timestamp_to_string(Timestamp(BASE + (start + i) * 1000, 0, node)),
            b"ct-%d" % (start + i),
        )
        for i in range(n_msgs)
    )
    return protocol.SyncRequest(msgs, user, node, "{}")


def _parse_prometheus(text):
    """name{labels} value -> {(name, frozenset(label items)): float}."""
    out = {}
    for line in text.strip().splitlines():
        if line.startswith("#"):
            continue
        m = re.match(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})? (.+)$", line)
        assert m, f"unparseable exposition line: {line!r}"
        labels = frozenset(
            tuple(kv.split("=", 1)) for kv in re.findall(r'[^,{]+="[^"]*"', m.group(3) or "")
        )
        out[(m.group(1), labels)] = float(m.group(4).replace("+Inf", "inf"))
    return out


def _counter_sum(parsed, name):
    return sum(v for (n, _), v in parsed.items() if n == name)


def test_relay_metrics_and_stats_agree_with_driven_traffic():
    store = ShardedRelayStore(":memory:", shards=4)
    server = RelayServer(store).start()
    try:
        users = [f"user-{i}" for i in range(6)]
        for i, u in enumerate(users):
            _post(server.url, _sync_req(u, f"{i:016x}", n_msgs=3, start=i * 10))
        _post(server.url, _sync_req(users[0], "0" * 16, n_msgs=0))  # pull round

        parsed = _parse_prometheus(_get(server.url + "/metrics"))
        key = ("evolu_relay_requests_total", frozenset({("endpoint", '"/"')}))
        assert parsed[key] == 7
        # latency histogram: one observation per sync POST
        assert _counter_sum(
            {k: v for k, v in parsed.items() if k[0] == "evolu_relay_request_ms_count"},
            "evolu_relay_request_ms_count",
        ) == 7
        # per-shard counters cover every request exactly once
        shard_counts = {
            k[1]: v for k, v in parsed.items()
            if k[0] == "evolu_relay_shard_requests_total"
        }
        assert sum(shard_counts.values()) == 7
        expected_shards = {store.shard_index(u) for u in users} | {
            store.shard_index(users[0])
        }
        assert {
            int(dict(k)["shard"].strip('"')) for k in shard_counts
        } == expected_shards

        stats = json.loads(_get(server.url + "/stats"))
        assert stats["messages"] == 6 * 3  # every pushed row landed
        assert stats["users"] == 6
        assert stats["requests_total"] == 7
        assert len(stats["shards"]) == 4
        assert sum(s["messages"] for s in stats["shards"]) == 18
        assert sum(s["requests"] for s in stats["shards"]) == 7
        assert stats["latency_ms"]["count"] == 7
        # /metrics and /stats must agree with each other too
        assert _counter_sum(parsed, "evolu_relay_shard_requests_total") == (
            stats["requests_total"]
        )
    finally:
        server.stop()


def test_relay_metrics_include_client_side_counters_in_process():
    """The registry is process-global: a relay serving /metrics in the
    same process as kernel work exposes winner-cache hit/miss and
    host-fallback counts alongside its own — one scrape shows the whole
    pipeline's decisions, all driven by REAL traffic here (cache plans
    + a non-canonical batch + relay sync posts)."""
    from evolu_tpu_torch.ops.merge import plan_batch_device
    from evolu_tpu_torch.ops.winner_cache import DeviceWinnerCache
    from evolu_tpu_torch.storage.apply import apply_messages

    db = _cache_db()
    cache = DeviceWinnerCache(db, adaptive=False, device="cpu")
    tree = apply_messages(
        db, {}, [_msg(i, f"r{i}") for i in range(4)], planner=cache.plan_batch
    )
    apply_messages(
        db, tree, [_msg(10 + i, f"r{i}") for i in range(4)],
        planner=cache.plan_batch,
    )
    plan_batch_device(
        [CrdtMessage("2023-09-01T10:00:00.000Z-0000-ABCDEF0123456789",
                     "todo", "rw", "title", "U")], {}, device="cpu",
    )
    server = RelayServer(RelayStore()).start()
    try:
        _post(server.url, _sync_req("u1", "a" * 16, n_msgs=2))
        parsed = _parse_prometheus(_get(server.url + "/metrics"))
        assert parsed[("evolu_winner_cache_hits_total", frozenset())] == 4
        assert parsed[("evolu_winner_cache_misses_total", frozenset())] == 4
        assert parsed[("evolu_merge_host_fallbacks_total", frozenset())] == 1
        key = ("evolu_relay_requests_total", frozenset({("endpoint", '"/"')}))
        assert parsed[key] == 1
        assert parsed[("evolu_relay_request_ms_count", frozenset())] == 1
    finally:
        server.stop()
        db.close()


def test_multiprocess_relay_metrics_and_stats(tmp_path):
    relay = MultiprocessRelay(
        str(tmp_path / "relay.db"), workers=2, shards=4
    ).start()
    try:
        for i in range(8):
            _post(relay.url, _sync_req(f"mp-user-{i}", f"{i:016x}", n_msgs=2))
        # /metrics: any worker's exposition must parse as valid text.
        parsed = _parse_prometheus(_get(relay.url + "/metrics"))
        assert any(k[0] == "evolu_relay_requests_total" for k in parsed) or parsed == {}
        # /stats row counts come from the SHARED store: exact no matter
        # which worker answers (request counters are per-process and
        # are asserted only in the single-process test).
        stats = json.loads(_get(relay.url + "/stats"))
        assert stats["messages"] == 16
        assert stats["users"] == 8
        assert len(stats["shards"]) == 4
    finally:
        relay.stop()


# --- parity with the JAX package ---


def _seeded_events(seed=5, n=400):
    """One seeded sequence of registry events over the families the relay
    and the engine record: counters with labels, histograms (log buckets,
    the size and count buckets) with exemplars, and gauges."""
    import numpy as np

    rng = np.random.default_rng(seed)
    events = []
    for i in range(n):
        kind = int(rng.integers(0, 3))
        if kind == 0:
            events.append(("inc", "evolu_relay_requests_total", float(rng.integers(1, 5)),
                           {"endpoint": ["/", "/stats", "/metrics"][int(rng.integers(0, 3))]}))
        elif kind == 1:
            fam = ["evolu_relay_request_ms", "evolu_relay_request_bytes", "evolu_sched_batch_requests"][
                int(rng.integers(0, 3))]
            value = float(rng.lognormal(3.0, 2.0))
            events.append(("observe", fam, value, {"exemplar": f"{int(rng.integers(0, 1 << 62)):032x}"}))
        else:
            events.append(("set_gauge", "evolu_sched_queue_depth", float(rng.integers(0, 64)), {}))
    return events


def _replay(mod, events):
    reg = mod.MetricsRegistry()
    buckets = {"evolu_relay_request_bytes": mod.SIZE_BUCKETS, "evolu_sched_batch_requests": mod.COUNT_BUCKETS}
    for op, name, value, labels in events:
        if op == "observe":
            reg.observe(name, value, buckets=buckets.get(name), **labels)
        else:
            getattr(reg, op)(name, value, **labels)
    # The process gauges, pinned.
    reg.set_gauge("evolu_process_uptime_seconds", 12.5)
    reg.set_gauge("evolu_process_rss_bytes", float(1 << 27))
    return reg


def test_metrics_parity_with_jax_on_seeded_events(monkeypatch):
    """The same seeded inc / observe (with exemplars) / set_gauge events
    through the JAX registry and the port's give byte-identical
    `render_prometheus()` (with and without exemplars) and equal
    `snapshot()`, with the clock pinned."""
    import time as _time

    from evolu_tpu.obs import metrics as jmetrics

    monkeypatch.setattr(_time, "time", lambda: 1_700_000_000.25)
    events = _seeded_events()
    jreg, preg = _replay(jmetrics, events), _replay(metrics, events)
    assert preg.render_prometheus() == jreg.render_prometheus()
    assert preg.render_prometheus(exemplars=True) == jreg.render_prometheus(exemplars=True)
    assert preg.snapshot() == jreg.snapshot()
    for q in (0.5, 0.9, 0.99):
        assert preg.quantile("evolu_relay_request_ms", q) == jreg.quantile("evolu_relay_request_ms", q)


def _families(text):
    return {m.group(1) for m in re.finditer(r"^# TYPE (\S+) ", text, re.M)}


def test_single_relay_metrics_parity_with_jax():
    """The same bodies POSTed one at a time to a batching JAX relay and a
    batching port relay: the same /metrics family names and the same
    values for the deterministic counters (requests, messages, bytes,
    batches, coalesced requests, store passes, upload bytes)."""
    from evolu_tpu.server import relay as jrelay
    from evolu_tpu.utils.log import logger as jlogger

    bodies = [_sync_req(f"par-{i}", f"{i + 1:016x}", n_msgs=3 + i, start=i * 10) for i in range(5)]
    bodies.append(_sync_req("par-0", "f" * 16, n_msgs=0))  # a pull round

    def drive(server, clear):
        clear()
        server.start()
        try:
            out = [_post(server.url, b) for b in bodies]
            return out, _get(server.url + "/metrics")
        finally:
            server.stop()

    want, jtext = drive(jrelay.RelayServer(jrelay.RelayStore(backend="native"), batching=True), jlogger.clear)
    got, ptext = drive(RelayServer(RelayStore(backend="native"), batching=True, device="cpu"), logger.clear)
    assert got == want
    # The port prices only the card (COST_LAWS has a `cuda` row alone), so on
    # the CPU it records no floor families; the JAX package prices its CPU.
    priced = {"evolu_stage_floor_ms", "evolu_stage_over_floor_ratio", "evolu_stage_over_floor_total"}
    assert _families(ptext) == _families(jtext) - priced
    assert not _families(ptext) & priced
    jp, pp = _parse_prometheus(jtext), _parse_prometheus(ptext)
    for name in ("evolu_relay_requests_total", "evolu_crypto_v1_relay_messages_total",
                 "evolu_relay_request_bytes_sum", "evolu_relay_request_bytes_count",
                 "evolu_relay_response_bytes_sum", "evolu_relay_request_ms_count",
                 "evolu_relay_shard_requests_total", "evolu_sched_batches_total",
                 "evolu_sched_coalesced_requests_total", "evolu_engine_store_passes_total"):
        assert {k: v for k, v in pp.items() if k[0] == name} == {k: v for k, v in jp.items() if k[0] == name}, name
    # The JAX engine's pass spans conftest's 8 virtual CPU devices, the
    # port's one shard: each request's one owner fills one shard of the
    # same bucket, so the JAX upload is 8 of the port's.
    upload = ("evolu_engine_compact_upload_bytes_total", frozenset({("variant", '"delta"')}))
    assert 8 * pp[upload] == jp[upload] > 0
    assert pp[("evolu_crypto_v1_relay_messages_total", frozenset())] == sum(3 + i for i in range(5))
