"""The port's conservation ledger (`evolu_tpu_torch.obs.ledger`), the twin
of tests/test_ledger.py's module-level tests: stations and equations,
audit with per-station deltas and barrier scoping, pending entries, the
owner cardinality cap, the snapshot, a disabled ledger; then the
recompile sentinel's port counterpart, the pull waves and the evidence
dump, and parity with the JAX package's audit() and snapshot() for the
same counts. No module of the port counts into the ledger yet, so the
relay-level tests of the reference have no twin here."""

import json
import urllib.error
import urllib.request

from _torch_jax_state import jax_process_state  # noqa: F401  (the JAX package's native libraries and ledger)

from evolu_tpu_torch.core.timestamp import Timestamp, timestamp_to_string
from evolu_tpu_torch.obs import ledger as ledger_mod
from evolu_tpu_torch.obs import metrics
from evolu_tpu_torch.obs.ledger import Ledger
from evolu_tpu_torch.server.relay import RelayServer, ShardedRelayStore
from evolu_tpu_torch.sync import protocol

BASE = 1700000000000


def setup_function(_fn):
    ledger_mod.reset()
    ledger_mod.set_enabled(True)
    metrics.reset()


def _ts(i, node="89e3b4f11a2c5d70"):
    return timestamp_to_string(Timestamp(BASE + i * 1000, 0, node))


def _sync_req(user, node, n_msgs, start=0, ts_list=None):
    msgs = tuple(
        protocol.EncryptedCrdtMessage(t, b"ct-%d" % i)
        for i, t in enumerate(
            ts_list
            if ts_list is not None
            else [_ts(start + i, node) for i in range(n_msgs)]
        )
    )
    return protocol.SyncRequest(msgs, user, node, "{}")


def _post(url, req, expect_error=None):
    body = protocol.encode_sync_request(req)
    try:
        r = urllib.request.urlopen(
            urllib.request.Request(
                url, data=body,
                headers={"Content-Type": "application/octet-stream"},
            ),
            timeout=30,
        )
        return protocol.decode_sync_response(r.read())
    except urllib.error.HTTPError as e:
        if expect_error is not None and e.code == expect_error:
            return None
        raise


def _get_json(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read().decode("utf-8"))


# --- unit semantics ---


def test_counts_totals_and_owner_subledgers():
    led = Ledger()
    led.count(ledger_mod.INGRESS_SYNC, 5, owner="alice")
    led.count(ledger_mod.INGRESS_SYNC, 2, owner="bob")
    led.count(ledger_mod.STORE_INSERTED, 7)
    assert led.total(ledger_mod.INGRESS_SYNC) == 7
    assert led.owner_totals("alice") == {ledger_mod.INGRESS_SYNC: 5}
    assert led.audit() == []  # 7 in, 7 out
    led.count(ledger_mod.STORE_DUPLICATE, 1)
    v = led.audit()
    assert len(v) == 1 and v[0]["equation"] == "server-flow"
    assert v[0]["delta"] == -1
    assert v[0]["rhs"][ledger_mod.STORE_DUPLICATE] == 1


def test_audit_reports_per_station_deltas_and_barrier_scoping():
    led = Ledger()
    led.count(ledger_mod.WB_QUEUED, 10)
    # Mid-stream: the wb balance only holds at a drain barrier.
    assert led.audit(at_barrier=False) == []
    v = led.audit(at_barrier=True)
    names = {x["equation"] for x in v}
    assert "write-behind-balance" in names
    led.count(ledger_mod.WB_DRAINED, 10)
    led.count(ledger_mod.INGRESS_SYNC, 10)
    led.count(ledger_mod.STORE_INSERTED, 10)
    assert led.audit(at_barrier=True) == []


def test_apply_plane_equations():
    led = Ledger()
    led.count(ledger_mod.APPLY_INGRESS, 10)
    led.count(ledger_mod.ROUTE_PACKED, 6)
    led.count(ledger_mod.ROUTE_OBJECT, 4)
    led.count(ledger_mod.APPLY_INSERTED, 5)
    led.count(ledger_mod.APPLY_LOSING, 2)
    led.count(ledger_mod.APPLY_DUPLICATE, 3)
    assert led.audit() == []
    led.count(ledger_mod.APPLY_INGRESS, 1)  # unrouted message
    assert [v["equation"] for v in led.audit()] == ["apply-routing"]


def test_pending_entry_commit_abort_and_single_shot():
    led = Ledger()
    e = led.pending()
    e.count(ledger_mod.INGRESS_SYNC, 3, owner="o")
    assert led.total(ledger_mod.INGRESS_SYNC) == 0  # not yet posted
    e.commit()
    e.commit()  # idempotent
    assert led.total(ledger_mod.INGRESS_SYNC) == 3
    a = led.pending()
    a.count(ledger_mod.INGRESS_SYNC, 99)
    a.abort()
    a.commit()  # after abort: nothing
    assert led.total(ledger_mod.INGRESS_SYNC) == 3


def test_owner_cardinality_cap_folds_into_overflow():
    led = Ledger(owner_cardinality_cap=4)
    for i in range(10):
        led.count(ledger_mod.INGRESS_SYNC, 1, owner=f"owner-{i}")
    owners = led.owners()
    assert len(owners) == 5  # 4 real + __overflow__
    assert led.owner_totals(ledger_mod.OWNER_OVERFLOW) == {
        ledger_mod.INGRESS_SYNC: 6
    }
    # The GLOBAL station total is never lost to the fold.
    assert led.total(ledger_mod.INGRESS_SYNC) == 10


def test_snapshot_shape_and_reset():
    led = Ledger()
    led.count(ledger_mod.INGRESS_SYNC, 2, owner="a")
    snap = led.snapshot()
    assert snap["stations"][ledger_mod.INGRESS_SYNC] == 2
    assert snap["owners"]["a"][ledger_mod.INGRESS_SYNC] == 2
    assert {e["name"] for e in snap["equations"]} >= {
        "server-flow", "write-behind-balance", "apply-routing",
        "apply-outcomes",
    }
    led.reset()
    assert led.totals() == {}
    assert led.owners() == []
    # Equations persist across reset (configuration, not data).
    led.count(ledger_mod.INGRESS_SYNC, 1)
    assert led.audit(at_barrier=True) != []


def test_disabled_ledger_records_nothing():
    led = Ledger()
    led.enabled = False
    led.count(ledger_mod.INGRESS_SYNC, 5)
    e = led.pending()
    e.count(ledger_mod.STORE_INSERTED, 5)
    e.commit()
    assert led.totals() == {}


# --- the recompile sentinel's port counterpart ---


def test_recompile_sentinel_flat_within_buckets():
    """The port keeps no jit cache; its sentinel counts the engine's launch
    shapes. Traffic within one bucket leaves the counter flat."""
    from evolu_tpu_torch.server import engine as eng_mod

    # The launch shapes are process-wide: start from none seen.
    eng_mod._DISPATCHED_BUCKETS.clear()
    eng_mod._JIT_SENTINEL_SIZES.clear()
    server = RelayServer(ShardedRelayStore(shards=2), batching=True, device="cpu").start()
    try:
        _post(server.url, _sync_req("alice", "a" * 16, 8))  # warm-up
        assert metrics.get_gauge("evolu_jit_cache_size", cache="merkle") == (
            eng_mod.merkle_jit_cache_size()
        )
        recompiles = metrics.get_counter("evolu_jit_recompiles_total", cache="merkle")
        # Same bucket (8 and 5 rows both pad to the 64-row bucket): flat.
        _post(server.url, _sync_req("bob", "b" * 16, 5, start=100))
        _post(server.url, _sync_req("carol", "c" * 16, 8, start=200))
        assert metrics.get_counter("evolu_jit_recompiles_total", cache="merkle") == recompiles, \
            "recompile sentinel moved within one bucket"
        # A new bucket (200 rows pad to 256) is a new launch shape: growth.
        _post(server.url, _sync_req("dave", "d" * 16, 200, start=300))
        assert metrics.get_counter("evolu_jit_recompiles_total", cache="merkle") == recompiles + 1
    finally:
        server.stop()


def test_recompile_sentinel_counts_growth_and_flight_event():
    from evolu_tpu_torch.obs import flight
    from evolu_tpu_torch.server import engine as eng_mod

    eng_mod._JIT_SENTINEL_SIZES.clear()
    eng_mod._note_bucket("delta", 64, 64, 1)  # at least one launch shape
    before = metrics.get_counter("evolu_jit_recompiles_total", cache="merkle")
    eng_mod.observe_jit_caches(0)  # baseline observation
    real = eng_mod.merkle_jit_cache_size()
    assert real >= 1
    # Simulate growth without dispatching: shrink the recorded baseline.
    eng_mod._JIT_SENTINEL_SIZES["merkle"] = real - 2 if real >= 2 else 0
    flight.clear()
    eng_mod.observe_jit_caches(batch_rows=777)
    grown = metrics.get_counter("evolu_jit_recompiles_total", cache="merkle")
    assert grown >= before + (2 if real >= 2 else real)
    evs = [e for e in flight.dump() if e.target == "kernel:jit"]
    assert evs and evs[-1].fields["bucket_rows"] >= 777
    eng_mod._JIT_SENTINEL_SIZES.clear()


# --- the pull waves ---


def test_pull_instrumentation_counts_waves():
    import numpy as np
    import torch

    from evolu_tpu_torch.ops import to_host_many

    before = metrics.get_counter("evolu_pull_bytes_total")
    arrs = to_host_many(torch.arange(1024, dtype=torch.int32), np.arange(256, dtype=np.int64))
    wave = sum(a.nbytes for a in arrs)
    assert metrics.get_counter("evolu_pull_bytes_total") == before + wave
    got = metrics.registry.get_histogram("evolu_pull_wave_bytes")
    assert got is not None and got[3] >= 1
    assert metrics.get_counter("evolu_pull_seconds_total") > 0


# --- the evidence dump carries the ledger ---


def test_write_evidence_includes_ledger_snapshot(tmp_path):
    from evolu_tpu_torch.obs import trace

    ledger_mod.count(ledger_mod.INGRESS_SYNC, 4, owner="ev-owner")
    path = trace.write_evidence("ledger-evidence-test", seed=1)
    assert not path.startswith("<")
    payload = json.loads(open(path).read())
    assert payload["ledger"]["stations"][ledger_mod.INGRESS_SYNC] == 4
    assert "violations" in payload["ledger"]


# --- parity with the JAX package ---


def test_audit_and_snapshot_parity_with_jax():
    """The same seeded counts, direct and through pending entries
    (committed and aborted), over every station and a few hundred owners
    (past a small cardinality cap), give the same audit() at and off a
    barrier and the same snapshot() in both packages."""
    import numpy as np

    from evolu_tpu.obs import ledger as jledger

    stations = sorted({v for k, v in vars(ledger_mod).items() if k.isupper() and isinstance(v, str)
                       and "." in v})
    assert stations == sorted({v for k, v in vars(jledger).items() if k.isupper() and isinstance(v, str)
                               and "." in v})
    rng = np.random.default_rng(23)
    events = [(stations[int(rng.integers(0, len(stations)))], int(rng.integers(0, 50)),
               f"owner-{int(rng.integers(0, 300))}" if rng.random() < 0.7 else None, int(rng.integers(0, 3)))
              for _ in range(2000)]
    ledgers = (ledger_mod.Ledger(owner_cardinality_cap=64), jledger.Ledger(owner_cardinality_cap=64))
    for led in ledgers:
        for station, n, owner, how in events:
            if how == 0:
                led.count(station, n, owner=owner)
            else:
                e = led.pending()
                e.count(station, n, owner=owner)
                e.commit() if how == 1 else e.abort()
    port, jax = ledgers
    assert port.audit() == jax.audit()
    assert port.audit(at_barrier=False) == jax.audit(at_barrier=False)
    assert port.snapshot() == jax.snapshot()
    assert port.snapshot(at_barrier=True) == jax.snapshot(at_barrier=True)
    # A balanced flow audits clean in both.
    for led in ledgers:
        led.reset()
        led.count("ingress.sync", 10, owner="a")
        led.count("store.inserted", 7, owner="a")
        led.count("store.duplicate", 3, owner="a")
    assert port.audit() == jax.audit() == []
