"""The port's twin of tests/test_model_check.py's mixed-traffic
conservation episode: one relay process sees every hostile flow at once,
and its conservation ledger still proves that every message that entered
reached exactly one terminal. The episode runs once on the JAX relay and
once on the port's (engine on the CPU), on the same seeded traffic.

- A write-behind relay worker (`tests/_write_behind_worker.py` for JAX,
  `tests/_torch_write_behind_worker.py` for the port) is SIGKILLed with
  ACKed but undrained records in its durable log.
- The restarted relay replays them (`ingress.replay`), classifying the
  rows a pre-kill drain already committed as `store.duplicate`.
- It then takes canonical pushes with an exact redelivery, a
  non-canonical-width request (the singleton's 500), a poisoned engine
  pass retried as singletons, and a 503 shed.

Where the kill lands decides the replay's counts, so they are held by the
equations in each package: `audit(at_barrier=True) == []` at the end,
`wb.queued == wb.drained`, and the replayed rows' terminals equal to the
replay's ingress. The traffic after the restart does not depend on timing:
its owners' station totals and the shed and reject totals must be equal in
both packages, and equal to the counts the script drives.

Tolerance: exact."""

import os
import subprocess
import sys
import time
import types
import urllib.error
import urllib.request

from _torch_jax_state import jax_process_state  # noqa: F401  (the JAX package's native libraries and ledger)

import evolu_tpu.obs.ledger as jledger
import evolu_tpu.server.engine as jengine
import evolu_tpu.server.relay as jrelay
import evolu_tpu.sync.protocol as jproto
import evolu_tpu_torch.obs.ledger as pledger
import evolu_tpu_torch.server.engine as pengine
import evolu_tpu_torch.server.relay as prelay
import evolu_tpu_torch.sync.protocol as pproto
from evolu_tpu_torch.core.timestamp import Timestamp, timestamp_to_string

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 20260805
OWNERS = ("mixed-alice", "mixed-nc", "mixed-bob", "mixed-shed")

JAX = types.SimpleNamespace(
    name="jax", ledger=jledger, engine=jengine, relay=jrelay, proto=jproto, kw={},
    worker=[os.path.join(HERE, "_write_behind_worker.py"), "ingest", "{db}", str(SEED), "6", "0.2"])
PORT = types.SimpleNamespace(
    name="port", ledger=pledger, engine=pengine, relay=prelay, proto=pproto, kw={"device": "cpu"},
    worker=[os.path.join(HERE, "_torch_write_behind_worker.py"), "ingest", "{db}", str(SEED), "6", "0.2",
            "1", "0", "cpu"])


def _ts(i):
    return timestamp_to_string(Timestamp(1700000000000 + i * 1000, 0, "1234567890abcdef"))


def _kill_mid_drain(pkg, db_path):
    """Run the package's worker until its third ACK, then SIGKILL it
    mid-drain. → the last ACKed batch."""
    argv = [sys.executable] + [a.format(db=db_path) for a in pkg.worker]
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE, text=True, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    acked = -1
    try:
        for line in proc.stdout:
            if line.startswith("ACK "):
                acked = int(line.split()[1])
                if acked >= 2:
                    time.sleep(0.15)  # land mid-drain
                    proc.kill()
                    break
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    return acked


def _episode(pkg, tmp_path, monkeypatch):
    """One package's episode. → (the script's owners' station totals, every
    station's total at the barrier)."""
    led = pkg.ledger
    db_path = str(tmp_path / f"mixed-{pkg.name}.db")
    acked = _kill_mid_drain(pkg, db_path)
    assert acked >= 0, f"{pkg.name}: worker never ACKed a batch"
    assert os.path.getsize(db_path + ".wblog") > 16, f"{pkg.name}: SIGKILL left no undrained log to replay"

    led.reset()  # the proof window starts at the restart
    led.set_enabled(True)
    orig = pkg.engine.BatchReconciler.run_batch_wire
    poison = {"armed": False, "fired": 0}

    def flaky(self, requests):
        if poison["armed"] and not poison["fired"]:
            poison["fired"] += 1
            raise RuntimeError("injected poisoned batch")
        return orig(self, requests)

    monkeypatch.setattr(pkg.engine.BatchReconciler, "run_batch_wire", flaky)
    server = pkg.relay.RelayServer(pkg.relay.RelayStore(db_path), write_behind=True, **pkg.kw).start()
    try:
        t = led.totals()
        replayed = t.get(led.INGRESS_REPLAY, 0)
        assert replayed > 0, f"{pkg.name}: restart replayed nothing"
        assert t.get(led.STORE_INSERTED, 0) + t.get(led.STORE_DUPLICATE, 0) == replayed

        def post(req, expect_error=None):
            body = pkg.proto.encode_sync_request(req)
            try:
                with urllib.request.urlopen(urllib.request.Request(server.url, data=body), timeout=30) as r:
                    return r.read()
            except urllib.error.HTTPError as e:
                assert expect_error == e.code, e
                return None

        def req(user, node, ts_list):
            return pkg.proto.SyncRequest(tuple(pkg.proto.EncryptedCrdtMessage(ts, b"ct") for ts in ts_list),
                                         user, node, "{}")

        ts = [_ts(i) for i in range(4)]
        # Canonical pushes and one exact redelivery (duplicates).
        post(req("mixed-alice", "a" * 16, ts[:3]))
        post(req("mixed-alice", "a" * 16, ts[:3]))
        # A non-canonical width → the singleton's host-oracle reject (500).
        post(req("mixed-nc", "b" * 16, ["1970-01-01T00:00:00.001Z-001-deadbeefdeadbeef"]), expect_error=500)
        # A poisoned engine pass → the singleton retry serves it exactly once.
        poison["armed"] = True
        post(req("mixed-bob", "c" * 16, [ts[3]]))
        poison["armed"] = False
        assert poison["fired"] == 1, f"{pkg.name}: poison injection never fired"
        # A 503 backpressure shed.
        real_max = server.scheduler.max_queue
        server.scheduler.max_queue = 0
        post(req("mixed-shed", "d" * 16, ts[:2]), expect_error=503)
        server.scheduler.max_queue = real_max

        server.write_behind.flush()
        t = led.totals()
        assert t[led.WB_QUEUED] == t[led.WB_DRAINED]
        assert t[led.BOUNCE_NON_CANONICAL] >= 1
        violations = led.audit(at_barrier=True)
        assert violations == [], (pkg.name, violations)
        return {o: led.ledger.owner_totals(o) for o in OWNERS}, t
    finally:
        server.stop()


def test_mixed_traffic_ledger_conservation_episode(tmp_path, monkeypatch):
    j_owners, j_totals = _episode(JAX, tmp_path, monkeypatch)
    p_owners, p_totals = _episode(PORT, tmp_path, monkeypatch)
    assert p_owners == j_owners
    for station in (pledger.SHED_BACKPRESSURE, pledger.REJECT_INVALID):
        assert p_totals[station] == j_totals[station]
    # The counts the script drives.
    assert p_totals[pledger.SHED_BACKPRESSURE] == 2
    assert p_totals[pledger.REJECT_INVALID] == 1
    alice, bob = p_owners["mixed-alice"], p_owners["mixed-bob"]
    assert alice[pledger.INGRESS_SYNC] == 6
    assert alice[pledger.STORE_INSERTED] == 3 and alice[pledger.STORE_DUPLICATE] == 3
    # mixed-bob's row: exactly once despite the poisoned pass.
    assert bob[pledger.STORE_INSERTED] == 1
    assert bob.get(pledger.STORE_DUPLICATE, 0) == 0
