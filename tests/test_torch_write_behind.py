"""Port parity: the write-behind storage inversion (`storage/write_behind.py`,
`storage/_wb_shard_proc.py`, the engine's deferred serve, the scheduler's
backpressure and the drain barriers of the relay tier) against the JAX
package's.

Every episode of `tests/test_write_behind.py` runs twice, once on the JAX
objects (write-behind engine + synchronous engine) and once on the port's
(`device="cpu"`), with the same inputs, and each side makes the reference
test's own checks. Then the two sides must agree on:
- what each episode observed: response bytes, `_dump` states after
  `flush()`, health and stats fields;
- the bytes of every record appended to a queue, in order;
- the counts: the port's queue counts (and the engine's
  `counts["store_duplicate"]`) against the JAX ledger's totals
  over the episode, as posted from its write-behind module and its
  deferred pass (`wb.queued`, `wb.drained`, `wb.dropped`, `store.inserted`,
  `store.duplicate`, `ingress.replay`).

Besides: crash-and-replay through the port's worker
(`tests/_torch_write_behind_worker.py`) on 1 shard and on 3, with the
reference's torture seeds marked slow as the reference's are; and a log
written by either package replayed by the other to the same state.

Tolerance: exact everywhere."""

import collections
import json
import os
import struct
import sys
import time
import urllib.error
import urllib.request
import zlib
from contextlib import contextmanager
from types import SimpleNamespace

import numpy as np
import pytest
from _torch_jax_state import jax_process_state  # noqa: F401  (the JAX package's native libraries and ledger)

import evolu_tpu.core.types as jtypes
import evolu_tpu.server.engine as jengine
import evolu_tpu.server.relay as jrelay
import evolu_tpu.server.scheduler as jsched
import evolu_tpu.server.snapshot as jsnap
import evolu_tpu.storage.write_behind as jwb
import evolu_tpu.sync.protocol as jproto
import evolu_tpu_torch.core.types as ptypes
import evolu_tpu_torch.server.engine as pengine
import evolu_tpu_torch.server.relay as prelay
import evolu_tpu_torch.server.scheduler as psched
import evolu_tpu_torch.server.snapshot as psnap
import evolu_tpu_torch.storage.write_behind as pwb
import evolu_tpu_torch.sync.protocol as pproto
from evolu_tpu_torch.core.timestamp import timestamp_to_string

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_write_behind_worker as pworker  # noqa: E402

BASE = 1700000000000


def _kit(name):
    if name == "jax":
        return SimpleNamespace(
            name=name, proto=jproto, wbm=jwb, RelayStore=jrelay.RelayStore,
            Sharded=jrelay.ShardedRelayStore,
            engine=lambda store, wb=None: jengine.BatchReconciler(store, write_behind=wb),
            scheduler=lambda store, **kw: jsched.SyncScheduler(store, **kw),
            QueueFull=jsched.SchedulerQueueFull, RelayServer=jrelay.RelayServer,
            snapshot=jsnap, EvoluError=jtypes.EvoluError)
    return SimpleNamespace(
        name=name, proto=pproto, wbm=pwb, RelayStore=prelay.RelayStore,
        Sharded=prelay.ShardedRelayStore,
        engine=lambda store, wb=None: pengine.BatchReconciler(store, device="cpu", write_behind=wb),
        scheduler=lambda store, **kw: psched.SyncScheduler(store, device="cpu", **kw),
        QueueFull=psched.SchedulerQueueFull,
        RelayServer=lambda store=None, **kw: prelay.RelayServer(store, device="cpu", **kw),
        snapshot=psnap, EvoluError=ptypes.EvoluError)


JAX, PORT = _kit("jax"), _kit("port")

# The JAX ledger's stations and the port's count names for them.
_STATIONS = {"wb.queued": "queued", "wb.drained": "drained", "wb.dropped": "dropped",
             "store.inserted": "inserted", "store.duplicate": "duplicate", "ingress.replay": "replayed"}


@contextmanager
def _jax_counts():
    """The JAX ledger's totals posted over the block from its write-behind
    module or its deferred pass (the synchronous twins' posts are left
    out), by port count name."""
    from evolu_tpu.obs import ledger

    got = collections.Counter()
    wb_file = os.path.join("storage", "write_behind.py")
    orig = ledger.ledger._post

    def post(counts):
        f = sys._getframe(1)
        while f is not None:
            if f.f_code.co_filename.endswith(wb_file) or f.f_code.co_name == "_finish_batch_deferred":
                for (station, _owner), n in counts.items():
                    if station in _STATIONS:
                        got[_STATIONS[station]] += n
                break
            f = f.f_back
        return orig(counts)

    ledger.ledger._post = post
    try:
        yield got
    finally:
        del ledger.ledger._post


@contextmanager
def _port_counts(queues):
    before = pengine.counts["store_duplicate"]
    got = collections.Counter()
    yield got
    for q in queues:
        for k in _STATIONS.values():
            got[k] += q.counts[k]
    got["duplicate"] += pengine.counts["store_duplicate"] - before


def _run(kit, episode, *args):
    """Run `episode(kit, *args)` with every appended record's bytes and the
    counts captured. → (observations, records, counts)."""
    cls = kit.wbm.WriteBehindQueue
    records, queues = [], []
    orig_init, orig_append = cls.__init__, cls.append_batch

    def init(self, *a, **kw):
        queues.append(self)
        orig_init(self, *a, **kw)

    def append(self, recs, trees=None):
        out = orig_append(self, recs, trees)
        records.append([r.encode() for r in recs])
        return out

    cls.__init__, cls.append_batch = init, append
    try:
        counting = _jax_counts() if kit is JAX else _port_counts(queues)
        with counting as counts:
            obs = episode(kit, *args)
    finally:
        cls.__init__, cls.append_batch = orig_init, orig_append
    return obs, records, {k: v for k, v in counts.items() if v}


def _parity(episode, *args):
    j = _run(JAX, episode, *args)
    p = _run(PORT, episode, *args)
    assert p[0] == j[0]
    assert p[1] == j[1]
    assert p[2] == j[2]
    return p


def _msgs(k, node, start, n, payload=b"ct"):
    return tuple(
        k.proto.EncryptedCrdtMessage(timestamp_to_string(ptypes.Timestamp(BASE + (start + i) * 1000, 0, node)),
                                     payload + b"-%d" % (start + i))
        for i in range(n))


def _req(k, msgs, owner, node, tree="{}"):
    return k.proto.SyncRequest(tuple(msgs), owner, node, tree)


def _synced_tree(k, req):
    """The post-push server tree of `req`: an in-sync client sends it, so
    the response diff is empty and nothing on the serving path needs
    SQLite."""
    s = k.RelayStore()
    try:
        return s.sync(req).merkle_tree
    finally:
        s.close()


def _dump(store):
    shards = getattr(store, "shards", None) or [store]
    rows, trees = [], []
    for s in shards:
        rows += [(r["userId"], r["timestamp"], r["content"])
                 for r in s.db.exec_sql_query('SELECT "timestamp", "userId", "content" FROM "message"')]
        trees += [(r["userId"], r["merkleTree"])
                  for r in s.db.exec_sql_query('SELECT "userId", "merkleTree" FROM "merkleTree"')]
    return sorted(rows), sorted(trees)


@contextmanager
def _pair(k, shards=4):
    """(store, write-behind queue, its engine, oracle store, synchronous
    engine), torn down in order."""
    store = k.Sharded(shards=shards)
    wb = k.wbm.WriteBehindQueue(store)
    eng = k.engine(store, wb)
    oracle = k.Sharded(shards=shards)
    oeng = k.engine(oracle)
    try:
        yield store, wb, eng, oracle, oeng
    finally:
        wb.close()
        eng.close()
        oeng.close()
        store.close()
        oracle.close()


def _owners_per_shard(store, per_shard=1):
    found, i = {}, 0
    while any(len(v) < per_shard for v in found.values()) or len(found) < len(store.shards):
        o = f"owner{i}"
        found.setdefault(store.shard_index(o), [])
        if len(found[store.shard_index(o)]) < per_shard:
            found[store.shard_index(o)].append(o)
        i += 1
    return found


def _record_of(k, owner_msgs):
    gu, gc, ts, ct, lens = [], [], b"", b"", []
    for o, msgs in owner_msgs.items():
        gu.append(o)
        gc.append(len(msgs))
        for m in msgs:
            ts += m.timestamp.encode("ascii")
            ct += m.content
            lens.append(len(m.content))
    return k.wbm.IngestRecord(gu, gc, ts, ct, np.array(lens, np.int32), [])


def _write_log(k, path, records):
    with open(path, "wb") as f:
        f.write(k.wbm.LOG_MAGIC)
        for r in records:
            body = r.encode()
            f.write(struct.pack("<I", len(body)) + struct.pack("<I", zlib.crc32(body)) + body)


def _tmp(tmp_path, k, name):
    d = tmp_path / k.name
    d.mkdir(exist_ok=True)
    return str(d / name)


# -- record framing --


def _ep_record_roundtrip(k):
    ts = _msgs(k, "a" * 16, 0, 3)
    contents = [b"\x00plain\x00", b"", b"\xff" * 9]
    rec = k.wbm.IngestRecord(["owner-é", "ow2"], [2, 1], "".join(m.timestamp for m in ts).encode("ascii"),
                             b"".join(contents), np.array([len(c) for c in contents], np.int32),
                             [("owner-é", '{"t": 1}')])
    body = rec.encode()
    back = k.wbm.IngestRecord.decode(body)
    assert (back.gu, back.gc, back.ts_packed, back.content_packed, back.lens.tolist(), back.tree_rows) == (
        rec.gu, rec.gc, rec.ts_packed, rec.content_packed, rec.lens.tolist(), rec.tree_rows)
    return body


def test_record_roundtrip_with_nul_and_unicode():
    _parity(_ep_record_roundtrip)


def _ep_decode_rejects(k):
    body = k.wbm.IngestRecord(["u"], [1], b"x" * 46, b"abc", np.array([3], np.int32), []).encode()
    raised = []
    for bad in (body[:-2], body + b"zz"):
        with pytest.raises(ValueError) as e:
            k.wbm.IngestRecord.decode(bad)
        raised.append(str(e.value))
    return body, raised


def test_record_decode_rejects_corruption():
    _parity(_ep_decode_rejects)


def _ep_torn_tail(k):
    rec = k.wbm.IngestRecord(["u"], [1], _msgs(k, "a" * 16, 0, 1)[0].timestamp.encode(), b"abc",
                             np.array([3], np.int32), [])
    body = rec.encode()
    frame = struct.pack("<I", len(body)) + struct.pack("<I", zlib.crc32(body)) + body
    good = k.wbm.WriteBehindQueue._decode_log(k.wbm.LOG_MAGIC + frame + frame[: len(frame) // 2])
    assert len(good) == 1
    with pytest.raises(ValueError):
        k.wbm.WriteBehindQueue._decode_log(b"not a log" + frame)
    return [r.encode() for r in good]


def test_torn_log_tail_is_discarded():
    _parity(_ep_torn_tail)


# -- serve and drain against the synchronous engine --


def _ep_fresh(k):
    with _pair(k) as (store, wb, eng, oracle, oeng):
        reqs = [_req(k, _msgs(k, "a" * 16, 0, 40), "userA", "a" * 16),
                _req(k, _msgs(k, "b" * 16, 0, 23), "userB", "b" * 16),
                _req(k, (), "userC", "c" * 16)]
        out = eng.run_batch_wire(reqs)
        assert out == oeng.run_batch_wire(reqs)
        wb.flush()
        assert _dump(store) == _dump(oracle)
        return out, _dump(store)


def test_fresh_pushes_and_drained_state_byte_identical():
    _parity(_ep_fresh)


def _ep_multi_batch(k):
    with _pair(k) as (store, wb, eng, oracle, oeng):
        outs = []
        for rnd in range(4):
            reqs = [_req(k, _msgs(k, "a" * 16, rnd * 50, 17), "userA", "a" * 16)]
            outs.append(eng.run_batch_wire(reqs))
            assert outs[-1] == oeng.run_batch_wire(reqs)
        wb.flush()
        assert _dump(store) == _dump(oracle)
        return outs, _dump(store)


def test_multi_batch_same_owner_sequential_trees():
    _parity(_ep_multi_batch)


def _ep_cold_sync(k):
    with _pair(k) as (store, wb, eng, oracle, oeng):
        push = [_req(k, _msgs(k, "a" * 16, 0, 30), "uA", "a" * 16)]
        outs = [eng.run_batch_wire(push)]
        oeng.run_batch_wire(push)
        pull = [_req(k, (), "uA", "d" * 16)]
        got = eng.run_batch_wire(pull)
        assert got == oeng.run_batch_wire(pull)
        assert len(got[0]) > 30 * 46
        wb.flush()
        return outs + [got], _dump(store)


def test_cold_sync_waits_on_drain_watermark():
    _parity(_ep_cold_sync)


def _ep_duplicate_delivery(k):
    with _pair(k) as (store, wb, eng, oracle, oeng):
        reqs = [_req(k, _msgs(k, "a" * 16, 0, 12), "uA", "a" * 16)]
        outs = [eng.run_batch_wire(reqs)]
        oeng.run_batch_wire(reqs)
        outs.append(eng.run_batch_wire(reqs))  # the client's retry: every row stored
        oeng.run_batch_wire(reqs)
        wb.flush()
        assert _dump(store) == _dump(oracle)
        pull = [_req(k, (), "uA", "e" * 16)]
        outs.append(eng.run_batch_wire(pull))
        assert outs[-1] == oeng.run_batch_wire(pull)
        fresh = [_req(k, _msgs(k, "a" * 16, 100, 6), "uA", "a" * 16)]
        outs.append(eng.run_batch_wire(fresh))
        assert outs[-1] == oeng.run_batch_wire(fresh)
        wb.flush()
        assert _dump(store) == _dump(oracle)
        return outs, _dump(store)


def test_duplicate_delivery_corrected_exactly_at_drain():
    _obs, _records, counts = _parity(_ep_duplicate_delivery)
    assert counts["duplicate"] == 12


def _ep_duplicate_retry(k):
    with _pair(k) as (store, wb, eng, oracle, oeng):
        reqs = [_req(k, _msgs(k, "a" * 16, 0, 9), "uR", "a" * 16)]
        outs = [eng.run_batch_wire(reqs)]
        oeng.run_batch_wire(reqs)
        outs.append(eng.run_batch_wire(reqs))
        assert outs[-1] == oeng.run_batch_wire(reqs)
        wb.flush()
        assert _dump(store) == _dump(oracle)
        return outs, _dump(store)


def test_duplicate_retry_response_tree_is_exact():
    _parity(_ep_duplicate_retry)


def _ep_partial_overlap(k):
    with _pair(k) as (store, wb, eng, oracle, oeng):
        first = [_req(k, _msgs(k, "a" * 16, 0, 10), "uA", "a" * 16)]
        outs = [eng.run_batch_wire(first)]
        oeng.run_batch_wire(first)
        overlap = [_req(k, _msgs(k, "a" * 16, 5, 10), "uA", "a" * 16)]  # 5 stored + 5 new
        outs.append(eng.run_batch_wire(overlap))
        oeng.run_batch_wire(overlap)
        wb.flush()
        assert _dump(store) == _dump(oracle)
        return outs, _dump(store)


def test_partial_overlap_batch_converges():
    _parity(_ep_partial_overlap)


def _ep_non_canonical_case(k):
    with _pair(k) as (store, wb, eng, oracle, oeng):
        ts = timestamp_to_string(ptypes.Timestamp(BASE, 0, "a" * 16)).replace("a", "A")
        reqs = [_req(k, (k.proto.EncryptedCrdtMessage(ts, b"weird"),) + _msgs(k, "b" * 16, 0, 3), "uQ", "b" * 16)]
        out = eng.run_batch_wire(reqs)
        assert out == oeng.run_batch_wire(reqs)
        wb.flush()
        assert _dump(store) == _dump(oracle)
        return out, _dump(store)


def test_non_canonical_case_owner_quarantine_state_identical():
    _parity(_ep_non_canonical_case)


# -- crash replay --


def _abandon(wb):
    """The queue of a "crashed" process: its drain worker, still asleep in
    the delay hook, ends at its next failure instead of retrying against
    the closed store."""
    with wb._cv:
        wb._stopping = True


def _ep_crash_replay(k, tmp_path):
    path = _tmp(tmp_path, k, "relay.db")
    store = k.RelayStore(path)
    wb = k.wbm.WriteBehindQueue(store, log_path=path + ".wblog", _drain_delay_s=30.0)
    eng = k.engine(store, wb)
    base = _req(k, _msgs(k, "a" * 16, 0, 25), "uA", "a" * 16)
    reqs = [_req(k, base.messages, "uA", "a" * 16, _synced_tree(k, base))]
    out = eng.run_batch_wire(reqs)  # ACKed into the log; the drain is stalled
    assert wb.backlog()[1] == 25
    with open(path + ".wblog", "rb") as f:
        log = f.read()
    store.close()  # the "crash": the queue is abandoned, neither flushed nor closed
    eng.close()
    _abandon(wb)
    store2 = k.RelayStore(path)
    wb2 = k.wbm.WriteBehindQueue(store2, log_path=path + ".wblog")  # replays
    oracle = k.RelayStore()
    oeng = k.engine(oracle)
    oeng.run_batch_wire(reqs)
    assert _dump(store2) == _dump(oracle)
    wb2.close()
    store3 = k.RelayStore(path)
    wb3 = k.wbm.WriteBehindQueue(store3, log_path=path + ".wblog")  # idempotent replay
    assert _dump(store3) == _dump(oracle)
    dump = _dump(oracle)
    wb3.close()
    for s in (store2, store3, oracle):
        s.close()
    oeng.close()
    return out, log, dump


def test_crash_replay_recovers_acked_writes(tmp_path):
    _obs, _records, counts = _parity(_ep_crash_replay, tmp_path)
    assert counts["replayed"] == 25


def _ep_clean_shutdown(k, tmp_path):
    path = _tmp(tmp_path, k, "relay.db")
    store = k.RelayStore(path)
    wb = k.wbm.WriteBehindQueue(store, log_path=path + ".wblog")
    eng = k.engine(store, wb)
    out = eng.run_batch_wire([_req(k, _msgs(k, "a" * 16, 0, 9), "uA", "a" * 16)])
    wb.close()
    eng.close()
    dump = _dump(store)
    store.close()
    with open(path + ".wblog", "rb") as f:
        assert f.read() == k.wbm.LOG_MAGIC
    return out, dump


def test_clean_shutdown_leaves_empty_log(tmp_path):
    _parity(_ep_clean_shutdown, tmp_path)


# -- backpressure --


def _ep_queue_full(k):
    with _pair(k) as (store, wb, eng, oracle, oeng):
        wb.max_rows = 16
        wb._drain_delay_s = 3.0  # (30 in the reference: any stall past the next call)
        base = _req(k, _msgs(k, "a" * 16, 0, 16), "uA", "a" * 16)
        r1 = [_req(k, base.messages, "uA", "a" * 16, _synced_tree(k, base))]
        out = eng.run_batch_wire(r1)
        assert wb.backlog()[1] == 16
        with pytest.raises(k.wbm.WriteBehindFull) as e:
            eng.run_batch_wire([_req(k, _msgs(k, "a" * 16, 100, 8), "uA", "a" * 16)])
        wb._drain_delay_s = 0.0
        wb.flush(timeout=60)
        oeng.run_batch_wire(r1)
        assert _dump(store) == _dump(oracle)
        if k is PORT:
            assert wb.counts["stalls"] == 1
        return out, (e.value.retry_after, e.value.backlog_rows), _dump(store)


def test_queue_full_raises_before_any_state_change():
    _parity(_ep_queue_full)


def _ep_scheduler_backpressure(k):
    store = k.RelayStore()
    wb = k.wbm.WriteBehindQueue(store, max_rows=8, _drain_delay_s=3.0)
    sched = k.scheduler(store, write_behind=wb, max_wait_s=0.001)
    try:
        base = _req(k, _msgs(k, "a" * 16, 0, 8), "uA", "a" * 16)
        out = sched.submit(_req(k, base.messages, "uA", "a" * 16, _synced_tree(k, base)))
        with pytest.raises(k.QueueFull) as e:
            sched.submit(_req(k, _msgs(k, "a" * 16, 50, 4), "uA", "a" * 16))
        return out, e.value.retry_after
    finally:
        wb._drain_delay_s = 0.0
        sched.stop()
        wb.close()
        store.close()


def test_scheduler_maps_backpressure_to_queue_full():
    _parity(_ep_scheduler_backpressure)


# -- the direct (non-batchable) path behind the barrier --


def _ep_singleton_drains_first(k):
    store = k.RelayStore()
    wb = k.wbm.WriteBehindQueue(store, _drain_delay_s=0.2)
    sched = k.scheduler(store, write_behind=wb, max_wait_s=0.001)
    oracle = k.RelayStore()
    try:
        base = _req(k, _msgs(k, "a" * 16, 0, 10), "uA", "a" * 16)
        push = _req(k, base.messages, "uA", "a" * 16, _synced_tree(k, base))
        out = sched.submit(push)
        oracle.sync_wire(push)
        weird = _req(k, (k.proto.EncryptedCrdtMessage("short-stamp", b"x"),), "uA", "a" * 16)
        with pytest.raises(k.EvoluError):
            sched.submit(weird)
        with pytest.raises(k.EvoluError):
            oracle.sync_wire(weird)
        assert wb.backlog() == (0, 0)  # the barrier drained the ACKed push first
        assert _dump(store) == _dump(oracle)
        return out, _dump(store)
    finally:
        sched.stop()
        wb.close()
        store.close()
        oracle.close()


def test_non_canonical_width_singleton_drains_first():
    _parity(_ep_singleton_drains_first)


# -- the relay: the env gate, /health, /stats, the checkpoint barrier --


def _get_json(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(url, body):
    return urllib.request.urlopen(urllib.request.Request(url, data=body), timeout=30).read()


_HEALTH_KEYS = ("backlog_records", "backlog_rows", "last_seq", "drained_seq", "saturated", "drain_mode",
                "drain_workers", "drain_failures_consecutive", "log_poisoned", "failing")


def _ep_env_gate(k, monkeypatch):
    monkeypatch.setenv("EVOLU_WRITE_BEHIND", "1")
    server = k.RelayServer(k.Sharded(shards=2))
    assert server.write_behind is not None and server.scheduler is not None
    server.start()
    try:
        req = _req(k, _msgs(k, "a" * 16, 0, 12), "uZ", "a" * 16)
        out = _post(server.url + "/", k.proto.encode_sync_request(req))
        oracle = k.RelayStore()
        assert out == oracle.sync_wire(req)
        oracle.close()
        code, h = _get_json(server.url + "/health")
        wbh = h["write_behind"]
        assert code == 200 and wbh["saturated"] is False and wbh["last_seq"] >= wbh["drained_seq"]
        server.write_behind.flush()
        _code, s = _get_json(server.url + "/stats")
        assert s["write_behind"]["enqueued_rows"] >= 12
        # (The JAX package's stats counters are process-wide: the counts
        # are compared apart.)
        return out, code, sorted(k_ for k_ in s["write_behind"] if k_ != "counts")
    finally:
        server.stop()


def test_relay_env_gate_and_observability(monkeypatch):
    _parity(_ep_env_gate, monkeypatch)


def _ep_health_backlogged(k):
    server = k.RelayServer(k.RelayStore(), write_behind=True)
    server.write_behind.max_rows = 0  # "saturated"
    server.start()
    try:
        code, detail = _get_json(server.url + "/health")
        assert code == 503 and detail["status"] == "backlogged"
        return code, detail["status"], {k_: detail["write_behind"][k_] for k_ in _HEALTH_KEYS}
    finally:
        server.write_behind.max_rows = 1 << 20
        server.stop()


def test_health_backlogged_answers_503():
    _parity(_ep_health_backlogged)


def _ep_drain_failing(k, monkeypatch):
    server = k.RelayServer(k.RelayStore(), write_behind=True)
    wb = server.write_behind

    def boom(si, ops, exact=False, carry_taint=(), wid=None):
        raise RuntimeError("injected persistent drain failure")

    monkeypatch.setattr(wb, "_materialize_shard", boom)
    server.start()
    try:
        req = _req(k, _msgs(k, "a" * 16, 0, 6), "uF", "a" * 16)
        base = _req(k, req.messages, "uF", "a" * 16, _synced_tree(k, req))
        out = _post(server.url + "/", k.proto.encode_sync_request(base))
        deadline = time.time() + 10
        while time.time() < deadline and not wb.failing():
            time.sleep(0.05)
        assert wb.failing()
        code, detail = _get_json(server.url + "/health")
        assert code == 503 and detail["status"] == "drain-failing"
        return out, code, detail["status"]
    finally:
        monkeypatch.undo()  # let close() drain the backlog for real
        server.stop()


def test_persistent_drain_failure_fails_health(monkeypatch):
    _parity(_ep_drain_failing, monkeypatch)


def _ep_checkpoint_barrier(k, tmp_path):
    path = _tmp(tmp_path, k, "relay.db")
    store = k.RelayStore(path)
    wb = k.wbm.WriteBehindQueue(store, log_path=path + ".wblog")
    eng = k.engine(store, wb)
    reqs = [_req(k, _msgs(k, "a" * 16, 0, 15), "uA", "a" * 16)]
    out = eng.run_batch_wire(reqs)
    ckpt = _tmp(tmp_path, k, "relay.ckpt")
    k.snapshot.write_checkpoint(store, ckpt, barrier=wb.drain_barrier)
    restored = k.RelayStore()
    k.snapshot.restore_checkpoint(restored, ckpt)
    oracle = k.RelayStore()
    oeng = k.engine(oracle)
    oeng.run_batch_wire(reqs)
    assert _dump(restored) == _dump(oracle)
    dump = _dump(restored)
    wb.close()
    eng.close()
    oeng.close()
    for s in (store, restored, oracle):
        s.close()
    return out, dump


def test_checkpoint_barrier_sees_drained_state(tmp_path):
    _parity(_ep_checkpoint_barrier, tmp_path)


def _ep_replication(k):
    a = k.RelayServer(k.RelayStore(), write_behind=True, peers=[], replication_interval_s=3600).start()
    b = k.RelayServer(k.RelayStore(), peers=[a.url], replication_interval_s=3600).start()
    try:
        req = _req(k, _msgs(k, "a" * 16, 0, 20), "uA", "a" * 16)
        out = _post(a.url + "/", k.proto.encode_sync_request(req))
        b.replication.run_once()
        oracle = k.RelayStore()
        oracle.sync_wire(req)
        assert _dump(b.store) == _dump(oracle)
        oracle.close()
        return out, _dump(b.store)
    finally:
        b.stop()
        a.stop()


def test_replication_advertises_committed_state_only():
    _parity(_ep_replication)


# -- reset --


def _wait_drain_asleep(wb):
    """Wait until the drain worker has taken its first batch and sleeps in
    the delay hook: its innermost Python frame is then `_drain_loop` with
    the `delay` it sleeps for bound."""
    ident = wb._threads[0].ident
    deadline = time.time() + 30
    while not (f := sys._current_frames()[ident]).f_code.co_name == "_drain_loop" or "delay" not in f.f_locals:
        assert time.time() < deadline
        time.sleep(0.01)


def _ep_reset(k, tmp_path):
    path = _tmp(tmp_path, k, "relay.db")
    store = k.RelayStore(path)
    # An in-sync push, so its serve needs no flush, and a drain stalled 2 s:
    # the reset really drops the pending rows (the batch the sleeping
    # worker already took commits after it, in both packages).
    wb = k.wbm.WriteBehindQueue(store, log_path=path + ".wblog", _drain_delay_s=2.0)
    eng = k.engine(store, wb)
    base = _req(k, _msgs(k, "a" * 16, 0, 10), "uA", "a" * 16)
    out = eng.run_batch_wire([_req(k, base.messages, "uA", "a" * 16, _synced_tree(k, base))])
    assert wb.backlog() == (1, 10)
    _wait_drain_asleep(wb)
    wb._drain_delay_s = 0.0
    wb.reset()
    assert wb.backlog() == (0, 0)
    wb.flush(timeout=5)
    wb.close()
    wb2 = k.wbm.WriteBehindQueue(store, log_path=path + ".wblog")
    with open(path + ".wblog", "rb") as f:
        assert f.read() == k.wbm.LOG_MAGIC
    wb2.close()
    eng.close()
    dump = _dump(store)
    store.close()
    return out, dump


def test_reset_drops_pending_and_truncates(tmp_path):
    _obs, _records, counts = _parity(_ep_reset, tmp_path)
    assert counts["dropped"] == 10


# -- the parallel owner-sharded drain --


def _ep_parallel_drain(k):
    store = k.Sharded(shards=4)
    wb = k.wbm.WriteBehindQueue(store)
    eng = k.engine(store, wb)
    oracle = k.Sharded(shards=4)
    owb = k.wbm.WriteBehindQueue(oracle, drain_workers=1)
    oeng = k.engine(oracle, owb)
    assert wb.drain_workers == 4 and owb.drain_workers == 1
    owners = [v[0] for v in _owners_per_shard(store).values()]
    node = {o: f"{i + 1:016x}" for i, o in enumerate(owners)}
    outs = []
    for rnd in range(3):
        reqs = [_req(k, _msgs(k, node[o], rnd * 10, 7 + rnd), o, node[o]) for o in owners]
        if rnd == 2:
            reqs += [_req(k, _msgs(k, node[o], 0, 3), o, node[o]) for o in owners]
        outs.append(eng.run_batch_wire(reqs))
        assert outs[-1] == oeng.run_batch_wire(reqs)
    wb.flush(timeout=60)
    owb.flush(timeout=60)
    assert _dump(store) == _dump(oracle)
    dump = _dump(store)
    for q, s, e in ((wb, store, eng), (owb, oracle, oeng)):
        q.close()
        e.close()
        s.close()
    return outs, dump


def test_parallel_drain_matches_single_worker_oracle():
    _parity(_ep_parallel_drain)


def _ep_flush_owner_isolation(k):
    store = k.Sharded(shards=2)
    by = _owners_per_shard(store)
    fast_o, slow_o = by[0][0], by[1][0]
    store2 = k.Sharded(shards=2)
    wb = k.wbm.WriteBehindQueue(store2, _shard_delay_s={1: 3.0})
    try:
        wb.append_batch([_record_of(k, {fast_o: _msgs(k, "a" * 16, 0, 5), slow_o: _msgs(k, "b" * 16, 0, 5)})])
        t0 = time.monotonic()
        wb.flush_owner(fast_o, timeout=10)
        assert time.monotonic() - t0 < 2.0
        shards = {s["shard"]: s for s in wb.shard_payloads()}
        assert shards[0]["backlog_rows"] == 0 and shards[1]["backlog_rows"] == 5
        with pytest.raises(TimeoutError):
            wb.flush(timeout=0.2)
        wb.flush(timeout=30)
        return [shards[i]["backlog_rows"] for i in (0, 1)], _dump(store2)
    finally:
        wb.close()
        store2.close()
        store.close()


def test_flush_owner_touches_only_its_shard():
    _parity(_ep_flush_owner_isolation)


def _ep_partial_commit_replay(k, tmp_path):
    path = _tmp(tmp_path, k, "relay.db")
    store = k.Sharded(path, shards=2)
    by = _owners_per_shard(store)
    k_owner, j_owner = by[0][0], by[1][0]
    k_msgs, j_msgs = _msgs(k, "c" * 16, 0, 8), _msgs(k, "d" * 16, 0, 6)
    _write_log(k, path + ".wblog", [_record_of(k, {k_owner: k_msgs, j_owner: j_msgs})])
    store.add_messages(k_owner, list(k_msgs))  # shard k committed before the "crash"
    wb = k.wbm.WriteBehindQueue(store, log_path=path + ".wblog")  # replays
    oracle = k.Sharded(shards=2)
    oracle.add_messages(k_owner, list(k_msgs))
    oracle.add_messages(j_owner, list(j_msgs))
    assert _dump(store) == _dump(oracle)
    dump = _dump(store)
    wb.close()
    store.close()
    oracle.close()
    return dump


def test_partial_commit_crash_replay_reclassifies_committed_shard(tmp_path):
    _obs, _records, counts = _parity(_ep_partial_commit_replay, tmp_path)
    assert counts == {"duplicate": 8, "inserted": 6, "replayed": 14}


def _ep_shard_count_change(k, tmp_path):
    owners = [f"owner{i}" for i in range(6)]
    nodes = {o: f"{i + 1:016x}" for i, o in enumerate(owners)}
    log_path = _tmp(tmp_path, k, "wb.wblog")
    _write_log(k, log_path, [_record_of(k, {o: _msgs(k, nodes[o], rnd * 10, 4) for o in owners})
                             for rnd in range(2)])
    store3 = k.Sharded(_tmp(tmp_path, k, "relay3.db"), shards=3)
    wb = k.wbm.WriteBehindQueue(store3, log_path=log_path)  # replays under 3 shards
    oracle = k.Sharded(shards=3)
    for o in owners:
        for rnd in range(2):
            oracle.add_messages(o, list(_msgs(k, nodes[o], rnd * 10, 4)))
    assert _dump(store3) == _dump(oracle)
    dump = _dump(store3)
    wb.close()
    store3.close()
    oracle.close()
    return dump


def test_replay_survives_shard_count_change(tmp_path):
    _parity(_ep_shard_count_change, tmp_path)


def _ep_process_drain(k, tmp_path):
    path = _tmp(tmp_path, k, "relay.db")
    store = k.Sharded(path, backend="python", shards=2)
    wb = k.wbm.WriteBehindQueue(store, log_path=path + ".wblog", drain_process=True)
    assert wb.drain_mode == "process"
    eng = k.engine(store, wb)
    oracle = k.Sharded(shards=2)
    oeng = k.engine(oracle)
    owners = [v[0] for v in _owners_per_shard(store).values()]
    nodes = {o: f"{i + 1:016x}" for i, o in enumerate(owners)}
    outs = []
    for rnd in range(2):
        reqs = [_req(k, _msgs(k, nodes[o], rnd * 10, 6), o, nodes[o]) for o in owners]
        if rnd == 1:
            reqs += [_req(k, _msgs(k, nodes[o], 0, 2), o, nodes[o]) for o in owners]
        outs.append(eng.run_batch_wire(reqs))
        assert outs[-1] == oeng.run_batch_wire(reqs)
    wb.flush(timeout=60)
    assert _dump(store) == _dump(oracle)
    dump = _dump(store)
    if k is PORT:
        assert wb.counts["proc_spawned"] == 2 and wb.counts["queued"] == wb.counts["drained"]
    wb.close()
    eng.close()
    oeng.close()
    store.close()
    oracle.close()
    return outs, dump


def test_process_drain_parity(tmp_path):
    _parity(_ep_process_drain, tmp_path)


def _ep_fresh_plus_duplicate(k):
    node = "1".zfill(16)
    gt = k.RelayStore()
    gt.add_messages("uZ", list(_msgs(k, node, 0, 6)) + list(_msgs(k, node, 10, 6)))
    gt_tree = gt.get_merkle_tree_string("uZ")
    gt.close()
    with _pair(k, shards=2) as (store, wb, eng, oracle, oeng):
        r0 = [_req(k, _msgs(k, node, 0, 6), "uZ", node)]
        outs = [eng.run_batch_wire(r0)]
        assert outs[-1] == oeng.run_batch_wire(r0)
        r1 = [_req(k, _msgs(k, node, 10, 6), "uZ", node), _req(k, _msgs(k, node, 0, 2), "uZ", node)]
        outs.append(eng.run_batch_wire(r1))
        assert outs[-1] == oeng.run_batch_wire(r1)
        wb.flush(timeout=30)
        assert store.get_merkle_tree_string("uZ") == gt_tree
        assert _dump(store) == _dump(oracle)
        return outs, _dump(store)


def test_same_batch_fresh_plus_duplicate_requests_stay_exact():
    _parity(_ep_fresh_plus_duplicate)


def _ep_process_fallback(k):
    store = k.Sharded(shards=2)  # :memory: shards cannot be shared with a child
    wb = k.wbm.WriteBehindQueue(store, drain_process=True)
    mode = wb.drain_mode
    assert mode == "thread"
    if k is PORT:
        assert wb.counts["process_drain_refused"] == 1
    wb.close()
    store.close()
    return mode


def test_process_drain_falls_back_for_memory_or_native_stores():
    _parity(_ep_process_fallback)


def _ep_stats_per_shard(k):
    with _pair(k) as (store, wb, eng, oracle, oeng):
        owners = [v[0] for v in _owners_per_shard(store).values()]
        nodes = {o: f"{i + 1:016x}" for i, o in enumerate(owners)}
        out = eng.run_batch_wire([_req(k, _msgs(k, nodes[o], 0, 4), o, nodes[o]) for o in owners])
        wb.flush(timeout=30)
        s = wb.stats_payload()
        assert s["drain_workers"] == 4 and s["drain_mode"] == "thread"
        assert [sh["shard"] for sh in s["shards"]] == [0, 1, 2, 3]
        for sh in s["shards"]:
            assert (sh["backlog_rows"], sh["watermark_lag"], sh["drain_failures_consecutive"], sh["failing"]) \
                == (0, 0, 0, False)
        h = wb.health_payload()
        assert len(h["shards"]) == 4 and h["failing"] is False
        if k is PORT:
            assert s["counts"]["queued"] == s["counts"]["drained"] == 16
        return out, s["shards"], {k_: h[k_] for k_ in _HEALTH_KEYS}, sorted(x for x in s if x != "counts")


def test_stats_and_health_report_per_shard():
    _parity(_ep_stats_per_shard)


# -- the winner cache audit (client side) --


def test_winner_cache_verify_against_db():
    """`verify_against_db` counts every exact slot and catches a poisoned
    one, on both packages over the same batch."""
    from evolu_tpu.core.types import CrdtMessage as JMsg
    from evolu_tpu.ops.winner_cache import DeviceWinnerCache as JCache
    from evolu_tpu.storage.apply import apply_messages as japply
    from evolu_tpu.storage.native import open_database as jopen
    from evolu_tpu_torch.core.types import CrdtMessage as PMsg
    from evolu_tpu_torch.ops.winner_cache import DeviceWinnerCache as PCache
    from evolu_tpu_torch.storage.apply import apply_messages as papply
    from evolu_tpu_torch.storage.native import open_database as popen

    ddl = ('CREATE TABLE IF NOT EXISTS "__message" ("timestamp" TEXT, "table" TEXT, "row" TEXT, '
           '"column" TEXT, "value" ANY, PRIMARY KEY ("timestamp", "table", "row", "column"))',
           'CREATE TABLE IF NOT EXISTS "todo" ("id" TEXT PRIMARY KEY, "title" ANY)')
    got = []
    for opener, cache_cls, msg, apply, kw in ((jopen, JCache, JMsg, japply, {}),
                                               (popen, PCache, PMsg, papply, {"device": "cpu"})):
        db = opener(":memory:", "auto")
        for q in ddl:
            db.exec(q)
        cache = cache_cls(db, adaptive=False, **kw)
        msgs = [msg(timestamp_to_string(ptypes.Timestamp(BASE + i * 1000, 0, "a" * 16)), "todo", f"row{i % 7}",
                    "title", f"v{i}") for i in range(50)]
        apply(db, {}, msgs, planner=cache.plan_batch)
        got.append((cache.verify_against_db(), cache.verify_against_db(sample=3),
                    db.exec('SELECT "id", "title" FROM "todo" ORDER BY 1')))
        if cache_cls is PCache:
            cache._w1[0] = 12345
        else:
            import jax
            import jax.numpy as jnp

            with jax.enable_x64(True):
                cache._w1 = cache._w1.at[0].set(jnp.uint64(12345))
        with pytest.raises(AssertionError):
            cache.verify_against_db()
        db.close()
    assert got[0][:2] == (7, 3)
    assert got[1] == got[0]


# -- crash and replay through the port's worker --


def test_port_worker_batches_are_the_reference_workers():
    """The port worker draws the reference worker's batches: same
    requests, bytes for bytes, and the same state crc for a store."""
    from _write_behind_worker import seeded_batches, state_crc

    jb, pb = seeded_batches(17, 12), pworker.seeded_batches(17, 12)
    assert [[jproto.encode_sync_request(r) for r in b] for b in jb] == \
        [[pproto.encode_sync_request(r) for r in b] for b in pb]
    js, ps = jrelay.RelayStore(), prelay.RelayStore()
    for b in jb:
        for r in b:
            js.sync_wire(r)
    for b in pb:
        for r in b:
            ps.sync_wire(r)
    assert state_crc(js) == pworker.state_crc(ps)
    js.close()
    ps.close()


@pytest.mark.parametrize("shards, workers, seed", [(1, 0, 5), (3, 3, 11)])
def test_crash_and_replay_through_the_port_worker(tmp_path, shards, workers, seed):
    """SIGKILL the port's worker at a seeded ACK count, replay in a fresh
    process: the state crc equals a synchronous twin of the ACKed prefix
    (or prefix+1, or a record prefix of the next batch on 3 shards), and
    the replay launched no kernel."""
    got = pworker.torture(str(tmp_path / "victim.db"), seed, shards=shards, workers=workers)
    assert got["crc"] in got["accepted"], got
    assert got["finish"]["launches"] == "0"


@pytest.mark.parametrize("shards, workers, seed", [(1, 0, 71), (3, 3, 7)])
def test_crash_without_redeliveries_replays_a_backlog(tmp_path, shards, workers, seed):
    """`chip_smoke.py` K3's batches on the CPU (its seeds and sizes: 12
    batches of ~8,000 messages over 64 owners): batches that redeliver no
    rows (`resend=0`) never make the respond wait for a drain, so with the
    drain stalled the SIGKILL leaves ACKed rows queued, and the replay
    lands them: rows replayed, the state a synchronous twin's. With the
    reference worker's redeliveries the same kill on one shard finds the
    queue empty."""
    got = pworker.torture(str(tmp_path / "victim.db"), seed, drain_delay=2.0, shards=shards, workers=workers,
                          size=(64, 64, 500), resend=0.0)
    assert got["crc"] in got["accepted"], got
    assert int(got["finish"]["records"]) > 0 and int(got["finish"]["rows"]) > 0, got["finish"]
    assert got["finish"]["launches"] == "0"


@pytest.mark.slow
@pytest.mark.parametrize("seed", [3, 17, 71])
def test_port_write_behind_sigkill_torture(tmp_path, seed):
    """The reference's torture seeds (tests/test_model_check.py) on the port."""
    got = pworker.torture(str(tmp_path / "victim.db"), seed)
    assert got["crc"] in got["accepted"], got


@pytest.mark.slow
@pytest.mark.parametrize("seed", [7, 29, 101])
def test_port_write_behind_sharded_sigkill_torture(tmp_path, seed):
    got = pworker.torture(str(tmp_path / "victim.db"), seed, shards=3, workers=3)
    assert got["crc"] in got["accepted"], got


# -- logs across the two packages --


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_log_replays_in_the_other_package(tmp_path, writer):
    """A log that one package's engine wrote (its drain stalled, then the
    process "crashed") replays in the other package's queue to the state
    the writer's own replay reaches."""
    w = JAX if writer == "jax" else PORT
    r = PORT if writer == "jax" else JAX
    path = str(tmp_path / "w.db")
    store = w.Sharded(path, shards=3)
    wb = w.wbm.WriteBehindQueue(store, log_path=path + ".wblog", _drain_delay_s=30.0)
    eng = w.engine(store, wb)
    trees = w.RelayStore()  # in-sync client trees: no serve waits on the drain
    owners = [f"owner{i}" for i in range(7)]
    nodes = {o: f"{i + 1:016x}" for i, o in enumerate(owners)}
    for rnd in range(3):
        reqs = [_req(w, _msgs(w, nodes[o], rnd * 10, 5 + rnd), o, nodes[o]) for o in owners[rnd:]]
        eng.run_batch_wire([_req(w, r.messages, r.user_id, r.node_id, trees.sync(r).merkle_tree)
                            for r in reqs])
    assert wb.backlog()[1] == 106
    with open(path + ".wblog", "rb") as f:
        log = f.read()
    store.close()
    trees.close()
    eng.close()
    _abandon(wb)
    dumps = []
    for kit, shards in ((w, 3), (r, 3), (r, 2)):
        d = tmp_path / f"{kit.name}{shards}"
        d.mkdir(exist_ok=True)
        with open(d / "r.db.wblog", "wb") as f:
            f.write(log)
        s = kit.Sharded(str(d / "r.db"), shards=shards)
        q = kit.wbm.WriteBehindQueue(s, log_path=str(d / "r.db.wblog"))
        dumps.append(_dump(s))
        q.close()
        s.close()
    assert dumps[0][0] and dumps[1] == dumps[0] and dumps[2] == dumps[0]
