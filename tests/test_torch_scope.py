"""Port parity: scoped sync (partial replication) against the JAX package.

Every case of `tests/test_scope.py` runs its episode twice, once on JAX
objects and once on the port's (`device="cpu"`), and demands equal
observations: lane tags and clause bytes, scoped trees and response
bytes, `scopeLane` rows, worker table dumps (`__scope_deferred`
included) and deferred frontiers, and the port's `counts` equal to the
change of the JAX package's `evolu_scope_*` metrics, its ledger totals or
its client counters over the episode. The reference's own assertions run
on the port's side too. The model-check episode
(`tests/test_model_check.py::test_scoped_partial_replication_episode`)
runs on port relays and clients, its invariants held as the reference
holds them, and its converged log replays into a JAX and a port scoped
client that must end equal.

Tolerance: exact everywhere. Every threaded episode runs inside its own
time limit (`within`)."""

import importlib
import itertools
import random
import time

import pytest
from _torch_jax_state import jax_process_state  # noqa: F401  (the JAX package's native libraries and ledger)

from evolu_tpu.core.timestamp import Timestamp, timestamp_to_string
from evolu_tpu.obs import ledger as jledger
from evolu_tpu.obs import metrics as jmetrics

from _torch_port_data import within

BASE = 1_700_000_000_000
MINUTE = 60_000
NODE_A = "a1b2c3d4e5f60718"
NODE_B = "0f1e2d3c4b5a6978"
MNEMONIC = "legal winner thank year wave sausage worth useful legal winner thank yellow"
LIMIT_S = 120

SCHEMA = {
    "todo": ("title", "isCompleted", "createdAt", "createdBy", "updatedAt", "isDeleted"),
    "note": ("body", "createdAt", "createdBy", "updatedAt", "isDeleted"),
}


class Pkg:
    """One package's modules."""

    def __init__(self, root):
        mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
        self.root, self.port = root, root == "evolu_tpu_torch"
        self.proto, self.sscope, self.scope = mod("sync.protocol"), mod("sync.scope"), mod("server.scope")
        self.relay, self.snap, self.push = mod("server.relay"), mod("server.snapshot"), mod("server.push")
        self.merkle, self.ts, self.types = mod("core.merkle"), mod("core.timestamp"), mod("core.types")
        self.client, self.msg, self.sclient = mod("runtime.client"), mod("runtime.messages"), mod("sync.client")
        self.config, self.query, self.clock = mod("utils.config"), mod("api.query"), mod("storage.clock")
        self.dev = {"device": "cpu"} if self.port else {}

    def store(self, backend="python"):
        return self.relay.RelayStore(backend=backend)

    def server(self, store=None, **kw):
        return self.relay.RelayServer(store, **kw, **self.dev)

    def response(self, store, request):
        """A scoped response, encoded."""
        return self.proto.encode_sync_response(self.scope.scoped_response(store, request, **self.dev))

    def fold(self, timestamps, mask):
        return self.scope.scoped_minute_deltas(timestamps, mask, **self.dev)

    def serve(self, store, request):
        return self.relay.serve_single_request(store, request, **self.dev)


JAX, PORT = Pkg("evolu_tpu"), Pkg("evolu_tpu_torch")

# The JAX package's metric (and label) for each key of the port's
# `server.scope.counts`.
JAX_SCOPE_METRICS = {
    "serves": ("evolu_scope_serves_total", {}),
    "served_rows": ("evolu_scope_served_rows_total", {}),
    "filtered_rows": ("evolu_scope_filtered_rows_total", {}),
    "fold_device": ("evolu_scope_fold_total", {"route": "device"}),
    "fold_host": ("evolu_scope_fold_total", {"route": "host"}),
    "tree_cache_hits": ("evolu_scope_tree_cache_hits_total", {}),
    "tree_cache_misses": ("evolu_scope_tree_cache_misses_total", {}),
    "tree_cache_evictions": ("evolu_scope_tree_cache_evictions_total", {}),
    "overflow": ("evolu_scope_overflow_total", {}),
}


def scope_counts(pkg):
    if pkg.port:
        return dict(pkg.scope.counts)
    return {k: jmetrics.get_counter(name, **labels) for k, (name, labels) in JAX_SCOPE_METRICS.items()}


def both(episode, *args, counted=True):
    """Run `episode(pkg, *args)` on JAX, then on the port, each from an empty
    tree cache: → the port's observation, after demanding it equal to the
    JAX one and (`counted`) the port's scope counts' change equal to the JAX
    metrics' change. An episode whose clients' transport threads race one
    another (which round first meets another client's rows) passes
    `counted=False`: its end state is compared, its serve counts are not."""
    obs, deltas = [], []
    for pkg in (JAX, PORT):
        pkg.scope.tree_cache.reset()
        before = scope_counts(pkg)
        try:
            obs.append(episode(pkg, *args))
        finally:
            pkg.scope.tree_cache.reset()
        after = scope_counts(pkg)
        deltas.append({k: after[k] - before[k] for k in after})
    assert obs[1] == obs[0]
    if counted:
        assert deltas[1] == deltas[0]
    return obs[1], deltas[1]


def _ts(millis, counter=0, node=NODE_A):
    return timestamp_to_string(Timestamp(millis, counter, node))


def _emsgs(pkg, node, minute, n, start=0):
    return tuple(pkg.proto.EncryptedCrdtMessage(_ts(BASE + minute * MINUTE + (start + i) * 500, 0, node),
                                                b"ct-%d-%d" % (minute, start + i)) for i in range(n))


def _client_tree(pkg, timestamps):
    deltas, _ = pkg.merkle.minute_deltas_host(timestamps)
    return pkg.merkle.merkle_tree_to_string(pkg.merkle.apply_prefix_xors({}, deltas))


def _lanes(db, user=None):
    if not db.exec("SELECT name FROM sqlite_schema WHERE name='scopeLane'"):
        return None
    if user is None:
        return db.exec('SELECT * FROM "scopeLane" ORDER BY 1, 2')
    return [(r["timestamp"], r["tag"]) for r in db.exec_sql_query(
        'SELECT "timestamp", "tag" FROM "scopeLane" WHERE "userId" = ? ORDER BY 1', (user,))]


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - the error type is the observation
        return ("raised", type(e).__name__)


@pytest.fixture(autouse=True)
def _fresh_scope_state():
    for pkg in (JAX, PORT):
        pkg.scope.tree_cache.reset()
    yield
    for pkg in (JAX, PORT):
        pkg.scope.tree_cache.reset()


# --- scope model + lane tags (sync/scope.py) ---


def test_derive_scope_tag_shape_and_determinism():
    pairs = [(m, n) for m in ("alpha mnemonic", "beta mnemonic", MNEMONIC, "") for n in ("todo", "note", "", "ü")]
    got, _ = both(lambda pkg: [pkg.sscope.derive_scope_tag(m, n) for m, n in pairs])
    assert got[0] == PORT.sscope.derive_scope_tag("alpha mnemonic", "todo")
    assert all(len(t) == PORT.sscope.SCOPE_TAG_HEX_LEN == 16 and set(t) <= set("0123456789abcdef") for t in got)
    assert len(set(got)) == len(got)


def test_sync_scope_model():
    def episode(pkg):
        S = pkg.sscope.SyncScope
        s = S(tables=("todo",))
        return (S().is_noop, s.is_noop, [s.table_in_scope(t) for t in ("todo", "note", "__message", "__x")],
                S(watermark_millis=5).table_in_scope("anything"), S(watermark_millis=5).is_noop,
                _outcome(lambda: S(watermark_millis=-1)),
                _outcome(lambda: S(tables=tuple(f"t{i}" for i in range(pkg.proto._MAX_SCOPE_TAGS + 1)))),
                _outcome(lambda: S(tables=tuple(f"t{i}" for i in range(pkg.proto._MAX_SCOPE_TAGS))).tables[-1]))

    got, _ = both(episode)
    assert got[:2] == (True, False) and got[2] == [True, False, True, True]
    assert got[5] == got[6] == ("raised", "ValueError")


def test_widen_semantics():
    def episode(pkg):
        S = pkg.sscope.SyncScope
        s = S(watermark_millis=100, tables=("todo",))
        w = s.widen(50, ("note",))
        return ((w.watermark_millis, w.tables), s.widen() == s, _outcome(lambda: s.widen(200)),
                _outcome(lambda: S(watermark_millis=100).widen(tables=("todo",))),
                s.widen(tables=("todo",)).tables, S(watermark_millis=100).widen(0).is_noop)

    got, _ = both(episode)
    assert got[0] == (50, ("todo", "note")) and got[1] is True
    assert got[2] == got[3] == ("raised", "ValueError") and got[4] == ("todo",) and got[5] is True


def test_wire_clause():
    def episode(pkg):
        S = pkg.sscope.SyncScope
        c = S(watermark_millis=7, tables=("todo",)).wire_clause("m", push_tables=("todo", "note"))
        c2 = S(watermark_millis=7).wire_clause("m", push_tables=("todo",))
        return (S().wire_clause("m"), pkg.proto.encode_scope_clause(c), pkg.proto.encode_scope_clause(c2),
                c.tags, c.push_tags, c2.tags, c2.push_tags)

    got, _ = both(episode)
    tag = PORT.sscope.derive_scope_tag
    assert got[0] is None and got[3] == (tag("m", "todo"),)
    assert got[4] == (tag("m", "todo"), tag("m", "note")) and got[5] == got[6] == ()


# --- wire codec ---


def _scoped_request(pkg):
    clause = pkg.proto.ScopeClause(12345, ("aa" * 8, "bb" * 8), ("cc" * 8, ""))
    return pkg.proto.SyncRequest(
        (pkg.proto.EncryptedCrdtMessage(_ts(BASE), b"x"), pkg.proto.EncryptedCrdtMessage(_ts(BASE + 1), b"y")),
        "user1", NODE_A, "{}", ("sync-scope-v1",), clause)


def test_scope_clause_roundtrip():
    def episode(pkg):
        req = _scoped_request(pkg)
        data = pkg.proto.encode_sync_request(req)
        out = pkg.proto.decode_sync_request(data)
        return data, out == req, out.scope.watermark_millis, out.scope.push_tags

    got, _ = both(episode)
    assert got[1] is True and got[2] == 12345 and got[3] == ("cc" * 8, "")
    # Each package decodes the other's bytes.
    assert JAX.proto.decode_sync_request(got[0]).scope.tags == PORT.proto.decode_sync_request(got[0]).scope.tags


def test_unscoped_request_stays_byte_identical():
    def episode(pkg):
        base = pkg.proto.encode_sync_request(pkg.proto.SyncRequest((), "u", NODE_A, "{}"))
        joined = b"".join((pkg.proto._string(2, "u"), pkg.proto._string(3, NODE_A), pkg.proto._string(4, "{}")))
        return base, joined == base, pkg.proto.encode_request_scope(None), pkg.sscope.SyncScope().wire_clause("m")

    got, _ = both(episode)
    assert got[1] is True and got[2] == b"" and got[3] is None


def test_scope_decode_bounds():
    def episode(pkg):
        p = pkg.proto
        too_many = p.ScopeClause(0, tuple("t%02d" % i for i in range(p._MAX_SCOPE_TAGS + 4)))
        long_tag = p.ScopeClause(0, ("x" * (p._MAX_SCOPE_TAG_LEN + 1),))
        bad = p.encode_sync_request(p.SyncRequest((), "u", NODE_A, "{}")) + p.encode_request_scope(
            p.ScopeClause(0, (), ("t1",)))
        neg = p._tag(1, 0) + p._varint((1 << 64) - 5)
        return [_outcome(fn) for fn in (
            lambda: p.decode_scope_clause(p.encode_scope_clause(too_many)),
            lambda: p.decode_scope_clause(p.encode_scope_clause(long_tag)),
            lambda: p.decode_sync_request(bad), lambda: p.decode_scope_clause(neg),
            lambda: p.decode_scope_clause(p._tag(2, 0) + p._varint(7)))]

    got, _ = both(episode)
    assert got == [("raised", "ValueError")] * 5


def test_scope_codec_fuzz_valueerror_only():
    """Malformed scope bytes, alone and embedded as field 6: both decoders
    give the same clause or both raise ValueError, and nothing else."""
    def decode(pkg, fn, data):
        try:
            out = fn(data)
        except ValueError:
            return "ValueError"
        return out.scope if hasattr(out, "scope") else out

    def norm(v):
        if v is None or v == "ValueError":
            return v
        return (v.watermark_millis, v.tags, v.push_tags)

    rng = random.Random(18)
    prefix = PORT.proto.encode_sync_request(PORT.proto.SyncRequest((), "u", NODE_A, "{}"))
    n_ok = 0
    for _ in range(1500):
        blob = rng.randbytes(rng.randrange(0, 80))
        for data, name in ((blob, "decode_scope_clause"),
                           (prefix + PORT.proto._len_delimited(6, blob), "decode_sync_request")):
            got, want = (norm(decode(pkg, getattr(pkg.proto, name), data)) for pkg in (PORT, JAX))
            assert got == want, data
            n_ok += got != "ValueError"
    assert n_ok > 0


def test_snapshot_request_scope_roundtrip():
    def episode(pkg):
        p = pkg.proto
        req = p.SnapshotRequest("r1", 4096, ("o1",), BASE, ("aa" * 8,))
        data = p.encode_snapshot_request(req)
        return (data, p.decode_snapshot_request(data) == req, p.encode_snapshot_request(p.SnapshotRequest("r1", 0, ())),
                _outcome(lambda: p.decode_snapshot_request(p._string(1, "r") + p._tag(5, 0) + p._varint(3))))

    got, _ = both(episode)
    assert got[1] is True and got[2] == PORT.proto._string(1, "r1") and got[3] == ("raised", "ValueError")


# --- relay lane tracking + cardinality hardening ---


@pytest.mark.parametrize("backend", ["python", "native"])
def test_record_push_lanes_and_overflow_cap(backend):
    def episode(pkg):
        store = pkg.store(backend)
        try:
            db = store.db
            n = pkg.scope.MAX_OWNER_LANES
            ts = [_ts(BASE + i) for i in range(n + 10)]
            tags = ["%016x" % i for i in range(n)] + ["%016x" % (n + i) for i in range(10)]
            pkg.scope.record_push_lanes(db, "u1", ts, tags)
            excl = pkg.scope.excluded_timestamps(db, "u1", frozenset({"%016x" % 0}))
            pkg.scope.record_push_lanes(db, "u2", [_ts(BASE)], [""])
            return (_lanes(db), sorted(excl), db.exec('SELECT * FROM "scopeLane" WHERE "userId" = \'u2\''),
                    sorted(pkg.scope.excluded_timestamps(db, "u1", frozenset())))
        finally:
            store.close()

    (lanes, excl, u2, none), counts = both(episode)
    n = PORT.scope.MAX_OWNER_LANES
    tags = {r[2] for r in lanes}
    assert PORT.scope.OVERFLOW_TAG in tags and len(tags) == n + 1
    assert counts["overflow"] == 10
    ts = [_ts(BASE + i) for i in range(n + 10)]
    assert set(ts[n:]).isdisjoint(excl) and ts[1] in excl and ts[0] not in excl
    assert u2 == [] and none == []


def test_record_push_lanes_author_only():
    def episode(pkg):
        store = pkg.store()
        try:
            own, foreign = _ts(BASE, 0, NODE_A), _ts(BASE + 1, 0, NODE_B)
            pkg.scope.record_push_lanes(store.db, "u1", [own, foreign], ["aa" * 8, "bb" * 8], node_id=NODE_A)
            return _lanes(store.db, "u1")
        finally:
            store.close()

    got, _ = both(episode)
    assert got == [(_ts(BASE, 0, NODE_A), "aa" * 8)]


# --- scoped subtree: fold routes + cache ---


@pytest.fixture
def small_fold(monkeypatch):
    """Both packages' device route from 4 rows up."""
    for pkg in (JAX, PORT):
        monkeypatch.setattr(pkg.scope, "SCOPE_DEVICE_FOLD_MIN", 4)


def test_scoped_fold_device_host_equivalence(small_fold):
    """The masked device fold (the port's on `device="cpu"`, the kernels'
    plain versions) equals the host fold on canonical batches;
    non-canonical hex case and a batch below the threshold take the host
    route, in both packages alike."""
    ts = [_ts(BASE + i * 700, i % 3, NODE_A if i % 2 else NODE_B) for i in range(64)]
    mask = [i % 3 != 1 for i in range(64)]
    bad = [t[:30] + t[30:].upper() for t in ts]

    def episode(pkg):
        return pkg.fold(ts, mask), pkg.fold(bad, mask), pkg.fold(ts[:3], mask[:3])

    (dev, host_bad, small), counts = both(episode)
    assert counts["fold_device"] == 1 and counts["fold_host"] == 2
    want, _ = PORT.merkle.minute_deltas_host(t for t, keep in zip(ts, mask) if keep)
    assert dev == want
    want_bad, _ = PORT.merkle.minute_deltas_host(t for t, keep in zip(bad, mask) if keep)
    assert host_bad == want_bad


def test_scoped_fold_takes_the_host_route_only_for_small_and_non_canonical_batches(small_fold, monkeypatch):
    """The port's routes: a canonical batch at the threshold runs on the
    device (a fault there raises `KernelError`, never a host fold); below
    it, or with any non-canonical row, the host fold runs and the device
    is never asked. `device=None` resolves to the card, which raises here."""
    import torch

    from evolu_tpu_torch.ops import cuda_lib

    ts = [_ts(BASE + i * 700, i % 3, NODE_A) for i in range(8)]
    mask = [True] * 8
    calls = []
    real = PORT.scope.merkle_minute_deltas

    def spy(*a, **kw):
        calls.append(len(a[0]))
        return real(*a, **kw)

    monkeypatch.setattr(PORT.scope, "merkle_minute_deltas", spy)
    PORT.scope.scoped_minute_deltas(ts[:3], mask[:3], device="cpu")
    PORT.scope.scoped_minute_deltas([t[:30] + t[30:].upper() for t in ts], mask, device="cpu")
    assert calls == []
    PORT.scope.scoped_minute_deltas(ts[:4], mask[:4], device="cpu")
    assert calls == [4]

    def fault(*a, **kw):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(PORT.scope, "merkle_minute_deltas", fault)
    before = dict(PORT.scope.counts)
    with pytest.raises(cuda_lib.KernelError, match="scoped fold"):
        PORT.scope.scoped_minute_deltas(ts, mask, device="cpu")
    assert PORT.scope.counts == before  # no host fold counted after the fault
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PORT.scope.scoped_minute_deltas(ts, mask)


def test_scoped_tree_cache_coherent_by_construction():
    def episode(pkg):
        store = pkg.store()
        try:
            store.add_messages("u1", _emsgs(pkg, NODE_A, 0, 8))
            clause = pkg.proto.ScopeClause(BASE, (), ())
            full = store.get_merkle_tree_string("u1")
            t1 = pkg.scope.scoped_tree_for(store, "u1", NODE_B, clause, full, **pkg.dev)
            t2 = pkg.scope.scoped_tree_for(store, "u1", NODE_B, clause, full, **pkg.dev)
            store.add_messages("u1", _emsgs(pkg, NODE_A, 1, 4))
            full2 = store.get_merkle_tree_string("u1")
            t3 = pkg.scope.scoped_tree_for(store, "u1", NODE_B, clause, full2, **pkg.dev)
            return t1[1], t2 == t1, full2 != full, t3[1]
        finally:
            store.close()

    (r1, same, moved, r3), counts = both(episode)
    assert same and moved and r3 != r1
    assert counts["tree_cache_hits"] == 1 and counts["tree_cache_misses"] == 2


def test_scoped_tree_cache_evicts_past_its_cap(monkeypatch):
    """LRU past `TREE_CACHE_CAP` in both packages: the evictions count, and
    an evicted entry is a miss again."""
    def episode(pkg):
        monkeypatch.setattr(pkg.scope.tree_cache, "_cap", 3)
        store = pkg.store()
        try:
            store.add_messages("u1", _emsgs(pkg, NODE_A, 0, 8))
            full = store.get_merkle_tree_string("u1")
            trees = [pkg.scope.scoped_tree_for(store, "u1", NODE_B, pkg.proto.ScopeClause(BASE + k * 500, (), ()),
                                               full, **pkg.dev)[1] for k in (0, 1, 2, 3, 0)]
            return trees
        finally:
            store.close()

    trees, counts = both(episode)
    assert trees[0] == trees[4] and len(set(trees)) == 4
    assert counts["tree_cache_evictions"] == 2 and counts["tree_cache_misses"] == 5


# --- the scoped serve ---


@pytest.mark.parametrize("backend", ["python", "native"])
def test_scoped_response_watermark_filter(backend):
    def episode(pkg):
        store = pkg.store(backend)
        try:
            new = _emsgs(pkg, NODE_A, 2, 6)
            store.add_messages("u1", _emsgs(pkg, NODE_A, 0, 6) + new)
            wm = BASE + 2 * MINUTE
            req = pkg.proto.SyncRequest((), "u1", NODE_B, "{}", ("sync-scope-v1",), pkg.proto.ScopeClause(wm, (), ()))
            first = pkg.response(store, req)
            tree = pkg.proto.decode_sync_response(first).merkle_tree
            full = pkg.proto.encode_sync_response(store.sync(pkg.proto.SyncRequest((), "u1", NODE_B, "{}")))
            req2 = pkg.proto.SyncRequest((), "u1", NODE_B, tree, ("sync-scope-v1",),
                                         pkg.proto.ScopeClause(wm, (), ()))
            return first, full, pkg.response(store, req2), [m.timestamp for m in new]
        finally:
            store.close()

    (first, full, again, new), counts = both(episode)
    resp = PORT.proto.decode_sync_response(first)
    got = [m.timestamp for m in resp.messages]
    assert got == new and resp.merkle_tree == _client_tree(PORT, got)
    assert len(PORT.proto.decode_sync_response(full).messages) == 12
    assert PORT.proto.decode_sync_response(again).messages == ()
    assert counts["serves"] == 2 and counts["served_rows"] == 6


@pytest.mark.parametrize("backend", ["python", "native"])
def test_scoped_response_lane_filter_and_unknown_conservative(backend):
    def episode(pkg):
        store = pkg.store(backend)
        try:
            tag_todo, tag_note = (pkg.sscope.derive_scope_tag("m", t) for t in ("todo", "note"))
            todo_rows, note_rows, untagged = (_emsgs(pkg, NODE_A, k, n) for k, n in ((0, 4), (1, 4), (2, 3)))
            push = pkg.proto.SyncRequest(todo_rows + note_rows, "u1", NODE_A, "{}", ("sync-scope-v1",),
                                         pkg.proto.ScopeClause(0, (tag_todo,), (tag_todo,) * 4 + (tag_note,) * 4))
            pushed = pkg.serve(store, push)
            pkg.serve(store, pkg.proto.SyncRequest(untagged, "u1", NODE_A, "{}"))
            clause = pkg.proto.ScopeClause(0, (tag_todo,), ())
            pull = pkg.response(store, pkg.proto.SyncRequest((), "u1", NODE_B, "{}", ("sync-scope-v1",), clause))
            tree = pkg.proto.decode_sync_response(pull).merkle_tree
            again = pkg.response(store, pkg.proto.SyncRequest((), "u1", NODE_B, tree, ("sync-scope-v1",), clause))
            wanted = {m.timestamp for m in todo_rows + untagged}
            return pushed, pull, again, _lanes(store.db), wanted
        finally:
            store.close()

    (_pushed, pull, again, lanes, wanted), counts = both(episode)
    resp = PORT.proto.decode_sync_response(pull)
    got = {m.timestamp for m in resp.messages}
    assert got == wanted and resp.merkle_tree == _client_tree(PORT, sorted(got))
    assert PORT.proto.decode_sync_response(again).messages == () and len(lanes) == 8
    assert counts["serves"] == 3 and counts["served_rows"] == 7 and counts["filtered_rows"] == 4


def test_scoped_serve_own_rows_no_livelock():
    def episode(pkg):
        store = pkg.store()
        try:
            tag_todo, tag_note = (pkg.sscope.derive_scope_tag("m", t) for t in ("todo", "note"))
            own_note = _emsgs(pkg, NODE_B, 0, 5)
            pkg.serve(store, pkg.proto.SyncRequest(own_note, "u1", NODE_B, "{}", ("sync-scope-v1",),
                                                   pkg.proto.ScopeClause(0, (tag_todo,), (tag_note,) * 5)))
            local = _client_tree(pkg, [m.timestamp for m in own_note])
            pull = pkg.proto.SyncRequest((), "u1", NODE_B, local, ("sync-scope-v1",),
                                         pkg.proto.ScopeClause(0, (tag_todo,), ()))
            resp = pkg.scope.scoped_response(store, pull, **pkg.dev)
            diff = pkg.merkle.diff_merkle_trees(pkg.merkle.merkle_tree_from_string(resp.merkle_tree),
                                                pkg.merkle.merkle_tree_from_string(local))
            return pkg.proto.encode_sync_response(resp), diff
        finally:
            store.close()

    (resp, diff), _ = both(episode)
    assert PORT.proto.decode_sync_response(resp).messages == () and diff is None


def test_serve_single_request_scoped_ledger_clean():
    """The port counts what the JAX ledger posts at `serve.scoped_rows`
    and `serve.scope_filtered` (the JAX ledger balances, as in the
    reference's test)."""
    def episode(pkg):
        store = pkg.store()
        try:
            tag = pkg.sscope.derive_scope_tag("m", "todo")
            push = pkg.proto.SyncRequest(_emsgs(pkg, NODE_A, 0, 10), "u1", NODE_A, "{}", ("sync-scope-v1",),
                                         pkg.proto.ScopeClause(0, (tag,), (tag,) * 10))
            if not pkg.port:
                jledger.count(jledger.INGRESS_SYNC, len(push.messages), owner="u1")
            out = [pkg.serve(store, push)]
            out.append(pkg.serve(store, pkg.proto.SyncRequest((), "u1", NODE_B, "{}", ("sync-scope-v1",),
                                                              pkg.proto.ScopeClause(BASE + 2_000, (), ()))))
            return out
        finally:
            store.close()

    jledger.reset()
    try:
        out, counts = both(episode)
        assert jledger.audit() == []
        stations = jledger.snapshot()["stations"]
        assert counts["served_rows"] == stations.get(jledger.SERVE_SCOPED, 0) == 6
        assert counts["filtered_rows"] == stations.get(jledger.SERVE_SCOPE_FILTERED, 0) == 4
    finally:
        jledger.reset()
    assert len(PORT.proto.decode_sync_response(out[1]).messages) == 6


# --- push hub lane gating ---


def test_event_wakes_truth_table():
    fs = frozenset
    cases = [(fs({NODE_A}), None, NODE_A, None), (fs({NODE_B}), None, NODE_A, None),
             (fs({NODE_B}), fs({"t1"}), NODE_A, fs({"t2"})), (fs({NODE_B}), fs({"t1", "t2"}), NODE_A, fs({"t2"})),
             (fs({NODE_B}), None, NODE_A, fs({"t2"})), (fs({NODE_B}), fs({"t1"}), NODE_A, None),
             (None, None, NODE_A, fs({"t2"})), (None, fs({"t1"}), NODE_A, fs({"t2"}))]
    got, _ = both(lambda pkg: [pkg.push._event_wakes(*c) for c in cases])
    assert got == [False, True, False, True, True, True, True, False]


def test_parse_poll_query_tags():
    def episode(pkg):
        q = f"owner=u1&node={NODE_A}&cursor=0"
        many = ",".join("t%d" % i for i in range(pkg.proto._MAX_SCOPE_TAGS + 1))
        return (pkg.push.parse_poll_query(q + "&tags=aa,bb"), pkg.push.parse_poll_query(q)[4],
                _outcome(lambda: pkg.push.parse_poll_query(q + "&tags=" + many)),
                _outcome(lambda: pkg.push.parse_poll_query(q + "&tags=" + "x" * (pkg.proto._MAX_SCOPE_TAG_LEN + 1))))

    got, _ = both(episode)
    assert got[0][4] == frozenset({"aa", "bb"}) and got[1] is None and got[2] == got[3] == ("raised", "ValueError")


def test_hub_lane_gated_wakeups():
    def episode(pkg):
        hub = pkg.push.PushHub()
        try:
            out = [hub.notify("u1", [_ts(BASE, 0, NODE_B)], tags=None)]
            kind, _ = hub.park("u1", NODE_A, 1, None, token="tok1", tags=frozenset({"t1"}))
            if kind == "now":
                kind, _ = hub.park("u1", NODE_A, 2, None, token="tok1", tags=frozenset({"t1"}))
            out.append(kind)
            out.append(hub.notify("u1", [_ts(BASE + 1, 0, NODE_B)], tags=frozenset({"t2"})))
            out.append(hub.notify("u1", [_ts(BASE + 2, 0, NODE_B)], tags=frozenset({"t1"})))
            out.append(hub.park("u1", NODE_A, 3, None, token="tok2", tags=frozenset({"t1"}))[0])
            out.append(hub.notify("u1", [_ts(BASE + 3, 0, NODE_B)], tags=None))
            return out
        finally:
            hub.close()

    got, _ = both(episode)
    assert got[1:] == ["parked", 0, 1, "parked", 1]


# --- client emission gate + failover downgrade ---


class Clients:
    """Deterministic handles of one package: row ids, node ids, ISO and
    worker clocks equal in both packages."""

    def __init__(self, pkg, monkeypatch):
        self.pkg = pkg
        ids, nodes = itertools.count(), itertools.count(1)
        monkeypatch.setattr(pkg.client, "create_id", lambda: f"id{next(ids):019d}")
        monkeypatch.setattr(pkg.ts, "create_node_id", lambda: f"{next(nodes):016x}")
        isos = itertools.count(BASE, 1000)
        self.now_iso = lambda: pkg.ts.millis_to_iso(next(isos))
        self.made = []

    def make(self, config=None, mnemonic=MNEMONIC, **cfg):
        pkg = self.pkg
        config = config or pkg.config.Config(**cfg)
        kw = {"device": "cpu", "backend": "native"} if pkg.port else {}
        e = pkg.client.Evolu(config=config, mnemonic=mnemonic, now_iso=self.now_iso, **kw)
        ticks = itertools.count(BASE, 1000)
        e.worker.now = lambda: next(ticks)
        e.update_db_schema(SCHEMA)
        self.made.append(e)
        return e

    def dispose(self):
        for e in self.made:
            if not e._disposed:
                e.dispose()


def _round(ev, tr):
    ev.worker.flush()
    tr.flush()
    ev.worker.flush()


def _has_lane_table(store):
    return bool(store.db.exec("SELECT name FROM sqlite_schema WHERE name='scopeLane'"))


def test_scope_clause_capability_gated_end_to_end(monkeypatch):
    """Round 1 (nothing negotiated): no clause, no lane state at the
    relay. Round 2 (the echo landed): the clause rides and lanes record."""
    def episode(pkg):
        clients = Clients(pkg, monkeypatch)
        server = pkg.server(pkg.store("native")).start()
        try:
            ev = clients.make(sync_url=server.url, sync_scope=pkg.sscope.SyncScope(tables=("todo",)),
                              **({"backend": "cuda"} if pkg.port else {}))
            tr = pkg.sclient.connect(ev)
            ev.create("todo", {"title": "r1"})
            _round(ev, tr)
            negotiated = pkg.proto.CAP_SYNC_SCOPE in tr.negotiated_capabilities[server.url]
            lanes1 = _has_lane_table(server.store)
            ev.create("todo", {"title": "r2"})
            _round(ev, tr)
            return (negotiated, lanes1, server.store.db.exec('SELECT "tag" FROM "scopeLane"'),
                    pkg.sscope.derive_scope_tag(ev.owner.mnemonic, "todo"), ev.get_error(),
                    server.store.db.exec('SELECT "timestamp", "userId" FROM "message" ORDER BY 1'))
        finally:
            clients.dispose()
            server.stop()

    (negotiated, lanes1, tags, tag, err, rows), _ = within(LIMIT_S, lambda: both(episode))
    assert negotiated and not lanes1 and err is None
    assert {r[0] for r in tags} == {tag} and len(rows) == 6  # title, createdAt, createdBy of two rows


def test_scope_failover_reencodes_without_clause(monkeypatch):
    """A failover target that never advertised sync-scope-v1 is never sent
    a scope clause: the round is encoded again without it (the port counts
    `scope_downgrades_failover` where the JAX transport posts
    `evolu_scope_downgrades_total{reason="failover"}`)."""
    def episode(pkg):
        clients = Clients(pkg, monkeypatch)
        a = pkg.server(pkg.store("native"), peers=[], replication_interval_s=30).start()
        b = pkg.server(pkg.store("native"), capabilities=(), peers=[], replication_interval_s=30).start()
        cfg = pkg.config.FleetConfig(relays=(a.url, b.url), replication_factor=2, version=1)
        a.enable_fleet(cfg)
        b.enable_fleet(cfg)
        try:
            ev = clients.make(sync_url=b.url, sync_scope=pkg.sscope.SyncScope(tables=("todo",)))
            tr = pkg.sclient.connect(ev)
            tr._routes[ev.owner.id] = a.url + "/"
            ev.create("todo", {"title": "r1"})
            _round(ev, tr)
            negotiated = pkg.proto.CAP_SYNC_SCOPE in tr.negotiated_capabilities[a.url + "/"]
            ev.create("todo", {"title": "r2"})
            _round(ev, tr)
            lanes_a = _has_lane_table(a.store)
            a.stop()
            errors = []
            ev.subscribe_error(errors.append)
            before = (tr.counts.get("scope_downgrades_failover", 0) if pkg.port else
                      jmetrics.get_counter("evolu_scope_downgrades_total", reason="failover"))
            ev.create("todo", {"title": "r3"})
            _round(ev, tr)
            after = (tr.counts.get("scope_downgrades_failover", 0) if pkg.port else
                     jmetrics.get_counter("evolu_scope_downgrades_total", reason="failover"))
            return (negotiated, lanes_a, errors, after - before, b.store.user_ids() == [ev.owner.id],
                    _has_lane_table(b.store),
                    # r3's rows at least (a resend of older rows may race the read).
                    len(b.store.db.exec('SELECT "timestamp" FROM "message"')) >= 3)
        finally:
            clients.dispose()
            b.stop()

    got, _ = within(LIMIT_S, lambda: both(episode))
    assert got == (True, True, [], 1, True, False, True)


def test_unadvertising_relay_strips_hostile_clause():
    def episode(pkg):
        server = pkg.server(pkg.store("native"), capabilities=()).start()
        try:
            pkg.serve(server.store, pkg.proto.SyncRequest(_emsgs(pkg, NODE_A, 0, 4), "u1", NODE_A, "{}"))
            body = pkg.proto.encode_sync_request(pkg.proto.SyncRequest(
                (), "u1", NODE_B, "{}", ("sync-scope-v1",), pkg.proto.ScopeClause(BASE + MINUTE, (), ())))
            return pkg.sclient._http_post(server.url, body)
        finally:
            server.stop()

    out, counts = within(LIMIT_S, lambda: both(episode))
    assert len(PORT.proto.decode_sync_response(out).messages) == 4 and counts["serves"] == 0


# --- worker: deferred materialization + typed deferral + widen ---


def _drain(pkg, src, dst):
    node = pkg.clock.read_clock(dst.db).timestamp.node
    rows = src.db.exec_sql_query('SELECT * FROM "__message" WHERE "timestamp" NOT LIKE \'%\' || ? '
                                 'ORDER BY "timestamp"', (node,))
    return tuple(pkg.types.CrdtMessage(r["timestamp"], r["table"], r["row"], r["column"], r["value"]) for r in rows)


def _tree_str(pkg, ev):
    return pkg.merkle.merkle_tree_to_string(pkg.clock.read_clock(ev.db).merkle_tree)


def _tables(ev, clock=True):
    """Every table of a client; without `__clock` where the HLC depends on
    how a live relay's rounds interleaved."""
    names = [r[0] for r in ev.db.exec("SELECT name FROM sqlite_schema WHERE type='table' ORDER BY name")]
    return {t: sorted(ev.db.exec(f'SELECT * FROM "{t}"'), key=repr) for t in names if clock or t != "__clock"}


def _err(e):
    if e is None:
        return None
    return (type(e).__name__, str(e), getattr(e, "tables", None), getattr(e, "deferred_rows", None))


def _thin(pkg, clients, **cfg):
    return clients.make(sync_scope=pkg.sscope.SyncScope(tables=("todo",)),
                        **({"backend": "cuda"} if pkg.port else {}), **cfg)


def test_worker_defers_out_of_scope_then_widens(monkeypatch):
    def episode(pkg):
        clients = Clients(pkg, monkeypatch)
        try:
            full = clients.make()
            thin = _thin(pkg, clients)
            full.create("todo", {"title": "t1"})
            full.create("note", {"body": "n1"})
            full.create("note", {"body": "n2"})
            full.worker.flush()
            drained = _drain(pkg, full, thin)
            thin.receive(drained, _tree_str(pkg, full))
            thin.worker.flush()
            q_todo = pkg.query.table("todo").select("title").serialize()
            q_note = pkg.query.table("note").select("body").serialize()
            obs = [[r["title"] for r in thin.query_once(q_todo)], thin.db.exec('SELECT * FROM "note"'),
                   _tree_str(pkg, thin) == _tree_str(pkg, full),
                   thin.db.exec('SELECT "table", "rows" FROM "__scope_deferred"'),
                   sum(1 for m in drained if m.table == "note")]
            thin.query_once(q_note)
            thin.worker.flush()
            obs.append(_err(thin.get_error()))
            thin.worker.post(pkg.msg.WidenSyncScope(full=True))
            thin.worker.flush()
            obs += [thin.worker.config.sync_scope, sorted(r["body"] for r in thin.query_once(q_note)),
                    thin.db.exec('SELECT * FROM "__scope_deferred"'), _tree_str(pkg, thin) == _tree_str(pkg, full),
                    _tables(thin), _tables(full)]
            return obs
        finally:
            clients.dispose()

    obs, _ = within(LIMIT_S, lambda: both(episode))
    assert obs[0] == ["t1"] and obs[1] == [] and obs[2] is True
    n_note = obs[4]
    assert obs[3] == [("note", n_note)] and n_note == 2 * 3  # body, createdAt, createdBy of two rows
    assert obs[5][0] == "ScopeDeferred" and obs[5][2:] == (("note",), n_note)
    assert obs[6] is None and obs[7] == ["n1", "n2"] and obs[8] == [] and obs[9] is True


def test_worker_widen_rematerializes_lww_winner(monkeypatch):
    def episode(pkg):
        clients = Clients(pkg, monkeypatch)
        try:
            full = clients.make()
            thin = _thin(pkg, clients)
            rid = full.create("note", {"body": "v1"})
            full.worker.flush()
            full.update("note", rid, {"body": "v2"})
            full.worker.flush()
            thin.receive(_drain(pkg, full, thin), _tree_str(pkg, full))
            thin.worker.flush()
            before = thin.db.exec('SELECT * FROM "note"')
            thin.worker.post(pkg.msg.WidenSyncScope(full=True))
            thin.worker.flush()
            return rid, before, thin.db.exec('SELECT "id", "body" FROM "note"'), _tables(thin)
        finally:
            clients.dispose()

    (rid, before, rows, _tables_), _ = within(LIMIT_S, lambda: both(episode))
    assert before == [] and rows == [(rid, "v2")]


def test_worker_widen_narrowing_surfaces_error(monkeypatch):
    def episode(pkg):
        clients = Clients(pkg, monkeypatch)
        try:
            thin = clients.make(sync_scope=pkg.sscope.SyncScope(watermark_millis=100, tables=("todo",)))
            thin.worker.post(pkg.msg.WidenSyncScope(watermark_millis=200))
            thin.worker.flush()
            return _err(thin.get_error()), thin.worker.config.sync_scope.watermark_millis
        finally:
            clients.dispose()

    (err, wm), _ = within(LIMIT_S, lambda: both(episode))
    assert err[0] == "ValueError" and wm == 100


def test_scoped_clients_converge_within_slice_through_relay(monkeypatch):
    """A full and a thin device of one owner through a live relay: the
    thin device converges on its slice and defers the rest with an exact
    counter, on the port as on JAX (same relay rows, lanes, client
    tables)."""
    def episode(pkg):
        clients = Clients(pkg, monkeypatch)
        server = pkg.server(pkg.store("native")).start()
        try:
            full = clients.make(sync_url=server.url)
            thin = _thin(pkg, clients, sync_url=server.url)
            tf, tt = pkg.sclient.connect(full), pkg.sclient.connect(thin)
            q = pkg.query.table("todo").select("title").order_by("title").serialize()
            # The thin device negotiates sync-scope-v1 before it writes, so
            # its rows always ride with the clause and record their lanes
            # (otherwise whether its first push beats the echo is a race).
            thin.sync(refresh_queries=False)
            _round(thin, tt)
            full.create("todo", {"title": "a"})
            full.create("note", {"body": "hidden"})
            thin.create("todo", {"title": "b"})
            for _ in range(6):
                _round(full, tf)
                _round(thin, tt)
                full.sync(refresh_queries=False)
                thin.sync(refresh_queries=False)
            _round(full, tf)
            _round(thin, tt)
            return ([r["title"] for r in full.query_once(q)], [r["title"] for r in thin.query_once(q)],
                    full.get_error(), thin.db.exec('SELECT * FROM "note"'),
                    thin.db.exec('SELECT "table", "rows" FROM "__scope_deferred"'), _tables(thin, False),
                    _tables(full, False),
                    server.store.db.exec('SELECT "timestamp", "userId" FROM "message" ORDER BY 1, 2'), _lanes(server.store.db))
        finally:
            clients.dispose()
            server.stop()

    obs, _ = within(LIMIT_S, lambda: both(episode, counted=False))
    assert obs[0] == obs[1] == ["a", "b"] and obs[2] is None and obs[3] == []
    assert obs[4] and obs[4][0][0] == "note" and obs[4][0][1] > 0
    assert [(ts[-16:], tag) for _u, ts, tag in obs[8]] == [(f"{2:016x}", obs[8][0][2])] * 3


def test_query_of_a_mixed_case_deferred_table_answers_rows_as_jax(monkeypatch):
    """A fault of the reference that the port keeps (ROADMAP queue 3 item
    9): the dependency walk lowercases table names (`storage/deps.py`), and
    the worker compares them with the frontier's names as stored, so a
    deferred table whose name has upper-case letters never answers
    `ScopeDeferred`: its query answers the (empty) rows. A lower-case
    table defers. This fails if either package repairs the fault alone."""
    schema = {"todo": ("title",), "todoCategory": ("name",), "note": ("body",)}

    def episode(pkg):
        clients = Clients(pkg, monkeypatch)
        try:
            full = clients.make()
            full.update_db_schema(schema)
            thin = _thin(pkg, clients)
            thin.update_db_schema(schema)
            full.create("todoCategory", {"name": "c"})
            full.create("note", {"body": "n"})
            full.worker.flush()
            thin.receive(_drain(pkg, full, thin), _tree_str(pkg, full))
            thin.worker.flush()
            out = [thin.worker._deferred_frontier()]
            for t, c in (("todoCategory", "name"), ("note", "body")):
                errors = []
                unsub = thin.subscribe_error(errors.append)
                rows = thin.query_once(pkg.query.table(t).select(c).serialize())
                thin.worker.flush()
                unsub()
                out.append((rows, [_err(e) for e in errors]))
            return out
        finally:
            clients.dispose()

    (frontier, cat, note), _ = within(LIMIT_S, lambda: both(episode))
    assert frontier["todoCategory"] > 0 and frontier["note"] > 0
    assert cat == ([], [])
    assert note[1] and note[1][0][0] == "ScopeDeferred" and note[1][0][2] == ("note",)


# --- scoped snapshot capture ---


def test_scoped_snapshot_capture_regenerates_trees():
    def episode(pkg):
        store = pkg.store()
        try:
            new = _emsgs(pkg, NODE_A, 3, 10)
            store.add_messages("u1", _emsgs(pkg, NODE_A, 0, 10) + new)
            manifest, chunks = pkg.snap.capture_snapshot(store, snapshot_id="s", watermark_millis=BASE + 3 * MINUTE)
            recs = [r for c in chunks for r in pkg.snap.iter_records(c)]
            dest = pkg.store()
            try:
                pkg.snap.install_stream(dest, manifest, chunks)
                installed = dest.get_merkle_tree_string("u1")
            finally:
                dest.close()
            _m2, c2 = pkg.snap.capture_snapshot(store, snapshot_id="t")
            unscoped = sum(1 for c in c2 for r in pkg.snap.iter_records(c) if r[0] == "M")
            return (pkg.proto.encode_snapshot_manifest(manifest), chunks, [r[1] for r in recs if r[0] == "M"],
                    {r[1]: r[2] for r in recs if r[0] == "T"}, installed, unscoped, [m.timestamp for m in new])
        finally:
            store.close()

    (_m, _c, kept, trees, installed, unscoped, new), _ = both(episode)
    assert kept == new and trees["u1"] == installed == _client_tree(PORT, kept) and unscoped == 20


# --- the model-check episode ---


def _adversarial_now(base, sub_seed):
    """The reference episode's hostile clock: 40% frozen, 20% a bounded
    regression, else small advances."""
    r = random.Random(sub_seed)
    state = {"t": base}

    def now():
        roll = r.random()
        if roll < 0.4:
            pass
        elif roll < 0.6:
            state["t"] = max(base - 20_000, state["t"] - r.randrange(0, 10_000))
        else:
            state["t"] += r.randrange(1, 400)
        return state["t"]

    return now


class _Faulty:
    """A replication transport that can block a peer (a partition)."""

    def __init__(self, post):
        self._post, self.blocked = post, set()

    def post(self, url, body):
        if any(url.startswith(b) for b in self.blocked):
            raise OSError("partitioned")
        return self._post(url, body)


def _relay_state(store):
    return {u: (store.get_merkle_tree_string(u),
                tuple((m.timestamp, bytes(m.content)) for m in store.replica_messages(u, "")))
            for u in sorted(store.user_ids())}


def _run_port_scope_episode():
    """`tests/test_model_check.py::_run_scoped_partial_replication_episode`
    on port relays and clients (the full device on the card planner's plain
    versions with the winner cache, the scoped one on the host oracle)."""
    import functools

    from evolu_tpu_torch.core.types import CrdtMessage, SyncError
    from evolu_tpu_torch.runtime import messages as wmsg
    from evolu_tpu_torch.runtime.client import create_evolu
    from evolu_tpu_torch.server.relay import RelayServer, RelayStore
    from evolu_tpu_torch.server.replicate import ReplicationManager
    from evolu_tpu_torch.storage.clock import read_clock
    from evolu_tpu_torch.sync.client import _http_post, connect
    from evolu_tpu_torch.sync.scope import SyncScope
    from evolu_tpu_torch.utils.config import Config

    seed = 20260807
    rng = random.Random(seed)
    base = int(time.time() * 1000)
    schema = {"todo": ("title", "isCompleted", "categoryId"), "todoCategory": ("name",)}
    stores = [RelayStore(backend="native"), RelayStore(backend="native")]
    faults = [_Faulty(functools.partial(_http_post, retries=0)) for _ in stores]
    mgrs = [ReplicationManager(s, [], replica_id=f"scope-{i}", interval_s=0.1, debounce_s=0.02,
                               backoff_base_s=0.05, backoff_max_s=0.3, http_post=f.post)
            for i, (s, f) in enumerate(zip(stores, faults))]
    servers = [RelayServer(s, replication=m, device="cpu").start() for s, m in zip(stores, mgrs)]
    a, b = servers
    replicas = []
    try:
        mgrs[0].add_peer(b.url)
        mgrs[1].add_peer(a.url)
        full = create_evolu(schema, config=Config(sync_url=a.url, backend="cuda"), device="cpu")
        thin = create_evolu(schema, mnemonic=full.owner.mnemonic, device="cpu",
                            config=Config(sync_url=b.url, backend="cpu", sync_scope=SyncScope(tables=("todo",))))
        replicas = [full, thin]
        errors = []
        for i, r in enumerate(replicas):
            r.worker.now = _adversarial_now(base, seed + i)
            connect(r)
            r.subscribe_error(errors.append)

        def step(r, allow_category):
            t = rng.choice(["todo", "todo", "todoCategory"] if allow_category else ["todo"])
            if t == "todo":
                r.create("todo", {"title": f"t{rng.randrange(10**6)}", "isCompleted": False})
            else:
                r.create("todoCategory", {"name": f"c{rng.randrange(10**6)}"})
            r.worker.flush()
            if rng.random() < 0.4:
                r.sync()
                r.worker.flush()

        for _ in range(14):
            step(full, True)
            step(thin, False)
        # A non-canonical batch (upper-case node hex) for the in-scope table:
        # the winner cache's host route plans it wherever it lands.
        cache = full.worker._planner.cache
        bounces0 = cache.counts["host_fallbacks"]
        full._transport.flush()
        full.worker.flush()
        nc = tuple(CrdtMessage((lambda s: s[:30] + s[30:].upper())(timestamp_to_string(
            Timestamp(base + 1000 + i, 0, "00000000000000ab"))), "todo", f"ncrow{i}", "title", f"nc{i}")
            for i in range(3))
        local = read_clock(full.db).merkle_tree
        deltas, _ = PORT.merkle.minute_deltas_host(m.timestamp for m in nc)
        full.receive(nc, PORT.merkle.merkle_tree_to_string(PORT.merkle.apply_prefix_xors(dict(local), deltas)))
        full.worker.flush()
        assert cache.counts["host_fallbacks"] > bounces0

        faults[0].blocked.add(b.url)
        faults[1].blocked.add(a.url)
        for _ in range(8):
            step(full, True)
            step(thin, False)
        faults[0].blocked.clear()
        faults[1].blocked.clear()
        mgrs[0].hint()
        mgrs[1].hint()

        def log(r):
            return r.db.exec('SELECT * FROM "__message" ORDER BY "timestamp"')

        def converge(what, relays_too):
            deadline = time.time() + 60
            while True:
                for r in replicas:
                    r.sync()
                    r.worker.flush()
                if log(full) == log(thin) and (not relays_too or _relay_state(stores[0]) == _relay_state(stores[1])):
                    break
                assert time.time() < deadline, what
                time.sleep(0.05)
            for r in replicas:
                r._transport.flush()
                r.worker.flush()

        converge("logs/relays did not converge across the scope boundary", True)
        assert not [e for e in errors if not isinstance(e, SyncError)], errors
        todo_full = full.db.exec('SELECT * FROM "todo" ORDER BY "id"')
        assert todo_full == thin.db.exec('SELECT * FROM "todo" ORDER BY "id"')
        assert any(r[0].startswith("ncrow") for r in thin.db.exec('SELECT "id" FROM "todo"'))
        assert thin.db.exec('SELECT * FROM "todoCategory"') == []
        n_cat = thin.db.exec_sql_query('SELECT COUNT(*) AS n FROM "__message" WHERE "table" = ?',
                                       ("todoCategory",))[0]["n"]
        assert n_cat > 0, "episode never exercised the deferred leg"
        frontier = thin.db.exec_sql_query('SELECT "rows" FROM "__scope_deferred" WHERE "table" = ?',
                                          ("todoCategory",))
        assert frontier and frontier[0]["rows"] == n_cat
        converged_log = log(full)

        thin.worker.post(wmsg.WidenSyncScope(full=True))
        thin.worker.flush()
        assert thin.db.exec_sql_query('SELECT * FROM "__scope_deferred"') == []
        for _ in range(4):
            step(full, True)
        converge("post-escalation convergence failed", False)
        assert full.db.exec('SELECT * FROM "todoCategory" ORDER BY "id"') == \
            thin.db.exec('SELECT * FROM "todoCategory" ORDER BY "id"')
        assert full.db.exec('SELECT * FROM "todo" ORDER BY "id"') == thin.db.exec('SELECT * FROM "todo" ORDER BY "id"')
        assert not [e for e in errors if not isinstance(e, SyncError)], errors
        return schema, converged_log, n_cat, todo_full
    finally:
        for r in replicas:
            r.dispose()
        for s in servers:
            s.stop()


def _replay_scoped(pkg, schema, log):
    """A fresh scoped client of `pkg` fed the episode's converged log in
    two receives, then widened: → its tables before and after the widening
    and its frontier."""
    from evolu_tpu.core.merkle import apply_prefix_xors, merkle_tree_to_string, minute_deltas_host

    kw = {"device": "cpu", "backend": "native"} if pkg.port else {}
    e = pkg.client.Evolu(config=pkg.config.Config(sync_scope=pkg.sscope.SyncScope(tables=("todo",)),
                                                  **({"backend": "cuda"} if pkg.port else {})),
                         mnemonic=MNEMONIC, **kw)
    try:
        e.update_db_schema(schema)
        msgs = [pkg.types.CrdtMessage(*r) for r in log]
        half = len(msgs) // 2
        clock = pkg.clock.read_clock(e.db)
        stamps = sorted(m.timestamp for m in msgs)
        deltas, _ = minute_deltas_host(stamps)
        server_tree = merkle_tree_to_string(apply_prefix_xors(dict(clock.merkle_tree), deltas))
        # Wall clock at the newest stamp: every received stamp is within the drift.
        newest = max(pkg.ts.timestamp_from_string(s).millis for s in stamps)
        e.worker.now = lambda: newest
        for part in (msgs[:half], msgs[half:]):
            e.receive(tuple(part), server_tree)
            e.worker.flush()
        before = (_tables(e), e.worker._deferred_frontier())
        e.worker.post(pkg.msg.WidenSyncScope(full=True))
        e.worker.flush()
        after = _tables(e)
        return before, after, _err(e.get_error())
    finally:
        e.dispose()


def test_scoped_partial_replication_episode(monkeypatch):
    """The reference's model-check scope episode on port relays and port
    clients: a full and a scoped device of one owner at different relays
    that gossip, under the adversarial clocks, a partition and its heal, a
    non-canonical batch and a mid-stream widening; the reference's
    invariants hold (logs converge, the in-scope table byte-identical, the
    out-of-scope table empty with a counter-exact frontier, everything
    equal after the widening). Then the converged log replays into a fresh
    JAX and a fresh port scoped client, which must end equal before and
    after their widening."""
    schema, converged, n_cat, todo_full = within(240, _run_port_scope_episode)
    for pkg in (JAX, PORT):
        monkeypatch.setattr(pkg.ts, "create_node_id", lambda: "00000000000000ee")
    want = _replay_scoped(JAX, schema, converged)
    got = _replay_scoped(PORT, schema, converged)
    assert got == want
    (before, frontier), after, err = got
    assert err is None and frontier == {"todoCategory": n_cat} and before["todoCategory"] == []
    assert sorted(before["todo"], key=repr) == sorted(todo_full, key=repr)
    assert len(after["todoCategory"]) > 0 and after["__scope_deferred"] == []
