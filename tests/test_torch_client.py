"""Port parity: the client handle (`runtime.client.Evolu`, `api.hooks`,
`utils.reload`) against the JAX package's.

Each workload — the handle workloads of tests/test_runtime.py, the
hooks, the reload signal on a file database, and the typed calls on
the `board` schema — runs once on the JAX `Evolu` and once on the
port's (`device="cpu"`), with row ids, node ids, `now_iso` and the
worker's clock made deterministic and equal in both. The workload's
observations (query rows and row identity, listener and on_complete
firings, the error channel by type and message, `post_sync` pushes),
every worker output (OnQuery patches included) and every table of
every client (`__message`, `__clock`, `__owner`, `__crdt_*` and the
app tables) must be equal. Tolerance: exact everywhere.

The handle runs worker, watcher and listener threads, so each test
runs inside its own time limit (`within`)."""

import importlib
import itertools
import threading

import numpy as np
import pytest
from _torch_jax_state import jax_process_state  # noqa: F401  (the JAX package's native libraries and ledger)

from _torch_port_data import within

NOW = 1_700_000_000_000
MNEMONIC = "legal winner thank year wave sausage worth useful legal winner thank yellow"
MNEMONIC2 = "letter advice cage absurd amount doctor acoustic avoid letter advice cage above"
TODO = {"todo": ("title", "isCompleted", "createdAt", "createdBy", "updatedAt", "isDeleted")}
JOINED = {"todo": ("title", "isCompleted", "categoryId"), "todoCategory": ("name",)}
BOARD = {"board": ("title", "votes:counter", "tags:awset", "body:list", "w:tensor:sum:f32:8",
                   "avg:tensor:mean:f32:8", "peak:tensor:max:f32:8")}
LIMIT_S = 120


class Pkg:
    """One package's modules, and the clients a workload made with it."""

    def __init__(self, root, monkeypatch, tmp_path):
        mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
        self.root, self.port = root, root == "evolu_tpu_torch"
        self.client, self.q, self.hooks = mod("runtime.client"), mod("api.query"), mod("api.hooks")
        self.msg, self.types, self.model = mod("runtime.messages"), mod("core.types"), mod("api.model")
        self.reload, self.Config = mod("utils.reload"), mod("utils.config").Config
        self.read_clock = mod("storage.clock").read_clock
        self.merkle, self.ts = mod("core.merkle"), mod("core.timestamp")
        self.tmp = tmp_path / root
        self.tmp.mkdir()
        ids, nodes = itertools.count(), itertools.count(1)
        monkeypatch.setattr(self.client, "create_id", lambda: f"id{next(ids):019d}")
        monkeypatch.setattr(self.ts, "create_node_id", lambda: f"{next(nodes):016x}")
        isos = itertools.count(NOW, 1000)
        self.now_iso = lambda: self.ts.millis_to_iso(next(isos))
        self.clients, self.outputs, self.pushes = [], [], []

    def kw(self):
        """Evolu kwargs: the deterministic ISO clock, and on the port the CPU
        and the Python SQLite backend."""
        return {"now_iso": self.now_iso, **({"device": "cpu", "backend": "python"} if self.port else {})}

    def adopt(self, evolu):
        """Make a client's worker clock deterministic and record its
        outputs and pushes (wrapping, not replacing, the handle's own)."""
        ticks = itertools.count(NOW, 1000)
        evolu.worker.now = lambda: next(ticks)
        n = len(self.clients)
        out, post = evolu.worker.on_output, evolu.worker.post_sync
        evolu.worker.on_output = lambda o: (self.outputs.append((n, o)), out(o))[1]
        evolu.worker.post_sync = lambda r: (self.pushes.append((n, r)), post(r))[1]
        self.clients.append(evolu)
        return evolu

    def make(self, schema, config=None, db_path=":memory:", mnemonic=MNEMONIC):
        evolu = self.adopt(self.client.Evolu(db_path=db_path, config=config, mnemonic=mnemonic, **self.kw()))
        evolu.update_db_schema(schema)
        return evolu

    def create_hooks(self, schema):
        hooks = self.hooks.create_hooks(schema, mnemonic=MNEMONIC, **self.kw())
        self.adopt(hooks.evolu)
        return hooks

    def finish(self):
        """Every client's tables, then dispose."""
        dumps = []
        for e in self.clients:
            if not e._disposed:
                e.worker.flush()
                names = [r[0] for r in e.db.exec("SELECT name FROM sqlite_schema WHERE type='table' ORDER BY name")]
                dumps.append({t: sorted(e.db.exec(f'SELECT * FROM "{t}"'), key=repr) for t in names})
                e.dispose()
        return dumps


def _norm_output(o):
    name = type(o).__name__
    if name == "OnInit":
        return (name, o.owner.id, o.owner.mnemonic)
    if name == "OnQuery":
        return (name, o.queries_patches, o.on_complete_ids)
    if name == "OnError":
        return (name, type(o.error).__name__, str(o.error))
    return (name,)


def _norm_push(r):
    return ([(m.timestamp, m.table, m.row, m.column, m.value) for m in r.messages],
            r.clock_timestamp, r.merkle_tree, r.owner.id, r.previous_diff)


def _err(e):
    return (type(e).__name__, str(e))


def _raises(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the error type is the observation
        return type(e).__name__
    return None


# --- the workloads (tests/test_runtime.py:395-640, 686-721, 721-860, 874-990) ---


def wl_reactive(p):
    """Mutate and reactive query, row identity across an update, the
    auto columns and soft delete, on_complete, batching."""
    e = p.make(TODO)
    obs = {}
    q = p.q.table("todo").select("id", "title").order_by("createdAt").serialize()
    seen, done = [], []
    e.subscribe_query(q, listener=lambda: seen.append(True))
    a = e.create("todo", {"title": "buy milk", "isCompleted": False}, on_complete=lambda: done.append("a"))
    b = e.create("todo", {"title": "b"})
    e.worker.flush()
    before = {r["id"]: r for r in e.get_query_rows(q)}
    e.update("todo", b, {"title": "b2"})
    e.worker.flush()
    after = {r["id"]: r for r in e.get_query_rows(q)}
    obs["rows"] = e.get_query_rows(q)
    obs["identity kept"] = after[a] is before[a]
    obs["listener fired"] = len(seen)
    qa = p.q.table("todo").select_all().serialize()
    e.subscribe_query(qa)
    e.update("todo", a, {"isDeleted": True, "isCompleted": True})
    e.worker.flush()
    obs["all"] = e.get_query_rows(qa)
    obs["dates"] = [p.model.is_sqlite_date(r["createdAt"]) for r in obs["all"]]
    with e.batching():
        e.create("todo", {"title": "c"})
        with e.batching():
            e.create("todo", {"title": "d"}, on_complete=lambda: done.append("d"))
    e.worker.flush()
    obs["done"] = done
    obs["first data"] = e.first_data_loaded.is_set()
    return obs


def wl_errors(p):
    """The error channel, a failed Send that pushes nothing, an aborted
    batch, an unwired transport."""
    e = p.make(TODO)
    errors = []
    e.subscribe_error(errors.append)
    e.worker.post(p.msg.Query((p.msg.serialize_query("SELECT nonsense FROM nowhere"),)))
    e.worker.flush()
    obs = {"first": [_err(x) for x in errors], "get_error is first": e.get_error() is errors[0]}
    bad = p.msg.serialize_query("SELECT broken FROM nowhere")
    unsub = e.subscribe_query(bad)
    e.worker.flush()
    e.create("todo", {"title": "x"})  # the Send applies, its query sweep raises: rolled back
    e.worker.flush()
    obs["messages after failure"] = e.db.exec('SELECT COUNT(*) FROM "__message"')
    unsub()
    q = p.q.table("todo").select("title").serialize()
    try:
        with e.batching():
            e.create("todo", {"title": "doomed"}, on_complete=lambda: errors.append("never"))
            raise RuntimeError("abort")
    except RuntimeError:
        pass
    e.create("todo", {"title": "kept"})
    e.worker.flush()
    obs["rows"] = e.query_once(q)
    obs["errors"] = [x if isinstance(x, str) else _err(x) for x in errors]
    obs["bytes refused"] = _raises(lambda: (e.create("todo", {"title": b"raw"}), e.worker.flush()))
    e.worker.flush()
    obs["errors after bytes"] = [x if isinstance(x, str) else _err(x) for x in errors]
    return obs


def wl_owner(p):
    """reset_owner wipes and reloads; restore_owner reseeds; a bad
    mnemonic raises."""
    e = p.make(TODO)
    reloaded = []
    e.on_reload(lambda: reloaded.append(True))
    e.create("todo", {"title": "x"})
    e.worker.flush()
    e.reset_owner()
    e.worker.flush()
    obs = {"reloaded": list(reloaded),
           "tables after reset": e.db.exec("SELECT name FROM sqlite_schema WHERE type='table'")}
    e.restore_owner(MNEMONIC2)
    e.worker.flush()
    obs["owner"] = (e.owner.id, e.get_owner().mnemonic, e.worker.owner.id)
    obs["bad mnemonic"] = _raises(lambda: e.restore_owner("not a mnemonic at all"))
    e.update_db_schema(TODO)
    e.create("todo", {"title": "after restore"})
    e.worker.flush()
    obs["reloaded"] = list(reloaded)
    return obs


def _drain(p, evolu, for_replica):
    """All of `evolu`'s messages except those `for_replica` authored."""
    node = p.read_clock(for_replica.db).timestamp.node
    rows = evolu.db.exec_sql_query(
        'SELECT * FROM "__message" WHERE "timestamp" NOT LIKE \'%\' || ? ORDER BY "timestamp"', (node,))
    return tuple(p.types.CrdtMessage(r["timestamp"], r["table"], r["row"], r["column"], r["value"])
                 for r in rows)


def _tree(p, evolu):
    return p.merkle.merkle_tree_to_string(p.read_clock(evolu.db).merkle_tree)


def wl_converge(p):
    """Two replicas converge by exchanging Receive commands; LWW."""
    a, b = p.make(TODO), p.make(TODO)
    q = p.q.table("todo").select("id", "title").order_by("id").serialize()
    a.subscribe_query(q)
    b.subscribe_query(q)
    rid = a.create("todo", {"title": "from-a"})
    a.worker.flush()
    b.create("todo", {"title": "from-b"})
    b.worker.flush()
    b.receive(_drain(p, a, b), _tree(p, a))
    b.worker.flush()
    a.receive(list(_drain(p, b, a)), _tree(p, b))
    a.worker.flush()
    obs = {"a": a.query_once(q), "b": b.query_once(q), "trees": (_tree(p, a), _tree(p, b))}
    b.update("todo", rid, {"title": "edited-by-b"})
    b.worker.flush()
    a.receive(_drain(p, b, a), _tree(p, b))
    a.worker.flush()
    obs["a after"] = a.query_once(q)
    return obs


def wl_subscriptions(p):
    """query_once leaks no subscription, unsubscribe evicts, raw SQL and
    builders key the same entry, common columns appended."""
    e = p.make({"todo": ("title",)})
    q = p.q.table("todo").select("id").serialize()
    obs = {"once empty": e.query_once(q), "leaked": q in e._subscribed}
    rid = e.create("todo", {"title": "x"})
    e.worker.flush()
    unsub = e.subscribe_query(q)
    unsub2 = e.subscribe_query(q)
    e.worker.flush()
    obs["rows"] = e.get_query_rows(q)
    unsub()
    e.worker.flush()
    obs["kept while one holds it"] = (q in e.worker.queries_rows_cache, q in e._rows_cache)
    unsub2()
    e.worker.flush()
    obs["evicted"] = (q in e.worker.queries_rows_cache, q in e._rows_cache)
    raw = 'SELECT "title" FROM "todo"'
    builder = p.q.table("todo").select("title")
    obs["raw"] = e.query_once(raw)
    obs["builder"] = e.query_once(builder)
    unsub = e.subscribe_query(raw)
    e.worker.flush()
    obs["same entry"] = e.get_query_rows(raw) == e.get_query_rows(builder.serialize())
    unsub()
    obs["common"] = e.query_once('SELECT "id","title","createdAt","createdBy" FROM "todo"')
    e.update("todo", rid, {"isDeleted": True})
    e.worker.flush()
    obs["deleted"] = e.query_once('SELECT "isDeleted","updatedAt" FROM "todo"')
    e.sync()
    e.sync(refresh_queries=False)
    e.worker.flush()
    return obs


def wl_hooks(p):
    """create_hooks: use_query with a lambda, first-data flag, listener
    unsubscribe, use_owner."""
    hooks = p.create_hooks({"todo": ("title", "isCompleted")})
    obs = {"first before": hooks.use_evolu_first_data_are_loaded()}
    view = hooks.use_query(lambda t: t("todo").select("title").order_by("createdAt"))
    changes = []
    unsub = view.subscribe(lambda: changes.append(list(view.rows)))
    mutate = hooks.use_mutation()
    mutate("todo", {"title": "a"})
    hooks.evolu.worker.flush()
    obs["rows"], obs["first row"] = view.rows, view.first_row
    obs["first after"] = hooks.use_evolu_first_data_are_loaded()
    fired = len(changes)
    unsub()
    mutate("todo", {"title": "b"})
    hooks.evolu.worker.flush()
    obs["changes"], obs["fired"], obs["rows 2"] = changes, fired, view.rows
    obs["owner"] = hooks.use_owner() is hooks.evolu.owner
    view.dispose()
    view.dispose()
    return obs


def wl_joined_view(p):
    """A join and a group-by-having as live views, re-run when either
    side of the join changes."""
    hooks = p.create_hooks(JOINED)
    mutate = hooks.use_mutation()
    home = mutate("todoCategory", {"name": "home"})
    work = mutate("todoCategory", {"name": "work"})
    for title, cat in (("dishes", home), ("report", work), ("email", work)):
        mutate("todo", {"title": title, "categoryId": cat})
    view = hooks.use_query(lambda t: t("todo").select(("todo.title", "title"), ("todoCategory.name", "category"))
                           .inner_join("todoCategory", "todoCategory.id", "todo.categoryId").order_by("todo.title"))
    fn = p.q.fn
    counts = hooks.use_query(lambda t: t("todo").select("categoryId", fn.count("id").as_("n"))
                             .group_by("categoryId").having(fn.count("id"), ">", 1))
    changes = []
    view.subscribe(lambda: changes.append(True))
    hooks.evolu.worker.flush()
    obs = {"view": view.rows, "counts": counts.rows}
    mutate("todoCategory", {"id": home, "name": "chores"})
    hooks.evolu.worker.flush()
    obs["changed"], obs["view after"] = bool(changes), view.rows
    view.dispose(), counts.dispose()
    return obs


def wl_predicate_view(p):
    """An OR-of-ANDs and a correlated exists as live views."""
    hooks = p.create_hooks(JOINED)
    q = p.q
    mutate = hooks.use_mutation()
    work = mutate("todoCategory", {"name": "work"})
    mutate("todo", {"title": "urgent: ship", "categoryId": None})
    done = mutate("todo", {"title": "rest", "isCompleted": True})
    mutate("todo", {"title": "idle"})
    flagged = hooks.use_query(lambda t: t("todo").select("title").where(q.or_(
        q.and_(q.c("isCompleted", "=", 1), q.c("isDeleted", "is not", 1)),
        q.c("title", "like", "urgent%"))).order_by("title"))
    categorized = hooks.use_query(lambda t: t("todo").select("title").where(q.exists(
        q.table("todoCategory").select("id").where(q.c("todoCategory.id", "=", q.ref("todo.categoryId")))))
        .order_by("title"))
    hooks.evolu.worker.flush()
    obs = {"flagged": flagged.rows, "categorized": categorized.rows}
    mutate("todo", {"id": done, "isCompleted": False})
    mutate("todo", {"id": done, "categoryId": work})
    hooks.evolu.worker.flush()
    obs["flagged after"], obs["categorized after"] = flagged.rows, categorized.rows
    flagged.dispose(), categorized.dispose()
    return obs


def _remote(p, n, table="todo", extra=()):
    return [p.types.CrdtMessage(p.ts.timestamp_to_string(p.types.Timestamp(NOW - 100_000 + i, 0, "b" * 16)),
                                table, f"r{i % 50}", "title", f"v{i}") for i in range(n)] + list(extra)


def wl_chunked_receive(p):
    """A receive above receive_chunk_size applies chunk by chunk with
    the same end state as the whole batch."""
    small = p.make(TODO, config=p.Config(receive_chunk_size=64))
    whole = p.make(TODO, config=p.Config(receive_chunk_size=None), mnemonic=MNEMONIC2)
    messages = tuple(_remote(p, 500))
    for c in (small, whole):
        c.receive(messages, "{}", None)
        c.worker.flush()
    return {"trees": (_tree(p, small), _tree(p, whole)),
            "same messages": small.db.exec('SELECT * FROM "__message" ORDER BY "timestamp"')
            == whole.db.exec('SELECT * FROM "__message" ORDER BY "timestamp"')}


def wl_poisoned_receive(p):
    """A poisoned last chunk rolls back alone; committed chunks render."""
    e = p.make(TODO, config=p.Config(receive_chunk_size=40))
    q = p.q.table("todo").select("title").order_by("title").serialize()
    e.subscribe_query(q)
    e.worker.flush()
    errors = []
    e.subscribe_error(errors.append)
    bad = p.types.CrdtMessage(p.ts.timestamp_to_string(p.types.Timestamp(NOW + 200, 0, "b" * 16)),
                              "no_such_table", "rx", "title", "x")
    e.receive(tuple(_remote(p, 100, extra=[bad])), "{}", None)
    e.worker.flush()
    e.worker.flush()
    return {"errors": [_err(x) for x in errors], "rows": len(e.get_query_rows(q)), "tree": _tree(p, e)}


def wl_typed_board(p):
    """The typed calls on the board schema: counter, AW-set, RGA list
    and the tensor sum, mean and max columns."""
    e = p.make(BOARD)
    q = p.q.table("board").select_all().order_by("id").serialize()
    e.subscribe_query(q)
    rows = [e.create("board", {"title": f"card{i}"}) for i in range(3)]
    e.worker.flush()
    obs = {}
    with e.batching():
        for i, r in enumerate(rows):
            e.increment("board", r, "votes", 3 + i)
            e.increment("board", r, "votes", -1)
            e.set_add("board", r, "tags", "urgent")
            e.set_add("board", r, "tags", i)
    e.set_remove("board", rows[0], "tags", "urgent")
    e.set_remove("board", rows[1], "tags", "missing", observed=())
    e.list_append("board", rows[0], "body", "hello")
    e.list_append("board", rows[0], "body", 12)
    e.list_insert("board", rows[0], "body", "head")
    elems = e.list_elements("board", rows[0], "body")
    e.list_delete("board", rows[0], "body", elems[1][0])
    obs["elements"] = [v for _, v in e.list_elements("board", rows[0], "body")]
    vec = np.arange(8, dtype=np.float32)
    e.tensor_delta("board", rows[0], "w", vec)
    e.tensor_delta("board", rows[0], "w", vec * 2)
    e.tensor_set("board", rows[1], "w", vec + 0.5)
    e.tensor_delta("board", rows[0], "avg", vec, count=3)
    e.tensor_delta("board", rows[0], "avg", -vec, count=1)
    e.tensor_delta("board", rows[2], "peak", vec - 4)
    e.tensor_delta("board", rows[2], "peak", 4 - vec)
    # The port's tensor_value is a CPU torch tensor (numpy has no
    # bfloat16); compare dtype names and values.
    obs["tensors"] = [None if (t := e.tensor_value("board", r, c)) is None
                      else (str(t.dtype).replace("torch.", ""), list(t.shape), t.tolist())
                      for r in rows for c in ("w", "avg", "peak")]
    obs["missing row"] = e.tensor_value("board", "nope", "w")
    obs["bad delta"] = _raises(lambda: e.tensor_delta("board", rows[0], "peak", vec, count=2))
    e.worker.flush()
    obs["rows"] = e.get_query_rows(q)
    return obs


def wl_reload_file(p):
    """The cross-process reload signal on a file database: a watcher sees
    notify_reload; restore_owner on one handle fires on_reload on a
    second handle of the same file (cross_process) and bumps the signal
    for other processes."""
    db_path = str(p.tmp / "shared.db")
    obs = {"memory nonce": p.reload.notify_reload(":memory:")}
    fired = threading.Event()
    w = p.reload.ReloadWatcher(db_path, fired.set, interval=0.05)
    try:
        own = p.reload.notify_reload(db_path)
        obs["signal seen"] = fired.wait(5.0)
        fired.clear()
        w.ignore(p.reload.notify_reload(db_path))
        obs["own nonce ignored"] = not fired.wait(0.3)
        obs["nonce is hex"] = len(own) == 32
    finally:
        w.stop()
    e = p.make(TODO, db_path=db_path)
    local, remote = threading.Event(), threading.Event()
    e.on_reload(local.set)
    other = p.make(TODO, db_path=str(p.tmp / "other.db"))
    other._reload_watcher = p.reload.ReloadWatcher(db_path, other._fire_reload, interval=0.05)
    other.on_reload(remote.set, cross_process=False)
    watcher = p.reload.ReloadWatcher(db_path, fired.set, interval=0.05)
    try:
        e.restore_owner(e.owner.mnemonic)
        e.worker.flush()
        obs["local fired"] = local.wait(5.0)
        obs["other process fired"] = remote.wait(5.0)
        obs["watcher fired"] = fired.wait(5.0)
    finally:
        watcher.stop()
    return obs


WORKLOADS = {f.__name__[3:]: f for f in (
    wl_reactive, wl_errors, wl_owner, wl_converge, wl_subscriptions, wl_hooks, wl_joined_view,
    wl_predicate_view, wl_chunked_receive, wl_poisoned_receive, wl_typed_board, wl_reload_file)}


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_handle_matches_jax(name, monkeypatch, tmp_path):
    jax = Pkg("evolu_tpu", monkeypatch, tmp_path)
    port = Pkg("evolu_tpu_torch", monkeypatch, tmp_path)
    results = []
    for p in (jax, port):
        try:
            obs = within(LIMIT_S, lambda: WORKLOADS[name](p))
        finally:
            dumps = within(LIMIT_S, p.finish)
        # Each client's outputs and pushes in its own order (two
        # clients' worker threads interleave freely).
        by_client = lambda pairs: sorted(pairs, key=lambda x: x[0])  # noqa: E731 - stable
        results.append((obs, [(n, _norm_output(o)) for n, o in by_client(p.outputs)],
                        [(n, _norm_push(r)) for n, r in by_client(p.pushes)], dumps))
    (jo, jout, jpush, jdump), (po, pout, ppush, pdump) = results
    assert po == jo
    assert pout == jout
    assert ppush == jpush
    assert pdump == jdump and pout


def test_unported_routes_raise_before_any_side_effect(tmp_path):
    """A bad backend name is a ValueError, and a native backend that does
    not build raises its log, both before the database file exists. A
    scoped-sync widening, refused until scoped sync was ported, answers as
    on the JAX handle: a narrowing is a ValueError that leaves the scope
    and the log untouched, a full widening drops the scope."""
    from evolu_tpu_torch.runtime import messages
    from evolu_tpu_torch.runtime.client import Evolu
    from evolu_tpu_torch.utils import native_loader

    path = tmp_path / "never.db"
    with pytest.raises(ValueError, match="backend"):
        Evolu(db_path=str(path), backend="sqlite4", device="cpu")
    failed = native_loader.NativeBuildError("evolu_tpu_torch: building libevolu_host.so failed\nlog")
    saved = native_loader._cache.get("libevolu_host.so")
    native_loader._cache["libevolu_host.so"] = failed
    try:
        with pytest.raises(native_loader.NativeBuildError, match="failed"):
            Evolu(db_path=str(path), backend="native", device="cpu")
    finally:
        native_loader._cache.pop("libevolu_host.so")
        if saved is not None:
            native_loader._cache["libevolu_host.so"] = saved
    assert not path.exists()
    from evolu_tpu.runtime import messages as jmessages
    from evolu_tpu.runtime.client import Evolu as JaxEvolu
    from evolu_tpu.sync.scope import SyncScope as JaxScope
    from evolu_tpu.utils.config import Config as JaxConfig
    from evolu_tpu_torch.sync.scope import SyncScope
    from evolu_tpu_torch.utils.config import Config

    seen = []
    for e, msgs in ((JaxEvolu(config=JaxConfig(sync_scope=JaxScope(100, ("todo",))), mnemonic=MNEMONIC), jmessages),
                    (Evolu(config=Config(sync_scope=SyncScope(100, ("todo",))), mnemonic=MNEMONIC, device="cpu",
                           backend="python"), messages)):
        try:
            e.worker.post(msgs.WidenSyncScope(watermark_millis=200))
            e.worker.flush()
            narrowed = (_err(e.get_error()), e.worker.config.sync_scope.watermark_millis)
            e.worker.post(msgs.WidenSyncScope(full=True))
            e.worker.flush()
            seen.append((narrowed, e.worker.config.sync_scope, e.db.exec('SELECT COUNT(*) FROM "__message"')))
        finally:
            e.dispose()
    assert seen[1] == seen[0] == ((("ValueError", "widen() cannot raise the watermark"), 100), None, [(0,)])


def test_entry_points_default_to_the_card():
    """Here there is no card: `device=None` raises rather than fall back."""
    import torch

    from evolu_tpu_torch.runtime.client import Evolu, create_evolu
    from evolu_tpu_torch.utils.config import Config

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default resolves to it")
    for make in (lambda: create_evolu(TODO, config=Config(backend="cuda")),
                 lambda: Evolu(config=Config(backend="auto"))):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
