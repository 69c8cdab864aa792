"""Web TodoMVC, the reference's examples/nextjs/pages/index.tsx demo:
todos (add, rename, toggle complete, soft-delete, assign to category),
categories (add, rename, soft-delete), owner (show mnemonic, restore,
reset), reactive updates, optional relay sync.

The client runtime runs in this process and the browser is a view: one
vanilla-JS page long-polling `/api/state` (the useSyncExternalStore
analog: one monotonically increasing version bumped by the query
subscriptions).

Run:  python -m evolu_tpu_torch.examples.web_todo [--port 8321] [--db todo.db]
      [--sync-url http://relay:4000] [--device cuda|cpu]
then open http://127.0.0.1:8321. Two processes with --sync-url against
`python -m evolu_tpu_torch.examples.relay_server` (the second started with
--restore "<mnemonic of the first>") converge live. `--device` is where
the client's device planner runs (default: the CUDA card, which it then
requires).
"""

from __future__ import annotations

import argparse
import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from evolu_tpu_torch import Config, connect, create_hooks, table

SCHEMA = {
    "todo": ("title", "isCompleted", "categoryId"),
    "todoCategory": ("name",),
}

TODOS = (
    table("todo")
    .select("id", "title", "isCompleted", "categoryId")
    .where_is_deleted(False)
    .order_by("createdAt")
)
CATEGORIES = (
    table("todoCategory")
    .select("id", "name")
    .where_is_deleted(False)
    .order_by("createdAt")
)

PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>evolu_tpu_torch TodoMVC</title>
<style>
  :root { color-scheme: light dark; }
  body { font: 15px/1.5 system-ui, sans-serif; max-width: 620px; margin: 2rem auto; padding: 0 1rem; }
  h1 { font-size: 1.3rem; } h2 { font-size: 1.05rem; margin-top: 1.6rem; }
  ul { list-style: none; padding: 0; } li { display: flex; gap: .5rem; align-items: center; padding: .15rem 0; }
  li .t { flex: 1; cursor: pointer; } li.done .t { text-decoration: line-through; opacity: .6; }
  button { font: inherit; } input, select { font: inherit; padding: .15rem .3rem; }
  .muted { opacity: .65; font-size: .85rem; } .row { display: flex; gap: .5rem; margin: .5rem 0; }
  #mnemonic { user-select: all; word-break: break-word; }
</style></head><body>
<h1>evolu_tpu_torch TodoMVC</h1>
<p class="muted" id="status">loading…</p>
<div class="row">
  <input id="newTitle" placeholder="What needs to be done?" style="flex:1">
  <select id="newCat"><option value="">no category</option></select>
  <button id="add">Add</button>
</div>
<ul id="todos"></ul>
<h2>Categories</h2>
<div class="row"><input id="newCatName" placeholder="New category" style="flex:1"><button id="addCat">Add</button></div>
<ul id="cats"></ul>
<h2>Owner</h2>
<p class="muted">Mnemonic (restores this data on any device):</p>
<p id="mnemonic" class="muted"></p>
<div class="row">
  <button id="restore">Restore owner…</button>
  <button id="reset">Reset owner (delete all)</button>
  <button id="sync">Sync now</button>
</div>
<script>
const $ = (id) => document.getElementById(id);
let version = -1, state = {todos: [], categories: [], owner: {}};

async function api(path, body) {
  const r = await fetch(path, body === undefined ? {} :
    {method: "POST", headers: {"content-type": "application/json"}, body: JSON.stringify(body)});
  if (!r.ok) { alert(await r.text()); throw new Error(path); }
  return r.json();
}
const mutate = (tbl, values) => api("/api/mutate", {table: tbl, values});

function render() {
  $("status").textContent = `${state.todos.length} todos · ${state.categories.length} categories` +
    (state.first_data_loaded ? "" : " · loading…");
  $("mnemonic").textContent = state.owner.mnemonic || "";
  const sel = $("newCat"), had = sel.value;
  sel.innerHTML = '<option value="">no category</option>' +
    state.categories.map(c => `<option value="${esc(c.id)}">${esc(c.name)}</option>`).join("");
  sel.value = had;
  $("todos").innerHTML = state.todos.map(t => `
    <li class="${t.isCompleted ? "done" : ""}" data-id="${esc(t.id)}">
      <input type="checkbox" ${t.isCompleted ? "checked" : ""} data-a="toggle">
      <span class="t" data-a="rename" title="click to rename">${esc(t.title)}</span>
      <select data-a="cat"><option value="">—</option>${
        state.categories.map(c => `<option value="${esc(c.id)}" ${c.id === t.categoryId ? "selected" : ""}>${esc(c.name)}</option>`).join("")}
      </select>
      <button data-a="del">×</button>
    </li>`).join("");
  $("cats").innerHTML = state.categories.map(c => `
    <li data-id="${esc(c.id)}"><span class="t" data-a="renameCat" title="click to rename">${esc(c.name)}</span>
    <button data-a="delCat">×</button></li>`).join("");
}
const esc = (s) => String(s ?? "").replace(/[&<>"]/g, ch => ({"&":"&amp;","<":"&lt;",">":"&gt;",'"':"&quot;"}[ch]));

document.body.addEventListener("click", async (e) => {
  const a = e.target.dataset.a, li = e.target.closest("li"), id = li && li.dataset.id;
  if (a === "toggle") {
    const t = state.todos.find(t => t.id === id);
    if (t) await mutate("todo", {id, isCompleted: !t.isCompleted});  // stale row: next poll re-renders
  }
  else if (a === "del") await mutate("todo", {id, isDeleted: true});
  else if (a === "delCat") await mutate("todoCategory", {id, isDeleted: true});
  else if (a === "rename") { const v = prompt("New title?"); if (v) await mutate("todo", {id, title: v}); }
  else if (a === "renameCat") { const v = prompt("New name?"); if (v) await mutate("todoCategory", {id, name: v}); }
});
document.body.addEventListener("change", async (e) => {
  if (e.target.dataset.a === "cat") {
    const id = e.target.closest("li").dataset.id;
    await mutate("todo", {id, categoryId: e.target.value || null});
  }
});
$("add").onclick = async () => {
  const title = $("newTitle").value.trim(); if (!title) return;
  await mutate("todo", {title, isCompleted: false, categoryId: $("newCat").value || null});
  $("newTitle").value = "";
};
$("newTitle").onkeydown = (e) => { if (e.key === "Enter") $("add").click(); };
$("addCat").onclick = async () => {
  const name = $("newCatName").value.trim(); if (!name) return;
  await mutate("todoCategory", {name}); $("newCatName").value = "";
};
$("restore").onclick = async () => {
  const m = prompt("Mnemonic?"); if (m) { await api("/api/restore", {mnemonic: m}); location.reload(); }
};
$("reset").onclick = async () => {
  if (confirm("Delete ALL local data?")) { await api("/api/reset", {}); location.reload(); }
};
$("sync").onclick = () => api("/api/sync", {});

(async function poll() {
  for (;;) {
    try {
      const s = await api(`/api/state?since=${version}`);
      version = s.version; state = s; render();
    } catch (err) { await new Promise(r => setTimeout(r, 1000)); }
  }
})();
</script></body></html>"""


class DemoApp:
    """Owns the framework client and a change-versioned state snapshot."""

    def __init__(self, db_path=":memory:", sync_url=None, mnemonic=None, device=None):
        # With a relay, auto-pull every 2s — the headless analog of the
        # reference's load/online/focus sync triggers (db.ts:390-412);
        # without it an idle instance would never see remote changes.
        config = Config(sync_url=sync_url, sync_interval=2.0) if sync_url else Config()
        self.hooks = create_hooks(
            SCHEMA, db_path=db_path, config=config, mnemonic=mnemonic, device=device
        )
        self.evolu = self.hooks.evolu
        self.synced = False
        if sync_url:
            connect(self.evolu)
            self.synced = True
        self._version = 0
        self._cond = threading.Condition()
        # The useQuery analog: two live subscriptions; any change bumps
        # the version and wakes long-polls.
        self.todos = self.hooks.use_query(TODOS)
        self.cats = self.hooks.use_query(CATEGORIES)
        self.todos.subscribe(self._bump)
        self.cats.subscribe(self._bump)
        self.evolu.worker.flush()

    def _bump(self):
        with self._cond:
            self._version += 1
            self._cond.notify_all()

    def state(self, since: int, timeout: float = 25.0) -> dict:
        with self._cond:
            if since == self._version:
                self._cond.wait(timeout)
            owner = self.evolu.owner
            return {
                "version": self._version,
                "todos": self.todos.rows,
                "categories": self.cats.rows,
                "owner": {"id": owner.id, "mnemonic": owner.mnemonic},
                "first_data_loaded": self.hooks.use_evolu_first_data_are_loaded(),
                "synced": self.synced,
            }

    def mutate(self, tbl: str, values: dict) -> str:
        row_id = self.evolu.mutate(tbl, values)
        self.evolu.worker.flush()
        return row_id

    def restore(self, mnemonic: str) -> None:
        self.evolu.restore_owner(mnemonic)
        self.evolu.worker.flush()
        self.evolu.update_db_schema(SCHEMA)  # the reference re-runs it on reload
        self.evolu.worker.flush()
        if self.synced:
            self.evolu.sync()
        self._bump()

    def reset(self) -> None:
        self.evolu.reset_owner()
        self.evolu.worker.flush()
        self.evolu.update_db_schema(SCHEMA)
        self.evolu.worker.flush()
        self._bump()

    def dispose(self):
        self.todos.dispose()
        self.cats.dispose()
        self.evolu.dispose()


class _Handler(BaseHTTPRequestHandler):
    app: DemoApp

    def log_message(self, *a):
        pass

    def _json(self, obj, code=200):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/" or self.path.startswith("/index"):
            body = PAGE.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path.startswith("/api/state"):
            query = urllib.parse.parse_qs(urllib.parse.urlparse(self.path).query)
            try:
                since = int(query.get("since", ["-1"])[0])
            except ValueError:
                since = -1
            self._json(self.app.state(since))
        else:
            self.send_error(404)

    def do_POST(self):
        length = int(self.headers.get("Content-Length", 0))
        try:
            body = json.loads(self.rfile.read(length) or b"{}")
            if self.path == "/api/mutate":
                self._json({"id": self.app.mutate(body["table"], body["values"])})
            elif self.path == "/api/restore":
                self.app.restore(body["mnemonic"])
                self._json({"ok": True})
            elif self.path == "/api/reset":
                self.app.reset()
                self._json({"ok": True})
            elif self.path == "/api/sync":
                self.app.evolu.sync()
                self._json({"ok": True})
            else:
                self.send_error(404)
        except Exception as e:  # noqa: BLE001 - surface to the page
            self._json({"error": str(e)}, code=400)


class DemoServer:
    def __init__(self, app: DemoApp, host="127.0.0.1", port=0):
        handler = type("BoundHandler", (_Handler,), {"app": app})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self.app = app
        self._thread = None

    @property
    def url(self):
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self):
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="web-todo"
        )
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        if self._thread:
            self._thread.join()
        self._httpd.server_close()
        self.app.dispose()


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--port", type=int, default=8321)
    p.add_argument("--db", default=":memory:")
    p.add_argument("--sync-url", default=None)
    p.add_argument("--restore", default=None, metavar="MNEMONIC")
    p.add_argument("--device", default=None,
                   help="where the device planner runs (default: the CUDA card; 'cpu' runs the plain versions)")
    args = p.parse_args()
    app = DemoApp(db_path=args.db, sync_url=args.sync_url, mnemonic=args.restore, device=args.device)
    server = DemoServer(app, port=args.port).start()
    print(f"TodoMVC at {server.url}  (owner {app.evolu.owner.id})")
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
