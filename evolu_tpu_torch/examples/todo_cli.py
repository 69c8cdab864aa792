"""TodoMVC client (the reference's examples/nextjs/pages/index.tsx
demo): the `todo` + `todoCategory` tables, create / toggle / rename /
categorize / soft-delete, owner mnemonic restore, driven from a command
line. The row list re-renders from a query subscription, not from the
command handlers.

Run a relay first (`python -m evolu_tpu_torch.examples.relay_server`),
then:

    python -m evolu_tpu_torch.examples.todo_cli --db /tmp/a.db \
        --sync-url http://127.0.0.1:4000/ [--device cuda|cpu]

`--device` is where the client's device planner runs (default: the CUDA
card, which it then requires).

Commands:
    add <title>            create a todo
    cat <name>             create a category
    assign <n> <category>  set todo #n's category
    toggle <n>             flip isCompleted
    rename <n> <title>     change title
    rm <n>                 soft-delete (isDeleted=1, like the reference)
    ls                     list (excluding soft-deleted)
    sync                   explicit sync round (also runs on start)
    owner                  print the mnemonic (restore with --mnemonic)
    quit
"""

from __future__ import annotations

import argparse
import sys

from evolu_tpu_torch import Config, Evolu, connect, model, table

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


class TodoApp:
    def __init__(self, db_path: str, sync_url: str, mnemonic: str | None = None, device=None):
        self.evolu = Evolu(
            db_path=db_path,
            config=Config(sync_url=sync_url),
            mnemonic=mnemonic,
            device=device,
        )
        self.evolu.update_db_schema(SCHEMA)
        self.evolu.subscribe_error(lambda e: print(f"! error: {e}", file=sys.stderr))
        self.transport = connect(self.evolu)
        # Reactive rendering: the subscription drives the list, like
        # useQuery → useSyncExternalStore in the reference demo.
        self._unsub = self.evolu.subscribe_query(TODOS, listener=self.render)
        self.evolu.subscribe_query(CATEGORIES)
        self.sync()

    # -- reactive view --

    def rows(self):
        return self.evolu.get_query_rows(TODOS)

    def categories(self):
        return self.evolu.get_query_rows(CATEGORIES)

    def render(self) -> None:
        cats = {c["id"]: c["name"] for c in self.categories()}
        print("-- todos --")
        for i, r in enumerate(self.rows(), 1):
            mark = "x" if r["isCompleted"] else " "
            cat = f"  [{cats.get(r['categoryId'], '?')}]" if r["categoryId"] else ""
            print(f" {i:2d}. [{mark}] {r['title']}{cat}")

    # -- commands --

    def _nth(self, n: str):
        rows = self.rows()
        i = int(n) - 1
        if not 0 <= i < len(rows):
            raise IndexError(f"no todo #{n}")
        return rows[i]

    def add(self, title: str) -> None:
        self.evolu.create("todo", {"title": model.validate_non_empty_string_1000(title),
                                   "isCompleted": False})

    def cat(self, name: str) -> None:
        self.evolu.create("todoCategory", {"name": model.validate_non_empty_string_1000(name)})

    def assign(self, n: str, category: str) -> None:
        match = [c for c in self.categories() if c["name"] == category]
        if not match:
            raise ValueError(f"no category {category!r}")
        self.evolu.update("todo", self._nth(n)["id"], {"categoryId": match[0]["id"]})

    def toggle(self, n: str) -> None:
        row = self._nth(n)
        self.evolu.update("todo", row["id"], {"isCompleted": not row["isCompleted"]})

    def rename(self, n: str, title: str) -> None:
        self.evolu.update("todo", self._nth(n)["id"],
                          {"title": model.validate_non_empty_string_1000(title)})

    def rm(self, n: str) -> None:
        # Soft delete (CommonColumns.isDeleted, types.ts:194-201).
        self.evolu.update("todo", self._nth(n)["id"], {"isDeleted": True})

    def sync(self) -> None:
        self.evolu.sync()
        self.evolu.worker.flush()
        self.transport.flush()
        self.evolu.worker.flush()

    def owner(self) -> str:
        return self.evolu.owner.mnemonic

    def close(self) -> None:
        self._unsub()
        self.transport.stop()
        self.evolu.dispose()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--db", default=":memory:")
    ap.add_argument("--sync-url", default="http://127.0.0.1:4000/")
    ap.add_argument("--mnemonic", default=None, help="restore an existing owner")
    ap.add_argument("--device", default=None,
                    help="where the device planner runs (default: the CUDA card; 'cpu' runs the plain versions)")
    args = ap.parse_args()

    app = TodoApp(args.db, args.sync_url, args.mnemonic, device=args.device)
    print(f"owner: {app.evolu.owner.id}  (type 'owner' for the mnemonic)")
    app.render()
    try:
        for line in sys.stdin:
            parts = line.strip().split(None, 1)
            if not parts:
                continue
            cmd, rest = parts[0], parts[1] if len(parts) > 1 else ""
            try:
                if cmd == "add":
                    app.add(rest)
                elif cmd == "cat":
                    app.cat(rest)
                elif cmd == "assign":
                    n, category = rest.split(None, 1)
                    app.assign(n, category)
                elif cmd == "toggle":
                    app.toggle(rest)
                elif cmd == "rename":
                    n, title = rest.split(None, 1)
                    app.rename(n, title)
                elif cmd == "rm":
                    app.rm(rest)
                elif cmd == "ls":
                    app.render()
                elif cmd == "sync":
                    app.sync()
                    app.render()
                elif cmd == "owner":
                    print(app.owner())
                elif cmd in ("quit", "exit"):
                    break
                else:
                    print(f"? unknown command {cmd!r}")
            except (ValueError, IndexError) as e:
                print(f"! {e}")
    finally:
        app.sync()
        app.close()


if __name__ == "__main__":
    main()
