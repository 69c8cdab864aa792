"""createHooks analog — the binding layer apps consume.

Reference: packages/evolu/src/createHooks.ts (useQuery/useMutation),
useOwner.ts, db.ts:89-94 (useEvoluFirstDataAreLoaded). React hooks
become plain objects: `create_hooks(schema)` boots a client for the
schema and returns a `Hooks` handle whose `use_query` gives a live
`QueryView` (subscribed rows + change listeners — the
useSyncExternalStore analog) and whose `use_mutation` returns the
stable mutate function.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Callable, List, Optional

from evolu_tpu_torch.api.query import QueryBuilder, table

if TYPE_CHECKING:  # runtime imports api.model; keep the cycle lazy
    from evolu_tpu_torch.runtime.client import Evolu


class QueryView:
    """A subscribed query: `.rows` is always current; `subscribe(fn)`
    registers a change listener (createHooks.ts:28-49)."""

    def __init__(self, evolu: "Evolu", query):
        self._evolu = evolu
        self._query = query
        self._unsub = evolu.subscribe_query(query)
        self._listeners: List[Callable[[], None]] = []
        self._unlisten = evolu.listen(self._notify)
        self._disposed = False

    def _notify(self) -> None:
        for fn in list(self._listeners):
            fn()

    @property
    def rows(self) -> List[dict]:
        return self._evolu.get_query_rows(self._query)

    @property
    def first_row(self) -> Optional[dict]:
        rows = self.rows
        return rows[0] if rows else None

    def subscribe(self, listener: Callable[[], None]) -> Callable[[], None]:
        self._listeners.append(listener)

        def unsubscribe() -> None:
            if listener in self._listeners:
                self._listeners.remove(listener)

        return unsubscribe

    def dispose(self) -> None:
        if self._disposed:
            return
        self._disposed = True
        self._unlisten()
        self._unsub()


class Hooks:
    """What `create_hooks(schema)` returns (createHooks.ts:20-60)."""

    def __init__(self, evolu: "Evolu"):
        self.evolu = evolu

    def use_query(self, query) -> QueryView:
        """`query` is a QueryBuilder, raw SQL, a serialized query, or a
        callable receiving the `table` factory (the reference's
        `(db) => db.selectFrom(...)` lambda form)."""
        if callable(query) and not isinstance(query, QueryBuilder):
            query = query(table)
        return QueryView(self.evolu, query)

    def use_mutation(self):
        """The stable mutate function (createHooks.ts:51-54)."""
        return self.evolu.mutate

    def use_owner(self):
        """useOwner.ts:5."""
        return self.evolu.owner

    def use_evolu_first_data_are_loaded(self) -> bool:
        """db.ts:89-94 — True once the first query results arrived."""
        return self.evolu.first_data_loaded.is_set()


def create_hooks(schema, **evolu_kwargs) -> Hooks:
    """createHooks(schema) analog: boot a client, register the schema,
    return the hooks handle. Extra kwargs go to `Evolu(...)`
    (db_path, config, mnemonic, backend, device)."""
    from evolu_tpu_torch.runtime.client import Evolu

    evolu = Evolu(**evolu_kwargs)
    try:
        evolu.update_db_schema(schema)
        return Hooks(evolu)
    except BaseException:
        evolu.dispose()
        raise
