"""The Evolu client handle — main-thread runtime analog.

The port's copy of `evolu_tpu.runtime.client`. Reference:
packages/evolu/src/db.ts. Owns the DbWorker, the reactive
query-rows store (patch application keeps unchanged row identity,
db.ts:96-115), the mutation batch queue (db.ts:302-361), subscription
ref-counting (db.ts:236-266), the error store (error.ts), and owner
lifecycle (db.ts:367-388).

Differences from the browser, by design:
- No microtasks: mutations made inside `with evolu.batching():` flush
  as one `Send` (the reference batches per microtask); a bare
  `mutate()` flushes immediately.
- Sync triggers (`load`/`online`/`focus`, db.ts:390-412) become the
  explicit `sync()` method plus the transport's periodic pull.

Departures from `evolu_tpu.runtime.client`: `device` (None = the CUDA
card, which raises without one) is where the worker's device planner
and typed folds run. The database is `storage.native.open_database`'s:
the C++ backend for "native" (raising the build's log when it does not
build) and for "auto" when it builds, else `PySqliteDatabase`.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence

from evolu_tpu_torch.api.model import COMMON_COLUMNS, sqlite_value
from evolu_tpu_torch.core.ids import create_id
from evolu_tpu_torch.core.packed import PackedReceive
from evolu_tpu_torch.core.types import NewCrdtMessage, Owner, TableDefinition
from evolu_tpu_torch.runtime import messages as msg
from evolu_tpu_torch.runtime.jsonpatch import apply_patch
from evolu_tpu_torch.runtime.worker import DbWorker
from evolu_tpu_torch.storage.native import open_database
from evolu_tpu_torch.utils.config import Config


def _now_iso() -> str:
    from evolu_tpu_torch.core.timestamp import millis_to_iso
    import time

    return millis_to_iso(int(time.time() * 1000))


class Evolu:
    """One local replica: reactive queries + LWW mutations + sync."""

    def __init__(
        self,
        db_path: str = ":memory:",
        config: Optional[Config] = None,
        mnemonic: Optional[str] = None,
        now_iso: Callable[[], str] = _now_iso,
        backend: str = "auto",
        device=None,
    ):
        self.config = config or Config()
        self.db = open_database(db_path, backend)
        self._now_iso = now_iso
        self._lock = threading.RLock()
        self._rows_cache: Dict[str, List[dict]] = {}  # queriesRowsCacheRef (db.ts:55)
        self._subscribed: Dict[str, int] = {}  # ref-counted (db.ts:236)
        self._listeners: List[Callable[[], None]] = []
        self._error: Optional[Exception] = None
        self._error_listeners: List[Callable[[Exception], None]] = []
        self._reconnect_listeners: List[Callable[[], None]] = []
        self._disposed = False
        self._on_completes: Dict[str, Callable[[], None]] = {}  # by id (db.ts:70-82)
        # Batching state is thread-local: a batch open on one thread must
        # not capture (or, if aborted, discard) another thread's mutations.
        self._batch = threading.local()
        self._on_reload: Optional[Callable[[], None]] = None
        self._reload_watcher = None  # started by on_reload(cross_process=True)
        self._auto_syncer = None  # started by sync.client.connect
        self._transport = None  # set by attach_transport
        self.worker = DbWorker(
            self.db,
            config=self.config,
            on_output=self._dispatch_output,
            post_sync=self._post_sync,
            device=device,
        )
        self.owner: Owner = self.worker.start(mnemonic)
        self.first_data_loaded = threading.Event()

    # -- schema --

    def update_db_schema(self, schema: Dict[str, Sequence[str]]) -> None:
        """createHooks.ts:26 → updateDbSchema command. `schema` maps table
        name → app columns; `id` and the common columns (createdAt,
        createdBy, updatedAt, isDeleted) are appended here, mirroring
        dbSchemaToTableDefinitions (db.ts:210-221)."""
        tds = tuple(
            TableDefinition.of(
                name,
                tuple(c for c in cols if c != "id")
                + tuple(c for c in COMMON_COLUMNS if c not in cols),
            )
            for name, cols in schema.items()
        )
        self.worker.post(msg.UpdateDbSchema(tds))

    # -- reactive queries --

    @staticmethod
    def _normalize_query(query) -> str:
        """Accept a QueryBuilder, raw SQL, or an already-serialized
        SqlQueryString; always key caches/subscriptions by the
        serialized form (types.ts:115-124)."""
        serialize = getattr(query, "serialize", None)
        if callable(serialize):
            return serialize()
        s = str(query)
        if s.lstrip().startswith("{"):
            return s
        return msg.serialize_query(s)

    def subscribe_query(self, query, listener: Optional[Callable[[], None]] = None):
        """Subscribe a query; returns unsubscribe (db.ts:241-266)."""
        query = self._normalize_query(query)
        with self._lock:
            fresh = query not in self._subscribed
            self._subscribed[query] = self._subscribed.get(query, 0) + 1
            if listener is not None:
                self._listeners.append(listener)
        if fresh:
            self.worker.post(msg.Query((query,)))

        def unsubscribe() -> None:
            with self._lock:
                n = self._subscribed.get(query, 0) - 1
                evict = n <= 0
                if evict:
                    self._subscribed.pop(query, None)
                    self._rows_cache.pop(query, None)
                else:
                    self._subscribed[query] = n
                if listener is not None and listener in self._listeners:
                    self._listeners.remove(listener)
                if evict:
                    # Posted under the lock: a concurrent re-subscribe
                    # cannot enqueue its initial Query ahead of this
                    # eviction (which would then wipe a live cache entry).
                    self.worker.post(msg.EvictQueries((query,)))

        return unsubscribe

    def listen(self, listener: Callable[[], None]):
        """Row-store change notification (db.ts:57-68)."""
        with self._lock:
            self._listeners.append(listener)

        def unlisten() -> None:
            with self._lock:
                if listener in self._listeners:
                    self._listeners.remove(listener)

        return unlisten

    def get_query_rows(self, query) -> List[dict]:
        """Current rows for a subscribed query (db.ts:231-234). Row objects
        are identity-stable across unrelated updates."""
        query = self._normalize_query(query)
        with self._lock:
            return self._rows_cache.get(query, [])

    def query_once(self, query) -> List[dict]:
        """One-shot read-through (no subscription): runs on the worker
        thread to respect the single-writer discipline."""
        unsubscribe = self.subscribe_query(query)
        self.worker.flush()
        try:
            return self.get_query_rows(query)
        finally:
            unsubscribe()

    # -- mutations --

    def _batch_state(self):
        b = self._batch
        if not hasattr(b, "depth"):
            b.depth, b.pending, b.complete_ids = 0, [], []
        return b

    def batching(self):
        """Group several mutate() calls into one Send (db.ts:337-361)."""
        client = self

        class _Batch:
            def __enter__(self):
                client._batch_state().depth += 1
                return client

            def __exit__(self, exc_type, exc, tb):
                b = client._batch_state()
                b.depth -= 1
                if b.depth == 0:
                    if exc_type is None:
                        client._flush_mutations()
                    else:
                        # Aborted batch: drop its mutations outright —
                        # leaving them pending would splice them into the
                        # next unrelated Send.
                        b.pending.clear()
                        with client._lock:
                            for i in b.complete_ids:
                                client._on_completes.pop(i, None)
                        b.complete_ids.clear()
                return False

        return _Batch()

    def mutate(
        self,
        table: str,
        values: Dict[str, object],
        on_complete: Optional[Callable[[], None]] = None,
    ) -> str:
        """Insert or update one row (db.ts:309-365).

        No "id" in `values` ⇒ insert with a fresh nanoid id plus
        createdAt/createdBy; with an id ⇒ update plus updatedAt
        (db.ts:286-290). Values expand to one CrdtMessage per column;
        bools/datetimes cast to their SQLite encodings (db.ts:281-283).
        Returns the row id.
        """
        values = dict(values)
        row_id = values.pop("id", None)
        is_insert = row_id is None
        if is_insert:
            row_id = create_id()
        now = self._now_iso()
        if is_insert:
            values.setdefault("createdAt", now)
            values.setdefault("createdBy", self.owner.id)
        else:
            values.setdefault("updatedAt", now)
        new_messages = [
            NewCrdtMessage(table, row_id, column, sqlite_value(v))
            for column, v in values.items()
        ]
        b = self._batch_state()
        b.pending.extend(new_messages)
        if on_complete is not None:
            complete_id = create_id()
            with self._lock:
                self._on_completes[complete_id] = on_complete
            b.complete_ids.append(complete_id)
        if b.depth == 0:
            self._flush_mutations()
        return row_id

    # -- typed-column mutations (CRDT types beyond LWW) --

    def _mutate_raw(self, messages: List[NewCrdtMessage]) -> None:
        """Queue raw op messages through the same batch machinery as
        `mutate` (no common-column side writes — a typed op is ONE
        message on ONE cell)."""
        b = self._batch_state()
        b.pending.extend(messages)
        if b.depth == 0:
            self._flush_mutations()

    def increment(self, table: str, row_id: str, column: str, delta: int) -> None:
        """PN-counter op: add `delta` (may be negative) to a
        `"<column>:counter"` cell. The materialized cell value is the
        sum over all distinct ops across every replica."""
        from evolu_tpu_torch.core.crdt_types import counter_delta

        self._mutate_raw([NewCrdtMessage(table, row_id, column, counter_delta(delta))])

    def set_add(self, table: str, row_id: str, column: str, elem) -> None:
        """AW-set add op for a `"<column>:awset"` cell. The op's own
        timestamp becomes its unique add tag."""
        from evolu_tpu_torch.core.crdt_types import set_add_value

        self._mutate_raw([NewCrdtMessage(table, row_id, column, set_add_value(elem))])

    def set_remove(self, table: str, row_id: str, column: str, elem,
                   observed: Optional[Sequence[str]] = None) -> None:
        """AW-set observed-remove op: kills exactly the add tags this
        replica has APPLIED for (cell, elem). The worker queue is
        drained first so a just-queued same-replica `set_add` is
        covered — without the drain, add-then-remove on one replica
        would read an empty observation and silently remove nothing
        (the add's tag, unobserved, survives by add-wins). A concurrent
        add from ANOTHER replica this one has not synced still survives
        (add wins). Adds queued in a still-open `batching()` block are
        not yet stamped (no tag exists to observe) — close the batch
        first. Pass `observed` explicitly to skip the read."""
        from evolu_tpu_torch.core.crdt_types import observed_tags, set_remove_value

        if observed is None:
            self.worker.flush()
            observed = observed_tags(self.db, table, row_id, column, elem)
        self._mutate_raw([
            NewCrdtMessage(table, row_id, column, set_remove_value(elem, observed))
        ])

    # -- list (RGA sequence) mutations --

    def list_insert(self, table: str, row_id: str, column: str, value,
                    after: Optional[str] = None) -> None:
        """RGA insert op for a `"<column>:list"` cell: place `value`
        AFTER the element tagged `after` (None = head). The op's own
        timestamp becomes the new element's tag — read it back via
        `list_elements` after a flush. A concurrent insert at the same
        anchor orders deterministically on every replica (later
        timestamp lands closer to the anchor)."""
        from evolu_tpu_torch.core.crdt_list import list_insert_value

        self._mutate_raw([
            NewCrdtMessage(table, row_id, column, list_insert_value(value, after))
        ])

    def list_append(self, table: str, row_id: str, column: str, value) -> None:
        """Insert `value` after the cell's LAST alive element. The
        worker queue is drained first so a just-queued same-replica
        insert is observed (the `set_remove` drain lesson — without it,
        two unflushed appends would both anchor on the old tail and
        end up reversed). Appends queued in a still-open `batching()`
        block are not yet stamped — close the batch first."""
        from evolu_tpu_torch.core.crdt_list import list_state

        self.worker.flush()
        elems = list_state(self.db, table, row_id, column)
        self.list_insert(table, row_id, column, value,
                         after=elems[-1][0] if elems else None)

    def list_delete(self, table: str, row_id: str, column: str, tag: str) -> None:
        """Tombstone the element tagged `tag` (from `list_elements`).
        The element keeps its position as an anchor for concurrent
        inserts; a delete racing an unseen insert at the same tag still
        wins on every replica (kill tombstones, like `set_remove`)."""
        from evolu_tpu_torch.core.crdt_list import list_delete_value

        self._mutate_raw([NewCrdtMessage(table, row_id, column,
                                         list_delete_value(tag))])

    def list_elements(self, table: str, row_id: str, column: str):
        """Alive (tag, value) pairs in document order, after draining
        the worker (drain-before-observe) — the read that anchors
        `after=` inserts and tag-addressed deletes."""
        import json as _json

        from evolu_tpu_torch.core.crdt_list import list_state

        self.worker.flush()
        return [(tag, _json.loads(v))
                for tag, v in list_state(self.db, table, row_id, column)]

    # -- tensor (declared-monoid numeric) mutations --

    def tensor_delta(self, table: str, row_id: str, column: str, array,
                     count: int = 1) -> None:
        """Tensor delta op for a `"<column>:tensor:<monoid>:…"` cell:
        contributes `array` (validated against the DECLARED shape and
        dtype) under the column's merge monoid — element-wise sum,
        count-weighted mean (`count` is the mean monoid's weight; other
        monoids reject it), or element-wise max. Commutative: no
        observation needed, so no drain. The worker is flushed only to
        read the declared config (schema reads ride the same
        connection discipline as mutations)."""
        from evolu_tpu_torch.core.crdt_tensor import tensor_config, tensor_delta_value

        self.worker.flush()
        cfg = tensor_config(self.db, table, column)
        self._mutate_raw([
            NewCrdtMessage(table, row_id, column,
                           tensor_delta_value(cfg, array, count))
        ])

    def tensor_set(self, table: str, row_id: str, column: str, array,
                   count: int = 1) -> None:
        """Tensor overwrite (the semidirect LWW fallback): the
        latest-timestamped set resets the fold base; deltas timestamped
        after it reapply on top. Unlike `set_remove`, an overwrite is
        UNCONDITIONAL — it observes nothing, so there is no
        drain-before-observe hazard to manage (the set_remove lesson
        applies to reads, which `tensor_value` performs)."""
        from evolu_tpu_torch.core.crdt_tensor import tensor_config, tensor_set_value

        self.worker.flush()
        cfg = tensor_config(self.db, table, column)
        self._mutate_raw([
            NewCrdtMessage(table, row_id, column,
                           tensor_set_value(cfg, array, count))
        ])

    def tensor_value(self, table: str, row_id: str, column: str):
        """The materialized cell as a shaped numpy array (declared
        dtype), or None if the app row does not exist — after draining
        the worker (drain-before-observe), so a just-queued delta or
        set from this replica is reflected."""
        from evolu_tpu_torch.core.crdt_tensor import tensor_state

        self.worker.flush()
        return tensor_state(self.db, table, row_id, column)

    def create(self, table: str, values: Dict[str, object], on_complete=None) -> str:
        values = dict(values)
        values.pop("id", None)
        return self.mutate(table, values, on_complete)

    def update(self, table: str, row_id: str, values: Dict[str, object], on_complete=None) -> str:
        values = dict(values)
        values["id"] = row_id
        return self.mutate(table, values, on_complete)

    def _flush_mutations(self) -> None:
        b = self._batch_state()
        if not b.pending:
            return
        batch = tuple(b.pending)
        ids = tuple(b.complete_ids)
        b.pending.clear()
        b.complete_ids.clear()
        with self._lock:
            queries = tuple(self._subscribed)
        self.worker.post(msg.Send(batch, ids, queries))

    # -- sync --

    def attach_transport(self, transport) -> None:
        """Wire a sync transport (the SyncWorker analog). The transport
        must expose `request_sync(SyncRequestInput)` and feed responses
        back via `receive()`."""
        self._transport = transport

    def sync(self, refresh_queries: bool = True) -> None:
        """Trigger a pull round (the load/online/focus trigger analog,
        db.ts:390-412)."""
        queries = tuple(self._subscribed) if refresh_queries else ()
        self.worker.post(msg.Sync(queries))

    def receive(
        self, messages: tuple, merkle_tree: str, previous_diff: Optional[int] = None
    ) -> None:
        """Feed a sync response into the engine (db.worker.ts:129-135).
        `messages` is either a CrdtMessage sequence or a PackedReceive
        columnar batch (the fused receive leg); the worker handles both
        with the same end state."""
        if not isinstance(messages, PackedReceive):
            messages = tuple(messages)
        self.worker.post(msg.Receive(messages, merkle_tree, previous_diff))

    def _post_sync(self, request: msg.SyncRequestInput) -> None:
        if self._transport is not None:
            self._transport.request_sync(request)

    # -- owner lifecycle (db.ts:367-388) --

    def get_owner(self) -> Owner:
        return self.owner

    def reset_owner(self) -> None:
        self.worker.post(msg.ResetOwner())

    def restore_owner(self, mnemonic: str) -> None:
        from evolu_tpu_torch.core.mnemonic import validate_mnemonic
        from evolu_tpu_torch.core.types import UnknownError

        if not validate_mnemonic(mnemonic):
            raise UnknownError(f"invalid mnemonic")
        self.worker.post(msg.RestoreOwner(mnemonic))

    def on_reload(self, callback: Callable[[], None], cross_process: bool = True) -> None:
        """reloadAllTabs analog (reloadAllTabs.ts:6-14): fires after this
        replica's resetOwner/restoreOwner, and — when `cross_process` and
        the DB is file-backed — when another process sharing the same DB
        file signals one (the localStorage storage-event analog)."""
        self._on_reload = callback
        if cross_process and self._reload_watcher is None and self.db.path != ":memory:":
            from evolu_tpu_torch.utils.reload import ReloadWatcher

            self._reload_watcher = ReloadWatcher(self.db.path, lambda: self._fire_reload())

    def _fire_reload(self) -> None:
        """Another process reset/restored the shared DB file: re-run
        every subscribed query (the worker recomputes against the new
        file state and posts patches, which notify listeners — same
        flow as OnReceive), then the embedder callback. full=True: the
        foreign write never entered this worker's change log, so the
        r9 invalidation gate must not be consulted."""
        with self._lock:
            queries = tuple(self._subscribed)
        if queries:
            self.worker.post(msg.Query(queries, full=True))
        if self._on_reload is not None:
            self._on_reload()

    # -- reconnect (the `online` event analog, db.ts:390-412) --

    def subscribe_reconnect(self, listener: Callable[[], None]):
        """Fires when the sync transport transitions offline → online
        (first successful probe or round after swallowed fetch errors).
        The transport has already scheduled the immediate pull round;
        this is the app-facing hook."""
        with self._lock:
            self._reconnect_listeners.append(listener)

        def unsubscribe() -> None:
            with self._lock:
                if listener in self._reconnect_listeners:
                    self._reconnect_listeners.remove(listener)

        return unsubscribe

    def _fire_reconnect(self) -> None:
        with self._lock:
            listeners = list(self._reconnect_listeners)
        for fn in listeners:
            try:
                fn()
            except Exception:  # noqa: BLE001,S110 - a raising listener
                # must not block the reconnect sync
                pass

    # -- errors (error.ts:8-22) --

    def subscribe_error(self, listener: Callable[[Exception], None]):
        with self._lock:
            self._error_listeners.append(listener)

        def unsubscribe() -> None:
            with self._lock:
                if listener in self._error_listeners:
                    self._error_listeners.remove(listener)

        return unsubscribe

    def get_error(self) -> Optional[Exception]:
        return self._error

    # -- worker output dispatch (db.ts:158-186) --

    def _dispatch_output(self, output: object) -> None:
        if isinstance(output, msg.OnError):
            with self._lock:
                self._error = output.error
                listeners = list(self._error_listeners)
            for fn in listeners:
                fn(output.error)
        elif isinstance(output, msg.OnQuery):
            self._on_query(output)
        elif isinstance(output, msg.OnReceive):
            # Re-run every subscribed query (db.ts:174-176).
            with self._lock:
                queries = tuple(self._subscribed)
            if queries:
                self.worker.post(msg.Query(queries))
        elif isinstance(output, msg.ReloadAllTabs):
            with self._lock:
                self._rows_cache.clear()
                self.owner = self.worker.owner
            # Signal other processes sharing this DB file, then fire the
            # local callback (reloadAllTabs.ts does both: localStorage
            # ping + own location.assign). Our own watcher must skip the
            # nonce — the callback already fires here.
            from evolu_tpu_torch.utils.reload import notify_reload

            nonce = notify_reload(self.db.path)
            if self._reload_watcher is not None:
                self._reload_watcher.ignore(nonce)
            if self._on_reload is not None:
                self._on_reload()
        elif isinstance(output, msg.OnInit):
            self.owner = output.owner

    def _on_query(self, output: msg.OnQuery) -> None:
        with self._lock:
            for query, ops in output.queries_patches:
                self._rows_cache[query] = apply_patch(self._rows_cache.get(query, []), ops)
            listeners = list(self._listeners)
            completes = [
                self._on_completes.pop(i)
                for i in output.on_complete_ids
                if i in self._on_completes
            ]
        self.first_data_loaded.set()
        for fn in listeners:
            fn()
        for fn in completes:
            fn()

    def dispose(self) -> None:
        # Transport stop() bounds its prober join, so a straggler probe
        # can fire on_reconnect after dispose; the connect() wrapper
        # gates on this flag, and clearing the listeners makes the
        # residual instruction-level window benign (a post to the
        # stopped worker's dead queue is a no-op).
        self._disposed = True
        with self._lock:
            self._reconnect_listeners.clear()
        if self._auto_syncer is not None:
            self._auto_syncer.stop()
        self.worker.stop()
        if self._reload_watcher is not None:
            self._reload_watcher.stop()
        if self._transport is not None and hasattr(self._transport, "stop"):
            self._transport.stop()
        self.db.close()


def create_evolu(
    schema: Dict[str, Sequence[str]],
    config: Optional[Config] = None,
    db_path: str = ":memory:",
    mnemonic: Optional[str] = None,
    device=None,
) -> Evolu:
    """The `createHooks` analog (createHooks.ts:20-26): build a client
    and register the app schema. `device` (None = the CUDA card) is
    where the worker's device planner runs."""
    evolu = Evolu(db_path=db_path, config=config, mnemonic=mnemonic, device=device)
    evolu.update_db_schema(schema)
    return evolu
