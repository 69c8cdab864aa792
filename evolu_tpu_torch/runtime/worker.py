"""DbWorker — the single-writer command engine of a client.

Reference: packages/evolu/src/db.worker.ts, by way of
`evolu_tpu.runtime.worker`. All state-changing work funnels through one
ordered queue processed by one thread; every command runs inside one
SQLite transaction and reports failures as an `OnError` output instead
of raising. Command semantics live in methods named after the
reference's command modules (send.ts, receive.ts, query.ts, sync.ts,
updateDbSchema.ts, resetOwner.ts, restoreOwner.ts).

`Send`/`Receive` batches apply through the merge planner that
`select_planner` picks from `Config.backend`: the host oracle, or the
device planner with each cell's stored winner kept in device memory
across batches (`ops.winner_cache.DeviceWinnerCache`). End state is
identical either way. `device` (None = CUDA) is where the device planner
and the typed-CRDT folds run.

A Receive may carry a `PackedReceive` (the fused native decode of a
sync response): its timestamps parse in one native call, the HLC fold
runs on the columns, and the planner's `plan_packed` with the C++
backend's `apply_planned_cells` apply it without per-row objects.
Batches the packed route cannot take bounce to the object path exactly
where the reference's do. On the C++ backend the query sweep reads each
result as packed bytes and skips unchanged ones without a parse.

Not ported yet, and refused rather than routed elsewhere: partial
replication (`Config.sync_scope`, `WidenSyncScope`), the multi-device
hot-owner route, and the metrics, flight recorder and tracing seams.
"""

from __future__ import annotations

import queue
import threading
import time
from contextlib import nullcontext
from typing import Callable, Dict, List, Optional, Sequence

from evolu_tpu_torch.core.merkle import diff_merkle_trees, merkle_tree_from_string, merkle_tree_to_string
from evolu_tpu_torch.core.packed import PackedReceive
from evolu_tpu_torch.core.timestamp import (
    create_sync_timestamp,
    receive_timestamp,
    receive_timestamps_batch,
    receive_timestamps_batch_packed,
    send_timestamp,
    timestamp_from_string,
    timestamp_to_string,
)
from evolu_tpu_torch.core.types import CrdtClock, CrdtMessage, Owner, SyncError, TimestampParseError
from evolu_tpu_torch.ops import resolve_device
from evolu_tpu_torch.ops.host_parse import parse_timestamp_strings
from evolu_tpu_torch.runtime import messages as msg
from evolu_tpu_torch.runtime.jsonpatch import create_patch
from evolu_tpu_torch.runtime.synclock import SyncLock, get_sync_lock
from evolu_tpu_torch.storage.apply import (
    _notify_plan_failure,
    apply_messages,
    apply_messages_chunked,
    fetch_existing_winners,
    plan_batch,
)
from evolu_tpu_torch.storage.changes import ChangedSet
from evolu_tpu_torch.storage.clock import read_clock, update_clock
from evolu_tpu_torch.storage.deps import query_dependencies
from evolu_tpu_torch.storage.schema import delete_all_tables, init_db_model, update_db_schema
from evolu_tpu_torch.storage.sqlite import PySqliteDatabase
from evolu_tpu_torch.sync.protocol import assert_wire_encodable
from evolu_tpu_torch.utils.config import Config


def _now_millis() -> int:
    return int(time.time() * 1000)


_MISSING = object()  # pop sentinel: a cached [] must still count
_BACKENDS = ("cpu", "auto", "cuda")


def select_planner(config: Config, db: Optional[PySqliteDatabase] = None, device=None) -> Callable:
    """The merge planner for `config.backend`: the host oracle for
    "cpu"; for "auto" the host oracle below `min_device_batch` and the
    device planner at or above it; for "cuda" the device planner always.
    `device` (None = CUDA, which raises without a card) is where the
    device planner runs.

    With `db` and `config.winner_cache`, device-planned batches take
    their stored winners from the device-resident cache: the returned
    planner then owns winner fetching (`fetches_winners = False`,
    `on_transaction_failed`, `.cache`), and any batch planned outside
    the cache (host oracle, or a caller that handed explicit winners)
    invalidates its touched cells, keeping cache == SQLite."""
    if config.backend not in _BACKENDS:
        raise ValueError(f"Config.backend must be one of {_BACKENDS}, got {config.backend!r}")
    if config.backend == "cpu":
        return plan_batch

    from evolu_tpu_torch.ops.merge import plan_batch_device_full

    device = resolve_device(device)
    threshold = 0 if config.backend == "cuda" else config.min_device_batch
    cache = None
    if db is not None and config.winner_cache:
        from evolu_tpu_torch.ops.winner_cache import DeviceWinnerCache

        cache = DeviceWinnerCache(db, device=device)

    def planner(batch, existing):
        if cache is not None:
            if len(batch) >= threshold and not existing:
                return cache.plan_batch(batch)  # the standard device route
            # A route outside the cache plans this batch: it needs the
            # real stored winners, and afterwards the cache entries of
            # its cells are stale (no scatter), so they are invalidated.
            touched = {(m.table, m.row, m.column) for m in batch}
            if not existing:
                existing = fetch_existing_winners(db, touched)
            cache.invalidate(touched)
        if len(batch) >= threshold:
            return plan_batch_device_full(batch, existing, device=device)
        return plan_batch(batch, existing)

    def plan_packed(pb):
        """The packed twin of `planner` for a PackedReceive. None =
        materialize and take the object path (which owns invalidation
        for those shapes): small batches take the host oracle there."""
        if len(pb) < threshold:
            return None
        if cache is not None:
            return cache.plan_packed(pb)
        if db is None:
            return None
        return _plan_packed_streamed_nocache(db, pb, device)

    planner.plan_packed = plan_packed
    if cache is not None:
        planner.fetches_winners = False
        planner.on_transaction_failed = cache.on_transaction_failed
        planner.cache = cache
    return planner


def _plan_packed_streamed_nocache(db, pb, device):
    """Packed plan with winners streamed from SQLite (winner_cache off):
    the PackedReceive analog of `plan_batch_device_full`. None = the
    object path (non-canonical hex case in the batch or a stored
    winner)."""
    from evolu_tpu_torch.ops.merge import plan_packed_streamed

    millis, counter, node, case_ok = pb.parse_timestamps()
    if not bool(case_ok.all()):
        return None
    touched_ids, cells = pb.touched_cells()
    return plan_packed_streamed(db, pb, millis, counter, node, cells, touched_ids, device)


class DbWorker:
    """The engine. Post commands with `post`; outputs arrive on the
    `on_output` callback from the worker thread (or synchronously from
    `start` for `OnInit`). `device` is where the device planner and the
    typed folds run (None = CUDA)."""

    def __init__(
        self,
        db: PySqliteDatabase,
        config: Optional[Config] = None,
        on_output: Optional[Callable[[object], None]] = None,
        post_sync: Optional[Callable[[msg.SyncRequestInput], None]] = None,
        now: Callable[[], int] = _now_millis,
        sync_lock: Optional[SyncLock] = None,
        device=None,
    ):
        self.db = db
        self.config = config or Config()
        if self.config.sync_scope is not None:
            raise NotImplementedError(
                "Config.sync_scope: partial replication is not ported yet (the scoped-sync slice)"
            )
        self.on_output = on_output or (lambda _o: None)
        self.post_sync = post_sync or (lambda _r: None)
        self.now = now
        self.sync_lock = sync_lock or get_sync_lock(db.path)
        self.device = device
        self.owner: Optional[Owner] = None
        self.queries_rows_cache: Dict[str, List[dict]] = {}
        # (raw packed result bytes, per-row offsets) a query on the C++
        # backend: the sweep's change detector (bytes) and the
        # row-granular unpack's alignment key (offsets). Staged, committed,
        # evicted and cleared together with queries_rows_cache: a desynced
        # pair would suppress or duplicate patches.
        self.queries_raw_cache: Dict[str, tuple] = {}
        # Incremental invalidation: the change log is a short list of
        # (seq, ChangedSet) batches; each tracked query remembers the seq
        # it last executed at (`_query_seen`), so gating asks "did
        # anything after my seq touch my read set?" (`storage/deps.py`
        # gives the read set). `_query_lru` orders queries by last use
        # for the Config.query_cache_max bound; a run with no cached
        # baseline always emits a root replace, so eviction needs no
        # tombstones.
        self._query_deps: Dict[str, object] = {}
        self._query_seen: Dict[str, int] = {}
        self._query_lru: Dict[str, None] = {}
        self._change_log: List[tuple] = []
        self._change_seq: int = 0
        self._planner = select_planner(self.config, self.db, device)
        self._staged_effects: List = []
        self._staged_cache: Dict[str, List[dict]] = {}
        self._staged_raw: Dict[str, tuple] = {}
        self._staged_changes: ChangedSet = ChangedSet()
        self._staged_seen: set = set()
        self._queue: "queue.Queue[object]" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._stop = object()

    # -- lifecycle --

    def start(self, mnemonic: Optional[str] = None) -> Owner:
        """Init: bootstrap the db model in one transaction, emit OnInit
        with the owner, and start the worker thread."""
        with self.db.transaction():
            self.owner = init_db_model(self.db, mnemonic)
        self.on_output(msg.OnInit(self.owner))
        self._thread = threading.Thread(target=self._loop, daemon=True, name="evolu-db-worker")
        self._thread.start()
        return self.owner

    def stop(self) -> None:
        self._queue.put(self._stop)
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def post(self, command: object) -> None:
        """Enqueue a command."""
        self._queue.put(command)

    def flush(self) -> None:
        """Block until every queued command has been processed."""
        done = threading.Event()
        self._queue.put(done)
        done.wait()

    def _loop(self) -> None:
        while True:
            command = self._queue.get()
            if command is self._stop:
                return
            if isinstance(command, threading.Event):
                command.set()
                continue
            self.handle(command)

    # Side effects (outputs, sync pushes, query-cache writes) are staged
    # during a command and flushed only after its transaction commits:
    # a failure later in the command would otherwise roll back local
    # state that was already pushed to the relay (whose own-node
    # exclusion would never return those messages), and the query cache
    # would desync from the committed rows.

    def _emit(self, output: object) -> None:
        self._staged_effects.append(lambda: self.on_output(output))

    def _push(self, request: msg.SyncRequestInput) -> None:
        self._staged_effects.append(lambda: self.post_sync(request))

    def _manages_own_transactions(self, command: object) -> bool:
        """A Receive large enough to chunk commits per chunk; every
        other command gets one transaction. Nested transactions join the
        outer one, so the chunked path must run without it."""
        chunk = self.config.receive_chunk_size
        return isinstance(command, msg.Receive) and bool(chunk) and len(command.messages) > chunk

    def handle(self, command: object) -> None:
        """Dispatch one command inside one transaction; errors roll back
        and surface as OnError."""
        self._staged_effects = []
        self._staged_cache = {}
        self._staged_raw = {}
        self._staged_changes = ChangedSet()
        self._staged_seen = set()
        try:
            txn = nullcontext() if self._manages_own_transactions(command) else self.db.transaction()
            with txn:
                if isinstance(command, msg.Send):
                    self._send(command)
                elif isinstance(command, msg.Receive):
                    self._receive(command)
                elif isinstance(command, msg.Query):
                    # full=True: a refresh whose trigger the change log
                    # cannot see (another process wrote the file).
                    self._query(command.queries, gated=not command.full)
                elif isinstance(command, msg.EvictQueries):
                    for q in command.queries:
                        self._evict_query_entry(q)
                elif isinstance(command, msg.Sync):
                    self._sync(command)
                elif isinstance(command, msg.UpdateDbSchema):
                    update_db_schema(self.db, command.table_definitions, self.device)
                    # DDL and possible pre-declaration typed folds touch
                    # app tables in ways no batch describes.
                    self._staged_changes.mark_unknown()
                elif isinstance(command, msg.ResetOwner):
                    self._reset_owner()
                elif isinstance(command, msg.RestoreOwner):
                    self._restore_owner(command.mnemonic)
                elif isinstance(command, msg.WidenSyncScope):
                    raise NotImplementedError(
                        "WidenSyncScope: partial replication is not ported yet (the scoped-sync slice)"
                    )
                else:
                    raise ValueError(f"unknown command: {command!r}")
        except Exception as e:  # noqa: BLE001 - the Either-left channel
            if isinstance(command, (msg.Send, msg.Receive, msg.ResetOwner, msg.RestoreOwner)):
                # The transaction rolled back, but the winner cache may
                # have advanced at plan time inside it (e.g. the apply
                # succeeded, then the livelock SyncError aborted the
                # receive): resync it, or it keeps winners SQLite never
                # committed. Idempotent.
                _notify_plan_failure(self._planner)
            # The staged changed-set commits even on failure: for a
            # rolled-back transaction it is a harmless superset; for a
            # chunked receive it covers the chunks that did commit.
            self._commit_staged_changes()
            if self._manages_own_transactions(command):
                # Earlier chunks committed: their staged effects (the
                # OnReceive) must still fire.
                self.queries_rows_cache.update(self._staged_cache)
                self.queries_raw_cache.update(self._staged_raw)
                self._flush_staged_effects()
            try:
                self.on_output(msg.OnError(e))
            except Exception:  # noqa: BLE001,S110 - a raising error
                # listener must not kill the worker thread
                pass
            return
        self._commit_staged_changes()
        # After _commit_staged_changes the current seq covers this
        # command's own writes, which every query staged this command
        # already observed or was verified disjoint from.
        for q in self._staged_seen:
            self._query_seen[q] = self._change_seq
        self.queries_rows_cache.update(self._staged_cache)
        self.queries_raw_cache.update(self._staged_raw)
        self._enforce_query_cache_cap()
        self._flush_staged_effects()

    # -- incremental-invalidation bookkeeping --

    def _commit_staged_changes(self) -> None:
        if not self._staged_changes:
            return
        self._change_seq += 1
        self._change_log.append((self._change_seq, self._staged_changes))
        self._staged_changes = ChangedSet()
        if len(self._change_log) > 64:
            self._compact_change_log()

    def _compact_change_log(self) -> None:
        """Drop entries every tracked query has seen; if stale seen
        epochs still pin history, merge the oldest half into one entry
        whose seq is its newest member's (a superset: conservative)."""
        floor = min(self._query_seen.values(), default=self._change_seq)
        log = [(s, e) for s, e in self._change_log if s > floor]
        if len(log) > 64:
            half = len(log) // 2
            merged = ChangedSet()
            for _s, e in log[:half]:
                merged.merge(e)
            log = [(log[half - 1][0], merged)] + log[half:]
        self._change_log = log

    def _staged_changes_or_none(self):
        """The apply layer's recording target; None when invalidation is
        off, so nothing is recorded."""
        return self._staged_changes if self.config.query_invalidation else None

    def _evict_query_entry(self, q: str) -> None:
        self.queries_rows_cache.pop(q, None)
        self.queries_raw_cache.pop(q, None)
        self._query_deps.pop(q, None)
        self._query_seen.pop(q, None)
        self._query_lru.pop(q, None)

    def _enforce_query_cache_cap(self) -> None:
        """Bound the per-query caches to Config.query_cache_max by least
        recently executed eviction. A still-subscribed query that loses
        its entry heals on its next run with a root-replace patch."""
        cap = self.config.query_cache_max
        if not cap:
            return
        while len(self.queries_rows_cache) > cap and self._query_lru:
            q = next(iter(self._query_lru))
            del self._query_lru[q]
            self.queries_rows_cache.pop(q, _MISSING)
            self.queries_raw_cache.pop(q, None)
            self._query_deps.pop(q, None)
            self._query_seen.pop(q, None)
        if len(self._query_lru) > 2 * cap:
            # Failed or never-cached queries leave LRU-only residue.
            for q in list(self._query_lru):
                if len(self._query_lru) <= 2 * cap:
                    break
                if q not in self.queries_rows_cache:
                    del self._query_lru[q]
                    self._query_deps.pop(q, None)
                    self._query_seen.pop(q, None)

    def _pending_since(self, seen: int, memo: Dict[int, object]):
        """Gate state for every query last verified at epoch `seen`:
        "clean", "conservative", or (tables, rows) of the merged pending
        ChangedSet. Memoized per sweep and epoch."""
        pend = ChangedSet()
        for s, e in self._change_log:
            if s > seen:
                pend.merge(e)
        if self._staged_changes:
            pend.merge(self._staged_changes)
        if pend.conservative:
            state = "conservative"
        elif not pend.tables:
            state = "clean"
        else:
            state = (pend.tables, pend.rows)
        memo[seen] = state
        return state

    def _flush_staged_effects(self) -> None:
        for effect in self._staged_effects:
            try:
                effect()
            except Exception as e:  # noqa: BLE001 - a listener raised: it
                # must not kill the worker thread (the command committed)
                try:
                    self.on_output(msg.OnError(e))
                except Exception:  # noqa: BLE001,S110 - error channel broken
                    pass

    # -- commands --

    def _send(self, command: msg.Send) -> None:
        """send.ts: stamp → apply → persist clock → push → re-query, with
        one wall-clock sample per command."""
        # Refuse wire-unencodable values before they enter the log: a
        # committed value the encoder cannot express would wedge every
        # later resend batch.
        for m in command.messages:
            assert_wire_encodable(m.value, self.config.wire_extensions)
        clock = read_clock(self.db)
        t = clock.timestamp
        now = self.now()
        stamped: List[CrdtMessage] = []
        for m in command.messages:
            t = send_timestamp(t, now, self.config.max_drift)
            stamped.append(CrdtMessage(timestamp_to_string(t), m.table, m.row, m.column, m.value))
        tree = apply_messages(self.db, clock.merkle_tree, stamped, planner=self._planner,
                              changes=self._staged_changes_or_none(), device=self.device)
        update_clock(self.db, CrdtClock(t, tree))
        self._push(msg.SyncRequestInput(
            messages=tuple(stamped),
            clock_timestamp=timestamp_to_string(t),
            merkle_tree=merkle_tree_to_string(tree),
            owner=self.owner,
        ))
        self._query(command.queries, command.on_complete_ids)

    def _receive(self, command: msg.Receive) -> None:
        """receive.ts: merge remote messages, then anti-entropy."""
        clock = read_clock(self.db)
        if len(command.messages):
            # The HLC merge folded over every remote timestamp with one
            # wall-clock sample. A parse failure re-runs the fold
            # message by message, so the first failing message defines
            # the error, as in the reference.
            now = self.now()
            packed = isinstance(command.messages, PackedReceive)
            try:
                if packed:
                    # The 46-wide slab parses in one native call; node
                    # strings materialize only if a screen forces the
                    # exact sequential fold.
                    pb = command.messages
                    r_millis, r_counter, r_node, _case = pb.parse_timestamps()
                    t = receive_timestamps_batch_packed(
                        clock.timestamp, r_millis, r_counter, r_node,
                        lambda: [s[30:46] for s in pb.timestamp_strings()],
                        now=now, max_drift=self.config.max_drift,
                    )
                else:
                    r_millis, r_counter, _ = parse_timestamp_strings(
                        [m.timestamp for m in command.messages]
                    )
                    t = receive_timestamps_batch(
                        clock.timestamp, r_millis, r_counter,
                        [m.timestamp[30:46] for m in command.messages],
                        now=now, max_drift=self.config.max_drift,
                    )
            except TimestampParseError:
                ts_strings = (command.messages.timestamp_strings() if packed
                              else [m.timestamp for m in command.messages])
                t = clock.timestamp
                for ts in ts_strings:
                    t = receive_timestamp(t, timestamp_from_string(ts), now, self.config.max_drift)
            messages = command.messages if packed else list(command.messages)
            chunk = self.config.receive_chunk_size
            if chunk and len(messages) > chunk:
                # Huge history (a restored device's initial sync): apply
                # chunk by chunk with the clock persisted per chunk. The
                # HLC timestamp is already merged over the whole batch.
                receive_staged = False

                def persist(tree_so_far, _applied):
                    # OnReceive is staged when the first chunk commits,
                    # so a later chunk's failure still re-renders them.
                    nonlocal receive_staged
                    update_clock(self.db, CrdtClock(t, tree_so_far))
                    if not receive_staged:
                        receive_staged = True
                        self._emit(msg.OnReceive())

                tree = apply_messages_chunked(
                    self.db, clock.merkle_tree, messages, chunk_size=chunk,
                    planner=self._planner, on_chunk=persist,
                    changes=self._staged_changes_or_none(), device=self.device,
                )
                clock = CrdtClock(t, tree)
            else:
                tree = apply_messages(self.db, clock.merkle_tree, messages, planner=self._planner,
                                      changes=self._staged_changes_or_none(), device=self.device)
                clock = CrdtClock(t, tree)
                update_clock(self.db, clock)
                self._emit(msg.OnReceive())

        server_tree = merkle_tree_from_string(command.merkle_tree)
        diff = diff_merkle_trees(server_tree, clock.merkle_tree)
        if diff is None:
            return
        # Livelock guard: the same diff twice in a row means the
        # replicas cannot converge.
        if command.previous_diff is not None and diff == command.previous_diff:
            raise SyncError()
        if self.sync_lock.is_pending_or_held():
            return
        since = timestamp_to_string(create_sync_timestamp(diff))
        rows = self.db.exec_sql_query(
            'SELECT * FROM "__message" WHERE "timestamp" > ? ORDER BY "timestamp"', (since,),
        )
        self._push(msg.SyncRequestInput(
            messages=tuple(CrdtMessage(r["timestamp"], r["table"], r["row"], r["column"], r["value"])
                           for r in rows),
            clock_timestamp=timestamp_to_string(clock.timestamp),
            merkle_tree=merkle_tree_to_string(clock.merkle_tree),
            owner=self.owner,
            previous_diff=diff,
        ))

    def _query_skips(self, q: str, memo: Dict[int, object]) -> bool:
        """The changed-set gate for one query: True when nothing written
        since its last run can change its result. Sound by construction:
        no baseline or unknown deps ⇒ run; a conservative epoch or deps
        the EXPLAIN walk gave up on ⇒ run; table-disjoint ⇒ skip;
        table overlap with a static id filter disjoint from the changed
        rows ⇒ skip; anything else ⇒ run."""
        seen = self._query_seen.get(q)
        if seen is None or not (q in self.queries_rows_cache or q in self._staged_cache):
            return False
        state = memo.get(seen)
        if state is None:
            state = self._pending_since(seen, memo)
        if state == "clean":
            return True
        if state == "conservative":
            return False
        deps = self._query_deps.get(q)
        read_tables = deps.tables if deps is not None else None
        if read_tables is None:
            return False
        pend_tables, pend_rows = state
        if pend_tables.isdisjoint(read_tables):
            return True
        for t in read_tables:
            if t not in pend_tables:
                continue
            changed = pend_rows.get(t)
            flt = deps.row_filters.get(t)
            if changed is None or flt is None or not changed.isdisjoint(flt):
                return False  # unknown rows or a true overlap
        return True

    def _query(self, queries: Sequence[str], on_complete_ids: Sequence[str] = (),
               gated: bool = True) -> None:
        """query.ts: run, diff against the cache, post non-empty patches.

        With `Config.query_invalidation` the sweep is gated on the
        changed set (`_query_skips`); `gated=False` (an explicit Sync
        refresh, Query(full=True)) re-executes unconditionally. The patch
        stream equals re-running everything. A query with no cached
        baseline (first run, or LRU-evicted) emits a root-replace patch,
        which converges a subscriber from any state."""
        patches = []
        raw_capable = hasattr(self.db, "exec_sql_query_packed_raw")
        if raw_capable:
            from evolu_tpu_torch.storage.native import unpack_changed_rows, unpack_packed_rows
        gate = gated and self.config.query_invalidation
        build_deps = self.config.query_invalidation
        memo: Dict[int, object] = {}
        for q in queries:
            self._query_lru.pop(q, None)
            self._query_lru[q] = None
            self._staged_seen.add(q)
            if gate and self._query_skips(q, memo):
                continue  # no read, no compare, no patch
            sql, parameters = msg.deserialize_query(q)
            if build_deps and q not in self._query_deps:
                # Never raises: the statement's own errors surface from
                # the execution below.
                self._query_deps[q] = query_dependencies(self.db, sql, parameters)
            cached = q in self._staged_cache or q in self.queries_rows_cache
            prev = self._staged_cache.get(q, self.queries_rows_cache.get(q, []))
            entry = None
            if raw_capable:
                # The packed result bytes are the change detector: equal
                # bytes ⇔ an equal result set (SQLite stores no NaN), so
                # an unchanged query skips the parse and the diff.
                entry = self.db.exec_sql_query_packed_raw(sql, parameters, with_offsets=True)
                raw, offs = entry
                prev_entry = self._staged_raw.get(q, self.queries_raw_cache.get(q))
                if cached and prev_entry is not None and prev_entry[0] == raw:
                    self._staged_raw[q] = prev_entry
                    continue  # unchanged: no parse, no diff, no patch
                if prev_entry is not None and prev:
                    # Rows whose bytes are unchanged reuse prev's dicts.
                    rows = unpack_changed_rows(raw, offs, prev_entry[0], prev_entry[1], prev)
                else:
                    rows = unpack_packed_rows(raw)
            else:
                rows = self.db.exec_sql_query(sql, parameters)
            if cached:
                ops = create_patch(prev, rows)
            else:
                ops = [{"op": "replace", "path": "", "value": rows}]
            # Rows are staged before the raw entry: a failure between the
            # two leaves both at their old values.
            self._staged_cache[q] = rows
            if entry is not None:
                self._staged_raw[q] = entry
            if ops:
                patches.append((q, ops))
        if patches or on_complete_ids:
            self._emit(msg.OnQuery(tuple(patches), tuple(on_complete_ids)))

    def _sync(self, command: msg.Sync) -> None:
        """sync.ts: an optional (ungated) query refresh, then a
        pull-only round."""
        if command.queries:
            self._query(command.queries, gated=False)
        if self.sync_lock.is_pending_or_held():
            return
        clock = read_clock(self.db)
        self._push(msg.SyncRequestInput(
            messages=(),
            clock_timestamp=timestamp_to_string(clock.timestamp),
            merkle_tree=merkle_tree_to_string(clock.merkle_tree),
            owner=self.owner,
        ))

    def _drop_winner_cache(self) -> None:
        """Tables just got dropped; cached winner keys are meaningless."""
        cache = getattr(self._planner, "cache", None)
        if cache is not None:
            cache.reset()

    def verify_winner_cache(self, sample: "int | None" = None) -> int:
        """Audit this worker's live cache: every slot == SQLite
        MAX(timestamp) for its cell (`DeviceWinnerCache.verify_against_db`).
        → cells checked (0 with no cache: backend "cpu", winner_cache
        off, or streaming mode)."""
        cache = getattr(self._planner, "cache", None)
        if cache is None:
            return 0
        return cache.verify_against_db(sample=sample)

    def _clear_query_caches(self) -> None:
        self.queries_rows_cache.clear()
        self.queries_raw_cache.clear()
        self._query_deps.clear()
        self._query_seen.clear()
        self._query_lru.clear()
        # Only queries with a seen epoch read the change log; all were
        # just cleared (seq stays monotonic).
        self._change_log.clear()

    def _drop_aead_sessions(self) -> None:
        """The owner identity changed: drop the cached aead-batch-v1
        session keys (sync/aead.py). Sessions are keyed by mnemonic, so a
        stale one never decrypts wrongly; this keeps no keys of a retired
        identity and gives the next identity to sync a fresh session
        salt."""
        from evolu_tpu_torch.sync import aead

        aead.reset_sessions()

    def _reset_owner(self) -> None:
        """resetOwner.ts."""
        self._staged_changes.mark_unknown()  # DDL wipe: unattributable
        delete_all_tables(self.db)
        self._drop_winner_cache()
        self._drop_aead_sessions()
        self._staged_effects.append(self._clear_query_caches)
        self._emit(msg.ReloadAllTabs())

    def _restore_owner(self, mnemonic: str) -> None:
        """restoreOwner.ts: wipe and re-seed the identity; history
        returns with the first sync against the relay."""
        self._staged_changes.mark_unknown()  # DDL wipe: unattributable
        delete_all_tables(self.db)
        self._drop_winner_cache()
        self._drop_aead_sessions()
        self._staged_effects.append(self._clear_query_caches)
        self.owner = init_db_model(self.db, mnemonic)
        self._emit(msg.ReloadAllTabs())
