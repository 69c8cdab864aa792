"""Bounded async write-behind materializer: SQLite off the serving path.

The port's copy of `evolu_tpu.storage.write_behind`. With a queue attached,
the relay engine (`server/engine.BatchReconciler.run_batch_wire`) answers
sync responses and Merkle questions from in-memory per-owner trees, folded
from the deltas that kernels H and X compute on the card, and hands SQLite
materialization to this queue, which drains it in batches off the request
path.

Each storage shard has its own drain state (lock, pending deque, drained
watermark, consecutive-failure counter) and one drain worker (fewer with
`drain_workers`; workers then own shards round-robin):

- thread-per-shard (default): the native insert is a plain C call through
  ctypes, which drops the GIL, so N worker threads overlap N shard inserts.
- process-per-shard (`drain_process=True`, pure-Python file-backed stores
  only): each worker hands its shard transactions to a child `python -m
  evolu_tpu_torch.storage._wb_shard_proc` over a pipe and waits in the pipe
  read while the child commits (WAL + busy_timeout + BEGIN IMMEDIATE, as
  `sqlite.configure_shared_file_db` sets up for file-backed stores). Other
  stores drain on threads; `drain_mode` says which, and the refusal is
  counted (`counts["process_drain_refused"]`).

Durability:
- Every appended record is framed (length + crc32) into ONE append-only
  log and fsync'd BEFORE `append_batch` returns: the ACK point. A torn
  tail fails its crc and is discarded on replay; everything before it
  replays. The log bytes are the reference's: a log written by either
  package replays in the other.
- Replay is idempotent and exact: message inserts are primary-key deduped
  (INSERT OR IGNORE), and replay recomputes every owner tree from the
  per-row was-new flags through the host fold (`core.merkle.
  minute_deltas_host`); it launches no kernel. A crash with shard k
  committed and shard j not replays both; k's rows re-classify as
  duplicates.
- The log truncates only once EVERY shard queue is drained and committed.

Ordering and exactness:
- Records drain in append (seq) order within each shard; an owner's
  history is appended only from the engine's dispatcher thread and lands
  wholly in one shard, so per-owner order stays total.
- The serve-time trees are OPTIMISTIC: every in-batch-deduped row XORs (the
  engine cannot see rows already stored without reading the btree). The
  drain compares against the INSERT's was-new flags: a clean record lands
  its precomputed tree string verbatim; a record with any already-stored
  row gets its owner's tree recomputed exactly from the new rows, the
  owner's serving cache entry is dropped, and later pending records of that
  owner recompute too until the serving path has re-read the corrected tree
  (the `_needs_flush` handshake).

Barriers:
- `flush_owner(owner)` waits only on the owner's shard watermark.
- `flush()` waits on every shard's watermark.
- `drain_barrier()` = flush + hold EVERY shard lock (ascending order;
  workers only ever take their own shard's lock, so it cannot deadlock):
  the whole-store consistency point for checkpoints, replication serves,
  snapshot installs, fleet owner moves and the direct per-request write
  path. `db_lock` is that composite.
- Per-owner serving reads take `owner_lock(owner)`: one shard's lock.

Backpressure: a full queue raises `WriteBehindFull` before mutating
anything; the scheduler answers 503 + Retry-After (never drops).

Departure from the reference: plain `counts` in place of its ledger
terminals, metrics, trace spans and log lines (ROADMAP queue 1 item 10),
each posted where the reference posts its ledger terminal or metric:
`queued`, `drained`, `inserted`, `duplicate`, `replayed` (rows) and
`replayed_records`, `dropped` (by `reset`), `stalls`, `corrected_owners`
and `corrected_records`, `drain_batches`, `drain_failures`, `flushes`,
`log_poisoned`, `proc_spawned` and `process_drain_refused`. `stats_payload`
answers the reference's keys from them, with the apply-lag quantiles null.
"""

from __future__ import annotations

import json
import os
import struct
import subprocess
import sys
import threading
import time
import zlib
from collections import deque
from contextlib import contextmanager
from typing import Deque, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

LOG_MAGIC = b"EVOLUWB1\n"
_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")

_COUNT_KEYS = (
    "queued", "drained", "inserted", "duplicate", "replayed", "replayed_records", "dropped",
    "stalls", "corrected_owners", "corrected_records", "drain_batches", "drain_failures",
    "flushes", "log_poisoned", "proc_spawned", "process_drain_refused",
)


class WriteBehindFull(Exception):
    """Admission backpressure: the pending queue is at capacity. The caller
    stalls the write (the scheduler answers 503 + `retry_after` seconds),
    never drops it."""

    def __init__(self, retry_after: float, backlog_rows: int):
        super().__init__(
            f"write-behind queue full ({backlog_rows} rows pending); retry after {retry_after}s")
        self.retry_after = retry_after
        self.backlog_rows = backlog_rows


class IngestRecord:
    """One shard's slice of one engine batch: the packed row buffers as
    `engine.start_batch` built them, plus the optimistic per-owner tree
    strings computed at serve time. `decode` raises ValueError on any
    corruption."""

    __slots__ = ("gu", "gc", "ts_packed", "content_packed", "lens", "tree_rows")

    def __init__(self, gu: Sequence[str], gc: Sequence[int], ts_packed: bytes,
                 content_packed: bytes, lens, tree_rows: Sequence[Tuple[str, str]]):
        self.gu = list(gu)
        self.gc = [int(c) for c in gc]
        self.ts_packed = ts_packed
        self.content_packed = content_packed
        self.lens = np.ascontiguousarray(lens, dtype=np.int32)
        self.tree_rows = list(tree_rows)

    @property
    def n_rows(self) -> int:
        return int(len(self.lens))

    def encode(self) -> bytes:
        parts: List[bytes] = [_U32.pack(len(self.gu))]
        for u, c in zip(self.gu, self.gc):
            ub = u.encode("utf-8")
            parts += [_U16.pack(len(ub)), ub, _U32.pack(c)]
        parts += [_U32.pack(len(self.ts_packed)), self.ts_packed,
                  _U32.pack(len(self.content_packed)), self.content_packed]
        lens = self.lens.astype("<i4", copy=False)
        parts += [_U32.pack(len(lens)), lens.tobytes(), _U32.pack(len(self.tree_rows))]
        for u, t in self.tree_rows:
            ub, tb = u.encode("utf-8"), t.encode("utf-8")
            parts += [_U16.pack(len(ub)), ub, _U32.pack(len(tb)), tb]
        return b"".join(parts)

    @staticmethod
    def decode(body: bytes) -> "IngestRecord":
        pos = 0

        def take(n: int) -> bytes:
            nonlocal pos
            if pos + n > len(body):
                raise ValueError("truncated write-behind record")
            out = body[pos : pos + n]
            pos += n
            return out

        (n_groups,) = _U32.unpack(take(4))
        gu: List[str] = []
        gc: List[int] = []
        for _ in range(n_groups):
            (ul,) = _U16.unpack(take(2))
            gu.append(take(ul).decode("utf-8"))
            gc.append(_U32.unpack(take(4))[0])
        (tl,) = _U32.unpack(take(4))
        ts_packed = take(tl)
        (cl,) = _U32.unpack(take(4))
        content_packed = take(cl)
        (nl,) = _U32.unpack(take(4))
        lens = np.frombuffer(take(4 * nl), dtype="<i4").astype(np.int32)
        (n_trees,) = _U32.unpack(take(4))
        tree_rows: List[Tuple[str, str]] = []
        for _ in range(n_trees):
            (ul,) = _U16.unpack(take(2))
            u = take(ul).decode("utf-8")
            (sl,) = _U32.unpack(take(4))
            tree_rows.append((u, take(sl).decode("utf-8")))
        if pos != len(body):
            raise ValueError("trailing bytes after write-behind record")
        if sum(gc) != len(lens) or len(ts_packed) != 46 * len(lens):
            raise ValueError("write-behind record shape mismatch")
        if int(lens.sum()) != len(content_packed):
            raise ValueError("write-behind record content size mismatch")
        return IngestRecord(gu, gc, ts_packed, content_packed, lens, tree_rows)


class _Slice:
    """One (record, owner-group) routed to its shard: the per-shard drain
    unit. Byte ranges are cut at append, so a slice holds no reference to
    its record (the log frame is the durable copy)."""

    __slots__ = ("seq", "si", "owner", "k", "ts_b", "content_b", "lens", "tree_s")

    def __init__(self, seq, si, owner, k, ts_b, content_b, lens, tree_s):
        self.seq = seq
        self.si = si
        self.owner = owner
        self.k = k
        self.ts_b = ts_b
        self.content_b = content_b
        self.lens = lens
        self.tree_s = tree_s


class _ShardState:
    """Per-shard drain state. `lock` serializes the shard's SQLite use
    between its drain worker and per-owner serving reads; `pending` / `rows`
    are the shard's slice queue; `failures` / `err` its consecutive-failure
    counter (one wedged shard trips /health without stalling the others)."""

    __slots__ = ("si", "lock", "pending", "rows", "failures", "err")

    def __init__(self, si: int):
        self.si = si
        self.lock = threading.RLock()
        self.pending: Deque[_Slice] = deque()
        self.rows = 0
        self.failures = 0
        self.err: Optional[BaseException] = None


class _CompositeLock:
    """All shard locks as one: acquired in ascending shard order (workers
    take only their own shard's lock, so the fixed order cannot deadlock),
    released in reverse; reentrant because every member is an RLock."""

    def __init__(self, locks: Sequence[threading.RLock]):
        self._locks = tuple(locks)

    def acquire(self) -> None:
        for lk in self._locks:
            lk.acquire()

    def release(self) -> None:
        for lk in reversed(self._locks):
            lk.release()

    def __enter__(self) -> "_CompositeLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


def apply_shard_ops(db, get_tree, ops, exact: bool, carry_taint) -> Tuple[Set[str], List[Tuple[int, int]]]:
    """Apply one shard's ordered op list in ONE transaction on `db`: INSERT
    OR IGNORE each (owner, rows) group, land the precomputed trees of clean
    owners, recompute from the was-new flags for tainted or exact ones, and
    upsert the LAST tree an owner. → (tainted owners, per-op (n_new,
    n_dup)); the caller counts from them, because this also runs inside the
    `_wb_shard_proc` child.

    `ops` items: (owner, k, ts_bytes, content_bytes, lens, tree_s | None).
    `get_tree(owner)` → stored tree TEXT ("{}" when unseen). `carry_taint`:
    owners whose precomputed trees are stale (a correction the serving path
    has not re-read yet).

    Tree decisions are made per OWNER over the whole op list: a record that
    carries both a clean op and a duplicate-bearing op of one owner holds
    the post-batch optimistic tree, which pre-folded the duplicates' hashes
    (XOR-cancel), so the owner recomputes from the stored tree with all its
    new rows, the synchronous-apply semantics."""
    from evolu_tpu_torch.core.merkle import (
        apply_prefix_xors,
        merkle_tree_from_string,
        merkle_tree_to_string,
        minute_deltas_host,
    )

    tainted: Set[str] = set()
    counts: List[Tuple[int, int]] = []
    with db.transaction():
        per_owner: Dict[str, dict] = {}
        order: List[str] = []
        for (u, k, ts_b, content_b, lens, tree_s) in ops:
            flags = np.asarray(_insert_rows(db, [u], [k], ts_b, content_b, lens))
            n_new = int(flags.sum())
            counts.append((n_new, k - n_new))
            acc = per_owner.get(u)
            if acc is None:
                acc = per_owner[u] = {"clean": True, "tree_s": None, "new_ts": []}
                order.append(u)
            acc["clean"] = acc["clean"] and bool(flags.all())
            if tree_s is not None:
                # Each record's string is the post-THAT-batch tree: the
                # later one supersedes.
                acc["tree_s"] = tree_s
            acc["new_ts"] += [ts_b[i * 46 : (i + 1) * 46].decode("ascii") for i in range(k) if bool(flags[i])]
        cur: Dict[str, str] = {}
        for u in order:
            acc = per_owner[u]
            if not exact and acc["clean"] and u not in carry_taint and acc["tree_s"] is not None:
                # Steady state: every row was new, so the optimistic tree is
                # exact (replay-built records carry none and fold below).
                cur[u] = acc["tree_s"]
                continue
            # The exact path: fold the NEW rows onto the stored tree (read
            # before this transaction's upserts land below).
            if not acc["clean"] and not exact:
                tainted.add(u)
            if acc["new_ts"]:
                deltas, _d = minute_deltas_host(acc["new_ts"])
                cur[u] = merkle_tree_to_string(
                    apply_prefix_xors(merkle_tree_from_string(get_tree(u)), deltas))
            # No new rows: the tree is unchanged, and writing the read-back
            # base would mint a merkleTree row the synchronous oracle never
            # writes.
        for u, s in cur.items():
            db.run('INSERT OR REPLACE INTO "merkleTree" ("userId", "merkleTree") VALUES (?, ?)', (u, s))
    return tainted, counts


def _insert_rows(db, gu, gc, ts_packed, content_packed, lens):
    """INSERT OR IGNORE one record slice → per-row was-new flags: the packed
    C call where the database has it (it drops the GIL, which is what lets
    thread-per-shard workers overlap), generic per-row SQL otherwise (replay
    must work on any backend)."""
    if hasattr(db, "relay_insert_packed"):
        return db.relay_insert_packed(gu, gc, ts_packed, content_packed, lens)
    flags = np.zeros(int(sum(gc)), bool)
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    row = 0
    for u, k in zip(gu, gc):
        for _ in range(k):
            ts = ts_packed[row * 46 : (row + 1) * 46].decode("ascii")
            content = content_packed[offs[row] : offs[row + 1]]
            flags[row] = db.run(
                'INSERT OR IGNORE INTO "message" ("timestamp", "userId", "content") VALUES (?, ?, ?)',
                (ts, u, content),
            ) == 1
            row += 1
    return flags


class WriteBehindQueue:
    """The bounded, ordered, crash-safe materialization queue of one relay
    store (`RelayStore` or `ShardedRelayStore`; records split into per-shard
    slices at APPEND by the store's owner hash, and replay re-splits by the
    topology it wakes under, so it survives a shard-count change).

    `drain_workers`: worker threads (None / 0 → one a storage shard; clamped
    to the shard count). `drain_process=True` hands each shard's
    transactions to `_wb_shard_proc` children: pure-Python file-backed
    stores only; anything else drains on threads.

    The normal drain trusts each record's precomputed tree strings while the
    was-new flags say every row was new; replay and tainted owners
    recompute trees from the flags through the host fold."""

    # Consecutive failed drain batches of a shard before `failing()` trips
    # the relay's /health readiness gate (the drain itself retries forever).
    _FAILING_AFTER = 3

    def __init__(self, store, log_path: Optional[str] = None, max_rows: int = 1 << 20,
                 drain_batch_rows: int = 1 << 16, fsync: bool = True, retry_after_s: float = 1.0,
                 drain_workers: Optional[int] = None, drain_process: bool = False,
                 _drain_delay_s: float = 0.0, _shard_delay_s: Optional[Dict[int, float]] = None):
        self.store = store
        self.log_path = log_path
        self.max_rows = int(max_rows)
        self.drain_batch_rows = int(drain_batch_rows)
        self.fsync = bool(fsync)
        self.retry_after_s = float(retry_after_s)
        # Test hooks: stall every drain batch, or one shard's.
        self._drain_delay_s = float(_drain_delay_s)
        self._shard_delay_s: Dict[int, float] = dict(_shard_delay_s or {})
        self.counts = dict.fromkeys(_COUNT_KEYS, 0)
        self._counts_lock = threading.Lock()

        stores, _shard_index = self._shards()
        self._shard_states = [_ShardState(si) for si in range(len(stores))]
        if len(self._shard_states) == 1:
            self.db_lock = self._shard_states[0].lock
        else:
            self.db_lock = _CompositeLock([st.lock for st in self._shard_states])
        n = len(self._shard_states)
        if not drain_workers or int(drain_workers) <= 0:
            self.drain_workers = n
        else:
            self.drain_workers = max(1, min(int(drain_workers), n))

        self.drain_mode = "thread"
        if drain_process:
            blockers = [si for si, s in enumerate(stores)
                        if getattr(s.db, "path", None) in (None, ":memory:")
                        or hasattr(s.db, "relay_insert_packed")]
            if blockers:
                # Needs pure-Python file-backed shards: drain on threads.
                self._count("process_drain_refused")
            else:
                self.drain_mode = "process"

        self._cv = threading.Condition()
        self._pending_rows = 0
        self._last_seq = 0
        # seq → outstanding slice count: a record is fully drained when its
        # last slice commits (backlog_records, truncation).
        self._seq_slices: Dict[int, int] = {}
        self._owner_seq: Dict[str, int] = {}  # owner → last enqueued seq
        self._owner_shard: Dict[str, int] = {}
        # Serving trees, kept only while the owner has pending records.
        self._trees: Dict[str, Tuple[dict, str]] = {}
        # Owners whose optimistic trees a drain corrected: the serving path
        # must flush and re-read before trusting anything.
        self._needs_flush: Dict[str, int] = {}  # owner → seq bound
        self._stopping = False

        self._log = None
        self._log_bytes = 0
        # Set when the log became unrecoverable (a truncate after a failed
        # append failed too): admission is then refused rather than ACKed
        # without durability.
        self._log_poisoned = False
        if log_path is not None:
            self._open_log_and_replay()

        # Shard si → worker si % W; each shard has exactly one drainer.
        self._threads: List[threading.Thread] = []
        self._procs: Dict[int, subprocess.Popen] = {}  # worker id → child
        for wid in range(self.drain_workers):
            t = threading.Thread(target=self._drain_loop, args=(wid,), daemon=True,
                                 name=f"evolu-wb-drain-{wid}")
            self._threads.append(t)
            t.start()

    def _count(self, key: str, n: int = 1) -> None:
        with self._counts_lock:
            self.counts[key] += n

    # -- store topology --

    def _shards(self):
        shards = getattr(self.store, "shards", None)
        if shards is not None:
            return shards, self.store.shard_index
        return [self.store], (lambda _u: 0)

    def _worker_shards(self, wid: int) -> List[int]:
        return [st.si for st in self._shard_states if st.si % self.drain_workers == wid]

    def owner_lock(self, owner: str):
        """The one shard lock guarding `owner`'s rows: per-owner serving
        reads serialize only against their shard's drain."""
        _stores, shard_index = self._shards()
        return self._shard_states[shard_index(owner)].lock

    def _record_slices(self, seq: int, rec: IngestRecord) -> List[_Slice]:
        _stores, shard_index = self._shards()
        offs = np.concatenate([[0], np.cumsum(rec.lens)]).astype(np.int64)
        tree_of = dict(rec.tree_rows)
        out: List[_Slice] = []
        row = 0
        for u, k in zip(rec.gu, rec.gc):
            lo, hi = row, row + k
            out.append(_Slice(seq, shard_index(u), u, k, rec.ts_packed[lo * 46 : hi * 46],
                              rec.content_packed[int(offs[lo]) : int(offs[hi])],
                              rec.lens[lo:hi], tree_of.get(u)))
            row = hi
        return out

    # -- durable log --

    def _open_log_and_replay(self) -> None:
        path = self.log_path
        existing = b""
        if os.path.exists(path):
            with open(path, "rb") as f:
                existing = f.read()
        records = self._decode_log(existing)
        if records:
            self._count("replayed_records", len(records))
            # Replay through the always-exact path before serving and before
            # any worker starts: an ACKed write is in SQLite by the time the
            # constructor returns. The log replay is these rows' ingress.
            with self.db_lock:
                self._materialize(records, exact=True)
            self._count("replayed", sum(r.n_rows for r in records))
        self._log = open(path, "wb")
        self._log.write(LOG_MAGIC)
        self._log.flush()
        if self.fsync:
            os.fsync(self._log.fileno())
        self._log_bytes = len(LOG_MAGIC)

    @staticmethod
    def _decode_log(data: bytes) -> List[IngestRecord]:
        """Every intact record; a torn or corrupt tail (a crash mid-append,
        before the ACK) is discarded."""
        if not data:
            return []
        if not data.startswith(LOG_MAGIC):
            raise ValueError("not an evolu write-behind log")
        pos = len(LOG_MAGIC)
        out: List[IngestRecord] = []
        while pos < len(data):
            if pos + 8 > len(data):
                break  # torn frame header
            (n,) = _U32.unpack_from(data, pos)
            (crc,) = _U32.unpack_from(data, pos + 4)
            body = data[pos + 8 : pos + 8 + n]
            if len(body) != n or zlib.crc32(body) != crc:
                break  # torn or corrupt tail: pre-ACK, discard
            out.append(IngestRecord.decode(body))
            pos += 8 + n
        return out

    def _log_append(self, records: Sequence[IngestRecord]) -> None:
        if self._log is None:
            return
        start = self._log_bytes
        try:
            for r in records:
                body = r.encode()
                self._log.write(_U32.pack(len(body)))
                self._log.write(_U32.pack(zlib.crc32(body)))
                self._log.write(body)
                self._log_bytes += 8 + len(body)
            self._log.flush()
            if self.fsync:
                os.fsync(self._log.fileno())  # the ACK point
        except BaseException:
            # Roll the file back: a partial frame left in place would fail
            # its crc at replay and discard every later ACKed record behind
            # it. If even that fails, poison the log: no more ACKs.
            try:
                self._log.seek(start)
                self._log.truncate()
                self._log.flush()
                if self.fsync:
                    os.fsync(self._log.fileno())
            except BaseException:  # noqa: BLE001
                self._log.close()
                self._log = None
                self._log_poisoned = True
                self._count("log_poisoned")
            self._log_bytes = start
            raise

    def _log_truncate_locked(self) -> None:
        """Called under `_cv` with EVERY shard queue empty: everything in
        the log is committed, so replay would be a no-op; reclaim the file.
        A crash before this truncate only replays committed records."""
        if self._log is None or self._log_bytes == len(LOG_MAGIC):
            return
        self._log.seek(0)
        self._log.truncate()
        self._log.write(LOG_MAGIC)
        self._log.flush()
        if self.fsync:
            os.fsync(self._log.fileno())
        self._log_bytes = len(LOG_MAGIC)

    # -- admission (engine dispatcher thread) --

    def append_batch(self, records: Sequence[IngestRecord],
                     trees: Optional[Dict[str, Tuple[dict, str]]] = None) -> int:
        """Admit one engine batch (one record a live storage shard): the
        durable log append and fsync (the ACK), then the pending slices and
        the serve-time trees, atomically. Raises `WriteBehindFull` BEFORE
        mutating anything when the rows would pass `max_rows`."""
        n_rows = sum(r.n_rows for r in records)
        if n_rows == 0:
            return self._last_seq
        with self._cv:
            if self._stopping or self._log_poisoned:
                raise WriteBehindFull(self.retry_after_s, self._pending_rows)
            if self._pending_rows + n_rows > self.max_rows and self._pending_rows:
                self._count("stalls")
                raise WriteBehindFull(self.retry_after_s, self._pending_rows)
            # The log write and the fsync run under _cv, once an engine
            # pass: that keeps the drain's truncate (also under _cv) from
            # erasing a frame between its fsync and its pending-install.
            self._log_append(records)
            for r in records:
                self._last_seq += 1
                slices = self._record_slices(self._last_seq, r)
                if slices:
                    self._seq_slices[self._last_seq] = len(slices)
                for sl in slices:
                    st = self._shard_states[sl.si]
                    st.pending.append(sl)
                    st.rows += sl.k
                    self._owner_seq[sl.owner] = self._last_seq
                    self._owner_shard[sl.owner] = sl.si
            self._pending_rows += n_rows
            if trees:
                self._trees.update(trees)
            self._count("queued", n_rows)
            seq = self._last_seq
            self._cv.notify_all()
        return seq

    # -- serving-state reads (engine dispatcher thread) --

    def serving_tree(self, owner: str) -> Optional[Tuple[dict, str]]:
        """The serve-time tree of `owner`, or None when SQLite is current
        (no pending history, or a drain-time correction forced a flush: then
        this WAITS for the owner's shard watermark, so the SQLite read that
        follows is exact)."""
        with self._cv:
            if self._needs_flush.get(owner) is None:
                return self._trees.get(owner)
        self.flush_owner(owner)
        return None

    # -- watermarks and flushes --

    def _floor_locked(self, st: _ShardState) -> int:
        """Shard `st`'s drained watermark (caller holds `_cv`): every seq at
        or below it has its slices on this shard committed."""
        return self._last_seq if not st.pending else st.pending[0].seq - 1

    def backlog(self) -> Tuple[int, int]:
        with self._cv:
            return len(self._seq_slices), self._pending_rows

    def saturated(self) -> bool:
        with self._cv:
            return self._pending_rows >= self.max_rows

    def failing(self) -> bool:
        """True once ANY shard's drain failed `_FAILING_AFTER` batches in a
        row, or the log became unrecoverable: the readiness gate."""
        with self._cv:
            return (any(st.failures >= self._FAILING_AFTER for st in self._shard_states)
                    or self._log_poisoned)

    def watermarks(self) -> Tuple[int, int]:
        """(last appended seq, drained-and-committed seq: the least shard
        floor)."""
        with self._cv:
            return self._last_seq, min(self._floor_locked(st) for st in self._shard_states)

    def _wait_drained(self, seq: int, timeout: Optional[float],
                      sis: Optional[Sequence[int]] = None) -> None:
        """Wait out the drain on the given shards (default all), transient
        failures included (each worker retries with backoff). Raise only
        when a relevant worker thread is DEAD with work pending, or on
        timeout, with the last drain error as the cause."""
        deadline = None if timeout is None else time.monotonic() + timeout
        states = self._shard_states if sis is None else [self._shard_states[si] for si in sis]
        wids = {st.si % self.drain_workers for st in states}
        with self._cv:
            while min(self._floor_locked(st) for st in states) < seq:
                dead = [w for w in wids if not self._threads[w].is_alive()]
                err = next((st.err for st in states if st.err is not None), None)
                if dead and not self._stopping:
                    raise RuntimeError(f"write-behind drain worker(s) {dead} died") from err
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    lag = {st.si: self._floor_locked(st) for st in states if self._floor_locked(st) < seq}
                    raise TimeoutError(
                        f"write-behind drain did not reach seq {seq} (shard floors {lag})") from err
                self._cv.wait(min(remaining or 1.0, 1.0))

    def flush(self, timeout: Optional[float] = None) -> None:
        """Block until every record appended so far is committed on EVERY
        shard."""
        self._count("flushes")
        with self._cv:
            seq = self._last_seq
        self._wait_drained(seq, timeout)

    def flush_owner(self, owner: str, timeout: Optional[float] = None) -> None:
        """Block until `owner`'s enqueued history is committed: waits on the
        owner's SHARD watermark only."""
        _stores, shard_index = self._shards()
        si = shard_index(owner)
        with self._cv:
            seq = self._owner_seq.get(owner, 0)
        if seq:
            self._count("flushes")
            self._wait_drained(seq, timeout, sis=[si])
        with self._cv:
            if self._floor_locked(self._shard_states[si]) >= self._needs_flush.get(owner, 0):
                self._needs_flush.pop(owner, None)

    @contextmanager
    def drain_barrier(self):
        """Flush every shard, then hold EVERY shard lock, so no drain can
        restart under the caller. Loops until every queue is verified EMPTY
        while holding the locks: a record ACKed in the flush-to-lock window
        must not ride through the barrier. Once empty under the lock SQLite
        alone is the truth, so the serve-time trees are dropped (a
        concurrent serve then blocks at its base-tree read until the barrier
        releases)."""
        while True:
            self.flush()
            self.db_lock.acquire()
            with self._cv:
                if not any(st.pending for st in self._shard_states):
                    self._trees.clear()
                    break
            self.db_lock.release()
        try:
            yield
        finally:
            self.db_lock.release()

    # -- lifecycle --

    def reset(self) -> None:
        """Drop everything pending and truncate the log. Takes every shard
        lock FIRST, so an in-flight drain transaction finishes before the
        drop rather than committing after `reset` returned."""
        with self.db_lock, self._cv:
            dropped = self._pending_rows
            for st in self._shard_states:
                st.pending.clear()
                st.rows = 0
            self._seq_slices.clear()
            self._pending_rows = 0
            self._owner_seq.clear()
            self._owner_shard.clear()
            self._trees.clear()
            self._needs_flush.clear()
            self._log_truncate_locked()
            self._count("dropped", dropped)
            self._cv.notify_all()

    def close(self, flush: bool = True) -> None:
        """Flush (a failure to flush still stops the workers), stop the
        drain workers and children, close the log."""
        if flush:
            try:
                self.flush()
            except Exception:  # noqa: BLE001 - still stop the threads
                pass
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=30.0)
        for proc in self._procs.values():
            try:
                proc.stdin.close()
                proc.wait(timeout=10.0)
            except Exception:  # noqa: BLE001 - a wedged child: kill it
                proc.kill()
        self._procs.clear()
        if self._log is not None:
            self._log.close()
            self._log = None

    # -- drain (each shard has exactly one drainer) --

    def _drain_loop(self, wid: int) -> None:
        my = self._worker_shards(wid)
        backoff = {si: 0.05 for si in my}
        rr = 0
        while True:
            with self._cv:
                while not self._stopping and not any(self._shard_states[si].pending for si in my):
                    self._cv.wait()
                pick = None
                for off in range(len(my)):
                    si = my[(rr + off) % len(my)]
                    if self._shard_states[si].pending:
                        pick = si
                        rr = (rr + off + 1) % len(my)
                        break
                if pick is None:
                    return  # stopping, and every owned shard drained
                st = self._shard_states[pick]
                batch: List[_Slice] = []
                rows = 0
                for sl in st.pending:
                    if batch and rows + sl.k > self.drain_batch_rows:
                        break
                    batch.append(sl)
                    rows += sl.k
                # Owners an earlier drain corrected whose serving path has
                # not re-read yet: their precomputed trees are stale.
                carry_taint = set(self._needs_flush)
            delay = self._drain_delay_s + self._shard_delay_s.get(pick, 0.0)
            if delay:
                time.sleep(delay)  # the test hooks' kill window
            ops = [(sl.owner, sl.k, sl.ts_b, sl.content_b, sl.lens, sl.tree_s) for sl in batch]
            try:
                with st.lock:
                    tainted = self._materialize_shard(pick, ops, exact=False, carry_taint=carry_taint,
                                                      wid=wid)
            except Exception as e:  # noqa: BLE001 - keep draining
                self._count("drain_failures")
                with self._cv:
                    st.err = e
                    st.failures += 1
                    self._cv.notify_all()
                if self._stopping:
                    return
                time.sleep(backoff[pick])
                backoff[pick] = min(backoff[pick] * 2, 2.0)
                continue
            backoff[pick] = 0.05
            with self._cv:
                st.err = None
                st.failures = 0
                for sl in batch:
                    # A concurrent reset() may have cleared the deque; the
                    # rows are committed either way.
                    if st.pending and st.pending[0] is sl:
                        st.pending.popleft()
                        st.rows -= sl.k
                        self._pending_rows -= sl.k
                        left = self._seq_slices.get(sl.seq, 0) - 1
                        if left <= 0:
                            self._seq_slices.pop(sl.seq, None)
                        else:
                            self._seq_slices[sl.seq] = left
                floor = self._floor_locked(st)
                for o in tainted:
                    # The serving path must re-read the corrected tree
                    # before folding anything onto it.
                    self._needs_flush[o] = self._owner_seq.get(o, floor)
                    self._trees.pop(o, None)
                # This shard's fully drained owners fall back to SQLite.
                done = [o for o, s in self._owner_seq.items()
                        if self._owner_shard.get(o) == pick and s <= floor]
                for o in done:
                    del self._owner_seq[o]
                    self._owner_shard.pop(o, None)
                    self._trees.pop(o, None)
                    if floor >= self._needs_flush.get(o, 0):
                        self._needs_flush.pop(o, None)
                if not self._seq_slices:
                    self._log_truncate_locked()
                self._cv.notify_all()
            self._count("drained", rows)
            self._count("drain_batches")

    # -- materialization --

    def _materialize_shard(self, si: int, ops, exact: bool, carry_taint,
                           wid: Optional[int] = None) -> Set[str]:
        """Commit one shard's ordered op list in ONE transaction and count
        its inserted / duplicate rows iff it committed. A failed shard
        re-runs alone. Caller holds the shard's lock. → the owners whose
        optimistic trees were corrected (none in `exact` mode)."""
        stores, _ = self._shards()
        if self.drain_mode == "process" and wid is not None:
            tainted, counts = self._child_apply(wid, si, ops, exact, carry_taint)
        else:
            tainted, counts = apply_shard_ops(stores[si].db, stores[si].get_merkle_tree_string,
                                              ops, exact, carry_taint)
        self._count("inserted", sum(n for n, _ in counts))
        self._count("duplicate", sum(d for _, d in counts))
        if tainted and not exact:
            self._count("corrected_records")
            self._count("corrected_owners", len(tainted))
        return set(tainted)

    def _materialize(self, records: Sequence[IngestRecord], exact: bool = False) -> Set[str]:
        """Split `records` (in seq order) by the CURRENT shard topology and
        commit them shard by shard: the replay path, which is how replay
        survives a shard-count change. Caller holds `db_lock`."""
        per_shard: Dict[int, List[tuple]] = {}
        for rec in records:
            for sl in self._record_slices(0, rec):
                per_shard.setdefault(sl.si, []).append(
                    (sl.owner, sl.k, sl.ts_b, sl.content_b, sl.lens, sl.tree_s))
        with self._cv:
            carry_taint = set(self._needs_flush)
        tainted: Set[str] = set()
        for si, ops in per_shard.items():
            tainted |= self._materialize_shard(si, ops, exact=exact, carry_taint=carry_taint)
        return tainted

    # -- process-per-shard drain (pure-Python file-backed stores) --

    def _child_spawn(self, wid: int) -> subprocess.Popen:
        stores, _ = self._shards()
        args = [sys.executable, "-m", "evolu_tpu_torch.storage._wb_shard_proc"]
        for si in self._worker_shards(wid):
            args += ["--shard", f"{si}={stores[si].db.path}"]
        env = dict(os.environ)
        repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = repo + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        proc = subprocess.Popen(args, env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE)
        self._count("proc_spawned")
        return proc

    def _child_apply(self, wid: int, si: int, ops, exact: bool,
                     carry_taint) -> Tuple[Set[str], List[Tuple[int, int]]]:
        """One shard batch over the worker's child pipe. A dead child is a
        drain failure like any other: the worker respawns it and retries;
        rows the child committed before dying re-classify as duplicates."""
        proc = self._procs.get(wid)
        if proc is None or proc.poll() is not None:
            proc = self._procs[wid] = self._child_spawn(wid)
        header = json.dumps({
            "si": si,
            "exact": bool(exact),
            "taint": sorted(carry_taint),
            "ops": [{"u": u, "k": int(k), "lens": [int(x) for x in lens], "tree": tree_s}
                    for (u, k, _ts, _c, lens, tree_s) in ops],
        }).encode("utf-8")
        blob = b"".join(op[2] for op in ops) + b"".join(op[3] for op in ops)
        try:
            proc.stdin.write(_U32.pack(len(header)) + header + _U32.pack(len(blob)) + blob)
            proc.stdin.flush()
            raw = proc.stdout.read(4)
            if len(raw) != 4:
                raise RuntimeError("wb shard child closed the pipe")
            (n,) = _U32.unpack(raw)
            resp = json.loads(proc.stdout.read(n).decode("utf-8"))
        except BaseException:
            # A pipe failure orphans the child's state: kill it and respawn
            # on the retry (SQLite rolled back anything uncommitted).
            try:
                proc.kill()
            except Exception:  # noqa: BLE001
                pass
            self._procs.pop(wid, None)
            raise
        if not resp.get("ok"):
            raise RuntimeError(f"wb shard child failed: {resp.get('error', 'unknown')}")
        return set(resp["tainted"]), [tuple(c) for c in resp["counts"]]

    # -- stats --

    def shard_payloads(self) -> List[dict]:
        """Per-shard backlog, watermark and failure rows for /stats and
        /health: which shard is backlogged or wedged."""
        with self._cv:
            last = self._last_seq
            out = []
            for st in self._shard_states:
                floor = self._floor_locked(st)
                out.append({
                    "shard": st.si,
                    "worker": st.si % self.drain_workers,
                    "backlog_slices": len(st.pending),
                    "backlog_rows": st.rows,
                    "drained_floor": floor,
                    "watermark_lag": last - floor,
                    "drain_failures_consecutive": st.failures,
                    "failing": st.failures >= self._FAILING_AFTER,
                })
        return out

    def stats_payload(self) -> dict:
        """The `write_behind` section of /stats: the reference's keys, read
        from `counts` (the apply-lag quantiles null until the observability
        item is ported), plus the counts themselves."""
        records, rows = self.backlog()
        last, drained = self.watermarks()
        with self._counts_lock:
            counts = dict(self.counts)
        return {
            "backlog_records": records,
            "backlog_rows": rows,
            "last_seq": last,
            "drained_seq": drained,
            "saturated": rows >= self.max_rows,
            "max_rows": self.max_rows,
            "drain_mode": self.drain_mode,
            "drain_workers": self.drain_workers,
            "shards": self.shard_payloads(),
            "log_bytes": self._log_bytes,
            "log_path": self.log_path,
            "enqueued_rows": counts["queued"],
            "drained_rows": counts["drained"],
            "corrected_owners": counts["corrected_owners"],
            "replayed_records": counts["replayed_records"],
            "stalls": counts["stalls"],
            "flushes": counts["flushes"],
            "drain_failures": counts["drain_failures"],
            "apply_lag_ms_p50": None,
            "apply_lag_ms_p99": None,
            "counts": counts,
        }

    def health_payload(self) -> dict:
        records, rows = self.backlog()
        last, drained = self.watermarks()
        shards = self.shard_payloads()
        with self._cv:
            poisoned = self._log_poisoned
        failures = max((s["drain_failures_consecutive"] for s in shards), default=0)
        return {
            "backlog_records": records,
            "backlog_rows": rows,
            "last_seq": last,
            "drained_seq": drained,
            "saturated": rows >= self.max_rows,
            "drain_mode": self.drain_mode,
            "drain_workers": self.drain_workers,
            "shards": shards,
            "drain_failures_consecutive": failures,
            "log_poisoned": poisoned,
            "failing": failures >= self._FAILING_AFTER or poisoned,
        }
