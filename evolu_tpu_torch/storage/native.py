"""ctypes binding for the C++ SQLite host layer (native/evolu_host.cpp).

The port's copy of `evolu_tpu.storage.native`. `CppSqliteDatabase`
implements the same backend boundary as `PySqliteDatabase` (the
reference's `Database` interface, types.ts:162-176) over the C++
library, which drives the real SQLite C API directly. The merge hot
path runs as ONE C call per batch (`apply_sequential` / `apply_planned`
/ `apply_planned_cells`), with winner lookups, app-table upserts and
`__message` inserts all inside C++; the relay's ingest inserts a whole
shard with per-row was-new flags in one call (`relay_insert_packed`).

The library is the reference's unchanged source, built with g++ at
first use into `evolu_tpu_torch/_build/native/` (`utils.native_loader`).
`open_database(backend="native")` and `CppSqliteDatabase` raise the
build's log when it fails; `backend="auto"` takes the native backend
when it builds and `PySqliteDatabase` otherwise, as the reference does.
"""

from __future__ import annotations

import ctypes
import struct
import threading

import numpy as np
from contextlib import contextmanager
from typing import Iterable, List, Optional, Sequence, Tuple

from evolu_tpu_torch.core.types import NonCanonicalStoreError, UnknownError
from evolu_tpu_torch.utils.native_loader import load_native_library, try_load_native_library

SO_NAME = "libevolu_host.so"

_SQLITE_ROW = 100
_SQLITE_DONE = 101

# column types
_T_INT, _T_FLOAT, _T_TEXT, _T_BLOB, _T_NULL = 1, 2, 3, 4, 5


def _configure(lib: ctypes.CDLL) -> None:
    c = ctypes
    p, i, i64, d, s, u8p, i32p, i64p, dp = (
        c.c_void_p, c.c_int, c.c_int64, c.c_double, c.c_char_p,
        c.POINTER(c.c_uint8), c.POINTER(c.c_int32), c.POINTER(c.c_int64),
        c.POINTER(c.c_double),
    )
    sp = c.POINTER(s)
    lib.eh_open.restype = p
    lib.eh_open.argtypes = [s]
    lib.eh_close.argtypes = [p]
    lib.eh_errmsg.restype = s
    lib.eh_errmsg.argtypes = [p]
    lib.eh_exec.argtypes = [p, s]
    lib.eh_changes.argtypes = [p]
    lib.eh_total_changes.argtypes = [p]
    lib.eh_prepare.restype = p
    lib.eh_prepare.argtypes = [p, s]
    lib.eh_prepare_single.restype = p
    lib.eh_prepare_single.argtypes = [p, s, c.POINTER(c.c_int)]
    lib.eh_finalize.argtypes = [p]
    lib.eh_step.argtypes = [p]
    lib.eh_reset.argtypes = [p]
    lib.eh_bind.argtypes = [p, i, i, i64, d, s, i]
    lib.eh_column_count.argtypes = [p]
    lib.eh_column_name.restype = s
    lib.eh_column_name.argtypes = [p, i]
    lib.eh_column_type.argtypes = [p, i]
    lib.eh_column_int64.restype = i64
    lib.eh_column_int64.argtypes = [p, i]
    lib.eh_column_double.restype = d
    lib.eh_column_double.argtypes = [p, i]
    lib.eh_column_text.restype = p  # read via column_bytes + string_at (NUL-safe)
    lib.eh_column_text.argtypes = [p, i]
    lib.eh_column_blob.restype = p
    lib.eh_column_blob.argtypes = [p, i]
    lib.eh_column_bytes.argtypes = [p, i]
    lib.eh_fetch_winners.argtypes = [p, i64, sp, sp, sp, c.c_char_p, i64]
    lib.eh_apply_sequential.argtypes = [p, i64, sp, sp, sp, sp, i32p, i64p, dp, sp, i32p, u8p]
    lib.eh_apply_planned_packed.argtypes = [
        p, i64, s, i32p, s, i32p, s, i32p, s, i32p, i32p, i64p, dp, s, i32p, u8p,
    ]
    lib.eh_apply_planned_cells.argtypes = [
        p, i64, s, i64, s, i32p, i32p, u8p, i64p, dp, s, i32p, u8p,
    ]
    lib.eh_relay_insert.argtypes = [p, i64, sp, sp, sp, i32p, u8p]
    lib.eh_relay_insert_packed.argtypes = [p, i64, sp, i64p, s, s, i32p, u8p]
    lib.eh_parse_timestamps.argtypes = [s, i64, i64p, i32p, c.POINTER(c.c_uint64), u8p]
    lib.eh_run_many_tb.argtypes = [p, s, i64, c.c_int32, sp, i32p, i32p]
    lib.eh_get_messages.argtypes = [
        p, s, c.c_int32, s, s, c.c_int32,
        c.POINTER(c.c_char_p), c.POINTER(p), c.POINTER(i32p), c.POINTER(i64),
    ]
    lib.eh_free.argtypes = [p]
    lib.eh_exec_packed.argtypes = [p, c.POINTER(p), i64p, i64p, c.POINTER(i64p)]
    lib.eh_get_messages_wire.argtypes = [
        p, s, c.c_int32, s, s, c.c_int32, c.POINTER(p), i64p, i64p,
    ]
    lib.eh_snapshot_rows.argtypes = [p, c.POINTER(p), i64p, i64p, i64p]


def load_library() -> ctypes.CDLL:
    """The shared library, built on first use; raises NativeBuildError
    with the compiler's log when it cannot be built or loaded."""
    return load_native_library(SO_NAME, _configure)


def native_available() -> bool:
    """Whether the library builds and loads here (a failure's log stays
    in `utils.native_loader.build_info`)."""
    return try_load_native_library(SO_NAME, _configure) is not None


_PACK_I32 = struct.Struct("<i")
_PACK_I64 = struct.Struct("<q")
_PACK_F64 = struct.Struct("<d")
_PACK_U32 = struct.Struct("<I")


def _parse_packed_header(raw: bytes):
    """→ (column names, position after the header)."""
    (ncols,) = _PACK_I32.unpack_from(raw, 0)
    pos = 4
    cols = []
    for _ in range(ncols):
        (n,) = _PACK_I32.unpack_from(raw, pos)
        pos += 4
        cols.append(raw[pos : pos + n].decode("utf-8"))
        pos += n
    return cols, pos


def _parse_packed_row(raw: bytes, cols, pos: int):
    """One row at `pos` → (dict, next position)."""
    vals = []
    for _ in range(len(cols)):
        t = raw[pos]
        pos += 1
        if t == 1:
            (v,) = _PACK_I64.unpack_from(raw, pos)
            pos += 8
        elif t == 2:
            (v,) = _PACK_F64.unpack_from(raw, pos)
            pos += 8
        elif t == 3:
            (n,) = _PACK_U32.unpack_from(raw, pos)
            pos += 4
            v = raw[pos : pos + n].decode("utf-8")
            pos += n
        elif t == 4:
            (n,) = _PACK_U32.unpack_from(raw, pos)
            pos += 4
            v = raw[pos : pos + n]
            pos += n
        else:
            v = None
        vals.append(v)
    return dict(zip(cols, vals)), pos


def unpack_packed_rows(
    raw: bytes, start: Optional[int] = None, end: Optional[int] = None
) -> List[dict]:
    """`eh_exec_packed` buffer → list of row dicts (the
    `exec_sql_query` contract). Layout documented at the C function.
    `start`/`end` optionally bound the ROW region (byte offsets from
    the per-row offsets array) for partial unpacks."""
    cols, pos = _parse_packed_header(raw)
    if start is not None:
        pos = start
    stop = len(raw) if end is None else end
    rows: List[dict] = []
    while pos < stop:
        d, pos = _parse_packed_row(raw, cols, pos)
        rows.append(d)
    return rows


def unpack_changed_rows(raw, offs, prev_raw, prev_offs, prev_rows) -> List[dict]:
    """Row-granular re-unpack for the reactive query loop: the full
    unpack dominates a changed 10k-row query's cost while typically
    only a few rows changed. Rows whose
    packed bytes are unchanged REUSE the previous result's dict
    objects (identity-stable — the differ can shortcut on `is`); only
    changed/new rows parse.

    Alignment: the longest common row PREFIX and SUFFIX by row LENGTH
    (vectorized over the offset arrays), then ONE xor pass +
    `np.add.reduceat` per region decides content equality per row —
    in-place edits, appends, and tail deletions all localize, and the
    residual middle window unpacks fresh. Result is always EXACTLY
    `unpack_packed_rows(raw)` (property-pinned)."""
    n_new = len(offs) - 1
    n_old = len(prev_offs) - 1
    if n_old != len(prev_rows) or n_new == 0 or n_old == 0:
        return unpack_packed_rows(raw)
    h = int(offs[0])
    if h != int(prev_offs[0]) or raw[:h] != prev_raw[:h]:
        return unpack_packed_rows(raw)  # schema/header changed
    len_new = np.diff(offs)
    len_old = np.diff(prev_offs)
    m = min(n_new, n_old)
    neq = len_new[:m] != len_old[:m]
    p = int(np.argmax(neq)) if neq.any() else m
    rev_neq = len_new[n_new - m :][::-1] != len_old[n_old - m :][::-1]
    s = int(np.argmax(rev_neq)) if rev_neq.any() else m
    s = min(s, m - p)

    a = np.frombuffer(raw, np.uint8)
    b = np.frombuffer(prev_raw, np.uint8)

    def region_changed(starts_new, span_a, span_b):
        """Per-row any-byte-differs over an aligned equal-length region."""
        x = a[span_a] != b[span_b]
        if x.size == 0:
            return np.zeros(len(starts_new), bool)
        return np.add.reduceat(x, starts_new) > 0

    changed_pre = region_changed(
        (offs[:p] - h).astype(np.int64),
        slice(h, int(offs[p])), slice(h, int(prev_offs[p])),
    ) if p else np.zeros(0, bool)
    if s:
        ns, os_ = int(offs[n_new - s]), int(prev_offs[n_old - s])
        changed_suf = region_changed(
            (offs[n_new - s : n_new] - ns).astype(np.int64),
            slice(ns, len(raw)), slice(os_, len(prev_raw)),
        )
    else:
        changed_suf = np.zeros(0, bool)

    cols, _hp = _parse_packed_header(raw)
    rows: List[dict] = []
    for i in range(p):
        if changed_pre[i]:
            d, _ = _parse_packed_row(raw, cols, int(offs[i]))
            rows.append(d)
        else:
            rows.append(prev_rows[i])
    rows.extend(unpack_packed_rows(raw, start=int(offs[p]), end=int(offs[n_new - s])))
    for k in range(s):
        if changed_suf[k]:
            d, _ = _parse_packed_row(raw, cols, int(offs[n_new - s + k]))
            rows.append(d)
        else:
            rows.append(prev_rows[n_old - s + k])
    return rows


def _encode_value(v) -> Tuple[int, int, float, Optional[bytes], int]:
    """Python value → (kind, int64, double, bytes, blob_len)."""
    if v is None:
        return 0, 0, 0.0, None, 0
    if isinstance(v, bool):
        return 1, int(v), 0.0, None, 0
    if isinstance(v, int):
        return 1, v, 0.0, None, 0
    if isinstance(v, float):
        return 2, 0, v, None, 0
    if isinstance(v, bytes):
        return 4, 0, 0.0, v, len(v)
    enc = str(v).encode("utf-8")
    return 3, 0, 0.0, enc, len(enc)


def _columnar_values(values) -> Tuple:
    n = len(values)
    kinds = (ctypes.c_int32 * n)()
    ivals = (ctypes.c_int64 * n)()
    dvals = (ctypes.c_double * n)()
    svals = (ctypes.c_char_p * n)()
    blens = (ctypes.c_int32 * n)()
    for j, v in enumerate(values):
        k, iv, dv, sv, bl = _encode_value(v)
        kinds[j], ivals[j], dvals[j], svals[j], blens[j] = k, iv, dv, sv, bl
    return kinds, ivals, dvals, svals, blens


def _str_array(items: Sequence[str]):
    arr = (ctypes.c_char_p * len(items))()
    for j, x in enumerate(items):
        arr[j] = x.encode("utf-8") if isinstance(x, str) else x
    return arr


class CppSqliteDatabase:
    """Single-writer SQLite handle over the C++ host layer.

    Drop-in for `PySqliteDatabase`: exec / exec_script / exec_sql_query /
    run / run_many / changes / transaction / close, plus the batched
    native hot paths (`apply_sequential`, `apply_planned`,
    `fetch_winners`, `relay_insert`).
    """

    def __init__(self, path: str = ":memory:"):
        lib = load_library()
        self._lib = lib
        self._db = lib.eh_open(path.encode("utf-8"))
        if not self._db:
            raise UnknownError(f"cannot open database {path!r}")
        self._lock = threading.RLock()
        self._in_txn = False
        self.path = path
        self._begin_sql = b"BEGIN"

    # -- internals --

    def _check_open(self) -> None:
        if not self._db:
            raise UnknownError("Cannot operate on a closed database.")

    def _err(self) -> UnknownError:
        msg = self._lib.eh_errmsg(self._db)
        return UnknownError(msg.decode("utf-8", "replace") if msg else "sqlite error")

    def _read_row(self, st) -> Tuple:
        lib = self._lib
        ncol = lib.eh_column_count(st)
        out = []
        for i in range(ncol):
            t = lib.eh_column_type(st, i)
            if t == _T_INT:
                out.append(lib.eh_column_int64(st, i))
            elif t == _T_FLOAT:
                out.append(lib.eh_column_double(st, i))
            elif t == _T_TEXT:
                nb = lib.eh_column_bytes(st, i)
                ptr = lib.eh_column_text(st, i)
                out.append(ctypes.string_at(ptr, nb).decode("utf-8") if ptr else "")
            elif t == _T_BLOB:
                nb = lib.eh_column_bytes(st, i)
                ptr = lib.eh_column_blob(st, i)
                out.append(ctypes.string_at(ptr, nb) if ptr else b"")
            else:
                out.append(None)
        return tuple(out)

    def _execute(self, sql: str, parameters: Sequence = ()) -> Tuple[List[Tuple], List[str]]:
        lib = self._lib
        self._check_open()
        tail = ctypes.c_int(0)
        st = lib.eh_prepare_single(self._db, sql.encode("utf-8"), ctypes.byref(tail))
        if not st:
            raise self._err()
        if tail.value:
            lib.eh_finalize(st)
            raise UnknownError("You can only execute one statement at a time.")
        try:
            for j, v in enumerate(parameters):
                k, iv, dv, sv, bl = _encode_value(v)
                if lib.eh_bind(st, j + 1, k, iv, dv, sv, bl) != 0:
                    raise self._err()
            cols: List[str] = []
            rows: List[Tuple] = []
            first = True
            while True:
                rc = lib.eh_step(st)
                if rc == _SQLITE_ROW:
                    if first:
                        cols = [
                            (lib.eh_column_name(st, i) or b"").decode("utf-8")
                            for i in range(lib.eh_column_count(st))
                        ]
                        first = False
                    rows.append(self._read_row(st))
                elif rc == _SQLITE_DONE:
                    if first:
                        cols = [
                            (lib.eh_column_name(st, i) or b"").decode("utf-8")
                            for i in range(lib.eh_column_count(st))
                        ]
                    break
                else:
                    raise self._err()
            return rows, cols
        finally:
            lib.eh_finalize(st)

    # -- Database interface (types.ts:162-176) --

    def exec(self, sql: str) -> List[Tuple]:
        with self._lock:
            rows, _ = self._execute(sql)
            return rows

    def exec_script(self, sql: str) -> None:
        with self._lock:
            self._check_open()
            if self._in_txn:
                raise UnknownError("exec_script inside an open transaction")
            if self._lib.eh_exec(self._db, sql.encode("utf-8")) != 0:
                raise self._err()

    def exec_sql_query(self, sql: str, parameters: Sequence = ()) -> List[dict]:
        return unpack_packed_rows(self.exec_sql_query_packed_raw(sql, parameters))

    def exec_sql_query_packed_raw(
        self, sql: str, parameters: Sequence = (), with_offsets: bool = False
    ):
        """One C call steps the whole result set into a packed buffer
        (the per-cell ctypes path pays a call per column per row).
        The raw bytes double as a change-detection key: identical bytes
        ⇔ identical result set, so the worker's reactive re-execution
        skips dict materialization and diffing for unchanged queries
        (runtime/worker.py::_query). With `with_offsets`, returns
        (raw, offsets int64[rows+1]) — per-ROW byte spans, the
        row-granular change detector's alignment key."""
        lib = self._lib
        with self._lock:
            self._check_open()
            tail = ctypes.c_int(0)
            st = lib.eh_prepare_single(self._db, sql.encode("utf-8"), ctypes.byref(tail))
            if not st:
                raise self._err()
            if tail.value:
                lib.eh_finalize(st)
                raise UnknownError("You can only execute one statement at a time.")
            try:
                for j, v in enumerate(parameters):
                    k, iv, dv, sv, bl = _encode_value(v)
                    if lib.eh_bind(st, j + 1, k, iv, dv, sv, bl) != 0:
                        raise self._err()
                out = ctypes.c_void_p()
                out_len = ctypes.c_int64()
                out_rows = ctypes.c_int64()
                offs_p = ctypes.POINTER(ctypes.c_int64)()
                rc = lib.eh_exec_packed(
                    st, ctypes.byref(out), ctypes.byref(out_len),
                    ctypes.byref(out_rows),
                    ctypes.byref(offs_p) if with_offsets else None,
                )
                if rc != 0:
                    raise self._err()
                try:
                    raw = ctypes.string_at(out.value, out_len.value)
                    if not with_offsets:
                        return raw
                    n = out_rows.value
                    offs = np.frombuffer(
                        ctypes.string_at(offs_p, (n + 1) * 8), np.int64
                    )
                    return raw, offs
                finally:
                    lib.eh_free(out)
                    if with_offsets and offs_p:
                        lib.eh_free(ctypes.cast(offs_p, ctypes.c_void_p))
            finally:
                lib.eh_finalize(st)

    def run(self, sql: str, parameters: Sequence = ()) -> int:
        with self._lock:
            self._check_open()
            before = self._lib.eh_total_changes(self._db)
            self._execute(sql, parameters)
            return self._lib.eh_total_changes(self._db) - before

    def run_many(self, sql: str, rows: Iterable[Sequence]) -> int:
        rows = rows if isinstance(rows, list) else list(rows)
        # Fast path: all-text/blob/None rows bind inside ONE C call
        # (the generic path pays ~3us of ctypes per bind).
        if rows and all(
            isinstance(v, (str, bytes)) or v is None for r in rows for v in r
        ):
            return self._run_many_tb(sql, rows)
        lib = self._lib
        with self._lock:
            self._check_open()
            st = lib.eh_prepare(self._db, sql.encode("utf-8"))
            if not st:
                raise self._err()
            before = lib.eh_total_changes(self._db)
            try:
                for row in rows:
                    for j, v in enumerate(row):
                        k, iv, dv, sv, bl = _encode_value(v)
                        if lib.eh_bind(st, j + 1, k, iv, dv, sv, bl) != 0:
                            raise self._err()
                    rc = lib.eh_step(st)
                    if rc not in (_SQLITE_DONE, _SQLITE_ROW):
                        raise self._err()
                    lib.eh_reset(st)
            finally:
                lib.eh_finalize(st)
            return lib.eh_total_changes(self._db) - before

    def _run_many_tb(self, sql: str, rows) -> int:
        lib = self._lib
        nrows, ncols = len(rows), len(rows[0])
        ncells = nrows * ncols
        vals = (ctypes.c_char_p * ncells)()
        lens = (ctypes.c_int32 * ncells)()
        kinds = (ctypes.c_int32 * ncells)()
        i = 0
        for r in rows:
            if len(r) != ncols:
                raise UnknownError("run_many: ragged rows")
            for v in r:
                if v is None:
                    kinds[i] = 0
                elif isinstance(v, bytes):
                    vals[i], lens[i], kinds[i] = v, len(v), 4
                else:
                    b = v.encode("utf-8")
                    vals[i], lens[i], kinds[i] = b, len(b), 3
                i += 1
        with self._lock:
            self._check_open()
            before = lib.eh_total_changes(self._db)
            rc = lib.eh_run_many_tb(
                self._db, sql.encode("utf-8"), nrows, ncols, vals, lens, kinds
            )
            if rc != 0:
                raise self._err()
            return lib.eh_total_changes(self._db) - before

    def changes(self) -> int:
        with self._lock:
            self._check_open()
            return self._lib.eh_total_changes(self._db)

    # Explicit transaction control for the shard-parallel relay ingest:
    # unlike the `transaction()` context manager (which holds this
    # db's lock across its body — correct for the single-writer
    # runtime), these toggle the transaction in one short locked call
    # each, so OTHER threads can run statements inside the open
    # transaction. The caller owns exclusivity: exactly one logical
    # writer per database (the engine assigns one worker per shard).

    def begin(self) -> None:
        with self._lock:
            self._check_open()
            if self._in_txn:
                raise UnknownError("begin inside an open transaction")
            if self._lib.eh_exec(self._db, self._begin_sql) != 0:
                raise self._err()
            self._in_txn = True

    def commit(self) -> None:
        with self._lock:
            self._check_open()
            if not self._in_txn:
                raise UnknownError("commit without an open transaction")
            self._in_txn = False
            if self._lib.eh_exec(self._db, b"COMMIT") != 0:
                raise self._err()

    def rollback(self) -> None:
        with self._lock:
            if not self._db or not self._in_txn:
                return
            self._in_txn = False
            self._lib.eh_exec(self._db, b"ROLLBACK")

    @contextmanager
    def transaction(self):
        with self._lock:
            self._check_open()
            if self._in_txn:
                yield self
                return
            if self._lib.eh_exec(self._db, self._begin_sql) != 0:
                raise self._err()
            self._in_txn = True
            try:
                yield self
            except BaseException:
                self._lib.eh_exec(self._db, b"ROLLBACK")
                raise
            else:
                if self._lib.eh_exec(self._db, b"COMMIT") != 0:
                    raise self._err()
            finally:
                self._in_txn = False

    def set_begin_immediate(self) -> None:
        """See PySqliteDatabase.set_begin_immediate: cross-process
        writers must take the write lock at BEGIN (deferred upgrades
        bypass busy_timeout)."""
        self._begin_sql = b"BEGIN IMMEDIATE"

    def close(self) -> None:
        with self._lock:
            if self._db:
                self._lib.eh_close(self._db)
                self._db = None

    # -- native hot paths --

    def fetch_winners(
        self, cells: Sequence[Tuple[str, str, str]]
    ) -> List[Optional[str]]:
        """Winner timestamp per cell (None = no stored winner)."""
        n = len(cells)
        if n == 0:
            return []
        cap = 64
        out = ctypes.create_string_buffer(n * cap)
        with self._lock:
            self._check_open()
            rc = self._lib.eh_fetch_winners(
                self._db, n,
                _str_array([c[0] for c in cells]),
                _str_array([c[1] for c in cells]),
                _str_array([c[2] for c in cells]),
                out, cap,
            )
        if rc != 0:
            raise self._err()
        res: List[Optional[str]] = []
        for i in range(n):
            raw = out.raw[i * cap : (i + 1) * cap].split(b"\0", 1)[0]
            res.append(raw.decode("utf-8") if raw else None)
        return res

    def apply_sequential(self, messages) -> List[bool]:
        """applyMessages.ts:78-124 for a whole batch in one C call;
        returns the per-message Merkle-XOR mask. Caller manages the
        transaction."""
        n = len(messages)
        if n == 0:
            return []
        kinds, ivals, dvals, svals, blens = _columnar_values([m.value for m in messages])
        out = (ctypes.c_uint8 * n)()
        with self._lock:
            self._check_open()
            rc = self._lib.eh_apply_sequential(
                self._db, n,
                _str_array([m.timestamp for m in messages]),
                _str_array([m.table for m in messages]),
                _str_array([m.row for m in messages]),
                _str_array([m.column for m in messages]),
                kinds, ivals, dvals, svals, blens, out,
            )
        if rc != 0:
            raise self._err()
        return [bool(x) for x in out]

    def apply_planned(self, messages, upsert_mask: Sequence[bool]) -> None:
        """Apply a planner-computed upsert mask + bulk __message insert
        in one C call. Caller manages the transaction.

        Marshalling is packed: one contiguous buffer + int32 lengths
        per string column (`b"".join` at C speed) instead of 100k
        ctypes pointer-array assignments, and every bind carries its
        byte length so embedded NULs round-trip exactly like the
        Python backend."""
        n = len(messages)
        if n == 0:
            return
        i32p = ctypes.POINTER(ctypes.c_int32)

        def packed(items):
            enc = [x.encode("utf-8") for x in items]
            lens = np.fromiter(map(len, enc), np.int32, n)
            return b"".join(enc), lens.ctypes.data_as(i32p), lens

        ts_buf, ts_lens, _k1 = packed([m.timestamp for m in messages])
        tbl_buf, tbl_lens, _k2 = packed([m.table for m in messages])
        row_buf, row_lens, _k3 = packed([m.row for m in messages])
        col_buf, col_lens, _k4 = packed([m.column for m in messages])
        vals = [_encode_value(m.value) for m in messages]
        kinds = np.fromiter((v[0] for v in vals), np.int32, n)
        ivals = np.fromiter((v[1] for v in vals), np.int64, n)
        dvals = np.fromiter((v[2] for v in vals), np.float64, n)
        vlens = np.fromiter((v[4] for v in vals), np.int32, n)
        val_buf = b"".join(v[3] for v in vals if v[3] is not None)
        mask_np = np.ascontiguousarray(np.asarray(upsert_mask, dtype=np.uint8))
        if len(mask_np) != n:  # C reads n bytes; a short buffer would be OOB
            raise ValueError(f"upsert_mask length {len(mask_np)} != messages {n}")
        with self._lock:
            self._check_open()
            rc = self._lib.eh_apply_planned_packed(
                self._db, n,
                ts_buf, ts_lens, tbl_buf, tbl_lens,
                row_buf, row_lens, col_buf, col_lens,
                kinds.ctypes.data_as(i32p),
                ivals.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                dvals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                val_buf, vlens.ctypes.data_as(i32p),
                mask_np.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            )
        if rc == 3:
            raise UnknownError("identifier contains NUL")
        if rc != 0:
            raise self._err()

    def apply_planned_cells(self, pb, upsert_mask) -> None:
        """`eh_apply_planned_cells`: apply a planner-computed upsert
        mask + bulk __message insert for a PackedReceive batch in one C
        call — the buffers flow from the C decrypt straight to the C
        apply with zero per-row Python. Caller manages the
        transaction. End state identical to `apply_planned` on the
        materialized batch (test-pinned)."""
        n = pb.n
        if n == 0:
            return
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        cell_id = np.ascontiguousarray(pb.cell_id, np.int32)
        vkinds = np.ascontiguousarray(pb.vkinds, np.uint8)
        ivals = np.ascontiguousarray(pb.ivals, np.int64)
        dvals = np.ascontiguousarray(pb.dvals, np.float64)
        vlens = np.ascontiguousarray(pb.vlens, np.int32)
        cell_lens = np.ascontiguousarray(pb.cell_lens, np.int32)
        # A slice's text payloads occupy a contiguous vblob span
        # starting at its first row's offset (vlens is 0 for non-text).
        base = int(pb.voffs[0])
        vblob = pb.vblob[base : base + int(vlens.sum())]
        mask_np = np.ascontiguousarray(np.asarray(upsert_mask, dtype=np.uint8))
        if len(mask_np) != n:  # C reads n bytes; a short buffer would be OOB
            raise ValueError(f"upsert_mask length {len(mask_np)} != rows {n}")
        with self._lock:
            self._check_open()
            rc = self._lib.eh_apply_planned_cells(
                self._db, n, pb.ts_slab, len(pb.cells), pb.cell_blob,
                cell_lens.ctypes.data_as(i32p),
                cell_id.ctypes.data_as(i32p),
                vkinds.ctypes.data_as(u8p),
                ivals.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                dvals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                vblob, vlens.ctypes.data_as(i32p),
                mask_np.ctypes.data_as(u8p),
            )
        if rc == 3:
            raise UnknownError("identifier contains NUL")
        if rc == 2:
            raise UnknownError("apply_planned_cells: cell index out of range")
        if rc != 0:
            raise self._err()

    def snapshot_rows(self) -> bytes:
        """Whole-shard snapshot capture in ONE C call: every message
        row + merkleTree row as framed records (server/snapshot.py
        format), byte-identical to the stdlib oracle framing
        (the reference pins it in tests/test_snapshot.py). The caller
        holds the read transaction (consistency across the two internal
        SELECTs)."""
        lib = self._lib
        out = ctypes.c_void_p()
        out_len = ctypes.c_int64()
        n_msgs = ctypes.c_int64()
        n_trees = ctypes.c_int64()
        with self._lock:
            self._check_open()
            rc = lib.eh_snapshot_rows(
                self._db, ctypes.byref(out), ctypes.byref(out_len),
                ctypes.byref(n_msgs), ctypes.byref(n_trees),
            )
        if rc == 3:
            raise UnknownError("snapshot capture failed (out of memory?)")
        if rc != 0:
            raise self._err()
        try:
            return ctypes.string_at(out.value, out_len.value)
        finally:
            lib.eh_free(out)

    def fetch_relay_messages(
        self, user_id: str, since: str, node_id: str
    ) -> List[Tuple[str, bytes]]:
        """The relay's get_messages query with packed outputs: one C
        call, three buffers, no per-row ctypes column reads."""
        lib = self._lib
        ts_buf = ctypes.c_char_p()
        content_buf = ctypes.c_void_p()
        lens_ptr = ctypes.POINTER(ctypes.c_int32)()
        n = ctypes.c_int64(0)
        u = user_id.encode()
        nd = node_id.encode()
        with self._lock:
            self._check_open()
            # Explicit lengths: wire-derived user/node may contain NUL.
            rc = lib.eh_get_messages(
                self._db, u, len(u), since.encode(), nd, len(nd),
                ctypes.byref(ts_buf), ctypes.byref(content_buf),
                ctypes.byref(lens_ptr), ctypes.byref(n),
            )
        if rc == 1:
            raise self._err()
        if rc == 2:
            raise NonCanonicalStoreError("non-canonical timestamp width in relay store")
        if rc != 0:
            raise UnknownError("relay message fetch failed (out of memory?)")
        count = n.value
        try:
            ts_raw = ctypes.string_at(ts_buf, count * 46) if count else b""
            lens = lens_ptr[:count] if count else []
            total = sum(lens)
            content_raw = ctypes.string_at(content_buf, total) if total else b""
        finally:
            lib.eh_free(ts_buf)
            lib.eh_free(content_buf)
            lib.eh_free(ctypes.cast(lens_ptr, ctypes.c_void_p))
        out: List[Tuple[str, bytes]] = []
        off = 0
        for i in range(count):
            ts = ts_raw[i * 46 : (i + 1) * 46].decode("ascii")
            ln = lens[i]
            out.append((ts, content_raw[off : off + ln]))
            off += ln
        return out

    def fetch_relay_messages_wire(
        self, user_id: str, since: str, node_id: str
    ) -> Tuple[bytes, int]:
        """The same query emitted DIRECTLY as the SyncResponse
        `messages` protobuf stream — byte-identical to encoding the
        `fetch_relay_messages` rows with protocol.encode_sync_response,
        with zero per-row Python objects.
        → (stream_bytes, row_count)."""
        lib = self._lib
        out = ctypes.c_void_p()
        out_len = ctypes.c_int64()
        n = ctypes.c_int64(0)
        u = user_id.encode()
        nd = node_id.encode()
        with self._lock:
            self._check_open()
            # Explicit lengths: wire-derived user/node may contain NUL.
            rc = lib.eh_get_messages_wire(
                self._db, u, len(u), since.encode(), nd, len(nd),
                ctypes.byref(out), ctypes.byref(out_len), ctypes.byref(n),
            )
        if rc == 1:
            raise self._err()
        if rc == 2:
            raise NonCanonicalStoreError("non-canonical timestamp width in relay store")
        if rc != 0:
            raise UnknownError("relay message fetch failed (out of memory?)")
        try:
            return ctypes.string_at(out.value, out_len.value), n.value
        finally:
            lib.eh_free(out)

    def relay_insert_packed(
        self,
        group_users: Sequence[str],
        group_counts: Sequence[int],
        ts_packed: bytes,
        content_packed: bytes,
        content_lens,
    ):
        """Grouped one-call ingest for the batch reconciler: timestamps
        as ONE fixed-width 46-byte buffer, ciphertexts as ONE packed
        blob buffer. Returns the per-row was-new flags as a numpy bool
        array (in-batch duplicates dedup through the PK, exactly like
        sequential INSERT OR IGNORE)."""
        n = len(content_lens)
        if n * 46 != len(ts_packed):
            raise UnknownError("relay_insert_packed: timestamp buffer size mismatch")
        if n == 0:
            return np.zeros(0, bool)
        lens = np.ascontiguousarray(content_lens, dtype=np.int32)
        if int(lens.sum()) != len(content_packed):
            raise UnknownError("relay_insert_packed: content buffer size mismatch")
        counts = np.ascontiguousarray(group_counts, dtype=np.int64)
        out = (ctypes.c_uint8 * n)()
        with self._lock:
            self._check_open()
            rc = self._lib.eh_relay_insert_packed(
                self._db, len(group_users),
                _str_array(group_users),
                counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                ts_packed, content_packed,
                lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                out,
            )
        if rc != 0:
            raise self._err()
        return np.frombuffer(out, np.uint8).astype(bool)

    def relay_insert(self, rows: Sequence[Tuple[str, str, bytes]]) -> List[bool]:
        """Bulk INSERT OR IGNORE into the relay's message table; returns
        per-row was-new flags (index.ts:148-159 changes()==1 semantics)."""
        n = len(rows)
        if n == 0:
            return []
        contents = (ctypes.c_char_p * n)()
        lens = (ctypes.c_int32 * n)()
        for j, (_, _, content) in enumerate(rows):
            contents[j] = content
            lens[j] = len(content)
        out = (ctypes.c_uint8 * n)()
        with self._lock:
            self._check_open()
            rc = self._lib.eh_relay_insert(
                self._db, n,
                _str_array([r[0] for r in rows]),
                _str_array([r[1] for r in rows]),
                contents, lens, out,
            )
        if rc != 0:
            raise self._err()
        return [bool(x) for x in out]


def open_database(path: str = ":memory:", backend: str = "auto"):
    """Open the storage backend: "native" (C++ layer), "python"
    (stdlib sqlite3), or "auto" (native when buildable)."""
    from evolu_tpu_torch.storage.sqlite import PySqliteDatabase

    if backend not in ("auto", "native", "python"):
        raise ValueError(f"unknown storage backend {backend!r}")
    if backend == "python":
        return PySqliteDatabase(path)
    if backend == "native":
        return CppSqliteDatabase(path)
    if native_available():
        return CppSqliteDatabase(path)
    return PySqliteDatabase(path)
