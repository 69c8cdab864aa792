"""Port parity: the C++ SQLite host layer and its loader.

The port's `storage.native.CppSqliteDatabase` (its own build of the
unchanged `native/evolu_host.cpp`, `utils.native_loader`) against the
JAX package's `evolu_tpu.storage.native.CppSqliteDatabase` on the same
numpy-seeded inputs: the relay's packed insert and its was-new flags,
the response stream, the sequential and planned applies, the winner
lookup, the packed query reader and `parse_packed_timestamps`. Every
output is integer, bytes or SQLite text, so equality is exact."""

import os
import subprocess
import sys

import numpy as np
import pytest

from evolu_tpu.core.timestamp import Timestamp, timestamp_to_string
from evolu_tpu.core.types import CrdtMessage as JaxMessage
from evolu_tpu.core.types import TimestampParseError as JaxParseError
from evolu_tpu.ops.host_parse import parse_packed_timestamps as jax_parse_packed
from evolu_tpu.storage import native as jn
from evolu_tpu.storage.schema import init_db_model as jax_init
from evolu_tpu.sync import native_crypto as jnc
from evolu_tpu.sync import protocol as jproto

from evolu_tpu_torch.core.types import CrdtMessage, TimestampParseError
from evolu_tpu_torch.ops.host_parse import parse_packed_timestamps, parse_timestamp_strings
from evolu_tpu_torch.storage import native as pn
from evolu_tpu_torch.storage.schema import init_db_model
from evolu_tpu_torch.storage.sqlite import PySqliteDatabase
from evolu_tpu_torch.sync import native_crypto as pnc
from evolu_tpu_torch.utils import native_loader

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MN = "legal winner thank year wave sausage worth useful legal winner thank yellow"
BASE = 1_700_000_000_000
NODES = ("00000000000000a1", "c3c3c3c3c3c3c3c3", "fedcba9876543210")
APP_DDL = ('CREATE TABLE IF NOT EXISTS "todo" ("id" TEXT PRIMARY KEY, "title" BLOB, "isCompleted" BLOB)',
           'CREATE TABLE IF NOT EXISTS "todoCategory" ("id" TEXT PRIMARY KEY, "title" BLOB, '
           '"isCompleted" BLOB)')
RELAY_DDL = ('CREATE TABLE IF NOT EXISTS "message" ("timestamp" TEXT, "userId" TEXT, "content" BLOB, '
             'PRIMARY KEY ("userId", "timestamp")) WITHOUT ROWID',
             'CREATE TABLE IF NOT EXISTS "merkleTree" ("userId" TEXT PRIMARY KEY, "merkleTree" TEXT)')


def _pair(ddl=(), model=False):
    """(JAX db, port db), both native, with `ddl` run on each, and with
    `model` the client model (`__message`, `__clock`, `__owner`)."""
    j, p = jn.CppSqliteDatabase(), pn.CppSqliteDatabase()
    for sql in ddl:
        j.exec(sql)
        p.exec(sql)
    if model:
        jax_init(j, MN)
        init_db_model(p, MN)
    return j, p


def _dump(db, tables):
    return [db.exec(f'SELECT * FROM "{t}" ORDER BY 1, 2') for t in tables]


def _messages(rng, n, rows=20, unique=True):
    """n message tuples over todo/todoCategory: contention on `rows` rows,
    unicode, NUL-bearing and int64-extreme values, unique timestamps
    unless `unique` is False (then some repeat: duplicates)."""
    values = (None, "x", "título ✓", "a\x00b", 2**63 - 1, -(2**63), 0.25, "")
    out, seen = [], set()
    while len(out) < n:
        ts = timestamp_to_string(Timestamp(BASE + int(rng.integers(0, 4_000_000)),
                                           int(rng.integers(0, 3)), NODES[int(rng.integers(0, 3))]))
        if unique and ts in seen:
            continue
        seen.add(ts)
        out.append((ts, ("todo", "todoCategory")[int(rng.integers(0, 2))], f"row{int(rng.integers(0, rows))}",
                    ("title", "isCompleted")[int(rng.integers(0, 2))], values[int(rng.integers(0, len(values)))]))
    return out


def test_libraries_build_into_the_port_tree_from_the_unchanged_sources():
    """Both libraries are the port's own builds under `_build/native/`,
    the C++ sources in `native/` untouched by the build."""
    sources = {n: os.path.getmtime(os.path.join(_REPO, "native", n))
               for n in ("evolu_host.cpp", "evolu_crypto.cpp", "wire.h")}
    assert pn.native_available() and pnc.native_available()
    root = os.path.join(_REPO, "evolu_tpu_torch", "_build", "native")
    for so in ("libevolu_host.so", "libevolu_crypto.so"):
        path = native_loader.build_info[so]["path"]
        assert os.path.commonpath([path, root]) == root and os.path.basename(path) == so
    assert {n: os.path.getmtime(os.path.join(_REPO, "native", n)) for n in sources} == sources


def test_failed_build_raises_its_log_and_auto_falls_back(tmp_path, monkeypatch):
    """A compiler that refuses the flags: the explicit native caller gets
    the compiler's own message, `native_available` says no, and "auto"
    opens the Python backend (the reference's semantics)."""
    monkeypatch.setattr(native_loader, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(native_loader, "CXXFLAGS", native_loader.CXXFLAGS + ("-fno-such-option-x",))
    monkeypatch.setitem(native_loader._cache, pn.SO_NAME, None)
    with pytest.raises(native_loader.NativeBuildError, match="no-such-option"):
        pn.CppSqliteDatabase()
    with pytest.raises(native_loader.NativeBuildError, match="no-such-option"):
        pn.open_database(backend="native")
    assert not pn.native_available()
    assert "no-such-option" in native_loader.build_info[pn.SO_NAME]["log"]
    assert isinstance(pn.open_database(backend="auto"), PySqliteDatabase)
    assert not list(tmp_path.rglob("*.so")) and not list(tmp_path.rglob("*.tmp"))
    with pytest.raises(ValueError, match="backend"):
        pn.open_database(backend="sqlite4")


_CONCURRENT = r"""
import sys
from pathlib import Path
sys.path.insert(0, sys.argv[1])
from evolu_tpu_torch.utils import native_loader
native_loader.BUILD_ROOT = Path(sys.argv[2])
from evolu_tpu_torch.storage import native
db = native.CppSqliteDatabase()
db.exec("CREATE TABLE t (a)")
print("OK", native_loader.build_info["libevolu_host.so"]["path"])
"""


def test_concurrent_first_builds_load_one_whole_library(tmp_path):
    """Four processes building the same library at once (test workers do)
    all load it; one library is left and no temporary name."""
    procs = [subprocess.Popen([sys.executable, "-c", _CONCURRENT, _REPO, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _o, e in outs]
    paths = {o.split()[1] for o, _e in outs}
    assert len(paths) == 1 and all(o.startswith("OK") for o, _e in outs)
    assert len(list(tmp_path.rglob("libevolu_host.so"))) == 1
    assert not list(tmp_path.rglob("*.tmp"))


def test_open_database_backends():
    assert isinstance(pn.open_database(backend="auto"), pn.CppSqliteDatabase)
    assert isinstance(pn.open_database(backend="native"), pn.CppSqliteDatabase)
    assert isinstance(pn.open_database(backend="python"), PySqliteDatabase)


def test_relay_insert_packed_was_new_flags_match_jax():
    """Grouped one-call inserts with in-batch duplicates and rows stored
    by an earlier call: the same flags and tables."""
    rng = np.random.default_rng(1)
    j, p = _pair(RELAY_DDL)
    owners = ["alice", "bob", "carol"]
    for _ in range(3):
        groups = [(o, _messages(rng, int(rng.integers(1, 40)), unique=False)) for o in owners]
        # Repeat some rows of the first group inside the batch.
        groups.append((owners[0], groups[0][1][: len(groups[0][1]) // 2]))
        gu = [o for o, _m in groups]
        gc = [len(m) for _o, m in groups]
        ts = "".join(t[0] for _o, m in groups for t in m).encode()
        contents = [rng.bytes(int(rng.integers(0, 60))) for _o, m in groups for _t in m]
        lens = np.array([len(c) for c in contents], np.int32)
        flags = [db.relay_insert_packed(gu, gc, ts, b"".join(contents), lens) for db in (j, p)]
        assert np.array_equal(flags[0], flags[1]) and flags[1].dtype == bool
        assert 0 < flags[1].sum() < len(contents)
        assert _dump(j, ["message"]) == _dump(p, ["message"])
    rows = [(t, "dave", rng.bytes(8)) for t, *_r in _messages(rng, 30)]
    assert j.relay_insert(rows + rows[:5]) == p.relay_insert(rows + rows[:5])


def test_fetch_relay_messages_wire_bytes_match_jax():
    rng = np.random.default_rng(2)
    j, p = _pair(RELAY_DDL)
    rows = [(t, o, rng.bytes(int(rng.integers(1, 50)))) for o in ("u1", "u2")
            for t, *_r in _messages(rng, 60)]
    for db in (j, p):
        db.relay_insert(rows)
    stamps = sorted(r[0] for r in rows)
    for since in (stamps[0][:24] + "-0000-0000000000000000", stamps[30], stamps[-1]):
        for node in NODES + ("0" * 16,):
            for user in ("u1", "u2", "nobody"):
                assert j.fetch_relay_messages_wire(user, since, node) == \
                    p.fetch_relay_messages_wire(user, since, node)
                assert j.fetch_relay_messages(user, since, node) == p.fetch_relay_messages(user, since, node)


def test_apply_sequential_masks_match_jax():
    rng = np.random.default_rng(3)
    j, p = _pair(APP_DDL, model=True)
    for _ in range(3):
        batch = _messages(rng, 150, rows=8)
        batch += batch[:20]  # re-delivered rows
        jm = j.apply_sequential([JaxMessage(*t) for t in batch])
        pm = p.apply_sequential([CrdtMessage(*t) for t in batch])
        assert jm == pm and any(pm) and not all(pm)
        assert _dump(j, ["todo", "todoCategory"]) == _dump(p, ["todo", "todoCategory"])


def _response(tuples, tree="{}"):
    enc = jnc.encrypt_batch([JaxMessage(*t) for t in tuples], MN)
    return jproto.encode_sync_response(jproto.SyncResponse(tuple(enc), tree))


def test_apply_planned_and_planned_cells_match_jax():
    """The planned apply with one mask, from message objects and from the
    packed columns both packages decode from one response."""
    rng = np.random.default_rng(4)
    for cells in (False, True):
        j, p = _pair(APP_DDL, model=True)
        for _ in range(2):
            batch = _messages(rng, 200, rows=12)
            mask = rng.integers(0, 2, len(batch)).astype(bool)
            if cells:
                body = _response(batch)
                jpb, _ = jnc.decrypt_response_columns(body, MN)
                ppb, _ = pnc.decrypt_response_columns(body, MN)
                j.apply_planned_cells(jpb[5:150], mask[5:150])
                p.apply_planned_cells(ppb[5:150], mask[5:150])
            else:
                j.apply_planned([JaxMessage(*t) for t in batch], mask)
                p.apply_planned([CrdtMessage(*t) for t in batch], mask)
            tables = ["__message", "todo", "todoCategory"]
            assert _dump(j, tables) == _dump(p, tables)
        with pytest.raises(ValueError, match="upsert_mask"):
            p.apply_planned([CrdtMessage(*t) for t in batch], mask[:-1])


def test_fetch_winners_match_jax():
    rng = np.random.default_rng(5)
    j, p = _pair(APP_DDL, model=True)
    batch = _messages(rng, 300, rows=15)
    j.apply_sequential([JaxMessage(*t) for t in batch])
    p.apply_sequential([CrdtMessage(*t) for t in batch])
    cells = sorted({t[1:4] for t in batch}) + [("todo", "nobody", "title")]
    assert j.fetch_winners(cells) == p.fetch_winners(cells)
    assert p.fetch_winners([]) == []


def test_packed_query_reader_matches_jax():
    """`exec_sql_query_packed_raw` bytes and offsets, and both unpackers
    (full, and row-granular after edits, appends and deletes)."""
    rng = np.random.default_rng(6)
    j, p = _pair(APP_DDL)
    rows = [(f"id{i:03d}", v, None if i % 5 else b"\x00\x01blob")
            for i, (_t, _a, _r, _c, v) in enumerate(_messages(rng, 60))]
    for db in (j, p):
        db.run_many('INSERT INTO "todo" VALUES (?, ?, ?)', rows)
    q = 'SELECT * FROM "todo" ORDER BY "id"'
    jraw, joffs = j.exec_sql_query_packed_raw(q, (), with_offsets=True)
    praw, poffs = p.exec_sql_query_packed_raw(q, (), with_offsets=True)
    assert jraw == praw and np.array_equal(joffs, poffs)
    assert pn.unpack_packed_rows(praw) == jn.unpack_packed_rows(jraw) == j.exec_sql_query(q)
    prev_rows = pn.unpack_packed_rows(praw)
    for db in (j, p):
        db.run('UPDATE "todo" SET "title" = ? WHERE "id" = ?', ("changed", "id007"))
        db.run('DELETE FROM "todo" WHERE "id" = ?', ("id059",))
        db.run('INSERT INTO "todo" VALUES (?, ?, ?)', ("id999", 7, None))
    jraw2, joffs2 = j.exec_sql_query_packed_raw(q, (), with_offsets=True)
    praw2, poffs2 = p.exec_sql_query_packed_raw(q, (), with_offsets=True)
    assert jraw2 == praw2
    got = pn.unpack_changed_rows(praw2, poffs2, praw, poffs, prev_rows)
    assert got == jn.unpack_changed_rows(jraw2, joffs2, jraw, joffs, jn.unpack_packed_rows(jraw))
    assert got == pn.unpack_packed_rows(praw2)
    assert got[0] is prev_rows[0]  # unchanged rows keep their dicts
    assert p.exec_sql_query(q, ()) == j.exec_sql_query(q, ())


def test_parse_packed_timestamps_matches_jax():
    rng = np.random.default_rng(7)
    stamps = [t[0] for t in _messages(rng, 500)]
    stamps[3] = stamps[3][:30] + stamps[3][30:].upper()  # upper-case node hex: case_ok False
    stamps[9] = stamps[9][:25] + "00ab" + stamps[9][29:]  # lower-case counter hex
    packed = "".join(stamps).encode()
    got = parse_packed_timestamps(packed, len(stamps), with_case=True)
    want = jax_parse_packed(packed, len(stamps), with_case=True)
    for g, w in zip(got, want):
        assert np.array_equal(g, w) and g.dtype == w.dtype
    assert not got[3][3] and not got[3][9] and got[3].sum() == len(stamps) - 2
    for g, w in zip(got[:3], parse_timestamp_strings(stamps)):
        assert np.array_equal(g, w)
    bad = stamps[:]
    bad[7] = bad[7][:5] + "13" + bad[7][7:]  # month 13
    for parse, err in ((parse_packed_timestamps, TimestampParseError), (jax_parse_packed, JaxParseError)):
        with pytest.raises(err):
            parse("".join(bad).encode(), len(bad))
        with pytest.raises(err):
            parse(packed[:-1], len(stamps))


def test_sequential_and_planned_apply_on_the_port_backend_match_jax():
    """The port's apply routes on its native backend (`apply_messages_sequential`
    in one C call, `apply_messages` with `apply_planned` and the native
    winner lookup) against the JAX package's on its native backend."""
    from evolu_tpu.core.merkle import merkle_tree_to_string as jax_tree_string
    from evolu_tpu.storage.apply import apply_messages as jax_apply
    from evolu_tpu.storage.apply import apply_messages_sequential as jax_seq
    from evolu_tpu_torch.core.merkle import merkle_tree_to_string
    from evolu_tpu_torch.storage import apply as papply

    rng = np.random.default_rng(8)
    for fn, jfn in ((papply.apply_messages_sequential, jax_seq), (papply.apply_messages, jax_apply)):
        j, p = _pair(APP_DDL, model=True)
        jt, pt_ = {}, {}
        before = dict(papply.counts)
        for _ in range(3):
            batch = _messages(rng, 120, rows=10)
            batch += batch[:10]
            jt = jfn(j, jt, [JaxMessage(*t) for t in batch])
            pt_ = fn(p, pt_, [CrdtMessage(*t) for t in batch])
            assert jax_tree_string(jt) == merkle_tree_to_string(pt_)
            tables = ["__message", "todo", "todoCategory"]
            assert _dump(j, tables) == _dump(p, tables)
        route = "native_sequential" if fn is papply.apply_messages_sequential else "object"
        assert papply.counts[route] - before[route] == 3
