"""Write-behind shard drain child: one process per drain worker.

The port's copy of `evolu_tpu.storage._wb_shard_proc`; run it as `python -m
evolu_tpu_torch.storage._wb_shard_proc --shard <index>=<path> ...`.

The pure-Python sqlite3 insert leg holds the GIL, so thread-per-shard
workers cannot overlap it; in this child they do: the parent worker
ships each shard batch over a pipe and blocks in the read (GIL dropped)
while THIS process runs the transaction. File-backed shards only; cross-process safety is the
same WAL + busy_timeout + BEGIN IMMEDIATE discipline file-backed
relay stores run (`sqlite.configure_shared_file_db`).

Frame protocol (stdin → stdout, little-endian u32 lengths):

    request:  u32 header_len | header JSON | u32 blob_len | blob
      header = {"si", "exact", "taint": [owner...],
                "ops": [{"u", "k", "lens": [int...], "tree": str|null}]}
      blob   = all ops' ts_packed (46B/row) concatenated in op order,
               then all ops' content bytes in op order
    response: u32 len | JSON {"ok": true, "tainted": [...],
                              "counts": [[n_new, n_dup]...]}
              or {"ok": false, "error": "..."}

The child counts nothing: the parent counts from the returned counts iff
the response arrives (a child killed mid-transaction rolled back; killed
after its commit, the parent's retry re-classifies the committed rows as
duplicates, the rule replay runs). EOF on stdin is a clean shutdown.
"""

from __future__ import annotations

import json
import struct
import sys

import numpy as np

from evolu_tpu_torch.storage.sqlite import PySqliteDatabase, configure_shared_file_db
from evolu_tpu_torch.storage.write_behind import apply_shard_ops

_U32 = struct.Struct("<I")


def _read_exact(stream, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = stream.read(n - len(buf))
        if not chunk:
            if buf:
                raise EOFError("torn write-behind shard frame")
            raise EOFError("eof")
        buf += chunk
    return buf


def _get_tree(db):
    def get(owner: str) -> str:
        rows = db.exec_sql_query(
            'SELECT "merkleTree" FROM "merkleTree" WHERE "userId" = ?',
            (owner,),
        )
        return rows[0]["merkleTree"] if rows else "{}"
    return get


def _serve(shard_paths) -> None:
    stdin = sys.stdin.buffer
    stdout = sys.stdout.buffer
    dbs = {}
    while True:
        try:
            (hl,) = _U32.unpack(_read_exact(stdin, 4))
        except EOFError:
            break
        header = json.loads(_read_exact(stdin, hl).decode("utf-8"))
        (bl,) = _U32.unpack(_read_exact(stdin, 4))
        blob = _read_exact(stdin, bl)
        try:
            si = int(header["si"])
            db = dbs.get(si)
            if db is None:
                db = dbs[si] = PySqliteDatabase(shard_paths[si])
                configure_shared_file_db(db)
            ops = []
            rows = sum(int(op["k"]) for op in header["ops"])
            ts_off, c_off = 0, rows * 46
            for op in header["ops"]:
                k = int(op["k"])
                lens = np.asarray(op["lens"], dtype=np.int32)
                nb = int(lens.sum())
                ops.append((
                    op["u"], k,
                    blob[ts_off : ts_off + k * 46],
                    blob[c_off : c_off + nb],
                    lens, op["tree"],
                ))
                ts_off += k * 46
                c_off += nb
            tainted, counts = apply_shard_ops(
                db, _get_tree(db), ops,
                bool(header["exact"]), set(header["taint"]),
            )
            body = json.dumps({
                "ok": True,
                "tainted": sorted(tainted),
                "counts": [[int(a), int(b)] for a, b in counts],
            }).encode("utf-8")
        except Exception as e:  # noqa: BLE001 - report, keep serving
            body = json.dumps({"ok": False, "error": repr(e)}).encode("utf-8")
        stdout.write(_U32.pack(len(body)) + body)
        stdout.flush()
    for db in dbs.values():
        db.close()


def main(argv) -> None:
    shard_paths = {}
    it = iter(argv)
    for a in it:
        if a == "--shard":
            si, _, path = next(it).partition("=")
            shard_paths[int(si)] = path
    _serve(shard_paths)


if __name__ == "__main__":
    main(sys.argv[1:])
