"""The relay cells: a batching relay on the card, taking sync POSTs over
HTTP from closed-loop client lanes in a process of their own.

Set-up writes the configuration's preloaded store (every owner's history
and Merkle tree) with the stdlib's sqlite3, starts the load process, which
makes its first bodies meanwhile, opens the store as the program's
`RelayStore` on its native backend and serves it from
`RelayServer(batching=True)`, the relay whose sync POSTs take the
engine's device leg. It warms the engine at every row bucket the mix can
reach, on a throwaway store, and the live relay with answers that change
nothing. The window starts with the lanes' first requests and ends when
the last request sent in it is answered.

Once the relay has stopped, the plain relay (`reference/relay.py`)
replays each owner's requests in the order the owner sent them and
judges every answer's bytes; then it reads the store back and judges each
owner's rows and Merkle tree. Each is an exact comparison: its limit is 0.
"""

from __future__ import annotations

import dataclasses
import json
import multiprocessing
import os
import shutil
import sqlite3
import statistics
import sys
import tempfile
import threading
import time
from typing import Dict, Optional

import numpy as np

from portbench.gen import load
from portbench.gen.relay_sync import OwnerStream, RelayData
from portbench.reference import merkle
from portbench.reference.relay import RelayReference

# What a run can break on purpose (the tests and the control runs):
# acknowledge a pass without storing it, store only the first half of a
# pass's requests, or alter one answer of each pass where it is produced.
FAULTS = ("unchanged", "half_batch", "altered_answer")


# Bumped whenever the preload's layout changes, so a cached store is rebuilt.
STORE_LAYOUT = 1
CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_cache")


def cached_store(config: dict, data: RelayData) -> str:
    """The configuration's preloaded store, written once a checkout under
    `portbench/_cache/` (it depends on the configuration alone, never on
    the seed). → its path."""
    import hashlib

    key = hashlib.sha256(json.dumps([STORE_LAYOUT, config], sort_keys=True).encode()).hexdigest()[:16]
    path = os.path.join(CACHE, f"{config['name']}-{key}.db")
    if not os.path.exists(path):
        os.makedirs(CACHE, exist_ok=True)
        part = path + ".part"
        if os.path.exists(part):
            os.remove(part)
        write_store(part, data)
        os.replace(part, path)
    return path


def stored_trees(path: str, data: RelayData) -> Dict[int, str]:
    db = sqlite3.connect(f"file:{path}?mode=ro", uri=True)
    users = {data.user(o): o for o in range(data.owners)}
    trees = {users[u]: t for u, t in db.execute('SELECT "userId", "merkleTree" FROM "merkleTree"') if u in users}
    db.close()
    return trees


def write_store(path: str, data: RelayData) -> None:
    """The preloaded store in the program's schema (server/relay.py
    `RelayStore`): every owner's history and Merkle tree."""
    db = sqlite3.connect(path)
    db.execute('CREATE TABLE "message" ("timestamp" TEXT, "userId" TEXT, "content" BLOB, '
               'PRIMARY KEY ("userId", "timestamp")) WITHOUT ROWID')
    db.execute('CREATE TABLE "merkleTree" ("userId" TEXT PRIMARY KEY, "merkleTree" TEXT)')
    db.execute("PRAGMA synchronous=OFF")
    chunk = 50
    with db:
        for start in range(0, data.owners, chunk):
            owners = np.arange(start, min(start + chunk, data.owners))
            o, millis, counter, nodes, content = data.preload_columns(owners)
            ts = merkle.ts_rows(millis, counter, nodes)
            hashes = merkle.murmur3_rows(ts)
            strings = ts.view(f"S{merkle.TS_LEN}").ravel().astype(str)
            users = [data.user(x) for x in owners.tolist()]
            rows = data.pool[content]
            db.executemany('INSERT INTO "message" VALUES (?, ?, ?)',
                           ((strings[i], users[i // data.per_owner], rows[i].tobytes()) for i in range(len(o))))
            trees = []
            for k, x in enumerate(owners.tolist()):
                sl = slice(k * data.per_owner, (k + 1) * data.per_owner)
                trees.append((data.user(x), merkle.tree_to_string(merkle.tree_from_rows(millis[sl], hashes[sl]))))
            db.executemany('INSERT INTO "merkleTree" VALUES (?, ?)', trees)
    db.close()


def read_store(path: str, data: RelayData):
    """Each owner's rows digest and stored tree string, read back with
    sqlite3 (the relay has stopped)."""
    import hashlib

    db = sqlite3.connect(f"file:{path}?mode=ro", uri=True)
    digests, trees, others = {}, {}, set()
    users = {data.user(o): o for o in range(data.owners)}
    cur, h = None, None
    for user, ts, content in db.execute(
            'SELECT "userId", "timestamp", "content" FROM "message" ORDER BY "userId", "timestamp"'):
        if user != cur:
            if cur is not None:
                digests[cur] = h.digest()
            cur, h = user, hashlib.sha256()
        h.update(ts.encode())
        h.update(content)
    if cur is not None:
        digests[cur] = h.digest()
    for user, tree in db.execute('SELECT "userId", "merkleTree" FROM "merkleTree"'):
        trees[user] = tree
    db.close()
    others = (set(digests) | set(trees)) - set(users)
    return ({users[u]: d for u, d in digests.items() if u in users},
            {users[u]: t for u, t in trees.items() if u in users}, others)


def inject(fault: Optional[str]):
    """Break the engine's pass on purpose (see FAULTS). → the undo."""
    from evolu_tpu_torch.server.engine import BatchReconciler

    orig = BatchReconciler.run_batch_wire
    if fault is None:
        return lambda: None
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")

    def broken(self, requests):
        if fault == "unchanged":
            return orig(self, [dataclasses.replace(r, messages=()) for r in requests])
        if fault == "half_batch":
            keep = (len(requests) + 1) // 2
            return orig(self, [r if i < keep else dataclasses.replace(r, messages=())
                               for i, r in enumerate(requests)])
        outs = list(orig(self, requests))
        outs[-1] = outs[-1][:-1] + bytes([outs[-1][-1] ^ 1])
        return outs

    BatchReconciler.run_batch_wire = broken

    def undo():
        BatchReconciler.run_batch_wire = orig
    return undo


def warm_engine(data: RelayData, mix: dict, device) -> int:
    """One engine pass at each power-of-two row bucket the mix can reach
    (lanes x the largest push), on a throwaway in-memory store. → passes."""
    from evolu_tpu_torch.ops import bucket_size
    from evolu_tpu_torch.server.engine import BatchReconciler
    from evolu_tpu_torch.server.relay import RelayStore
    from evolu_tpu_torch.sync import protocol

    if float(mix["push_share"]) <= 0:
        return 0
    most = bucket_size(int(mix["devices"]) * int(mix["push_sizes"][1]))
    per = int(mix["push_sizes"][1])
    store = RelayStore(":memory:", backend="native")
    eng = BatchReconciler(store, device=device)
    passes, size, q0 = 0, 64, 0
    try:
        while size <= most:
            reqs = []
            for k, start in enumerate(range(0, size, per)):
                n = min(per, size - start)
                q = np.arange(q0, q0 + n, dtype=np.int64)
                q0 += n
                node = data.node(k, data.devices)
                ts = merkle.ts_rows(data.push_base + q // data.push_per_ms, q % data.push_per_ms,
                                    merkle.node_rows([node] * n))
                msgs = tuple(protocol.EncryptedCrdtMessage(bytes(t).decode(), bytes(c))
                             for t, c in zip(ts, data.pool[q % len(data.pool)]))
                reqs.append(protocol.SyncRequest(msgs, f"warm{k:04d}", node, "{}"))
            eng.run_batch_wire(reqs)
            passes += 1
            size *= 2
    finally:
        eng.close()
        store.close()
    return passes


class SpanDrain:
    """Copies the program's trace ring (a bounded deque) every `every`
    seconds, so no span of the window is overwritten before it is read."""

    def __init__(self, every: float = 0.2):
        from evolu_tpu_torch.obs import trace

        self.recorder, self.every = trace.recorder, every
        self.spans: Dict[str, object] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _take(self) -> None:
        for s in self.recorder.dump():
            self.spans[s.span_id] = s

    def _run(self) -> None:
        while not self._stop.wait(self.every):
            self._take()

    def stop(self):
        self._stop.set()
        self._thread.join()
        self._take()
        return list(self.spans.values())


def receive(pipe, proc, timeout: float):
    """The load process's next message; raises if it died or said nothing
    within `timeout` seconds."""
    deadline = time.monotonic() + timeout
    while not pipe.poll(0.2):
        if not proc.is_alive():
            raise RuntimeError(f"the load process exited with code {proc.exitcode}")
        if time.monotonic() > deadline:
            raise RuntimeError(f"the load process said nothing for {timeout:.0f} s")
    return pipe.recv()


HISTOGRAMS = {"sched_batch_requests": ("evolu_sched_batch_requests", {}),
              "sched_batch_ms": ("evolu_sched_batch_ms", {}),
              "host_apply_ms": ("evolu_stage_ms", {"stage": "host_apply"})}


def histograms() -> Dict[str, tuple]:
    from evolu_tpu_torch.obs import metrics

    out = {}
    for key, (name, labels) in HISTOGRAMS.items():
        h = metrics.registry.get_histogram(name, **labels)
        out[key] = (0.0, 0) if h is None else (h[2], h[3])
    return out


def run(ctx) -> dict:
    """One run of a relay cell. `ctx`: config, mix, seed, seconds, trace,
    device ("cuda" or "cpu"), fault, t_start. → the cell's readings."""
    config, mix, seed = ctx["config"], ctx["mix"], ctx["seed"]
    data = RelayData(config)
    phases = {}
    tmp = tempfile.mkdtemp(prefix="portbench-relay-")
    mp = multiprocessing.get_context("spawn")
    parent, child = mp.Pipe()
    proc = mp.Process(target=load.main, args=(child,))
    proc.start()
    server = None
    undo = lambda: None  # noqa: E731
    try:
        parent.send((config, mix, seed))
        if ctx["device"] == "cuda":
            from portbench.harness import require_cuda

            require_cuda(int(ctx["cell"]["chips"]))
        path = os.path.join(tmp, "relay.db")
        shutil.copyfile(cached_store(config, data), path)
        # The copy's dirty pages go to disk now, not inside the window.
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        preload_trees = stored_trees(path, data)
        phases["store"] = time.perf_counter() - ctx["t_start"]

        import torch

        from evolu_tpu_torch.server.relay import RelayServer, RelayStore

        phases["import"] = time.perf_counter() - ctx["t_start"]
        device = None if ctx["device"] == "cuda" else ctx["device"]
        store_cfg = config["store"]
        warm_passes = warm_engine(data, mix, device)
        phases["warm"] = time.perf_counter() - ctx["t_start"]
        undo = inject(ctx.get("fault"))
        server = RelayServer(RelayStore(path, backend=store_cfg["backend"]), batching=store_cfg["batching"],
                             connection_tier=store_cfg["connection_tier"],
                             write_behind=store_cfg["write_behind"], device=device).start()
        host, port = server._httpd.server_address[:2]
        # The live relay's engine is made at its first pass: answers that
        # store nothing (each owner's whole tree, no messages).
        for o in range(min(4, data.owners)):
            body = load.wire.request(b"", data.user(o), data.node(o, 0), preload_trees[o])
            status, _ = load.post(host, port, body)
            if status != 200:
                raise RuntimeError(f"the relay answered {status} to a warm-up request")
        dtrace = None
        if ctx["trace"] and ctx["device"] == "cuda":
            from portbench.devtrace import DeviceTrace

            dtrace = DeviceTrace(torch)
            dtrace.prepare()
        phases["relay"] = time.perf_counter() - ctx["t_start"]
        tag, prep_s = receive(parent, proc, 300)
        if tag != "ready":
            raise RuntimeError(f"the load process said {tag!r}")
        drain = None
        if ctx["trace"]:
            drain = SpanDrain()
            hist0 = histograms()
        if dtrace is not None:
            dtrace.start()
        setup_s = time.perf_counter() - ctx["t_start"]
        parent.send(("go", ctx["seconds"], host, port))
        tag, start, records, late_s, late_n = receive(parent, proc, ctx["seconds"] + 300)
        t_end = max([r[7] for r in records], default=start)
        if dtrace is not None:
            dtrace.stop()
        obs = {}
        if ctx["trace"]:
            obs["spans"] = drain.stop()
            hist1 = histograms()
            obs["hist"] = {k: (hist1[k][0] - hist0[k][0], hist1[k][1] - hist0[k][1]) for k in hist1}
            obs["device"] = dtrace.summary() if dtrace is not None else None
        mem_peak = torch.cuda.max_memory_allocated() if ctx["device"] == "cuda" else 0
        server.stop()
        server = None
        proc.join(timeout=60)
    finally:
        undo()
        if server is not None:
            server.stop()
        if proc.is_alive():
            proc.terminate()
            proc.join(timeout=30)
    try:
        checks = judge(data, mix, seed, records, path, preload_trees)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    window = t_end - start
    ok = [r for r in records if r[5] == 200]
    msgs = sum(r[3] + r[4] for r in ok)
    lat = sorted((r[7] - r[6]) * 1e3 if r[5] == 200 else float("inf") for r in records)
    p95 = float(np.percentile(np.array(lat), 95)) if lat else float("inf")
    late_share = late_s / max(window * int(mix["devices"]), 1e-9)
    if late_share > 0.01:
        raise RuntimeError(f"the generator ran dry: lanes waited {late_s:.3f} s for bodies "
                           f"({late_n} times, {late_share:.2%} of lane time)")
    slices = []
    for k in range(int(window // 5)):
        a, b = start + 5 * k, start + 5 * (k + 1)
        slices.append(round(sum(r[3] + r[4] for r in ok if a <= r[7] < b) / 5))
    p95_ms = p95 if p95 != float("inf") else 1e9
    obs["traffic"] = {"rows_pushed": sum(r[3] for r in ok if r[2]), "requests": len(records),
                      "window_s": window, "p95_ms": p95_ms}
    info = {"requests": len(records), "ok": len(ok), "messages": msgs, "window_s": window,
            "pushes": sum(1 for r in records if r[2]), "rows_up": sum(r[3] for r in ok),
            "rows_down": sum(r[4] for r in ok), "generator_prep_s": prep_s, "generator_late_s": late_s,
            "generator_late_n": late_n, "warm_passes": warm_passes, "setup_phases_s": phases,
            "rate_slices_5s": slices, "latency_ms_p50": float(statistics.median(lat)) if lat else None}
    print(f"portbench: {json.dumps(info)}", file=sys.stderr)
    return {"attempted": len(records), "failed": len(records) - len(ok),
            "e2e": {"sync_msgs_s": msgs / window if window > 0 else 0.0,
                    "sync_p95_ms": p95_ms,
                    "setup_s": setup_s},
            "obs": obs, "memory_peak_bytes": int(mem_peak), "checks": checks}


def judge(data: RelayData, mix: dict, seed: int, records, path: str, preload_trees: Dict[int, str]) -> dict:
    """The plain relay's verdict on every answer, and on the store it
    left: {name: (count, limit)}."""
    import hashlib

    ref = RelayReference(data)
    by_owner: Dict[int, list] = {}
    for r in records:
        by_owner.setdefault(r[0], []).append(r)
    wrong = 0
    for o, rs in by_owner.items():
        stream = OwnerStream(data, mix, seed, o)
        for r in sorted(rs, key=lambda r: r[1]):
            req = stream.next()  # an owner's requests go out in stream order
            if req.j != r[1]:
                raise RuntimeError(f"owner {o}: request {r[1]} answered, request {req.j} expected")
            want = ref.serve(req, stored=r[5] == 200)
            if r[5] == 200 and hashlib.sha256(want).digest() != r[8]:
                wrong += 1
    digests, trees, others = read_store(path, data)
    rows_wrong = trees_wrong = 0
    for o in range(data.owners):
        if digests.get(o) != ref.digest(o):
            rows_wrong += 1
        want = merkle.tree_to_string(ref.owners[o].tree) if o in ref.owners else preload_trees[o]
        if trees.get(o) != want:
            trees_wrong += 1
    return {"answers_wrong": (wrong, 0), "owners_rows_wrong": (rows_wrong, 0),
            "owners_tree_wrong": (trees_wrong, 0), "unknown_owners": (len(others), 0)}

