"""The load process of the relay cells: closed-loop client lanes over HTTP.

Runs in a process of its own (spawned), so that the clients' Python never
shares the relay's interpreter lock. It imports nothing of the program.
Each lane is one device awaiting each answer before its next request;
bodies are encoded ahead by a producer thread, per owner stream, and a
lane that finds its owner's next body not yet made waits for it: that
wait is the generator's lateness, which the run reports.

Protocol on the pipe: the parent sends (config, mix, seed); this process
answers ("ready", seconds spent making the first bodies); the parent
sends ("go", seconds, host, port); this process runs the lanes until that
many seconds have passed since the go, lets every request in flight
finish, and answers ("done", the go instant, records, seconds lanes
waited for bodies, times they waited), one record a request:
(owner, j, push, messages up, messages down, status, t_send, t_done,
sha256 of the answer), times on the monotonic clock the parent shares.
"""

from __future__ import annotations

import hashlib
import http.client
import math
import queue
import sys
import threading
import time
from collections import deque

import numpy as np

from portbench.gen.relay_sync import OwnerPicker, OwnerStream, RelayData, zipf_cdf
from portbench.reference import wire


# Spawned workers that make every owner's first bodies before the window.
GENERATOR_PROCESSES = 4


def post(host: str, port: int, body: bytes):
    """One sync POST as the reference client makes it. → (status, body);
    status 0 when the connection failed."""
    conn = http.client.HTTPConnection(host, port, timeout=300)
    try:
        conn.request("POST", "/", body=body, headers={"Content-Type": "application/octet-stream"})
        r = conn.getresponse()
        return r.status, r.read()
    except (OSError, http.client.HTTPException):
        return 0, b""
    finally:
        conn.close()


class Bodies:
    """Each owner's next requests, made ahead: `ahead[o]` of them, more for
    the owners drawn more often. `take(o)` hands out owner o's next
    request in stream order."""

    def __init__(self, data, mix, seed, cdf, lanes):
        self.streams = [OwnerStream(data, mix, seed, o) for o in range(data.owners)]
        p = np.diff(np.r_[0.0, cdf])
        self.ahead = [1 + math.ceil(2 * lanes * float(x)) for x in p]
        self.ready = [deque() for _ in self.streams]
        self.locks = [threading.Lock() for _ in self.streams]
        self.refill: queue.Queue = queue.Queue()
        self.late_s = 0.0
        self.late_n = 0
        self._late_lock = threading.Lock()

    def fill_all(self, processes: int) -> None:
        """Every owner's first bodies, made by `processes` spawned workers."""
        import multiprocessing

        owners = range(len(self.streams))
        chunks = [list(owners[i::processes]) for i in range(processes)]
        with multiprocessing.get_context("spawn").Pool(processes) as pool:
            jobs = [pool.apply_async(_fill_chunk, ([self.streams[o] for o in c], [self.ahead[o] for o in c]))
                    for c in chunks]
            for job in jobs:
                for o, stream, ready in job.get():
                    self.streams[o], self.ready[o] = stream, deque(ready)

    def fill(self, o: int) -> None:
        with self.locks[o]:
            while len(self.ready[o]) < self.ahead[o]:
                self.ready[o].append(_slim(self.streams[o].next()))

    def producer(self) -> None:
        while True:
            o = self.refill.get()
            if o is None:
                return
            self.fill(o)

    def take(self, o: int):
        t0 = time.perf_counter()
        with self.locks[o]:
            req = self.ready[o].popleft() if self.ready[o] else None
            if req is None:
                req = _slim(self.streams[o].next())
        wait = time.perf_counter() - t0
        if wait > 1e-3:
            with self._late_lock:
                self.late_s += wait
                self.late_n += 1
        self.refill.put(o)
        return req


def _slim(req):
    """What a lane needs of a request: (j, push, messages up, body)."""
    return req.j, req.push, len(req.ts), req.body


def _fill_chunk(streams, ahead):
    return [(s.o, s, [_slim(s.next()) for _ in range(n)]) for s, n in zip(streams, ahead)]


def main(conn) -> None:
    config, mix, seed = conn.recv()
    # Lanes wake on the answer's socket; a short switch interval keeps
    # the producer thread from holding them up by the default 5 ms.
    sys.setswitchinterval(0.0005)
    t0 = time.perf_counter()
    data = RelayData(config)
    lanes = int(mix["devices"])
    if lanes >= data.owners:
        raise ValueError(f"{lanes} lanes need more than {data.owners} owners")
    cdf = zipf_cdf(data.owners, float(mix["owner_zipf"]))
    bodies = Bodies(data, mix, seed, cdf, lanes)
    bodies.fill_all(GENERATOR_PROCESSES)
    conn.send(("ready", time.perf_counter() - t0))
    cmd, seconds, host, port = conn.recv()
    if cmd != "go":
        return
    prod = threading.Thread(target=bodies.producer, daemon=True)
    prod.start()
    busy: set = set()
    lock = threading.Lock()
    records = []
    start = time.perf_counter()
    end = start + float(seconds)

    def lane(i: int) -> None:
        picker = OwnerPicker(cdf, seed, i)
        while time.perf_counter() < end:
            with lock:
                o = picker.pick(busy)
                busy.add(o)
            j, push, up, body = bodies.take(o)
            t1 = time.perf_counter()
            status, out = post(host, port, body)
            t2 = time.perf_counter()
            down = wire.count_messages(out) if status == 200 else 0
            sha = hashlib.sha256(out).digest() if status == 200 else b""
            with lock:
                busy.discard(o)
                records.append((o, j, push, up, down, status, t1, t2, sha))

    threads = [threading.Thread(target=lane, args=(i,), daemon=True) for i in range(lanes)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    bodies.refill.put(None)
    prod.join()
    conn.send(("done", start, records, bodies.late_s, bodies.late_n))
