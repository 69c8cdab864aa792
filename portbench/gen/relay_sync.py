"""The general generator of relay sync traffic, driven by a mix's parameters.

A relay configuration fixes the store every run starts from: `owners`
owners, each with `messages_per_owner` messages written by
`devices_per_owner` devices, `preload_per_minute` a minute, contents drawn
from a pool of `content_pool` ciphertext-sized blobs of `content_bytes`
bytes (the relay is end-to-end-encryption blind: it stores and returns
them untouched).

A mix (`traffic/<mix>.json`, "generator": "relay_sync") sets:

- `devices`: client lanes in a closed loop, each awaiting its answer;
- `owner_zipf`: the Zipf constant of the owner a request is for (rank 1
  is owner 0), at most one request of an owner in flight;
  (every draw, of an owner, a size, a kind or a device, is a quantile
  from a low-discrepancy sequence with a start drawn from the seed);
- `push_share`: the share of requests that push new messages; each
  pushes a log-uniform `push_sizes` [lo, hi] of them, `push_per_millis`
  a millisecond, with the device's tree after applying them (so the
  answer carries no messages, as in a relay's steady state);
- `pull_missing`: the other requests carry no messages and a tree that
  holds the owner's first messages only, a log-uniform [lo, hi] of them
  missing; the relay diffs the trees and serves the rest.

Each owner's requests form a stream fixed by (seed, owner): the j-th
request of an owner has the same bytes in every run of a seed, whatever
order the lanes reach the owners in. The reference replays the same
streams.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from portbench.reference import merkle, wire


def seed_words(seed: int, *more: int) -> List[int]:
    """A SeedSequence entropy list from a signed seed of any size."""
    s = int(seed)
    words = [1 if s < 0 else 0]
    s = abs(s)
    while True:
        words.append(s & 0xFFFFFFFF)
        s >>= 32
        if not s:
            break
    return words + [int(m) for m in more]


def zipf_cdf(n: int, s: float) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** s
    c = np.cumsum(w)
    return c / c[-1]


def log_uniform(u: float, lo: int, hi: int) -> int:
    """The log-uniform integer in [lo, hi] at quantile u."""
    return min(hi, int(math.exp(math.log(lo) + u * (math.log(hi + 1) - math.log(lo)))))


class Quasi:
    """An additive low-discrepancy sequence in [0, 1) from a random start:
    any run of it covers [0, 1) nearly evenly, so a seed changes the order
    of the sizes and owners a window draws far more than their mix."""

    def __init__(self, rng: np.random.Generator, step: float):
        self.u, self.step = float(rng.random()), step

    def next(self) -> float:
        self.u = (self.u + self.step) % 1.0
        return self.u


# Irrational steps, one a purpose, so no two draws move in lockstep.
STEPS = {"kind": 0.6180339887498949, "size": 0.41421356237309515, "node": 0.7320508075688772,
         "missing": 0.2360679774997898, "owner": 0.6180339887498949}


class RelayData:
    """What a relay configuration fixes, the same for every seed: the
    content pool, each owner's preloaded history and device nodes."""

    def __init__(self, config: dict):
        self.owners = int(config["owners"])
        self.per_owner = int(config["messages_per_owner"])
        self.devices = int(config["devices_per_owner"])
        self.per_minute = int(config["preload_per_minute"])
        self.base = int(config["base_millis"])
        self.push_per_ms = int(config["push_per_millis"])
        rng = np.random.default_rng([0xC0, int(config["content_pool"])])
        self.pool = rng.integers(0, 256, (int(config["content_pool"]), int(config["content_bytes"])),
                                 dtype=np.uint8)
        minutes = -(-self.per_owner // self.per_minute)
        self.push_base = self.base + (minutes + 60) * 60000
        self._preload: Dict[int, tuple] = {}

    def __getstate__(self):
        # The per-owner cache is rebuilt on demand, never shipped.
        return {**self.__dict__, "_preload": {}}

    def user(self, o: int) -> str:
        return f"owner{o:04d}"

    def node(self, o: int, d: int) -> str:
        """Device d of owner o (d == devices_per_owner is the pushing device)."""
        return f"{o + 1:012x}{d:04x}"

    def preload_columns(self, owners: np.ndarray):
        """(owner, millis, counter, node rows, content index) of every
        preloaded message of `owners`, owner-major, in timestamp order."""
        owners = np.asarray(owners, np.int64)
        j = np.tile(np.arange(self.per_owner, dtype=np.int64), len(owners))
        o = np.repeat(owners, self.per_owner)
        step = 60000 // self.per_minute
        millis = self.base + (j // self.per_minute) * 60000 + (j % self.per_minute) * step + o % step
        d = j % self.devices
        nodes = np.frombuffer("".join(f"{x + 1:012x}" for x in owners.tolist()).encode(), np.uint8)
        nodes = np.repeat(nodes.reshape(-1, 12), self.per_owner, axis=0)
        dev = np.frombuffer("".join(f"{x:04x}" for x in range(self.devices)).encode(), np.uint8)
        node_rows = np.concatenate([nodes, dev.reshape(-1, 4)[d]], axis=1)
        content = (o * self.per_owner + j) % len(self.pool)
        return o, millis, np.zeros_like(j), node_rows, content

    def preload(self, o: int):
        """Owner o's preloaded history: (ts rows, millis, hashes, content index)."""
        got = self._preload.get(o)
        if got is None:
            _o, millis, counter, nodes, content = self.preload_columns(np.array([o]))
            ts = merkle.ts_rows(millis, counter, nodes)
            got = self._preload[o] = (ts, millis, merkle.murmur3_rows(ts), content)
        return got

    def preload_tree(self, o: int, upto: Optional[int] = None) -> dict:
        _ts, millis, hashes, _c = self.preload(o)
        n = self.per_owner if upto is None else upto
        return merkle.tree_from_rows(millis[:n], hashes[:n])


@dataclass
class Request:
    owner: int
    j: int
    push: bool
    node: str
    tree: str
    ts: np.ndarray  # (n, 46) uint8: the pushed messages' timestamps
    millis: np.ndarray  # int64[n]: their millis
    content: np.ndarray  # int64[n]: their indexes into the pool
    body: bytes


class OwnerStream:
    """The requests of one owner under one mix, in order."""

    def __init__(self, data: RelayData, mix: dict, seed: int, o: int):
        self.data, self.mix, self.o = data, mix, o
        rng = np.random.default_rng(seed_words(seed, 0x5E, o))
        self.u = {k: Quasi(rng, STEPS[k]) for k in ("kind", "size", "node", "missing")}
        self.j = 0
        self.pushed = 0
        self.tree: Optional[dict] = None  # the owner's tree after its pushes so far

    def next(self) -> Request:
        d, mix, o = self.data, self.mix, self.o
        push = self.u["kind"].next() < float(mix["push_share"])
        if push:
            lo, hi = mix["push_sizes"]
            n = log_uniform(self.u["size"].next(), int(lo), int(hi))
            q = np.arange(self.pushed, self.pushed + n, dtype=np.int64)
            millis = d.push_base + q // d.push_per_ms
            node = d.node(o, d.devices)
            ts = merkle.ts_rows(millis, q % d.push_per_ms, merkle.node_rows([node] * n))
            if self.tree is None:
                self.tree = d.preload_tree(o)
            self.tree = merkle.apply_deltas(self.tree, merkle.minute_deltas(millis, merkle.murmur3_rows(ts)))
            tree = merkle.tree_to_string(self.tree)
            content = (o * 1_000_003 + q * 7 + 1) % len(d.pool)
            self.pushed += n
            msgs = wire.messages_field(ts, d.pool[content])
        else:
            lo, hi = mix["pull_missing"]
            missing = log_uniform(self.u["missing"].next(), int(lo), int(hi))
            node = d.node(o, int(self.u["node"].next() * d.devices))
            tree = merkle.tree_to_string(d.preload_tree(o, max(0, d.per_owner - missing)))
            ts, content, msgs = np.zeros((0, merkle.TS_LEN), np.uint8), np.zeros(0, np.int64), b""
            millis = np.zeros(0, np.int64)
        req = Request(o, self.j, push, node, tree, ts, millis, content, wire.request(msgs, d.user(o), node, tree))
        self.j += 1
        return req


class OwnerPicker:
    """A lane's draws of the owner of its next request: Zipf over the
    owners, redrawn while the drawn owner has a request in flight."""

    def __init__(self, cdf: np.ndarray, seed: int, lane: int):
        self.cdf = cdf
        self.u = Quasi(np.random.default_rng(seed_words(seed, 0x1A, lane)), STEPS["owner"])

    def pick(self, busy) -> int:
        while True:
            o = int(np.searchsorted(self.cdf, self.u.next(), side="right"))
            if o not in busy:
                return o
