"""The plain relay: what a relay must answer and store, request by request.

A straightforward copy of the reference relay's semantics, Evolu v0.5.1
apps/server/src/index.ts:

- :138-171 `addMessages`: INSERT OR IGNORE on (timestamp, userId); only a
  newly inserted timestamp is XORed into the owner's Merkle tree;
- :173-202 `getMessages`: when the stored tree and the client's differ,
  every stored row after the first differing minute
  (`timestamp > createSyncTimestamp(diff)`), except the requesting
  node's own (`timestamp NOT LIKE '%' || nodeId`, case-blind as SQLite's
  LIKE is), in timestamp order;
- :204-248 the answer: those rows, then the stored tree as JSON.

It keeps each owner's rows in memory and replays one owner's requests in
the order the owner sent them. It reads nothing the program made: the
requests come from the traffic streams, the rows and trees from the
preload and the requests' own messages.
"""

from __future__ import annotations

import bisect
import hashlib
import json
from typing import Dict, List, Tuple

import numpy as np

from portbench.reference import merkle, wire


class OwnerRows:
    """One owner's stored rows (timestamps sorted, contents beside them)
    and Merkle tree."""

    def __init__(self, ts: List[str], contents: List[bytes], tree: dict):
        self.ts, self.contents, self.tree = ts, contents, tree

    def add(self, ts: List[str], contents: List[bytes], hashes: np.ndarray, millis: np.ndarray) -> None:
        new = []
        for i, (t, c) in enumerate(zip(ts, contents)):
            k = bisect.bisect_left(self.ts, t)
            if k < len(self.ts) and self.ts[k] == t:
                continue  # INSERT OR IGNORE: the stored row stays
            self.ts.insert(k, t)
            self.contents.insert(k, c)
            new.append(i)
        if new:
            ix = np.asarray(new)
            self.tree = merkle.apply_deltas(self.tree, merkle.minute_deltas(millis[ix], hashes[ix]))

    def answer(self, node: str, client_tree: str) -> bytes:
        tree_s = merkle.tree_to_string(self.tree)
        d = merkle.diff(self.tree, json.loads(client_tree))
        rows: List[Tuple[str, bytes]] = []
        if d is not None:
            since = merkle.sync_since(d)
            node = node.lower()
            for k in range(bisect.bisect_right(self.ts, since), len(self.ts)):
                t = self.ts[k]
                if t[-len(node):].lower() != node:
                    rows.append((t, self.contents[k]))
        return wire.response(wire.messages_field_rows(rows), tree_s)

    def digest(self) -> bytes:
        h = hashlib.sha256()
        for t, c in zip(self.ts, self.contents):
            h.update(t.encode())
            h.update(c)
        return h.digest()


class RelayReference:
    """Every owner's rows as a relay that started from the preload holds
    them, updated request by request."""

    def __init__(self, data):
        self.data = data
        self.owners: Dict[int, OwnerRows] = {}

    def owner(self, o: int) -> OwnerRows:
        got = self.owners.get(o)
        if got is None:
            ts, millis, hashes, content = self.data.preload(o)
            strings = [bytes(r).decode() for r in ts]
            got = self.owners[o] = OwnerRows(strings, [bytes(x) for x in self.data.pool[content]],
                                             self.data.preload_tree(o))
        return got

    def serve(self, req, stored: bool) -> bytes:
        """The answer to `req` (a traffic `Request`), its messages stored
        first when the relay acknowledged it (`stored`)."""
        rows = self.owner(req.owner)
        if stored and len(req.ts):
            rows.add([bytes(r).decode() for r in req.ts], [bytes(x) for x in self.data.pool[req.content]],
                     merkle.murmur3_rows(req.ts), req.millis)
        return rows.answer(req.node, req.tree)

    def preload_digest(self, o: int) -> bytes:
        """`OwnerRows.digest` of an owner no request touched."""
        ts, _m, _h, content = self.data.preload(o)
        h = hashlib.sha256()
        h.update(np.concatenate([ts, self.data.pool[content]], axis=1).tobytes())
        return h.digest()

    def digest(self, o: int) -> bytes:
        return self.owners[o].digest() if o in self.owners else self.preload_digest(o)

    def tree_string(self, o: int) -> str:
        if o in self.owners:
            return merkle.tree_to_string(self.owners[o].tree)
        return merkle.tree_to_string(self.data.preload_tree(o))

