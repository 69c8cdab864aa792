"""Conservation-ledger accounting plane: prove where every message went.

The reference's correctness story is "applyMessages eventually
converges"; ours spreads one message across six apply routes and four
ingress paths, and the independent `evolu_*` counters cannot say
whether a message that entered the system ever reached a terminal —
nothing relates them. This module is the relation: a thread-safe
per-process **message-flow ledger** of typed stations with REGISTERED
CONSERVATION EQUATIONS over them, so the obs plane stops being a
dashboard and becomes a correctness oracle (the "verify the merge
bookkeeping" direction of Certified Mergeable Replicated Data Types,
arXiv 2203.14518; Merkle-CRDTs get convergence *detection* from the
DAG — the analogous move for a batched substrate is explicit flow
accounting whose balance is machine-checkable).

Two independent planes share one station namespace:

SERVER plane (relay/engine/store — counts are MESSAGE deliveries, one
event per message per delivery attempt, *not* unique messages):

    ingress.sync         sync POST decoded at the relay (per message)
    ingress.forward      /fleet/forward envelope decoded at the target
    ingress.replication  messages pulled from a peer and served locally
    ingress.snapshot     snapshot rows swapped into the live store
    ingress.replay       write-behind log records replayed at restart
    egress.forward       handed to the placed peer (forward mode)
    egress.redirect      bounced with 307 (redirect mode)
    shed.backpressure    shed with 503 + Retry-After (flow control)
    reject.invalid       serve errored after decode (500/502 answers)
    store.inserted       row was new (changes==1 / was-new flag)
    store.duplicate      row already stored (incl. in-batch dedup)
    wb.queued            rows ACKed into the write-behind log
    wb.drained           rows materialized to SQLite by the drain
    wb.dropped           rows dropped by an explicit queue reset

APPLY plane (the local LWW apply — client/worker storage/apply.py):

    apply.ingress        messages entering apply_messages[_sequential]
    route.packed         applied via the packed columnar cell plan
    route.object         applied via the standard object path
    route.sequential     applied via the reference per-message oracle
    route.typed          (tally) messages folded by typed materializers
    route.host_fallback  (tally) messages planned by merge._host_fallback
    bounce.non_canonical (tally) packed rows bounced for canonicality
    apply.inserted       XORed into the tree AND won its cell
    apply.losing         XORed into the tree but lost LWW
    apply.duplicate      exact duplicate (no XOR)
    apply.rejected       batch rolled back (counted instead of a route)

Default equations (every message entering a station must exit through
exactly one successor; ingress totals == terminal totals at
quiescence):

    server-flow*         Σ ingress.* == store.inserted + store.duplicate
                           + shed.backpressure + reject.invalid
                           + egress.forward + egress.redirect + wb.dropped
    write-behind-balance* wb.queued == wb.drained + wb.dropped
    apply-routing        apply.ingress == route.packed + route.object
                           + route.sequential + apply.rejected
    apply-outcomes       route.packed + route.object + route.sequential
                           == apply.inserted + apply.losing + apply.duplicate

(*) barrier-only: meaningful at quiescence — after write-behind drain
barriers (the composed per-shard barrier; each shard's drain
transaction posts its OWN pending entry, committed iff that shard's
SQLite transaction committed, so a kill between shard commits leaves
every row at exactly one terminal), with no requests in flight. `audit(at_barrier=False)` skips
them; `audit()` (the default) checks everything and returns the
violated equations with per-station deltas — an empty list IS the
conservation proof. The port's modules do not count into this ledger
yet: the stations, equations and audit are here so that
`obs.trace.write_evidence` and the tests read the same shape as the
reference's.

Transactional posting: hot paths that classify inside a transaction
accumulate into a `pending()` entry and `commit()` it only after the
SQL transaction committed (`abort()` on rollback) — a poisoned batch
or rolled-back apply must post NOTHING, or the scheduler's singleton
retry would double-count (the retry posts once through the per-request
path instead).

Hard constraints, same as obs.metrics: HOST-SIDE ONLY (this module
imports no torch and no jax — tests/test_torch_import_hygiene.py),
O(1)-ish per event (one lock + a few dict adds on ints the call site
already holds; never a device pull). Owner-scoped sub-ledgers sit
behind the metrics registry's cardinality cap: past `owner_cardinality_cap` distinct owners, new
owners fold into the "__overflow__" aggregate, so hostile or merely
numerous owner ids can never grow the ledger unboundedly.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

# -- station names (typed constants; count() accepts any string so
# embedders can extend the graph, but equations only see registered
# stations) --

INGRESS_SYNC = "ingress.sync"
INGRESS_FORWARD = "ingress.forward"
INGRESS_REPLICATION = "ingress.replication"
INGRESS_SNAPSHOT = "ingress.snapshot"
INGRESS_REPLAY = "ingress.replay"
EGRESS_FORWARD = "egress.forward"
EGRESS_REDIRECT = "egress.redirect"
SHED_BACKPRESSURE = "shed.backpressure"
REJECT_INVALID = "reject.invalid"
STORE_INSERTED = "store.inserted"
STORE_DUPLICATE = "store.duplicate"
WB_QUEUED = "wb.queued"
WB_DRAINED = "wb.drained"
WB_DROPPED = "wb.dropped"

APPLY_INGRESS = "apply.ingress"
ROUTE_PACKED = "route.packed"
ROUTE_OBJECT = "route.object"
ROUTE_SEQUENTIAL = "route.sequential"
ROUTE_TYPED = "route.typed"
ROUTE_HOST_FALLBACK = "route.host_fallback"
BOUNCE_NON_CANONICAL = "bounce.non_canonical"
APPLY_INSERTED = "apply.inserted"
APPLY_LOSING = "apply.losing"
APPLY_DUPLICATE = "apply.duplicate"
APPLY_REJECTED = "apply.rejected"

# Partial-replication tallies (outside the flow equations
# on purpose: a scoped serve classifies response EGRESS rows, it never
# changes where an ingressed message terminates, so `server-flow`
# stays balanced and `audit() == []` holds with scoping on).
#   serve.scoped_rows      response rows served under a scope clause
#   serve.scope_filtered   response rows withheld by the scope filter
#                          (deferred — still fully stored and in the
#                          full tree; the client's deferred frontier is
#                          the mirror count, runtime/worker.py)
#   apply.deferred_mat     (client plane tally) messages whose
#                          app-table materialization the sync scope
#                          deferred — log+tree applied, upsert skipped
SERVE_SCOPED = "serve.scoped_rows"
SERVE_SCOPE_FILTERED = "serve.scope_filtered"
APPLY_DEFERRED_MAT = "apply.deferred_mat"

# The metrics registry's cardinality bound, applied to owner sub-ledgers: past
# the cap, new owners aggregate under this key.
OWNER_OVERFLOW = "__overflow__"
OWNER_CARDINALITY_CAP = 512

def flag_sum(mask) -> int:
    """Count truthy entries of a was-new/plan mask without caring
    whether it is a numpy bool array or a plain list — `.sum()` first
    (builtin sum over a 1M-element ndarray iterates per element in
    Python). ONE copy shared by storage/apply.py and server/relay.py."""
    s = getattr(mask, "sum", None)
    return int(s()) if s is not None else int(sum(1 for f in mask if f))


_SERVER_INGRESS = (INGRESS_SYNC, INGRESS_FORWARD, INGRESS_REPLICATION,
                   INGRESS_SNAPSHOT, INGRESS_REPLAY)
_SERVER_TERMINALS = (STORE_INSERTED, STORE_DUPLICATE, SHED_BACKPRESSURE,
                     REJECT_INVALID, EGRESS_FORWARD, EGRESS_REDIRECT,
                     WB_DROPPED)
_APPLY_ROUTES = (ROUTE_PACKED, ROUTE_OBJECT, ROUTE_SEQUENTIAL)


class PendingEntry:
    """A local, lock-free accumulator for one transaction's worth of
    flow events. `commit()` posts everything to the ledger atomically;
    `abort()` (or garbage collection) discards. Single-shot: a second
    commit is a no-op, so `finally: entry.abort()` patterns are safe."""

    __slots__ = ("_ledger", "_counts", "_done")

    def __init__(self, ledger: "Ledger"):
        self._ledger = ledger
        self._counts: Dict[Tuple[str, Optional[str]], int] = {}
        self._done = False

    def count(self, station: str, n: int = 1, owner: Optional[str] = None) -> None:
        if n:
            key = (station, owner)
            self._counts[key] = self._counts.get(key, 0) + int(n)

    def commit(self) -> None:
        if self._done:
            return
        self._done = True
        if self._counts:
            self._ledger._post(self._counts)

    def abort(self) -> None:
        self._done = True
        self._counts.clear()


class Ledger:
    """Typed stations + registered conservation equations + owner
    sub-ledgers. All counts are plain ints under one lock."""

    def __init__(self, owner_cardinality_cap: int = OWNER_CARDINALITY_CAP):
        self._lock = threading.Lock()
        self.enabled = True
        self.owner_cardinality_cap = owner_cardinality_cap
        self._counts: Dict[str, int] = {}
        self._owners: Dict[str, Dict[str, int]] = {}
        # (name, lhs stations, rhs stations, barrier_only)
        self._equations: List[Tuple[str, Tuple[str, ...], Tuple[str, ...], bool]] = []
        self._register_defaults()

    # -- configuration --

    def _register_defaults(self) -> None:
        self.register_equation(
            "server-flow", _SERVER_INGRESS, _SERVER_TERMINALS,
            barrier_only=True,
        )
        self.register_equation(
            "write-behind-balance", (WB_QUEUED,), (WB_DRAINED, WB_DROPPED),
            barrier_only=True,
        )
        self.register_equation(
            "apply-routing", (APPLY_INGRESS,),
            _APPLY_ROUTES + (APPLY_REJECTED,),
        )
        self.register_equation(
            "apply-outcomes", _APPLY_ROUTES,
            (APPLY_INSERTED, APPLY_LOSING, APPLY_DUPLICATE),
        )

    def register_equation(
        self, name: str, lhs: Sequence[str], rhs: Sequence[str],
        barrier_only: bool = False,
    ) -> None:
        """Register `sum(lhs) == sum(rhs)` as an invariant. Barrier-only
        equations are checked only by `audit(at_barrier=True)` — they
        hold at quiescence (drained write-behind, no in-flight
        requests), not mid-stream."""
        with self._lock:
            self._equations = [e for e in self._equations if e[0] != name]
            self._equations.append((name, tuple(lhs), tuple(rhs), barrier_only))

    # -- write side (hot paths) --

    def count(self, station: str, n: int = 1, owner: Optional[str] = None) -> None:
        """Record `n` messages passing `station`. Cheap by contract:
        one lock, two dict adds on ints the call site already holds."""
        if not self.enabled or not n:
            return
        self._post({(station, owner): int(n)})

    def pending(self) -> PendingEntry:
        """A transactional accumulator — see PendingEntry. Disabled
        ledgers still hand one out (its commit posts nothing)."""
        return PendingEntry(self)

    def _post(self, counts: Dict[Tuple[str, Optional[str]], int]) -> None:
        if not self.enabled:
            return
        with self._lock:
            for (station, owner), n in counts.items():
                self._counts[station] = self._counts.get(station, 0) + n
                if owner is None:
                    continue
                sub = self._owners.get(owner)
                if sub is None:
                    if len(self._owners) >= self.owner_cardinality_cap:
                        owner = OWNER_OVERFLOW
                    sub = self._owners.setdefault(owner, {})
                sub[station] = sub.get(station, 0) + n

    # -- read side --

    def total(self, station: str) -> int:
        with self._lock:
            return self._counts.get(station, 0)

    def totals(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def owner_totals(self, owner: str) -> Dict[str, int]:
        with self._lock:
            return dict(self._owners.get(owner, {}))

    def owners(self) -> List[str]:
        with self._lock:
            return list(self._owners)

    def audit(self, at_barrier: bool = True) -> List[dict]:
        """Check every registered equation; return the VIOLATED ones as
        [{equation, lhs: {station: count}, rhs: {...}, delta}] with
        delta = sum(lhs) - sum(rhs). Empty list == conserved. With
        `at_barrier=False`, barrier-only equations (write-behind
        balance, the server flow) are skipped — they only hold at
        quiescence."""
        with self._lock:
            counts = dict(self._counts)
            equations = list(self._equations)
        out: List[dict] = []
        for name, lhs, rhs, barrier_only in equations:
            if barrier_only and not at_barrier:
                continue
            lhs_m = {s: counts.get(s, 0) for s in lhs}
            rhs_m = {s: counts.get(s, 0) for s in rhs}
            delta = sum(lhs_m.values()) - sum(rhs_m.values())
            if delta != 0:
                out.append({
                    "equation": name,
                    "lhs": lhs_m,
                    "rhs": rhs_m,
                    "delta": delta,
                })
        return out

    def snapshot(self, at_barrier: bool = False) -> dict:
        """JSON-ready dump: station totals, per-owner sub-ledgers, the
        registered equations, and the current audit (run at the given
        barrier level — the default False never claims a quiescence
        violation from a merely in-flight message)."""
        with self._lock:
            payload = {
                "stations": dict(self._counts),
                "owners": {o: dict(sub) for o, sub in self._owners.items()},
                "equations": [
                    {"name": n, "lhs": list(l), "rhs": list(r),
                     "barrier_only": b}
                    for n, l, r, b in self._equations
                ],
                "owner_cardinality_cap": self.owner_cardinality_cap,
            }
        payload["violations"] = self.audit(at_barrier=at_barrier)
        return payload

    def reset(self) -> None:
        """Zero every station and owner sub-ledger (equations persist —
        like metrics bucket shapes, the flow graph is configuration,
        not data). Episode tests reset at start so earlier traffic in
        the process cannot leak into their conservation proof."""
        with self._lock:
            self._counts.clear()
            self._owners.clear()


# Module-level default ledger (the process's accounting plane — the
# relay's GET /ledger and the evidence dump both serve this instance).
ledger = Ledger()

count = ledger.count
pending = ledger.pending
audit = ledger.audit
totals = ledger.totals
snapshot = ledger.snapshot
reset = ledger.reset


def set_enabled(flag: bool) -> None:
    """Ledger kill switch (bench guard / overhead measurement)."""
    ledger.enabled = bool(flag)


def quarantine():
    """Context manager that disables the default ledger for its body:
    for ORACLE TWINS — tests re-running system paths (engine passes,
    store applies) as reference computations whose flows are not part
    of the system under audit. Process-global like the ledger itself:
    only use where no real traffic runs concurrently (the episodes'
    oracle phases run after teardown/quiescence)."""
    from contextlib import contextmanager

    @contextmanager
    def _ctx():
        prev = ledger.enabled
        ledger.enabled = False
        try:
            yield
        finally:
            ledger.enabled = prev

    return _ctx()
