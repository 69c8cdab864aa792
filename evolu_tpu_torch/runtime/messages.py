"""The worker command protocol — DbWorkerInput / DbWorkerOutput.

Reference: packages/evolu/src/types.ts:403-459; a copy of
`evolu_tpu.runtime.messages`. The tagged unions
become dataclasses; this protocol is the framework's public runtime
API boundary (SURVEY.md §7 "Boundary preserved") — anything that can
produce these commands can drive the engine, whether it's the Python
client handle, the relay server's reconcile engine, or a test.

Queries travel as `SqlQueryString`: the JSON serialization of
`{"sql": ..., "parameters": [...]}` (types.ts:109-124) so a query is a
hashable cache key.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from evolu_tpu_torch.core.types import CrdtMessage, NewCrdtMessage, Owner


def serialize_query(sql: str, parameters: Sequence = ()) -> str:
    """SqlQueryString (types.ts:115-124)."""
    return json.dumps({"sql": sql, "parameters": list(parameters)}, separators=(",", ":"))


def deserialize_query(query: str) -> Tuple[str, list]:
    q = json.loads(query)
    return q["sql"], q.get("parameters", [])


# --- inputs (types.ts:403-443) ---


@dataclass(frozen=True)
class Init:
    """Handshake; carries config in the reference (types.ts:405-409)."""

    config: object = None


@dataclass(frozen=True)
class UpdateDbSchema:
    table_definitions: tuple  # of TableDefinition


@dataclass(frozen=True)
class Send:
    messages: tuple  # of NewCrdtMessage
    on_complete_ids: tuple = ()
    queries: tuple = ()  # SqlQueryString


@dataclass(frozen=True)
class Query:
    queries: tuple  # SqlQueryString
    # full=True bypasses changed-set gating and re-executes
    # unconditionally — for refreshes whose trigger the worker cannot
    # see in its change log (another process wrote the shared DB file,
    # e.g. the reload watcher). Defaults keep the wire shape.
    full: bool = False


@dataclass(frozen=True)
class EvictQueries:
    """Drop unsubscribed queries from the worker's diff cache (no
    reference analog — the reference's worker cache lives for the
    worker's lifetime; eviction keeps long-lived clients bounded)."""

    queries: tuple  # SqlQueryString


@dataclass(frozen=True)
class Receive:
    messages: tuple  # of CrdtMessage
    merkle_tree: str  # serialized server tree
    previous_diff: Optional[int] = None  # Millis of the previous round's diff


@dataclass(frozen=True)
class Sync:
    queries: tuple = ()  # refresh these before syncing (focus/reshow)


@dataclass(frozen=True)
class ResetOwner:
    pass


@dataclass(frozen=True)
class RestoreOwner:
    mnemonic: str


@dataclass(frozen=True)
class WidenSyncScope:
    """Escalate the partial-replication scope (`sync/scope.py`): lower
    the watermark and/or add tables to the filter; `full=True` drops
    scoping entirely. The worker re-materializes every table brought into
    scope from the local `__message` log in LWW order and clears its
    deferred frontier; the missing history of the wider slice then arrives
    by ordinary anti-entropy. Narrowing answers OnError(ValueError), as
    `SyncScope.widen` raises."""

    watermark_millis: "int | None" = None
    tables: tuple = ()
    full: bool = False


# --- outputs (types.ts:445-459) ---


@dataclass(frozen=True)
class OnError:
    error: Exception


@dataclass(frozen=True)
class OnInit:
    owner: Owner


@dataclass(frozen=True)
class OnQuery:
    queries_patches: tuple  # of (SqlQueryString, ops-list)
    on_complete_ids: tuple = ()


@dataclass(frozen=True)
class OnReceive:
    pass


@dataclass(frozen=True)
class ReloadAllTabs:
    pass


# --- DbWorker → SyncWorker (types.ts:461-473) ---


@dataclass(frozen=True)
class SyncRequestInput:
    """One sync round's input to the sync transport.

    `messages` empty = pull-only round (sync.ts:49-57); non-empty = push
    after a local send (send.ts:63-80).
    """

    messages: tuple  # of CrdtMessage
    clock_timestamp: str
    merkle_tree: str
    owner: Owner
    previous_diff: Optional[int] = None
    # Distributed-trace context of the mutation that produced this
    # round (obs.trace.SpanContext), or None for pull-only rounds and
    # untraced embedders. Carried in-process only: on the wire the
    # context rides the HTTP traceparent header, never the body.
    # compare=False: two identical rounds carry different trace ids by
    # design.
    trace: Optional[object] = field(default=None, compare=False)
