"""Partial replication: the client-side sync-scope model.

The port's copy of `evolu_tpu.sync.scope`. A `SyncScope` declares the
slice of an owner's log a thin client wants to converge on, along two
axes the relay can evaluate without reading any plaintext:

- **timestamp watermark** (`watermark_millis`): an HLC-millis lower
  bound, "recent history only". Timestamps are plaintext on the wire
  already.
- **scope tags** (`tables` → HMAC lanes): each table name becomes an
  opaque HMAC of the name under a key derived from the owner mnemonic,
  so the relay partitions rows into lanes without learning what a lane
  names.

A scoped client converges byte for byte WITHIN its slice: the relay
answers from a scoped Merkle subtree built from the same filter
(`server/scope.py`). Rows the relay cannot attribute to a lane are served
anyway (over-approximation only), and the client records what it holds
but does not materialize as a counted deferred frontier
(`runtime/worker.py`).

`widen()` relaxes the scope (a lower watermark, more tables); the next
ordinary anti-entropy round catches up. Narrowing an established scope
is refused: a local tree that already holds out-of-scope rows would
diverge from the narrower scoped subtree for good.
"""

from __future__ import annotations

import hashlib
import hmac
from dataclasses import dataclass
from typing import Optional, Tuple

from evolu_tpu_torch.sync import protocol

# Tag length on the wire: 16 hex chars (64 bits), far under the
# protocol's per-tag byte bound.
SCOPE_TAG_HEX_LEN = 16
_SCOPE_KEY_INFO = b"evolu-scope-v1"


def derive_scope_tag(mnemonic: str, name: str) -> str:
    """The opaque lane tag for a table name: HMAC-SHA256 of the name
    under a scope key derived from the owner mnemonic, truncated to 16 hex
    chars. The same for every device of an owner, meaningless to the
    relay."""
    scope_key = hmac.new(mnemonic.encode("utf-8"), _SCOPE_KEY_INFO, hashlib.sha256).digest()
    digest = hmac.new(scope_key, name.encode("utf-8"), hashlib.sha256)
    return digest.hexdigest()[:SCOPE_TAG_HEX_LEN]


@dataclass(frozen=True)
class SyncScope:
    """A client's declared slice. `watermark_millis` = 0 means no time
    bound; empty `tables` means every table. Both empty is a no-op scope,
    treated as unscoped."""

    watermark_millis: int = 0
    tables: Tuple[str, ...] = ()

    def __post_init__(self):
        if self.watermark_millis < 0:
            raise ValueError("scope watermark must be non-negative")
        if len(self.tables) > protocol._MAX_SCOPE_TAGS:
            raise ValueError(
                f"scope declares {len(self.tables)} tables; the wire caps "
                f"requested lanes at {protocol._MAX_SCOPE_TAGS}"
            )

    @property
    def is_noop(self) -> bool:
        return not self.watermark_millis and not self.tables

    def table_in_scope(self, table: str) -> bool:
        """The client-side materialization filter: with no table filter
        everything materializes; system tables (`__`-prefixed) are always
        in scope, so the log and the clock stay whole."""
        if not self.tables or table.startswith("__"):
            return True
        return table in self.tables

    def widen(self, watermark_millis: Optional[int] = None,
              tables: Tuple[str, ...] = ()) -> "SyncScope":
        """A scope at least as wide (a lower or equal watermark, a
        superset of tables). Raises on any attempt to narrow."""
        new_wm = self.watermark_millis if watermark_millis is None else watermark_millis
        if new_wm > self.watermark_millis:
            raise ValueError("widen() cannot raise the watermark")
        if self.tables:
            new_tables = self.tables + tuple(t for t in tables if t not in self.tables)
        else:
            # No table filter = every table in scope already; adding names
            # would narrow it.
            if tables:
                raise ValueError("widen() cannot add a table filter to an unfiltered scope")
            new_tables = ()
        return SyncScope(new_wm, new_tables)

    def wire_clause(self, mnemonic: str,
                    push_tables: Tuple[str, ...] = ()) -> Optional[protocol.ScopeClause]:
        """The wire form: requested lane tags from `tables`, plus a lane
        for each of this round's pushed messages (`push_tables`, one table
        name a message, tagged even when the table is outside this scope,
        so the relay's lanes stay true for other scoped clients). None for
        a no-op scope: the unscoped wire, byte for byte."""
        if self.is_noop:
            return None
        tags = tuple(derive_scope_tag(mnemonic, t) for t in self.tables)
        push_tags: Tuple[str, ...] = ()
        if push_tables and tags:
            push_tags = tuple(derive_scope_tag(mnemonic, t) for t in push_tables)
        return protocol.ScopeClause(self.watermark_millis, tags, push_tags)


class ScopeDeferred(Exception):
    """A Query touched a table whose rows are (partly) outside the local
    scope: the store holds a counted deferred frontier for it, so the
    honest answer is this typed deferral, never silently empty rows. It
    carries what a caller needs to choose between widening the scope and
    rendering a placeholder."""

    def __init__(self, tables: Tuple[str, ...], deferred_rows: int):
        super().__init__(
            f"query touches out-of-scope table(s) {', '.join(tables)}: "
            f"{deferred_rows} row(s) deferred by the sync scope"
        )
        self.tables = tables
        self.deferred_rows = deferred_rows
