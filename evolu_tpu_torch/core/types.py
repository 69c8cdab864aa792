"""Core CRDT data types and errors (the slice of `evolu_tpu.core.types`
the reconcile pass, the client handle and worker, and the relay need).

A `CrdtValue` is `None | str | int | float`. Messages address a single
(table, row, column) cell and carry an HLC timestamp string that
totally orders all writes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Union

CrdtValue = Union[None, str, int, float]

MAX_COUNTER = 65535


@dataclass(frozen=True)
class Timestamp:
    """Hybrid logical clock timestamp: wall-clock `millis`, `counter`
    in [0, 65535] and a 16-hex-char `node` id. The string encoding is
    fixed-width, so string order equals (millis, counter, node) order."""

    millis: int
    counter: int
    node: str


@dataclass(frozen=True)
class NewCrdtMessage:
    """A cell write not yet stamped with a timestamp."""

    table: str
    row: str
    column: str
    value: CrdtValue


@dataclass(frozen=True)
class CrdtMessage:
    """A stamped cell write; `timestamp` is the 46-char string encoding."""

    timestamp: str
    table: str
    row: str
    column: str
    value: CrdtValue


@dataclass(frozen=True)
class CrdtClock:
    """Per-replica clock state persisted in `__clock`."""

    timestamp: Timestamp
    merkle_tree: dict


@dataclass(frozen=True)
class Owner:
    """A database owner: identity derived from a BIP39 mnemonic."""

    id: str
    mnemonic: str


@dataclass(frozen=True)
class TableDefinition:
    name: str
    columns: tuple

    @staticmethod
    def of(name: str, columns) -> "TableDefinition":
        return TableDefinition(name, tuple(columns))


class EvoluError(Exception):
    """Base class for all framework errors."""

    type: str = "EvoluError"

    def to_dict(self) -> dict:
        return {"type": self.type}


class TimestampDriftError(EvoluError):
    type = "TimestampDriftError"

    def __init__(self, next_millis: int, now: int):
        super().__init__(f"clock drift: next={next_millis} now={now}")
        self.next = next_millis
        self.now = now

    def to_dict(self) -> dict:
        return {"type": self.type, "next": self.next, "now": self.now}


class TimestampCounterOverflowError(EvoluError):
    type = "TimestampCounterOverflowError"

    def __init__(self) -> None:
        super().__init__("HLC counter overflow (> 65535)")


class TimestampDuplicateNodeError(EvoluError):
    type = "TimestampDuplicateNodeError"

    def __init__(self, node: str):
        super().__init__(f"duplicate node id: {node}")
        self.node = node

    def to_dict(self) -> dict:
        return {"type": self.type, "node": self.node}


class TimestampParseError(EvoluError):
    type = "TimestampParseError"


class SyncError(EvoluError):
    """The replica cannot converge: the same Merkle diff twice in a row."""

    type = "SyncError"

    def __init__(self) -> None:
        super().__init__("sync livelock: repeated identical merkle diff")


class ValidationError(EvoluError):
    """A model brand rejected a value (format or length)."""

    type = "ValidationError"


class StringMaxLengthError(ValidationError):
    type = "StringMaxLengthError"


class UnknownError(EvoluError):
    type = "UnknownError"

    def __init__(self, error: object):
        super().__init__(str(error))
        self.error = error

    def to_dict(self) -> dict:
        return {"type": self.type, "error": {"message": str(self.error)}}


class NonCanonicalStoreError(UnknownError):
    """A stored relay timestamp is not the canonical 46-byte width, so a
    fixed-width fetch path cannot serve it; callers fall back to the
    generic SQL path."""

    type = "UnknownError"  # wire-visible type is unchanged
