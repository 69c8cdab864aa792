"""Core CRDT data types and errors (the slice of `evolu_tpu.core.types`
the reconcile pass needs).

A `CrdtValue` is `None | str | int | float`. Messages address a single
(table, row, column) cell and carry an HLC timestamp string that
totally orders all writes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Union

CrdtValue = Union[None, str, int, float]


@dataclass(frozen=True)
class Timestamp:
    """Hybrid logical clock timestamp: wall-clock `millis`, `counter`
    in [0, 65535] and a 16-hex-char `node` id. The string encoding is
    fixed-width, so string order equals (millis, counter, node) order."""

    millis: int
    counter: int
    node: str


@dataclass(frozen=True)
class CrdtMessage:
    """A stamped cell write; `timestamp` is the 46-char string encoding."""

    timestamp: str
    table: str
    row: str
    column: str
    value: CrdtValue


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


class TimestampParseError(EvoluError):
    type = "TimestampParseError"


class UnknownError(EvoluError):
    type = "UnknownError"

    def __init__(self, error: object):
        super().__init__(str(error))
        self.error = error

    def to_dict(self) -> dict:
        return {"type": self.type, "error": {"message": str(self.error)}}
