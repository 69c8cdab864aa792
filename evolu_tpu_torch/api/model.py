"""Column value model: branded types, validation, and SQLite casts.

Reference: packages/evolu/src/model.ts. The reference brands values
with zod (`String1000`, `NonEmptyString1000`, `SqliteBoolean`,
`SqliteDate`, `Id`, `Mnemonic`); here the same constraints are
validator functions plus `cast` helpers mapping Python-native values
to their SQLite encodings (model.ts:100-112): bool ⇔ 0/1, datetime ⇔
fixed-width ISO-8601 string.
"""

from __future__ import annotations

import datetime
import re
from urllib.parse import urlparse
from typing import Union

from evolu_tpu_torch.core.ids import create_id, is_valid_id
from evolu_tpu_torch.core.mnemonic import validate_mnemonic
from evolu_tpu_torch.core.types import StringMaxLengthError, ValidationError

SqliteBoolean = int  # 0 | 1 (model.ts:57-63)
SqliteDate = str  # ISO-8601 string (model.ts:65-74)


def validate_string_1000(value: str) -> str:
    """String1000 (model.ts:78-84): max length 1000."""
    if not isinstance(value, str) or len(value) > 1000:
        raise StringMaxLengthError("String1000: max length is 1000")
    return value


def validate_non_empty_string_1000(value: str) -> str:
    """NonEmptyString1000 (model.ts:86-94): 1..1000 chars, trimmed not empty."""
    validate_string_1000(value)
    if len(value.strip()) == 0:
        raise StringMaxLengthError("NonEmptyString1000: must not be empty")
    return value


_EMAIL_RE = re.compile(r"^[^\s@]+@[^\s@]+\.[^\s@]+$")


def validate_email(value: str) -> str:
    """Email brand (model.ts:65-66). Like the reference's zod
    `.email()`, no length cap — sync never validates, so local
    strictness is a UX concern only."""
    if not isinstance(value, str) or not _EMAIL_RE.fullmatch(value):
        raise ValidationError(f"invalid email: {value!r}")
    return value


def validate_url(value: str) -> str:
    """Url brand (model.ts:69-70). Rejects whitespace anywhere (JS
    `new URL` / zod `.url()` semantics) and malformed hosts."""
    if not isinstance(value, str) or re.search(r"\s", value):
        raise ValidationError(f"invalid url: {value!r}")
    try:
        p = urlparse(value)
    except ValueError:
        raise ValidationError(f"invalid url: {value!r}") from None
    if not (p.scheme and p.netloc):
        raise ValidationError(f"invalid url: {value!r}")
    return value


def is_sqlite_boolean(value: object) -> bool:
    return value in (0, 1)


_ISO_RE = re.compile(r"^\d{4}-\d{2}-\d{2}T\d{2}:\d{2}:\d{2}\.\d{3}Z$")


def is_sqlite_date(value: object) -> bool:
    return isinstance(value, str) and _ISO_RE.match(value) is not None


def cast(value: Union[bool, datetime.datetime, int, str]) -> Union[int, str, bool, datetime.datetime]:
    """model.ts:100-112 — the two-way boolean/date cast.

    bool → 0/1, datetime → ISO string; 0/1 → bool and ISO string →
    datetime on the way back (the reference overloads one `cast`).
    """
    if isinstance(value, bool):
        return 1 if value else 0
    if isinstance(value, datetime.datetime):
        utc = value.astimezone(datetime.timezone.utc)
        millis = int(utc.timestamp() * 1000)
        from evolu_tpu_torch.core.timestamp import millis_to_iso

        return millis_to_iso(millis)
    if isinstance(value, int) and value in (0, 1):
        return value == 1
    if isinstance(value, str) and _ISO_RE.match(value):
        from evolu_tpu_torch.core.timestamp import iso_to_millis

        return datetime.datetime.fromtimestamp(
            iso_to_millis(value) / 1000, tz=datetime.timezone.utc
        )
    raise TypeError(f"cast: unsupported value {value!r}")


def sqlite_value(value: object) -> object:
    """Normalize a mutation value to its storable form: bools and
    datetimes cast (db.ts:281-283), everything else passes through."""
    if isinstance(value, (bool, datetime.datetime)):
        return cast(value)
    return value


# Common columns present on every row (types.ts:194-201).
COMMON_COLUMNS = ("createdAt", "createdBy", "updatedAt", "isDeleted")

__all__ = [
    "SqliteBoolean",
    "SqliteDate",
    "COMMON_COLUMNS",
    "cast",
    "sqlite_value",
    "create_id",
    "is_valid_id",
    "validate_mnemonic",
    "validate_string_1000",
    "validate_non_empty_string_1000",
    "validate_email",
    "validate_url",
    "is_sqlite_boolean",
    "is_sqlite_date",
]
