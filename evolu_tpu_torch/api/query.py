"""Compile-only SQL query builder — the Kysely analog.

Reference: packages/evolu/src/kysely.ts builds a Kysely instance with a
DummyDriver: queries are *compiled* to `{sql, parameters}` but never
executed by the builder; execution belongs to the DbWorker
(createHooks.ts:28-37). This module is the same idea natively: a small
immutable fluent builder whose `.serialize()` yields the
`SqlQueryString` the runtime subscribes with. The surface mirrors what
the reference's Kysely instance exposes to apps: selects with aliases,
inner/left joins (`innerJoin("todoCategory", "todoCategory.id",
"todo.categoryId")`), aggregate functions (`fn.count`), group by,
having, order/limit/offset.

Identifiers are always double-quoted; values always travel as bound
parameters — the builder never interpolates values into SQL.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import List, Optional, Sequence, Tuple, Union

from evolu_tpu_torch.runtime.messages import serialize_query

_OPS = ("=", "!=", "<>", "<", "<=", ">", ">=", "like", "not like", "is", "is not", "in")
_FNS = ("count", "sum", "avg", "min", "max", "total", "group_concat")


def _quote(identifier: str) -> str:
    if "\x00" in identifier:
        raise ValueError("identifier contains NUL")
    return '"' + identifier.replace('"', '""') + '"'


def _quote_ref(ref: str) -> str:
    """Quote a possibly table-qualified reference: `todo.title` →
    `"todo"."title"`, `title` → `"title"`."""
    return ".".join(_quote(part) for part in ref.split("."))


@dataclass(frozen=True)
class Fn:
    """An aggregate select expression, e.g. `fn.count("id").as_("n")`.
    `ref=None` means `*` (COUNT only)."""

    name: str
    ref: Optional[str]
    alias: Optional[str] = None
    distinct: bool = False

    def as_(self, alias: str) -> "Fn":
        return replace(self, alias=alias)

    def sql(self) -> str:
        inner = "*" if self.ref is None else _quote_ref(self.ref)
        if self.distinct:
            inner = "distinct " + inner
        out = f"{self.name}({inner})"
        if self.alias is not None:
            out += f" as {_quote(self.alias)}"
        return out


class fn:
    """Aggregate helpers, the Kysely `fn` namespace analog."""

    @staticmethod
    def _make(name: str, ref: Optional[str], distinct: bool = False) -> Fn:
        if name not in _FNS:
            raise ValueError(f"unsupported function: {name}")
        if ref is None and name != "count":
            raise ValueError(f"{name} requires a column")
        if ref is None and distinct:
            # count(distinct *) is invalid SQLite; failing here beats
            # failing later when the subscribed query first executes.
            raise ValueError("count(distinct) requires a column")
        return Fn(name, ref, None, distinct)

    @staticmethod
    def count(ref: Optional[str] = None, distinct: bool = False) -> Fn:
        return fn._make("count", ref, distinct)

    @staticmethod
    def sum(ref: str) -> Fn:
        return fn._make("sum", ref)

    @staticmethod
    def avg(ref: str) -> Fn:
        return fn._make("avg", ref)

    @staticmethod
    def min(ref: str) -> Fn:
        return fn._make("min", ref)

    @staticmethod
    def max(ref: str) -> Fn:
        return fn._make("max", ref)

    @staticmethod
    def total(ref: str) -> Fn:
        return fn._make("total", ref)

    @staticmethod
    def group_concat(ref: str, distinct: bool = False) -> Fn:
        return fn._make("group_concat", ref, distinct)


# A select item: a (possibly qualified) column ref, a (ref, alias)
# pair, or an aggregate Fn.
SelectItem = Union[str, Tuple[str, str], Fn]


# -- predicate expression trees --
#
# The reference exposes the full Kysely read-only expression surface to
# apps (types.ts:188-280; kysely.ts:12-27): `eb.or([...])`,
# `eb.and([...])`, `eb.not(...)`, `eb.exists(selectFrom(...))`, and
# `in`-subqueries. These nodes are the native analog: an immutable tree
# that `compile()` walks left-to-right so bound-parameter order always
# matches placeholder order.


class Cond:
    """A predicate node. Combine with `&`, `|`, `~` or the `and_` /
    `or_` / `not_` helpers."""

    def sql(self, parameters: List[object]) -> str:
        raise NotImplementedError

    def __and__(self, other: "Cond") -> "Cond":
        return and_(self, other)

    def __or__(self, other: "Cond") -> "Cond":
        return or_(self, other)

    def __invert__(self) -> "Cond":
        return not_(self)


@dataclass(frozen=True)
class Ref:
    """A column reference used as a comparison RHS — compiles to the
    quoted identifier, never a bound parameter. The Kysely `whereRef`
    analog; what makes `exists` subqueries correlated."""

    name: str


def ref(name: str) -> Ref:
    return Ref(name)


@dataclass(frozen=True)
class Comparison(Cond):
    """Leaf: `target op value`. For `in`, value may be a sequence of
    bindables or a QueryBuilder (compiled as a subquery); for any op,
    a `ref(...)` value compares against another column."""

    target: Union[str, Fn]
    op: str
    value: object

    def sql(self, parameters: List[object]) -> str:
        if isinstance(self.target, Fn):
            # Reusing a selected-and-aliased Fn in having() is the
            # natural flow; the alias belongs to the select list only.
            lhs = replace(self.target, alias=None).sql()
        else:
            lhs = _quote_ref(self.target)
        if isinstance(self.value, Ref):
            return f"{lhs} {self.op} {_quote_ref(self.value.name)}"
        if self.op == "in":
            if isinstance(self.value, QueryBuilder):
                sub_sql, sub_params = self.value.compile()
                parameters.extend(sub_params)
                return f"{lhs} in ({sub_sql})"
            values = list(self.value)  # type: ignore[arg-type]
            if not values:
                # SQLite rejects `x in ()` at parse time; an empty set
                # matches nothing, so compile the constant instead of
                # deferring a syntax error to first execution.
                return "1 = 0"
            marks = ", ".join("?" for _ in values)
            parameters.extend(values)
            return f"{lhs} in ({marks})"
        if self.op in ("is", "is not") and self.value is None:
            return f"{lhs} {self.op} null"
        parameters.append(self.value)
        return f"{lhs} {self.op} ?"


@dataclass(frozen=True)
class Group(Cond):
    """`(a AND b AND ...)` / `(a OR b OR ...)` — always parenthesized,
    so nesting needs no precedence bookkeeping."""

    kind: str  # "and" | "or"
    terms: Tuple[Cond, ...]

    def sql(self, parameters: List[object]) -> str:
        inner = f" {self.kind} ".join(t.sql(parameters) for t in self.terms)
        return f"({inner})"


@dataclass(frozen=True)
class Not(Cond):
    term: Cond

    def sql(self, parameters: List[object]) -> str:
        return f"not ({self.term.sql(parameters)})"


@dataclass(frozen=True)
class Exists(Cond):
    """`exists (SELECT ...)`. The subquery may reference outer-table
    columns (correlated); refs compile identically either way."""

    query: "QueryBuilder"
    negate: bool = False

    def sql(self, parameters: List[object]) -> str:
        sub_sql, sub_params = self.query.compile()
        parameters.extend(sub_params)
        keyword = "not exists" if self.negate else "exists"
        return f"{keyword} ({sub_sql})"


# Distinguishes "argument omitted" from an explicit None (NULL bind):
# a forgotten value must fail at build time, not compile to `x = NULL`
# (never true in SQLite — a silently empty subscribed query).
_MISSING = object()


def c(target: Union[str, Fn], op: str, value: object = _MISSING) -> Comparison:
    """Leaf constructor: `c("todo.title", "like", "a%")`."""
    if op.lower() not in _OPS:
        raise ValueError(f"unsupported operator: {op}")
    if value is _MISSING:
        raise ValueError(f"comparison {target!r} {op!r} is missing its value")
    return Comparison(target, op.lower(), value)


def _as_cond(term: object) -> Cond:
    if isinstance(term, Cond):
        return term
    if isinstance(term, tuple) and len(term) == 3:
        return c(*term)
    raise ValueError(f"not a condition: {term!r}")


def and_(*terms: object) -> Cond:
    """`and_(c(...), or_(...), ("col", "=", v))` — tuples are accepted
    as comparison shorthand."""
    if not terms:
        raise ValueError("and_ requires at least one term")
    return Group("and", tuple(_as_cond(t) for t in terms))


def or_(*terms: object) -> Cond:
    if not terms:
        raise ValueError("or_ requires at least one term")
    return Group("or", tuple(_as_cond(t) for t in terms))


def not_(term: object) -> Cond:
    return Not(_as_cond(term))


def exists(query: "QueryBuilder") -> Cond:
    return Exists(query)


def not_exists(query: "QueryBuilder") -> Cond:
    return Exists(query, negate=True)


def _select_sql(item: SelectItem) -> str:
    if isinstance(item, Fn):
        return item.sql()
    if isinstance(item, tuple):
        ref, alias = item
        return f"{_quote_ref(ref)} as {_quote(alias)}"
    return _quote_ref(item)


@dataclass(frozen=True)
class QueryBuilder:
    """An immutable SELECT builder; every method returns a new builder."""

    _table: str
    _columns: Tuple[SelectItem, ...] = ()
    _joins: Tuple[Tuple[str, str, str, str], ...] = ()  # (kind, table, left, right)
    _wheres: Tuple[Cond, ...] = ()
    _group_by: Tuple[str, ...] = ()
    _havings: Tuple[Cond, ...] = ()
    _order_by: Tuple[Tuple[str, str], ...] = ()
    _limit: Optional[int] = None
    _offset: Optional[int] = None

    def select(self, *columns: SelectItem) -> "QueryBuilder":
        return replace(self, _columns=self._columns + columns)

    def select_all(self) -> "QueryBuilder":
        return replace(self, _columns=())

    def inner_join(self, other: str, left_ref: str, right_ref: str) -> "QueryBuilder":
        """`inner_join("todoCategory", "todoCategory.id",
        "todo.categoryId")` — the Kysely innerJoin signature."""
        return replace(
            self, _joins=self._joins + (("inner", other, left_ref, right_ref),)
        )

    def left_join(self, other: str, left_ref: str, right_ref: str) -> "QueryBuilder":
        return replace(
            self, _joins=self._joins + (("left", other, left_ref, right_ref),)
        )

    def where(self, column, op: Optional[str] = None, value: object = _MISSING) -> "QueryBuilder":
        """Either the 3-arg comparison form `where("title", "=", x)` or
        a single expression tree `where(or_(c(...), and_(c(...), ...)))`
        — the Kysely `where(eb => eb.or([...]))` analog. Multiple
        `where()` calls AND together, like Kysely."""
        if op is None:
            term = _as_cond(column)
        else:
            term = c(column, op, value)
        return replace(self, _wheres=self._wheres + (term,))

    def where_is_deleted(self, deleted: bool = False) -> "QueryBuilder":
        """The common soft-delete filter (examples/nextjs/pages/index.tsx
        queries filter `isDeleted is not 1`)."""
        op, v = ("is", 1) if deleted else ("is not", 1)
        return self.where("isDeleted", op, v)

    def group_by(self, *refs: str) -> "QueryBuilder":
        return replace(self, _group_by=self._group_by + refs)

    def having(self, target, op: Optional[str] = None, value: object = _MISSING) -> "QueryBuilder":
        if op is None:
            term = _as_cond(target)
        else:
            term = c(target, op, value)
        return replace(self, _havings=self._havings + (term,))

    def order_by(self, column: str, direction: str = "asc") -> "QueryBuilder":
        if direction.lower() not in ("asc", "desc"):
            raise ValueError(f"bad direction: {direction}")
        return replace(self, _order_by=self._order_by + ((column, direction.lower()),))

    def limit(self, n: int) -> "QueryBuilder":
        return replace(self, _limit=int(n))

    def offset(self, n: int) -> "QueryBuilder":
        return replace(self, _offset=int(n))

    def compile(self) -> Tuple[str, List[object]]:
        """→ (sql, parameters), like Kysely's `.compile()`."""
        cols = ", ".join(_select_sql(c) for c in self._columns) if self._columns else "*"
        sql = f"SELECT {cols} FROM {_quote(self._table)}"
        for kind, other, left_ref, right_ref in self._joins:
            sql += (
                f" {kind} join {_quote(other)}"
                f" on {_quote_ref(left_ref)} = {_quote_ref(right_ref)}"
            )
        parameters: List[object] = []
        if self._wheres:
            sql += " WHERE " + " AND ".join(t.sql(parameters) for t in self._wheres)
        if self._group_by:
            sql += " GROUP BY " + ", ".join(_quote_ref(r) for r in self._group_by)
        if self._havings:
            if not self._group_by:
                raise ValueError("having requires group_by")
            sql += " HAVING " + " AND ".join(t.sql(parameters) for t in self._havings)
        if self._order_by:
            sql += " ORDER BY " + ", ".join(
                f"{_quote_ref(c)} {d}" for c, d in self._order_by
            )
        if self._limit is not None:
            sql += " LIMIT ?"
            parameters.append(self._limit)
        elif self._offset is not None:
            sql += " LIMIT -1"  # SQLite requires LIMIT before OFFSET
        if self._offset is not None:
            sql += " OFFSET ?"
            parameters.append(self._offset)
        return sql, parameters

    def serialize(self) -> str:
        """→ SqlQueryString, the runtime's canonical query key."""
        sql, parameters = self.compile()
        return serialize_query(sql, parameters)


def table(name: str) -> QueryBuilder:
    """Entry point: `table("todo").select("id", "title").where(...)`."""
    return QueryBuilder(name)
