"""Query dependency extraction for incremental query invalidation.

A copy of `evolu_tpu.storage.deps`, pure Python over SQLite's `EXPLAIN`.

The reactive loop re-runs every subscribed query after every mutation
(reference query.ts:31-76). To gate that loop on the merge planner's
changed-set, each subscribed query needs a *sound over-approximation*
of what it reads:

- **Tables** come from SQLite's own compiled program: `EXPLAIN` lists
  every btree cursor the statement opens (`OpenRead`/`ReopenIdx`, with
  the root page in p2), and `sqlite_master.rootpage → tbl_name` maps
  index cursors back to their owning tables — covering indexes, join
  flattening, subqueries and `EXISTS` all fall out of the bytecode for
  free, which a regex over the SQL never could. Anything the walk
  cannot prove (virtual tables, temp/schema cursors, unmappable root
  pages, EXPLAIN itself failing) degrades to `tables=None` = "don't
  know" = the caller must always re-execute. Non-deterministic SQL
  (`random()`, `'now'`, `CURRENT_*`, …) also degrades: its result can
  change with NO table write, so it must never be gated.

- **Row filters** are extracted only where provably sound: a top-level
  AND-conjunct of the WHERE clause of the exact shape `"id" = ?` /
  `"id" IN (?, …)` (optionally table-qualified) restricts every row
  the query can EVER depend on to those bound ids — regardless of
  predicates, aggregates, limits, or new-row inserts. NOTE this is
  deliberately NOT the "rowIds captured from the last result" sketch:
  a write can flip predicate membership for a row *outside* the last
  result (e.g. toggling `isDeleted`), so result-captured row sets are
  unsound. A static id-constraint is the shape that is sound by
  construction, and it is exactly the per-row detail-view subscription
  that dominates at 10^4+ live subscriptions.

Consumed by `runtime/worker.py::DbWorker._query`; the changed-set side
of the contract lives in `storage/changes.py`.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Mapping, Optional, Sequence

# Cursor-opening opcodes whose p2 is a root page in database p3.
_OPEN_OPCODES = frozenset(("OpenRead", "OpenWrite", "ReopenIdx"))
# Virtual-table opcodes: the cursor has no root page; give up.
_VTAB_OPCODES = frozenset(("VOpen", "VFilter", "VUpdate", "VColumn"))

# Substrings whose presence means the result can change without any
# table write (or depends on connection state). Lower-cased match;
# conservative false positives only cost gating for that one query.
_NONDETERMINISTIC = (
    "random",          # random(), randomblob()
    "'now'",           # datetime('now'), julianday('now'), ...
    "current_",        # CURRENT_TIMESTAMP / CURRENT_DATE / CURRENT_TIME
    "changes(",        # changes(), total_changes()
    "last_insert_rowid",
    # Zero-argument date/time functions default to 'now':
    # datetime() etc. are clock-dependent with no table
    # write. "time(" also covers "datetime("; strftime('%s') defaults
    # to now in recent SQLite.
    "date(",
    "time(",
    "julianday(",
    "unixepoch(",
    "strftime(",
)

# Internal tables written OUTSIDE the apply layer are invisible to the
# changed-set contract (`update_clock` UPDATEs "__clock" on every
# Send/Receive with no record_batch in sight).
# Only the tables the contract explicitly records may be gated;
# reading any other "__" table means "always re-execute".
_RECORDED_INTERNAL = frozenset(
    ("__message", "__crdt_counter", "__crdt_set", "__crdt_kill",
     "__crdt_list", "__crdt_list_kill"))


@dataclass(frozen=True)
class QueryDeps:
    """What a compiled query reads. `tables=None` means unknown —
    conservative full invalidation (the query always re-executes).
    `row_filters[table]` is the frozenset of id values the query's
    result can possibly depend on in that table; a table absent from
    the mapping has no such bound (any row write forces re-execution).
    """

    tables: Optional[FrozenSet[str]]
    row_filters: Mapping[str, FrozenSet] = field(default_factory=dict)


UNKNOWN_DEPS = QueryDeps(None, {})


def query_dependencies(db, sql: str, parameters: Sequence = ()) -> QueryDeps:
    """Dependencies of `sql` against `db`'s current schema. Never
    raises: every failure mode (including SQL that would error at
    execution) returns UNKNOWN_DEPS and lets the real execution own
    the error surface."""
    try:
        tables = _explain_read_tables(db, sql, parameters)
    except Exception:  # noqa: BLE001 - any failure = don't know
        return UNKNOWN_DEPS
    if tables is None:
        return UNKNOWN_DEPS
    if any(t.startswith("__") and t not in _RECORDED_INTERNAL
           for t in tables):
        return UNKNOWN_DEPS
    low = sql.lower()
    if any(tok in low for tok in _NONDETERMINISTIC):
        return UNKNOWN_DEPS
    try:
        filters = _id_row_filters(sql, parameters, tables)
    except Exception:  # noqa: BLE001 - row filters are an optimization
        filters = {}
    return QueryDeps(frozenset(tables), filters)


def _root_map(db) -> dict:
    """rootpage → owning table, for both table and index btrees.
    Cached on the connection keyed by `PRAGMA schema_version` (bumps on
    any DDL), so building the dependency index for 10^4 subscriptions
    does not rescan sqlite_master 10^4 times."""
    version = db.exec_sql_query("PRAGMA schema_version")[0]["schema_version"]
    cached = getattr(db, "_deps_root_cache", None)
    if cached is not None and cached[0] == version:
        return cached[1]
    # Lower-cased names: the ChangedSet side of the contract records
    # wire-verbatim table names folded the same way (SQLite identifier
    # resolution is case-insensitive, so "Todo" on the wire writes the
    # table created as "todo" — unfolded names would look disjoint).
    root_map = {
        int(r["rootpage"]): r["tbl_name"].lower()
        for r in db.exec_sql_query(
            'SELECT "tbl_name", "rootpage" FROM "sqlite_master" '
            'WHERE "rootpage" > 0'
        )
    }
    try:
        db._deps_root_cache = (version, root_map)
    except AttributeError:  # __slots__ backend: stay uncached
        pass
    return root_map


def _explain_read_tables(db, sql, parameters) -> Optional[set]:
    """Tables read by the compiled statement, via the VDBE listing.
    None = unverifiable (virtual/temp/schema cursor or unmapped root
    page)."""
    rows = db.exec_sql_query("EXPLAIN " + sql, parameters)
    root_map = _root_map(db)
    tables: set = set()
    for r in rows:
        op = r.get("opcode")
        if op in _VTAB_OPCODES:
            return None
        if op not in _OPEN_OPCODES:
            continue
        if int(r.get("p3") or 0) != 0:
            return None  # temp or attached database: out of scope
        root = int(r.get("p2") or 0)
        name = root_map.get(root)
        if name is None:
            return None  # sqlite_master itself (root 1) or unknown
        tables.add(name)
    return tables


# -- row filters --------------------------------------------------------

_WHERE_END_KEYWORDS = (" group by ", " order by ", " having ", " limit ",
                       " offset ", " window ")
_COMPOUND_KEYWORDS = (" union ", " intersect ", " except ")

_ID_CONJUNCT = re.compile(
    r'^(?:"((?:[^"]|"")+)"\s*\.\s*)?"id"\s+(?:=|in)\s+(.*)$',
    re.IGNORECASE | re.DOTALL,
)
_PLACEHOLDER = re.compile(r"^\?$")
_IN_PLACEHOLDERS = re.compile(r"^\(\s*\?(?:\s*,\s*\?)*\s*\)$")


_WORD_CHARS = frozenset("abcdefghijklmnopqrstuvwxyz0123456789_")


def _keyword_at(low: str, i: int, kw: str) -> bool:
    """Token-wise keyword match. SQLite tokenizes `x=? or"b"=?` with no
    surrounding spaces, so matching ' or ' with mandatory spaces misses
    real operators."""
    if not low.startswith(kw, i):
        return False
    if i > 0 and low[i - 1] in _WORD_CHARS:
        return False
    j = i + len(kw)
    return j >= len(low) or low[j] not in _WORD_CHARS


def _top_level_conjuncts(where: str):
    """(start, end) spans of the top-level AND conjuncts of a WHERE
    body, or None when no conjunct is provably top-level. AND binds
    tighter than OR, so in `a OR b AND "id" = ?` the id equality is a
    conjunct of the OR's right arm, not of the WHERE (a write to a
    row matching `a` can change the result) — ANY depth-0 OR therefore bails, mirroring
    the _COMPOUND_KEYWORDS bail. Quoted identifiers are skipped so
    their content can neither hide a keyword nor skew paren depth;
    unbalanced parens or an unterminated quote (also what the
    WHERE-end trim leaves when it cut inside one) bail too."""
    low = where.lower()
    if len(low) != len(where):  # non-ASCII case folding moved offsets
        return None
    n = len(low)
    splits = []
    depth = 0
    i = 0
    while i < n:
        ch = low[i]
        if ch == '"':
            j = low.find('"', i + 1)
            while j != -1 and low.startswith('""', j):
                j = low.find('"', j + 2)
            if j == -1:
                return None
            i = j + 1
            continue
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth < 0:
                return None
        elif depth == 0:
            if _keyword_at(low, i, "or"):
                return None
            if _keyword_at(low, i, "between"):
                # BETWEEN's AND is an operand separator, not a conjunct
                # boundary: `"a" BETWEEN ? AND "id" = ?` parses as
                # `("a" BETWEEN ? AND "id") = ?`, which only the str-only value
                # screen keeps sound today.
                return None
            if _keyword_at(low, i, "and"):
                splits.append(i)
                i += 3
                continue
        i += 1
    if depth != 0:
        return None
    spans = []
    prev = 0
    for s in splits:
        spans.append((prev, s))
        prev = s + 3
    spans.append((prev, n))
    return spans


def _find_depth0(low: str, needle: str, start: int = 0) -> int:
    """First depth-0 occurrence of `needle` in the lower-cased SQL."""
    depth = 0
    i = 0
    n = len(low)
    while i < n:
        ch = low[i]
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        elif depth == 0 and i >= start and low.startswith(needle, i):
            return i
        i += 1
    return -1


def _from_source_count(low: str, where_pos: int, table: str) -> int:
    """How many times `table` appears as a SOURCE (not a column
    qualifier) in the FROM clause. A self-join opens a second,
    UNCONSTRAINED cursor over the same table — `"t"."id" = ?` then
    bounds only one of them — so an id filter is
    sound only when the table is a source exactly once."""
    fs = _find_depth0(low, " from ")
    if fs < 0 or fs > where_pos:
        return 0
    seg = low[fs + 6 : where_pos]
    t = table.lower()
    pat = re.compile(
        '"%s"|\\b%s\\b' % (re.escape(t.replace('"', '""')), re.escape(t)))
    n = 0
    for m in pat.finditer(seg):
        if seg[m.end():].lstrip().startswith("."):
            continue  # qualifier use ("t"."col"), not a source
        n += 1
    return n


def _id_row_filters(sql: str, parameters: Sequence, tables) -> Dict[str, FrozenSet]:
    """`{table: frozenset(ids)}` for top-level `"id" = ?` / `"id" IN
    (?, …)` conjuncts. Empty dict whenever anything is uncertain."""
    if ("'" in sql or '"?"' in sql or "`" in sql or "[" in sql
            or "--" in sql or "/*" in sql):
        # String literals could hide '?' (indexing unmappable); `...`
        # and [...] alternative identifier quoting, and -- or /* ... */
        # comments, could hide keywords or skew the paren/quote scan
        # (a '(' or '"' inside a comment would swallow a real depth-0
        # OR). Give up. ("--" also matches `a - -b` arithmetic: only
        # costs that query its row filter.)
        return {}
    if sql.count("?") != len(parameters):
        return {}  # numbered/named placeholders: positions unmappable
    low = sql.lower()
    if low.count("select") > 1 or "exists" in low:
        # A subquery/EXISTS can read the SAME table through a second,
        # UNCONSTRAINED cursor (e.g. a scalar `(SELECT count(*) FROM
        # "t")` next to `FROM "t" WHERE "id" = ?`) — the id conjunct
        # then bounds only the outer cursor, not the result. Table
        # gating still applies; row filters give up.
        return {}
    if any(_find_depth0(low, k) >= 0 for k in _COMPOUND_KEYWORDS):
        return {}
    ws = _find_depth0(low, " where ")
    if ws < 0:
        return {}
    body_start = ws + len(" where ")
    end = len(sql)
    for kw in _WHERE_END_KEYWORDS:
        p = _find_depth0(low, kw, body_start)
        if 0 <= p < end:
            end = p
    where = sql[body_start:end]
    spans = _top_level_conjuncts(where)
    if spans is None:
        return {}  # depth-0 OR / unparseable structure: no conjunct is sound
    filters: Dict[str, FrozenSet] = {}
    for cstart, cend in spans:
        conj = where[cstart:cend].strip()
        m = _ID_CONJUNCT.match(conj)
        if not m:
            continue
        qualifier, rhs = m.group(1), m.group(2).strip()
        if _PLACEHOLDER.match(rhs):
            count = 1
        elif _IN_PLACEHOLDERS.match(rhs):
            count = rhs.count("?")
        else:
            continue
        if qualifier is not None:
            t = qualifier.replace('""', '"').lower()
            if t not in tables:
                continue  # alias or unknown: cannot attribute soundly
        elif len(tables) == 1:
            t = next(iter(tables))
        else:
            continue  # unqualified id in a join: ambiguous attribution
        if _from_source_count(low, ws, t) != 1:
            continue  # self-join (or unparseable FROM): second cursor
        k = sql[: body_start + cstart].count("?")
        values = frozenset(parameters[k : k + count])
        if any(not isinstance(v, str) for v in values):
            # SQLite's TEXT affinity coerces a non-str bound value at
            # comparison time (id = 5 matches the row whose id is '5'),
            # but the gate compares Python sets against the changed-set's
            # str rowIds — frozenset({5}) would be "disjoint" from
            # {'5'} and wrongly skip. Only str values are sound.
            continue
        # Multiple id-conjuncts on one table only ever narrow further;
        # keep the smallest set.
        prev = filters.get(t)
        if prev is None or len(values) < len(prev):
            filters[t] = values
    return filters
