"""Port parity: the public API bindings (`api.query`, `api.model`,
`api.hooks`) against the JAX package's.

Every builder case is built with both packages' `api.query` from the
same lambda and must compile to the same SQL string and parameters and
serialize to the same `SqlQueryString`; every rejected build must raise
the same error type. Every validator and cast case must return the
same value or raise the same error type. Tolerance: exact everywhere."""

import datetime

import pytest

import evolu_tpu.api as japi
import evolu_tpu.api.model as jmodel
import evolu_tpu.api.query as jq

import evolu_tpu_torch.api as papi
import evolu_tpu_torch.api.model as pmodel
import evolu_tpu_torch.api.query as pq

# Each case takes a query module and returns a builder (the cases of
# tests/test_runtime.py's builder tests, plus the shapes path F uses).
BUILDS = {
    "compile": lambda q: q.table("todo").select("id", "title").where("isCompleted", "=", 0)
    .where_is_deleted(False).order_by("createdAt").limit(10),
    "quoted identifiers": lambda q: q.table('t"x').select('c"ol'),
    "inner join with aliases": lambda q: q.table("todo")
    .select(("todo.title", "title"), ("todoCategory.name", "category"))
    .inner_join("todoCategory", "todoCategory.id", "todo.categoryId")
    .where("todo.isDeleted", "is not", 1).order_by("todo.title"),
    "left join": lambda q: q.table("todo").left_join("todoCategory", "todoCategory.id", "todo.categoryId"),
    "aggregates group by having": lambda q: q.table("todo")
    .select("categoryId", q.fn.count("id").as_("n"), q.fn.min("createdAt").as_("first"))
    .group_by("categoryId").having(q.fn.count("id"), ">", 1).order_by("n", "desc"),
    "aliased fn reused in having": lambda q: q.table("todo")
    .select("categoryId", q.fn.count("id").as_("n")).group_by("categoryId")
    .having(q.fn.count("id").as_("n"), ">", 1),
    "every aggregate": lambda q: q.table("t").select(
        q.fn.count(), q.fn.count("a", distinct=True), q.fn.sum("a"), q.fn.avg("a"), q.fn.max("a"),
        q.fn.total("a"), q.fn.group_concat("a", distinct=True)).group_by("b"),
    "or of ands": lambda q: q.table("todo").select("id").where(q.or_(
        q.and_(("isCompleted", "=", 1), ("isDeleted", "is not", 1)), q.c("title", "like", "urgent%"))),
    "operator sugar": lambda q: q.table("t").where(
        (q.c("a", "=", 1) & q.c("b", "=", 2)) | ~q.c("c", "is", None)),
    "chained where with not": lambda q: q.table("t").where("x", "=", 1).where(q.not_(("y", ">", 2))),
    "explicit null": lambda q: q.table("t").where("x", "is", None),
    "correlated exists": lambda q: q.table("todo").select("title").where(q.exists(
        q.table("todoCategory").select("id").where(q.c("todoCategory.id", "=", q.ref("todo.categoryId"))))),
    "not exists": lambda q: q.table("todo").where(q.not_exists(
        q.table("todoCategory").select("id").where(q.c("todoCategory.id", "=", q.ref("todo.categoryId"))))),
    "in subquery between parameters": lambda q: q.table("todo").select("title")
    .where("isDeleted", "is not", 1)
    .where(q.c("categoryId", "in", q.table("todoCategory").select("id").where("name", "=", "work")))
    .where("isCompleted", "=", 0),
    "in empty list": lambda q: q.table("todo").select("id").where(q.c("id", "in", [])),
    "not in empty tuple": lambda q: q.table("todo").where(q.not_(q.c("id", "in", ()))),
    "in list": lambda q: q.table("todo").where(q.c("id", "in", ["a", "b", "c"])),
    "offset without limit": lambda q: q.table("todo").offset(3),
    "limit and offset": lambda q: q.table("todo").select_all().limit(5).offset(2),
    "select_all after select": lambda q: q.table("todo").select("a").select_all(),
    "deleted only": lambda q: q.table("todo").where_is_deleted(True).order_by("id", "DESC"),
}

REJECTS = {
    "bad operator": lambda q: q.table("todo").where("title", "; DROP TABLE", 1),
    "having without group_by": lambda q: q.table("t").having(q.fn.count(), ">", 0).compile(),
    "sum without a column": lambda q: q.fn.sum(None),
    "count distinct star": lambda q: q.fn.count(distinct=True),
    "empty or": lambda q: q.or_(),
    "empty and": lambda q: q.and_(),
    "not a condition": lambda q: q.and_("not-a-condition"),
    "missing value": lambda q: q.table("t").where("isCompleted", "="),
    "in without value": lambda q: q.c("col", "in"),
    "bad direction": lambda q: q.table("t").order_by("a", "sideways"),
    "NUL in identifier": lambda q: q.table("t\x00").compile(),
}

UTC = datetime.timezone.utc
VALIDATORS = [
    ("validate_string_1000", "x" * 1000), ("validate_string_1000", "x" * 1001),
    ("validate_string_1000", 5), ("validate_non_empty_string_1000", "   "),
    ("validate_non_empty_string_1000", "ok"), ("validate_non_empty_string_1000", "y" * 1001),
    ("validate_email", "user@example.com"), ("validate_email", "not-an-email"), ("validate_email", "a@b"),
    ("validate_email", "x y@z.co"), ("validate_email", "user@example.com\n"), ("validate_email", None),
    ("validate_email", 123),
    ("validate_url", "https://example.com/a?b=1"), ("validate_url", "example.com"), ("validate_url", ""),
    ("validate_url", "http://"), ("validate_url", "http://[invalid"), ("validate_url", "http://exa mple.com/x"),
    ("validate_url", "http://\t.com"), ("validate_url", None), ("validate_url", 5),
    ("is_sqlite_boolean", 0), ("is_sqlite_boolean", 1), ("is_sqlite_boolean", 2), ("is_sqlite_boolean", True),
    ("is_sqlite_date", "2024-05-01T12:30:15.123Z"), ("is_sqlite_date", "2024-05-01"),
    ("is_sqlite_date", 7),
    ("cast", True), ("cast", False), ("cast", 1), ("cast", 0), ("cast", 7),
    ("cast", datetime.datetime(2024, 5, 1, 12, 30, 15, 123000, tzinfo=UTC)),
    ("cast", datetime.datetime(1969, 12, 31, 23, 59, 59, 1000, tzinfo=UTC)),
    ("cast", "2024-05-01T12:30:15.123Z"), ("cast", "not a date"), ("cast", 2.5),
    ("sqlite_value", True), ("sqlite_value", datetime.datetime(2030, 1, 2, 3, 4, 5, tzinfo=UTC)),
    ("sqlite_value", "text"), ("sqlite_value", None), ("sqlite_value", 3.25),
    ("is_valid_id", "A" * 21), ("is_valid_id", "A" * 20), ("is_valid_id", "é" * 21),
    ("validate_mnemonic", "legal winner thank year wave sausage worth useful legal winner thank yellow"),
    ("validate_mnemonic", "not a mnemonic at all"),
]


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 - the error type is the outcome
        return ("raises", type(e).__name__)


@pytest.mark.parametrize("case", list(BUILDS))
def test_builder_sql_matches_jax(case):
    jb, pb = BUILDS[case](jq), BUILDS[case](pq)
    assert pb.compile() == jb.compile()
    assert pb.serialize() == jb.serialize()


@pytest.mark.parametrize("case", list(REJECTS))
def test_builder_rejections_match_jax(case):
    want = _outcome(REJECTS[case], jq)
    assert want[0] == "raises"
    assert _outcome(REJECTS[case], pq) == want


@pytest.mark.parametrize("name,value", VALIDATORS, ids=[f"{n}-{i}" for i, (n, _) in enumerate(VALIDATORS)])
def test_model_matches_jax(name, value):
    assert _outcome(getattr(pmodel, name), value) == _outcome(getattr(jmodel, name), value)


def test_model_errors_are_the_port_types():
    """The branded-string errors are the port's own classes, with the
    reference's names and wire types."""
    from evolu_tpu_torch.core.types import EvoluError, StringMaxLengthError, ValidationError

    with pytest.raises(StringMaxLengthError) as e:
        pmodel.validate_string_1000("x" * 1001)
    assert isinstance(e.value, ValidationError) and isinstance(e.value, EvoluError)
    assert e.value.to_dict() == {"type": "StringMaxLengthError"}
    with pytest.raises(ValidationError) as e:
        pmodel.validate_email("nope")
    assert e.value.to_dict() == {"type": "ValidationError"}
    assert pmodel.COMMON_COLUMNS == jmodel.COMMON_COLUMNS
    assert pmodel.__all__ == jmodel.__all__


def test_api_package_exports_match_jax():
    assert papi.__all__ == japi.__all__
    for name in papi.__all__:
        assert getattr(papi, name).__name__.rsplit(".", 1)[-1] == getattr(japi, name).__name__.rsplit(".", 1)[-1]
    with pytest.raises(AttributeError):
        papi.no_such_name  # noqa: B018 - the lazy __getattr__ refuses unknown names
