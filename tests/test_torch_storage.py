"""Port twin of `tests/test_storage.py`: storage bootstrap, schema
evolution, clock persistence and identity on the port's storage package,
each against the JAX package's on the same inputs.

| JAX test | port test |
|---|---|
| `test_init_db_model_bootstrap_and_idempotence` | `test_init_db_model_bootstrap_and_idempotence` |
| `test_clock_roundtrip` | `test_clock_roundtrip` |
| `test_update_db_schema_create_and_alter` | `test_update_db_schema_create_and_alter` |
| `test_delete_all_tables` | `test_delete_all_tables` |
| `test_transaction_rollback` | `test_transaction_rollback` |
| `test_mnemonic_generate_validate` | `test_mnemonic_generate_validate` |

Each test runs on both storage backends ("python", "native") where the
reference's runs on the default one; tolerance: exact."""

import pytest
from _torch_jax_state import jax_process_state  # noqa: F401  (the JAX package's native libraries and ledger)

import evolu_tpu.core.mnemonic as jmnemonic
import evolu_tpu.core.types as jt
import evolu_tpu.storage as jstorage
from evolu_tpu_torch.core.mnemonic import generate_mnemonic, validate_mnemonic
from evolu_tpu_torch.core.ids import mnemonic_to_owner_id
from evolu_tpu_torch.core.types import CrdtClock, TableDefinition, Timestamp
from evolu_tpu_torch.storage import (
    delete_all_tables,
    get_existing_tables,
    init_db_model,
    open_database as _open_database,
    read_clock,
    update_clock,
    update_db_schema,
)
from evolu_tpu_torch.core.merkle import insert_into_merkle_tree

BACKENDS = ("python", "native")
MNEMONIC = "legal winner thank year wave sausage worth useful legal winner thank yellow"


@pytest.fixture(params=BACKENDS)
def open_database(request):
    return lambda: _open_database(backend=request.param)


def _schema_dump(db):
    return db.exec_sql_query("SELECT type, name, sql FROM sqlite_schema ORDER BY name")


def test_init_db_model_bootstrap_and_idempotence(open_database):
    db = open_database()
    owner = init_db_model(db, mnemonic=MNEMONIC)
    jdb = jstorage.open_database(backend="python")
    jowner = jstorage.init_db_model(jdb, mnemonic=MNEMONIC)
    assert (owner.id, owner.mnemonic) == (jowner.id, jowner.mnemonic)
    assert _schema_dump(db) == _schema_dump(jdb)
    assert db.exec('SELECT * FROM "__owner"') == jdb.exec('SELECT * FROM "__owner"')
    # The initial clock: millis 0, counter 0, a random node, an empty tree.
    (ts, tree), = db.exec('SELECT * FROM "__clock"')
    (jts, jtree), = jdb.exec('SELECT * FROM "__clock"')
    assert (ts[:30], len(ts), tree) == (jts[:30], len(jts), jtree)
    assert owner.id == mnemonic_to_owner_id(owner.mnemonic)
    assert len(owner.id) == 21
    # Idempotent: second init returns the same owner, keeps data.
    owner2 = init_db_model(db)
    assert owner2 == owner
    clock = read_clock(db)
    assert clock.timestamp.millis == 0 and clock.timestamp.counter == 0
    assert clock.merkle_tree == {}


def test_clock_roundtrip(open_database):
    db = open_database()
    init_db_model(db)
    t = Timestamp(1656873738591, 7, "aaaaaaaaaaaaaaaa")
    tree = insert_into_merkle_tree(t, {})
    update_clock(db, CrdtClock(t, tree))
    jdb = jstorage.open_database(backend="python")
    jstorage.init_db_model(jdb)
    jts = jt.Timestamp(1656873738591, 7, "aaaaaaaaaaaaaaaa")
    import evolu_tpu.core.merkle as jmerkle

    jstorage.update_clock(jdb, jt.CrdtClock(jts, jmerkle.insert_into_merkle_tree(jts, {})))
    assert db.exec('SELECT * FROM "__clock"') == jdb.exec('SELECT * FROM "__clock"')
    clock = read_clock(db)
    assert clock.timestamp == t
    assert clock.merkle_tree == tree


def test_update_db_schema_create_and_alter(open_database):
    db = open_database()
    init_db_model(db)
    update_db_schema(db, [TableDefinition.of("todo", ["title", "isCompleted"])])
    assert get_existing_tables(db) == {"todo"}
    cols = {r["name"] for r in db.exec_sql_query("PRAGMA table_info (todo)")}
    assert cols == {"id", "title", "isCompleted"}
    # Add-only migration: new column appears, nothing dropped.
    update_db_schema(db, [TableDefinition.of("todo", ["title", "isCompleted", "dueAt"])])
    cols = {r["name"] for r in db.exec_sql_query("PRAGMA table_info (todo)")}
    assert "dueAt" in cols and "title" in cols
    jdb = jstorage.open_database(backend="python")
    jstorage.init_db_model(jdb)
    for columns in (["title", "isCompleted"], ["title", "isCompleted", "dueAt"]):
        jstorage.update_db_schema(jdb, [jt.TableDefinition.of("todo", columns)])
    assert _schema_dump(db) == _schema_dump(jdb)


def test_delete_all_tables(open_database):
    db = open_database()
    init_db_model(db)
    update_db_schema(db, [TableDefinition.of("todo", ["title"])])
    delete_all_tables(db)
    rows = db.exec_sql_query("SELECT name FROM sqlite_schema WHERE type='table'")
    assert rows == []


def test_transaction_rollback(open_database):
    db = open_database()
    init_db_model(db)
    update_db_schema(db, [TableDefinition.of("todo", ["title"])])
    with pytest.raises(RuntimeError):
        with db.transaction():
            db.run('INSERT INTO "todo" ("id", "title") VALUES (?, ?)', ("x" * 21, "a"))
            raise RuntimeError("boom")
    assert db.exec_sql_query('SELECT * FROM "todo"') == []


def test_mnemonic_generate_validate():
    m = generate_mnemonic()
    assert len(m.split(" ")) == 12
    assert validate_mnemonic(m)
    assert not validate_mnemonic("abandon " * 12)
    # BIP-39 spec test vector (entropy 0x7f...7f).
    assert validate_mnemonic(
        "legal winner thank year wave sausage worth useful legal winner thank yellow"
    )
    assert not validate_mnemonic("not a mnemonic at all")
    # The reference's answers on the same words, and its owner id.
    for words in (m, "abandon " * 12, MNEMONIC, "not a mnemonic at all"):
        assert validate_mnemonic(words) == jmnemonic.validate_mnemonic(words)
    import evolu_tpu.core.ids as jids

    assert mnemonic_to_owner_id(m) == jids.mnemonic_to_owner_id(m)
