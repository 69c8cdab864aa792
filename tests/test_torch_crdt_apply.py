"""Port parity for the typed-CRDT apply slice as a whole.

JAX `storage.apply.apply_messages` against the port's, on a schema with
every column type (counter, awset, RGA list, tensor sum/mean/max, LWW)
and batches that carry re-deliveries, malformed ops, kills before their
adds, list deletes with inserts anchored on them and tensor set ops
mixed with deltas. Both packages' `DEVICE_FOLD_MIN` is patched to 1 so
the device folds run at this small size (the port's on the CPU, through
the kernels' plain versions). `__message`, every `__crdt_*` table, the
app table and the Merkle tree must be byte-identical."""

import functools
import json
import random
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from evolu_tpu.core import crdt_types as jct
from evolu_tpu.core.merkle import merkle_tree_to_string as jax_tree_string
from evolu_tpu.core.types import TableDefinition as JaxTable
from evolu_tpu.ops.merge import plan_batch_device_full as jax_planner
from evolu_tpu.storage import init_db_model as jax_init
from evolu_tpu.storage import update_db_schema as jax_update
from evolu_tpu.storage.apply import apply_messages as jax_apply
from evolu_tpu.storage.sqlite import PySqliteDatabase as JaxDb
from evolu_tpu_torch.core import crdt_types as ct
from evolu_tpu_torch.core.merkle import merkle_tree_to_string
from evolu_tpu_torch.core.types import CrdtMessage, TableDefinition
from evolu_tpu_torch.ops import cuda_scan
from evolu_tpu_torch.ops.merge import PlannedBatch, plan_batch_device_full, strip_typed_upserts
from evolu_tpu_torch.storage import (
    PySqliteDatabase,
    apply_messages,
    apply_messages_sequential,
    init_db_model,
    update_db_schema,
)
from evolu_tpu_torch.storage.schema import delete_all_tables

from _torch_port_data import (
    TYPED_COLUMNS,
    TYPED_TABLE,
    jax_messages,
    port_messages,
    typed_batches,
)

MNEMONIC = "legal winner thank year wave sausage worth useful legal winner thank yellow"
GOLDEN = json.loads((Path(__file__).parent / "fixtures" / "crdt_golden.json").read_text())
STATE_TABLES = ("__message", "__crdt_schema", "__crdt_counter", "__crdt_set", "__crdt_kill",
                "__crdt_list", "__crdt_list_kill", "__crdt_tensor", TYPED_TABLE)
PORT_PLANNER = functools.partial(plan_batch_device_full, device="cpu")


def _port_db(columns=TYPED_COLUMNS, table=TYPED_TABLE):
    db = PySqliteDatabase()
    init_db_model(db, MNEMONIC)
    update_db_schema(db, [TableDefinition.of(table, columns)], device="cpu")
    return db


def _jax_db():
    db = JaxDb()
    jax_init(db, MNEMONIC)
    jax_update(db, [JaxTable.of(TYPED_TABLE, TYPED_COLUMNS)])
    return db


def _count_calls(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **kw: calls.append(1) or fn(*a, **kw))
    return calls


def _dump(db, tables=STATE_TABLES):
    return {t: sorted(db.exec(f'SELECT * FROM "{t}"'), key=repr) for t in tables}


@pytest.mark.parametrize("planner", ["host", "device"])
@pytest.mark.parametrize("seed", [0, 1])
def test_typed_apply_matches_jax(seed, planner, monkeypatch):
    monkeypatch.setattr(jct, "DEVICE_FOLD_MIN", 1)
    monkeypatch.setattr(ct, "DEVICE_FOLD_MIN", 1)
    sums = _count_calls(monkeypatch, cuda_scan, "segmented_sum_scan_plain")
    maxes = _count_calls(monkeypatch, cuda_scan, "segmented_max_scan_plain")
    pdb, jdb = _port_db(), _jax_db()
    ptree, jtree = {}, {}
    for b in typed_batches(seed):
        ptree = apply_messages(pdb, ptree, port_messages(b), device="cpu",
                               planner=PORT_PLANNER if planner == "device" else None)
        with jax.enable_x64(True):
            jtree = jax_apply(jdb, jtree, jax_messages(b),
                              planner=jax_planner if planner == "device" else None)
    got, want = _dump(pdb), _dump(jdb)
    for t in STATE_TABLES:
        assert got[t] == want[t], t
    assert got["__crdt_tensor"] and got["__crdt_list_kill"] and got["__crdt_kill"]
    assert sums and maxes  # the device folds ran (S's and L's plain versions)
    assert merkle_tree_to_string(ptree) == jax_tree_string(jtree)


@pytest.mark.parametrize("seed", [2, 3])
def test_device_and_host_routes_agree(seed, monkeypatch):
    """The port's device folds (plain versions on the CPU) and its host
    folds give the same end state, and so does the sequential oracle."""
    batches = typed_batches(seed)
    dbs, trees = {}, {}
    for route, fold_min in (("device", 1), ("host", 10**12)):
        monkeypatch.setattr(ct, "DEVICE_FOLD_MIN", fold_min)
        db, tree = _port_db(), {}
        for b in batches:
            tree = apply_messages(db, tree, port_messages(b), device="cpu")
        dbs[route], trees[route] = db, tree
    oracle, oracle_tree = _port_db(), {}
    for b in batches:
        oracle_tree = apply_messages_sequential(oracle, oracle_tree, port_messages(b), device="cpu")
    assert _dump(dbs["device"]) == _dump(dbs["host"]) == _dump(oracle)
    assert (merkle_tree_to_string(trees["device"]) == merkle_tree_to_string(trees["host"])
            == merkle_tree_to_string(oracle_tree))


def test_device_fold_without_a_card_raises_and_rolls_back(monkeypatch):
    """device=None means CUDA: with no card a device-routed fold raises
    (never a quiet CPU fallback) and the batch's transaction rolls back.
    LWW-only batches never resolve the device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(ct, "DEVICE_FOLD_MIN", 1)
    db = _port_db()
    lww = [CrdtMessage(m.timestamp, m.table, m.row, "title", "t") for m in
           port_messages(typed_batches(4)[0][:5])]
    apply_messages(db, {}, lww)
    before = _dump(db)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        apply_messages(db, {}, port_messages(typed_batches(4)[1]))
    assert _dump(db) == before


def test_strip_typed_upserts_every_plan_shape():
    db = _port_db()
    schema = ct.load_schema(db)
    msgs = port_messages(typed_batches(5)[0][:40])
    typed = [i for i, m in enumerate(msgs) if schema.is_typed(m.table, m.column)]
    assert typed and len(typed) < len(msgs)
    mask = np.ones(len(msgs), bool)
    two = strip_typed_upserts(([True] * len(msgs), list(msgs)), msgs, schema)
    three = strip_typed_upserts(([True] * len(msgs), list(msgs), {}), msgs, schema)
    planned = strip_typed_upserts(PlannedBatch([True] * len(msgs), list(msgs), {}, mask), msgs, schema)
    untyped = [m for i, m in enumerate(msgs) if i not in typed]
    assert len(two) == 2 and two[1] == untyped
    assert len(three) == 3 and three[1] == untyped
    assert isinstance(planned, PlannedBatch) and planned[1] == untyped
    assert not planned.upsert_mask[typed].any() and mask.all()


def _golden_msgs(section):
    out = []
    for op in section["ops"]:
        t, r, c = section.get("cell", (op.get("table"), op.get("row"), op.get("column")))
        out.append(CrdtMessage(op["timestamp"], op.get("table", t), op.get("row", r),
                               op.get("column", c), op["value"]))
    return out


@pytest.mark.parametrize("fold_min", [1, 10**12])
@pytest.mark.parametrize("section", ["counter", "awset"])
@pytest.mark.parametrize("seed", [0, 7, 23])
def test_golden_replay_any_order_any_partition(section, seed, fold_min, monkeypatch):
    """crdt_golden.json (hand model, never updated) through the port's
    apply: any permutation, any partition, re-deliveries, both routes."""
    monkeypatch.setattr(ct, "DEVICE_FOLD_MIN", fold_min)
    g = GOLDEN[section]
    msgs = _golden_msgs(g)
    msgs += [msgs[i] for i in g["redeliver"]]
    rng = random.Random(seed)
    rng.shuffle(msgs)
    db = _port_db(("name", "clicks:counter", "tags:awset", "items:list"), "metrics")
    tree, i = {}, 0
    while i < len(msgs):
        j = i + rng.randrange(1, len(msgs) - i + 1)
        tree = apply_messages(db, tree, msgs[i:j], device="cpu")
        i = j
    col = g["cell"][2]
    value = db.exec_sql_query(f'SELECT "{col}" AS v FROM "metrics" WHERE "id" = ?', ("r1",))[0]["v"]
    assert value == g["expected_value"]
    if section == "counter":
        state = db.exec_sql_query('SELECT "pos", "neg" FROM "__crdt_counter"')
        assert (state[0]["pos"], state[0]["neg"]) == (g["expected_pos"], g["expected_neg"])
    else:
        alive = {r["tag"] for r in db.exec_sql_query('SELECT "tag" FROM "__crdt_set" WHERE "alive" = 1')}
        assert alive == set(g["expected_alive_tags"])
    apply_messages(db, tree, msgs, device="cpu")  # re-delivering everything changes nothing
    assert db.exec_sql_query(f'SELECT "{col}" AS v FROM "metrics"')[0]["v"] == g["expected_value"]


def test_golden_mixed_lww_untouched():
    g = GOLDEN["mixed_lww"]
    db = _port_db(("name", "clicks:counter", "tags:awset", "items:list"), "metrics")
    apply_messages(db, {}, _golden_msgs(g) + _golden_msgs(GOLDEN["counter"]), device="cpu")
    row = db.exec_sql_query('SELECT "name", "clicks" FROM "metrics" WHERE "id" = ?', ("r1",))[0]
    assert (row["name"], row["clicks"]) == (g["expected_value"], GOLDEN["counter"]["expected_value"])


def test_schema_registry_late_declaration_and_reset():
    """Declaring a column typed after its ops were logged folds them;
    re-declaring with another type raises; delete_all_tables drops the
    cached schema with the tables."""
    db = _port_db(("title", "votes"), TYPED_TABLE)
    msgs = [CrdtMessage(m.timestamp, m.table, m.row, "votes", 3) for m in
            port_messages(typed_batches(6)[0][:20])]
    apply_messages(db, {}, msgs)
    assert ct.load_schema(db).column_type(TYPED_TABLE, "votes") == "lww"
    update_db_schema(db, [TableDefinition.of(TYPED_TABLE, ("title", "votes:counter"))], device="cpu")
    assert ct.load_schema(db).column_type(TYPED_TABLE, "votes") == "counter"
    totals = {r["id"]: r["votes"] for r in db.exec_sql_query(f'SELECT "id", "votes" FROM "{TYPED_TABLE}"')}
    per_row = {}
    for m in msgs:
        per_row[m.row] = per_row.get(m.row, 0) + 3
    assert totals == per_row
    with pytest.raises(ValueError):
        ct.declare_column_types(db, [(TYPED_TABLE, "votes", "awset")])
    delete_all_tables(db)
    assert not ct.load_schema(db)
    with pytest.raises(ValueError):
        ct.parse_column_spec("votes:bogus")


def test_rebuild_state_and_observed_tags_match_jax(monkeypatch):
    """`rebuild_state` (refold from the full log) leaves the end state as
    the incremental apply made it, and `observed_tags` reads the same
    alive add tags as the JAX package's."""
    monkeypatch.setattr(ct, "DEVICE_FOLD_MIN", 1)
    pdb, jdb = _port_db(), _jax_db()
    for b in typed_batches(8):
        apply_messages(pdb, {}, port_messages(b), device="cpu")
        with jax.enable_x64(True):
            jax_apply(jdb, {}, jax_messages(b))
    before = _dump(pdb)
    ct.rebuild_state(pdb, ct.load_schema(pdb), device="cpu")
    assert _dump(pdb) == before == _dump(jdb)
    for row in sorted({r[2] for r in before["__crdt_set"]}):
        for elem in ("red", "blue", 7):
            assert (ct.observed_tags(pdb, TYPED_TABLE, row, "tags", elem)
                    == jct.observed_tags(jdb, TYPED_TABLE, row, "tags", elem))
