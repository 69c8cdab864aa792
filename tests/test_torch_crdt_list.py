"""Port parity: the RGA list (`core/crdt_list.py`,
`ops/crdt_list_merge.py`) against the JAX package, exactly, on random
forests with orphans (dangling origins) and tombstones, and the golden
`tests/fixtures/crdt_list_golden.json` (never updated) through the
port's `replay_log` and apply."""

import json
import random
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evolu_tpu.core import crdt_list as jcl
from evolu_tpu.core.types import CrdtMessage as JaxMessage
from evolu_tpu.ops import crdt_list_merge as jlm
from evolu_tpu_torch.core import crdt_list as cl
from evolu_tpu_torch.core import crdt_types as ct
from evolu_tpu_torch.core.types import CrdtMessage, TableDefinition
from evolu_tpu_torch.ops import crdt_list_merge as plm
from evolu_tpu_torch.storage import PySqliteDatabase, apply_messages, init_db_model, update_db_schema

GOLDEN = json.loads((Path(__file__).parent / "fixtures" / "crdt_list_golden.json").read_text())
SECTIONS = ["list", "same_anchor", "delete_before_insert"]


def _random_forest(rng, n_cells, max_elems):
    """(cell_id, parent_ix, alive, spans, tags, origins) in the device
    layout: ascending (cell, tag), parents resolved by the oracle's rule
    (dangling origins and origins not below the tag → -1)."""
    cell_id, parent, alive, tags, origins, spans = [], [], [], [], [], []
    base = 0
    for c in range(n_cells):
        n = rng.randrange(1, max_elems)
        ctags = sorted({f"c{c}-{rng.randrange(10**9):010d}" for _ in range(n)})
        for j, t in enumerate(ctags):
            roll = rng.random()
            if roll < 0.3 or j == 0:
                o = ""
            elif roll < 0.8:
                o = ctags[rng.randrange(j)]
            elif roll < 0.9:
                o = ctags[rng.randrange(j, len(ctags))]  # not below the tag: orphan
            else:
                o = "zzzz-dangling"
            p = base + ctags.index(o) if (o in ctags and o < t) else -1
            cell_id.append(c)
            parent.append(p)
            alive.append(rng.randrange(2))
            tags.append(t)
            origins.append(o)
        spans.append((base, len(ctags)))
        base += len(ctags)
    return (np.array(cell_id, np.int32), np.array(parent, np.int32),
            np.array(alive, np.int32), spans, tags, origins)


@pytest.mark.parametrize("seed,n_cells,max_elems", [(3, 5, 80), (31, 1, 300), (555, 40, 30), (8, 200, 40)])
def test_rga_order_matches_jax_and_oracle(seed, n_cells, max_elems):
    rng = random.Random(seed)
    cell_id, parent, alive, spans, tags, origins = _random_forest(rng, n_cells, max_elems)
    pos, slot = plm.rga_order(cell_id, parent, alive, device="cpu")
    j_pos, j_slot = jlm.rga_order(cell_id, parent, alive)
    assert pos.dtype == np.int32 and slot.dtype == np.int32
    np.testing.assert_array_equal(pos, j_pos)
    np.testing.assert_array_equal(slot, j_slot)
    for b, n in spans:
        assert list(pos[b:b + n]) == cl.linearize(tags[b:b + n], origins[b:b + n])


def test_rga_order_matches_pallas_interpret():
    rng = random.Random(9)
    cell_id, parent, alive, *_ = _random_forest(rng, 3, 60)
    pos, slot = plm.rga_order(cell_id, parent, alive, device="cpu")
    j_pos, j_slot = jlm.rga_order(cell_id, parent, alive, interpret_pallas=True)
    np.testing.assert_array_equal(pos, j_pos)
    np.testing.assert_array_equal(slot, j_slot)


def test_rga_order_deep_chain_and_bounds():
    n = 1000
    pos, slot = plm.rga_order(np.zeros(n, np.int32), np.arange(-1, n - 1, dtype=np.int32),
                              np.ones(n, np.int32), device="cpu")
    assert np.array_equal(pos, np.arange(n)) and np.array_equal(slot, np.arange(n))
    big = cl.DEVICE_MAX_ELEMS + 1
    with pytest.raises(ValueError):
        plm.rga_order(np.zeros(big, np.int32), np.full(big, -1, np.int32), np.ones(big, np.int32),
                      device="cpu")
    with pytest.raises(ValueError):
        plm.rga_order(np.array([cl.DEVICE_MAX_CELLS + 1], np.int32), np.array([-1], np.int32),
                      np.ones(1, np.int32), device="cpu")
    assert cl.DEVICE_MAX_ELEMS == jcl.DEVICE_MAX_ELEMS and cl.DEVICE_MAX_CELLS == jcl.DEVICE_MAX_CELLS


@pytest.mark.parametrize("seed", [12, 13])
def test_list_shard_order_core_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = 2048
    owner = np.sort(rng.integers(0, 5, n)).astype(np.int64)
    cells = rng.integers(0, 7, n).astype(np.int32)
    cells[-48:] = 0x7FFFFFFF  # padding rows
    parent = np.full(n, -1, np.int32)
    alive = rng.integers(0, 2, n).astype(np.int32)
    groups = {}
    for i in range(n):
        lst = groups.setdefault((int(owner[i]), int(cells[i])), [])
        if lst and rng.random() < 0.7:
            parent[i] = lst[int(rng.integers(0, len(lst)))]
        lst.append(i)
    got = plm.list_shard_order_core(*(torch.from_numpy(a) for a in (owner, cells, parent, alive)))
    with jax.enable_x64(True):
        want = jax.jit(jlm.list_shard_order_core)(*(jnp.asarray(a) for a in (owner, cells, parent, alive)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_linearize_matches_jax():
    rng = random.Random(4)
    for _ in range(20):
        n = rng.randrange(1, 60)
        tags = [f"{rng.randrange(10**6):07d}" for _ in range(n)]
        tags = sorted(set(tags))
        origins = [rng.choice(["", "x"] + tags) for _ in tags]
        assert cl.linearize(tags, origins) == jcl.linearize(tags, origins)


def _golden_msgs(section, cls=CrdtMessage):
    t, r, c = section["cell"]
    return [cls(op["timestamp"], t, r, c, op["value"]) for op in section["ops"]]


@pytest.mark.parametrize("section", SECTIONS)
def test_golden_replay_log(section):
    g = GOLDEN[section]
    msgs = _golden_msgs(g)
    msgs += [msgs[i] for i in g["redeliver"]]
    rng = random.Random(1)
    for _ in range(4):
        rng.shuffle(msgs)
        got = cl.replay_log(msgs)
        assert got[tuple(g["cell"])] == g["expected_value"]
        want = jcl.replay_log([JaxMessage(m.timestamp, m.table, m.row, m.column, m.value) for m in msgs])
        assert got == want


@pytest.mark.parametrize("fold_min", [1, 10**12])
@pytest.mark.parametrize("section", SECTIONS)
@pytest.mark.parametrize("seed", [0, 23])
def test_golden_apply_any_order_any_partition(section, seed, fold_min, monkeypatch):
    monkeypatch.setattr(ct, "DEVICE_FOLD_MIN", fold_min)
    g = GOLDEN[section]
    table, row, column = g["cell"]
    msgs = _golden_msgs(g)
    msgs += [msgs[i] for i in g["redeliver"]]
    rng = random.Random(seed)
    rng.shuffle(msgs)
    db = PySqliteDatabase()
    init_db_model(db)
    update_db_schema(db, [TableDefinition.of(table, ("title", f"{column}:list"))], device="cpu")
    tree, i = {}, 0
    while i < len(msgs):
        j = i + rng.randrange(1, len(msgs) - i + 1)
        tree = apply_messages(db, tree, msgs[i:j], device="cpu")
        i = j
    value = db.exec_sql_query(f'SELECT "{column}" AS v FROM "{table}" WHERE "id" = ?', (row,))[0]["v"]
    assert value == g["expected_value"]
    assert [t for t, _v in cl.list_state(db, table, row, column)] == [
        t for t in g["expected_order_tags"] if t not in g["expected_dead_tags"]]
