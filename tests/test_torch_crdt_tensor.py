"""Port parity: tensor columns (`core/crdt_tensor.py`,
`ops/crdt_tensor_merge.py`) against the JAX package, exactly: the cell
folds for sum, mean and max in f32 and bf16, the shard sums on their
packed and wide routes, bf16 done without `ml_dtypes` (pinned here
against it), and the golden `tests/fixtures/crdt_tensor_golden.json`
(never updated) through the port's `replay_log`."""

import json
import random
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from evolu_tpu.core import crdt_tensor as jtz
from evolu_tpu.core.types import CrdtMessage as JaxMessage
from evolu_tpu.ops import crdt_tensor_merge as jtm
from evolu_tpu_torch.core import crdt_tensor as tz
from evolu_tpu_torch.core import crdt_types as ct
from evolu_tpu_torch.core.types import CrdtMessage, TableDefinition
from evolu_tpu_torch.ops import crdt_tensor_merge as ptm
from evolu_tpu_torch.storage import PySqliteDatabase, apply_messages, init_db_model, update_db_schema

GOLDEN = json.loads((Path(__file__).parent / "fixtures" / "crdt_tensor_golden.json").read_text())
SECTIONS = [k for k in GOLDEN if k != "_comment"]
TYPES = ["tensor:sum:f32:4", "tensor:sum:bf16:3", "tensor:mean:f32:2", "tensor:mean:bf16:3",
         "tensor:max:f32:5", "tensor:max:bf16:2"]


def _golden_expected_bytes(section):
    cfg = jtz.parse_tensor_type(section["column_type"])
    return np.asarray(section["expected_elements"], np.float64).astype(jtz._np_dtype(cfg)).tobytes()


# --- bf16 without ml_dtypes ---


def test_bf16_bits_match_ml_dtypes():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2**32, 200_000, dtype=np.uint64).astype(np.uint32)
    f32 = bits.view(np.float32)
    f32 = f32[np.isfinite(f32)]
    f64 = np.concatenate([
        f32.astype(np.float64) * (1 + rng.uniform(-2**-20, 2**-20, len(f32))),
        [1.00390625 + 2**-30, 1.00390625, 1.01171875, -1.00390625 - 2**-30,
         3.3895313892515355e38, 3.4e38, 0.0, -0.0, 2**-140, -(2**-149)],
    ])
    f64 = f64[np.isfinite(f64) & (np.abs(f64) < 3.4028234e38)]
    for x in (f32, f64):
        np.testing.assert_array_equal(tz.bf16_bits(x), x.astype(ml_dtypes.bfloat16).view(np.uint16))
    u16 = rng.integers(0, 2**16, 50_000).astype(np.uint16)
    cfg = tz.parse_tensor_type("tensor:max:bf16:1")
    widened = np.concatenate([tz._payload_f32(cfg, b.tobytes()) for b in u16[:, None]])
    want = u16.view(ml_dtypes.bfloat16).astype(np.float32)
    np.testing.assert_array_equal(widened.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("type_string", TYPES)
def test_codecs_and_finalize_match_jax(type_string):
    cfg, jcfg = tz.parse_tensor_type(type_string), jtz.parse_tensor_type(type_string)
    rng = np.random.default_rng(len(type_string))
    for _ in range(50):
        arr = (rng.random(cfg.shape) * 200 - 100).astype(np.float32)
        count = int(rng.integers(1, 9)) if cfg.monoid == "mean" else 1
        v = tz.tensor_delta_value(cfg, arr, count)
        assert v == jtz.tensor_delta_value(jcfg, arr, count)
        assert tz.tensor_set_value(cfg, arr, count) == jtz.tensor_set_value(jcfg, arr, count)
        op = tz.decode_tensor_op(cfg, v)
        assert op == jtz.decode_tensor_op(jcfg, v)
        np.testing.assert_array_equal(tz.quantize(cfg, op[1]), jtz.quantize(jcfg, op[1]))
        np.testing.assert_array_equal(tz.monotone_key(cfg, op[1]), jtz.monotone_key(jcfg, op[1]))
        acc = rng.integers(0, 2**64, cfg.size, dtype=np.uint64)
        if cfg.monoid == "max":  # keys of finite values: codecs reject the rest
            finite = (rng.standard_normal(cfg.size) * 1e30).astype(np.float32)
            acc = tz.monotone_key(tz.parse_tensor_type(f"tensor:max:f32:{cfg.size}"),
                                  finite.tobytes()).astype(np.uint64)
        den = int(rng.integers(1, 2**20))
        assert tz._finalize(cfg, acc, den) == jtz._finalize(jcfg, acc, den)
    for bad in ("x", '["d","%%"]', json.dumps(["d", "AAAA"]), None):
        with pytest.raises(ValueError):
            tz.decode_tensor_op(cfg, bad)


# --- the device folds ---


def _ts(i):
    return f"2023-11-14T22:13:20.000Z-{i:04X}-aaaaaaaaaaaaaaa1"


def _contributions(rng, cfg, n_cells, max_ops):
    """Random set/delta ops per cell → masked contributions as the
    materializer builds them (cell_id, (n, size) u64, dens, plans)."""
    plans = {}
    t = 0
    for c in range(n_cells):
        ops = []
        for _ in range(int(rng.integers(1, max_ops + 1))):
            vals = (rng.random(cfg.size) * 64.0 - 32.0).astype(np.float32)
            payload = tz._element_bytes(cfg, vals)
            kind = "s" if rng.random() < 0.25 else "d"
            count = int(rng.integers(1, 9)) if cfg.monoid == "mean" else 1
            ops.append((_ts(t), kind, count, payload))
            t += 1
        plans[c] = tz.contributing_ops(ops)
    cell_id, rows = [], []
    for c, contribs in plans.items():
        for _kind, count, payload in contribs:
            if cfg.monoid == "max":
                rows.append(tz.monotone_key(cfg, payload).astype(np.uint64))
            else:
                k = count if cfg.monoid == "mean" else 1
                rows.append(tz.quantize(cfg, payload).view(np.uint64) * np.uint64(k))
            cell_id.append(c)
    return np.asarray(cell_id, np.int32), np.stack(rows), plans


@pytest.mark.parametrize("type_string", TYPES)
@pytest.mark.parametrize("seed", [2, 17])
def test_tensor_cell_folds_match_jax(type_string, seed):
    cfg = tz.parse_tensor_type(type_string)
    rng = np.random.default_rng(seed)
    n_cells = int(rng.integers(3, 300))
    cell_id, contrib, plans = _contributions(rng, cfg, n_cells, 12)
    perm = rng.permutation(len(cell_id))
    got = ptm.tensor_cell_folds(cell_id[perm], contrib[perm], n_cells, cfg.monoid, device="cpu")
    want = jtm.tensor_cell_folds(cell_id, contrib, n_cells, cfg.monoid)
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, want)
    for c, contribs in plans.items():
        dens = sum(k for _, k, _ in contribs) if cfg.monoid == "mean" else 1
        assert tz._finalize(cfg, got[c], dens) == tz._fold_contributions(cfg, contribs)


def test_tensor_cell_folds_wrap_mod_2_64():
    """Full-range u64 contributions: the sum fold wraps exactly."""
    rng = np.random.default_rng(5)
    cell_id = rng.integers(0, 9, 3000).astype(np.int32)
    contrib = rng.integers(0, 2**64, (3000, 3), dtype=np.uint64)
    got = ptm.tensor_cell_folds(cell_id, contrib, 9, "sum", device="cpu")
    np.testing.assert_array_equal(got, jtm.tensor_cell_folds(cell_id, contrib, 9, "sum"))
    want = np.zeros((9, 3), np.uint64)
    np.add.at(want, cell_id, contrib)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("variant", ["packed", "wide"])
def test_tensor_shard_sums_match_jax(variant):
    rng = np.random.default_rng(11)
    n, width = 2048, 3
    owner = rng.integers(0, 6, n).astype(np.int64)
    cell = (rng.integers(0, 40, n) * 6 + owner).astype(np.int64)
    if variant == "wide":
        cell = cell + (1 << 26)  # past the packed 2^25 cell budget
    contrib = rng.integers(0, 2**64, (n, width), dtype=np.uint64)
    got = ptm.tensor_shard_sums(owner, cell, contrib, device="cpu")
    want = jtm.tensor_shard_sums(owner, cell, contrib)
    assert set(got) == set(want) and len(got) > 100
    for key in want:
        assert got[key].dtype == np.int64
        np.testing.assert_array_equal(got[key], want[key])


def test_tensor_shard_sums_cores_route_by_host_maxima(monkeypatch):
    calls = []
    for name in ("tensor_shard_sums_core", "tensor_shard_sums_wide_core"):
        fn = getattr(ptm, name)
        monkeypatch.setattr(ptm, name, lambda *a, _n=name, _f=fn: calls.append(_n) or _f(*a))
    contrib = np.ones((4, 2), np.uint64)
    ptm.tensor_shard_sums(np.array([1, 2, 3, 4094]), np.arange(4), contrib, device="cpu")
    ptm.tensor_shard_sums(np.array([1, 2, 3, 4095]), np.arange(4), contrib, device="cpu")
    ptm.tensor_shard_sums(np.arange(4), np.array([0, 1, 2, 1 << 25]), contrib, device="cpu")
    assert calls == ["tensor_shard_sums_core", "tensor_shard_sums_wide_core", "tensor_shard_sums_wide_core"]


# --- goldens (hand model; never updated) ---


@pytest.mark.parametrize("section", SECTIONS)
def test_golden_replay_log(section):
    g = GOLDEN[section]
    t, r, c = g["cell"]
    msgs = [CrdtMessage(op["timestamp"], t, r, c, op["value"]) for op in g["ops"]]
    msgs += [msgs[i] for i in g["redeliver"]]
    types = {(t, c): g["column_type"]}
    rng = random.Random(3)
    for _ in range(4):
        rng.shuffle(msgs)
        got = tz.replay_log(types, msgs)
        assert got[(t, r, c)] == _golden_expected_bytes(g)
        assert got == jtz.replay_log(types, [JaxMessage(m.timestamp, m.table, m.row, m.column, m.value)
                                             for m in msgs])


@pytest.mark.parametrize("fold_min", [1, 10**12])
@pytest.mark.parametrize("section", SECTIONS)
def test_golden_apply_and_tensor_state(section, fold_min, monkeypatch):
    monkeypatch.setattr(ct, "DEVICE_FOLD_MIN", fold_min)
    g = GOLDEN[section]
    table, row, column = g["cell"]
    msgs = [CrdtMessage(op["timestamp"], table, row, column, op["value"]) for op in g["ops"]]
    msgs += [msgs[i] for i in g["redeliver"]]
    random.Random(5).shuffle(msgs)
    db = PySqliteDatabase()
    init_db_model(db)
    update_db_schema(db, [TableDefinition.of(table, ("name", f"{column}:{g['column_type']}"))],
                     device="cpu")
    tree = {}
    for i in range(0, len(msgs), 2):
        tree = apply_messages(db, tree, msgs[i:i + 2], device="cpu")
    state = tz.tensor_state(db, table, row, column)
    cfg = tz.parse_tensor_type(g["column_type"])
    assert state.dtype == (torch.float32 if cfg.dtype == "f32" else torch.bfloat16)
    assert tuple(state.shape) == cfg.shape
    assert state.contiguous().view(torch.uint8).numpy().tobytes() == _golden_expected_bytes(g)
    assert tz.tensor_state(db, table, "missing", column) is None
