"""Port parity: the public surface and the last helpers of the port.

- Every name of `evolu_tpu.__all__` and of the reference's `runtime`,
  `sync`, `server`, `api` and `parallel` `__all__` resolves in the port's
  counterpart, with the same kind (class, function, module or constant;
  constants equal).
- A bare `import evolu_tpu_torch` loads no torch and starts no thread;
  touching `create_evolu` loads torch and still initializes no CUDA.
- `core.merkle.insert_many_into_merkle_tree`, `ops.hash.murmur3_32_batch`,
  `ops.encode.render_timestamp_strings` and `u64_to_node_hex`,
  `ops.merge.plan_merge` and `ops.scatter_merge.plan_masks_scatter`
  against the JAX package's functions on the same numpy-seeded inputs;
  `core.types.SQLiteError` and `MAX_DRIFT_DEFAULT`, `Config`'s fields and
  defaults (`reload_url` among them); `exec_script` and `changes` through
  both packages' `PySqliteDatabase` and the port's `CppSqliteDatabase`.
- `ops.to_host` and `ops.start_host_transfer` pull through the counted
  pull-wave seam of `to_host_many`.

Tolerance: bit-identical everywhere (device arrays equal bit for bit,
strings and bytes equal)."""

import dataclasses
import importlib
import inspect
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from _torch_jax_state import jax_process_state  # noqa: F401  (the JAX package's native libraries and ledger)
import torch

import evolu_tpu
import evolu_tpu_torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PACKAGES = ("", ".runtime", ".sync", ".server", ".api", ".parallel")


def _kind(obj):
    if isinstance(obj, types.ModuleType):
        return "module"
    if inspect.isclass(obj):
        return "class"
    if callable(obj):
        return "function"
    return "constant"


@pytest.mark.parametrize("package", _PACKAGES, ids=lambda p: p.strip(".") or "top")
def test_every_reference_name_resolves_with_its_kind(package):
    ref = importlib.import_module("evolu_tpu" + package)
    port = importlib.import_module("evolu_tpu_torch" + package)
    assert set(ref.__all__) <= set(port.__all__)
    for name in ref.__all__:
        want, got = getattr(ref, name), getattr(port, name)
        assert _kind(got) == _kind(want), name
        if _kind(want) == "constant":
            assert got == want, name
        if _kind(want) == "module":
            assert got.__name__ == want.__name__.replace("evolu_tpu", "evolu_tpu_torch", 1), name
    if not package:
        assert port.__all__ == ref.__all__ + ["resolve_device"]
        assert {*port.__all__} - {"__version__"} <= set(dir(port)) | set(port._LAZY)


def test_star_import_gives_every_name():
    scope = {}
    exec("from evolu_tpu_torch import *", scope)
    assert set(evolu_tpu.__all__) <= set(scope)
    assert scope["create_evolu"].__module__ == "evolu_tpu_torch.runtime.client"


_BARE = r"""
import json, sys, threading
import evolu_tpu_torch
bare = {"torch": "torch" in sys.modules, "threads": threading.active_count(),
        "port": sorted(m for m in sys.modules if m.startswith("evolu_tpu_torch."))}
from evolu_tpu_torch import Timestamp, Config, create_id
host_only = {"torch": "torch" in sys.modules, "threads": threading.active_count()}
evolu_tpu_torch.create_evolu
import torch
print("RESULT:" + json.dumps({
    "bare": bare, "host_only": host_only, "torch_after": "torch" in sys.modules,
    "threads_after": threading.active_count(), "cuda_initialized": torch.cuda.is_initialized(),
    "forbidden": sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "evolu_tpu")),
}))
"""


def test_bare_import_loads_no_torch_and_starts_no_thread():
    out = subprocess.run([sys.executable, "-c", _BARE], cwd=_REPO, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": _REPO})
    assert out.returncode == 0, out.stderr
    result = json.loads(next(l for l in out.stdout.splitlines() if l.startswith("RESULT:"))[len("RESULT:"):])
    assert result["bare"] == {"torch": False, "threads": 1,
                              "port": ["evolu_tpu_torch.utils", "evolu_tpu_torch.utils.lazy"]}
    assert result["host_only"] == {"torch": False, "threads": 1}
    assert result["torch_after"] is True
    assert result["threads_after"] == 1
    assert result["cuda_initialized"] is False
    assert result["forbidden"] == []


# -- helpers -----------------------------------------------------------------


def _stamps(rng, n, dup_frac=0.0):
    millis = 1_700_000_000_000 + rng.integers(-10**10, 10**10, n)
    counter = rng.integers(0, 65536, n)
    node = rng.integers(0, 2**64, n, dtype=np.uint64)
    out = [(int(m), int(c), f"{int(v):016x}") for m, c, v in zip(millis, counter, node)]
    for i in range(1, n):
        if rng.random() < dup_frac:
            out[i] = out[int(rng.integers(0, i))]
    return out


@pytest.mark.parametrize("n,dup_frac,seed", [(0, 0.0, 0), (1, 0.0, 1), (500, 0.0, 2), (500, 0.3, 3),
                                             (64, 0.9, 4)])
def test_insert_many_into_merkle_tree_matches_jax(n, dup_frac, seed):
    from evolu_tpu.core import merkle as jm
    from evolu_tpu.core.types import Timestamp as JT
    from evolu_tpu_torch.core import merkle as pm
    from evolu_tpu_torch.core.types import Timestamp as PT

    stamps = _stamps(np.random.default_rng(seed), n, dup_frac)
    base = {}
    for start in ({}, "seeded"):
        if start == "seeded":
            base = pm.insert_into_merkle_tree(PT(1_700_000_000_000, 1, "a" * 16), {})
        want = jm.insert_many_into_merkle_tree(
            [JT(*s) for s in stamps], jm.merkle_tree_from_string(pm.merkle_tree_to_string(base)))
        frozen = pm.merkle_tree_to_string(base)
        got = pm.insert_many_into_merkle_tree([PT(*s) for s in stamps], base)
        assert pm.merkle_tree_to_string(got) == jm.merkle_tree_to_string(want)
        assert pm.merkle_tree_to_string(base) == frozen  # the input is not mutated


@pytest.mark.parametrize("n", [0, 1, 1000])
@pytest.mark.parametrize("length", [46, 7])
@pytest.mark.parametrize("seed", [0, 0x9747B28C])
def test_murmur3_32_batch_matches_jax(n, length, seed):
    from evolu_tpu.ops.hash import murmur3_32_batch as jax_batch
    from evolu_tpu_torch.ops.hash import murmur3_32_batch

    data = np.random.default_rng(n * 31 + length).integers(0, 256, (n, length)).astype(np.uint8)
    got = murmur3_32_batch(torch.from_numpy(data), seed)
    assert got.dtype == torch.int32 and got.shape == (n,)
    want = np.asarray(jax_batch(jnp.asarray(data), seed))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def _render_inputs():
    edge = 1000 << 32
    millis = np.array([1, 0, edge - 1, edge, edge + 1, edge - 1000, edge + 999, 1_700_000_000_000,
                       253_402_300_799_999, -1, -1000, 951_782_400_000], np.int64)
    rng = np.random.default_rng(5)
    millis = np.concatenate([millis, rng.integers(0, 2 * edge, 500), rng.integers(-edge, 0, 100)])
    n = len(millis)
    counter = rng.integers(0, 65536, n).astype(np.int32)
    counter[:4] = (0, 65535, 0, 65535)
    node = rng.integers(0, 2**64, n, dtype=np.uint64)
    node[:4] = (0, 2**64 - 1, 2**64 - 1, 0)
    return millis, counter, node


def test_render_timestamp_strings_matches_jax():
    from evolu_tpu.core.timestamp import timestamp_to_string
    from evolu_tpu.core.types import Timestamp as JT
    from evolu_tpu.ops.encode import render_timestamp_strings as jax_render
    from evolu_tpu_torch.ops.encode import render_timestamp_strings, timestamp_hashes

    millis, counter, node = _render_inputs()
    got = render_timestamp_strings(torch.from_numpy(millis), torch.from_numpy(counter),
                                   torch.from_numpy(node.view(np.int64)))
    assert got.dtype == torch.uint8 and got.shape == (len(millis), 46)
    with jax.enable_x64(True):
        want = np.asarray(jax_render(jnp.asarray(millis), jnp.asarray(counter), jnp.asarray(node)))
    np.testing.assert_array_equal(got.numpy(), want)
    # The strings are the canonical ones, and the bytes the hash path hashes.
    for i in (0, 1, 4, 7):
        assert bytes(got[i].tolist()).decode() == timestamp_to_string(
            JT(int(millis[i]), int(counter[i]), f"{int(node[i]):016x}"))
    from evolu_tpu_torch.ops.hash import murmur3_32_batch

    hashed = timestamp_hashes(torch.from_numpy(millis), torch.from_numpy(counter),
                              torch.from_numpy(node.view(np.int64)))
    np.testing.assert_array_equal(murmur3_32_batch(got).numpy(), hashed.numpy())


def test_render_timestamp_strings_of_an_empty_batch():
    from evolu_tpu_torch.ops.encode import render_timestamp_strings

    empty = torch.zeros(0, dtype=torch.int64)
    assert render_timestamp_strings(empty, empty.to(torch.int32), empty).shape == (0, 46)


@pytest.mark.parametrize("v", [0, 1, 0xABCDEF, 2**63, 2**64 - 1])
def test_u64_to_node_hex_matches_jax(v):
    from evolu_tpu.ops.encode import node_hex_to_u64, u64_to_node_hex as jax_hex
    from evolu_tpu_torch.ops.encode import u64_to_node_hex

    assert u64_to_node_hex(v) == jax_hex(v)
    assert node_hex_to_u64(u64_to_node_hex(v)) == v


def test_types_and_config_match_the_reference():
    from evolu_tpu.core import types as jt
    from evolu_tpu.utils.config import Config as JaxConfig
    from evolu_tpu_torch.core import types as pt
    from evolu_tpu_torch.utils.config import Config

    assert pt.MAX_DRIFT_DEFAULT == jt.MAX_DRIFT_DEFAULT == Config().max_drift
    assert pt.SQLiteError.type == jt.SQLiteError.type == "SQLiteError"
    assert pt.SQLiteError.__mro__[1] is pt.EvoluError
    assert [c.__name__ for c in pt.SQLiteError.__mro__] == [c.__name__ for c in jt.SQLiteError.__mro__]
    err = pt.SQLiteError("disk I/O error")
    assert isinstance(err, Exception) and str(err) == str(jt.SQLiteError("disk I/O error"))
    ref_fields = {f.name: f for f in dataclasses.fields(JaxConfig)}
    port_fields = {f.name: f for f in dataclasses.fields(Config)}
    assert set(port_fields) == set(ref_fields)
    for name in ref_fields:
        assert getattr(Config(), name) == getattr(JaxConfig(), name), name
    assert Config().reload_url == "/"
    names = list(port_fields)
    assert names.index("reload_url") == names.index("max_drift") + 1


_SCRIPT = """
CREATE TABLE "t" ("id" TEXT PRIMARY KEY, "v" BLOB);
INSERT INTO "t" VALUES ('a', 1);
INSERT INTO "t" VALUES ('b', 2);
UPDATE "t" SET "v" = 3;
"""


def _databases():
    from evolu_tpu.storage.sqlite import PySqliteDatabase as JaxPy
    from evolu_tpu_torch.storage.native import CppSqliteDatabase
    from evolu_tpu_torch.storage.sqlite import PySqliteDatabase

    return {"jax python": JaxPy, "port python": PySqliteDatabase, "port native": CppSqliteDatabase}


def test_exec_script_and_changes_agree():
    from evolu_tpu.core.types import UnknownError as JaxUnknown
    from evolu_tpu_torch.core.types import UnknownError

    seen = {}
    for name, cls in _databases().items():
        db = cls()
        try:
            before = db.changes()
            assert db.exec_script(_SCRIPT) is None
            after_script = db.changes()
            db.run('INSERT INTO "t" VALUES (?, ?)', ("c", 4))
            rows = db.exec('SELECT * FROM "t" ORDER BY "id"')
            with pytest.raises(JaxUnknown if name.startswith("jax") else UnknownError,
                               match="inside an open transaction"):
                with db.transaction():
                    db.run('INSERT INTO "t" VALUES (?, ?)', ("d", 5))
                    db.exec_script('INSERT INTO "t" VALUES (\'e\', 6);')
            # The refusal rolled the whole transaction back.
            assert db.exec('SELECT COUNT(*) FROM "t"') == [(3,)]
            with pytest.raises(JaxUnknown if name.startswith("jax") else UnknownError):
                db.exec_script('CREATE TABLE "t" ("x");')
            seen[name] = (before, after_script, db.changes(), rows)
        finally:
            db.close()
    assert len(set(map(repr, seen.values()))) == 1, seen
    # total_changes counts the rolled-back insert too.
    assert seen["port python"][:3] == (0, 4, 6)


# -- the planners under the reference's names -------------------------------

_NAMES = ("cell_id", "k1", "k2", "ex_k1", "ex_k2")


def _plan_columns(seed, n, dedupe):
    rng = np.random.default_rng(seed)
    cells = max(n // 6, 4)
    cell_id = rng.integers(0, cells, n).astype(np.int32)
    millis = 1_700_000_000_000 + rng.integers(0, 5_000, n).astype(np.int64)
    counter = rng.integers(0, 3, n).astype(np.int32)
    k1 = (millis.astype(np.uint64) << np.uint64(16)) | counter.astype(np.uint64)
    k2 = rng.integers(0, 4, n).astype(np.uint64) << np.uint64(62)
    has = rng.random(cells) < 0.6
    ex_k1 = np.where(has[cell_id], k1[rng.permutation(n)], 0).astype(np.uint64)
    ex_k2 = np.where(has[cell_id], k2[rng.permutation(n)], 0).astype(np.uint64)
    # The stored winner is one value a cell: take each cell's first draw.
    first = {}
    for i, c in enumerate(cell_id.tolist()):
        first.setdefault(c, i)
    idx = np.array([first[c] for c in cell_id.tolist()])
    ex_k1, ex_k2 = ex_k1[idx], ex_k2[idx]
    if dedupe:
        _, keep = np.unique(np.stack([cell_id.astype(np.uint64), k1, k2]), axis=1, return_index=True)
        keep = np.sort(keep)
        cell_id, k1, k2, ex_k1, ex_k2 = (a[keep] for a in (cell_id, k1, k2, ex_k1, ex_k2))
    return cell_id, k1, k2, ex_k1, ex_k2


def _pad(cols, size):
    from evolu_tpu_torch.ops.merge import _PAD_CELL

    pad = size - len(cols[0])
    return (np.concatenate([cols[0], np.full(pad, int(_PAD_CELL), np.int32)]),
            *(np.concatenate([c, np.zeros(pad, np.uint64)]) for c in cols[1:]))


def _port(cols):
    from evolu_tpu_torch.ops import columns_to_device

    t = columns_to_device(dict(zip(_NAMES, cols)), "cpu")
    return [t[k] for k in _NAMES]


@pytest.mark.parametrize("n,size", [(1, 64), (300, 512), (5000, 8192), (40_000, 1 << 16)])
def test_plan_merge_matches_jax(n, size):
    from evolu_tpu.ops import merge as jm
    from evolu_tpu_torch.ops.merge import plan_merge

    cols = _pad(_plan_columns(n, n, dedupe=False), size)
    got = plan_merge(*_port(cols), num_segments=size)
    with jax.enable_x64(True):
        want = jm.plan_merge(*(jnp.asarray(c) for c in cols), num_segments=size)
        want = [np.asarray(w) for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert got[0].any() and got[1].any()


@pytest.mark.parametrize("n,size", [(1, 64), (300, 512), (5000, 8192), (40_000, 1 << 16)])
def test_plan_masks_scatter_matches_jax(n, size):
    from evolu_tpu.ops import scatter_merge as jsm
    from evolu_tpu_torch.ops import scatter_merge as psm

    cols = _pad(_plan_columns(n + 1, n, dedupe=True), size)
    from evolu_tpu_torch.ops.merge import _PAD_CELL

    table = psm.table_size_for(int(cols[0][cols[0] != int(_PAD_CELL)].max()))
    got = psm.plan_masks_scatter(*_port(cols), table)
    with jax.enable_x64(True):
        want = jsm.plan_masks_scatter(*(jnp.asarray(c) for c in cols), table_size=table)
        want = [np.asarray(w) for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    # The mask-only plans agree with each other on a duplicate-free batch.
    from evolu_tpu_torch.ops.merge import plan_merge

    for g, s in zip(got, plan_merge(*_port(cols))):
        np.testing.assert_array_equal(g.numpy(), s.numpy())


def test_segmented_xor_scan_reference_matches_jax():
    from evolu_tpu.ops import merkle_ops as jmo
    from evolu_tpu_torch.ops.merkle_ops import segmented_xor_scan_reference

    rng = np.random.default_rng(9)
    for n in (0, 1, 255, 4097):
        flags = rng.random(n) < 0.1
        values = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        got = segmented_xor_scan_reference(torch.from_numpy(flags), torch.from_numpy(values.view(np.int32)))
        want = np.asarray(jmo.segmented_xor_scan_reference(jnp.asarray(flags), jnp.asarray(values)))
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


# -- pulls ---------------------------------------------------------------------


def test_to_host_and_start_host_transfer_go_through_the_pull_wave(monkeypatch):
    import evolu_tpu_torch.ops as ops

    waves = []
    real = ops.record_pull_wave
    monkeypatch.setattr(ops, "record_pull_wave",
                        lambda seconds, arrays: (waves.append([getattr(a, "nbytes", 0) for a in arrays]), real(seconds, arrays)))
    x = torch.arange(10, dtype=torch.int64)
    y = torch.ones(3, dtype=torch.bool)
    got = ops.to_host(x)
    assert isinstance(got, np.ndarray) and got.tolist() == list(range(10))
    assert waves == [[80]]
    started = ops.start_host_transfer(x, y, "passes")
    # On the CPU there is nothing to start: the inputs come back untouched.
    assert started[0] is x and started[1] is y and started[2] == "passes"
    a, b, c = ops.to_host_many(*started)
    assert a.tolist() == list(range(10)) and b.tolist() == [True] * 3 and c == "passes"
    assert waves == [[80], [80, 3, 0]]
