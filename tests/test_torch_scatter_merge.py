"""Port parity: the sort-free scatter-argmax LWW plan, its router and the
mask-only planner (`evolu_tpu_torch.ops.scatter_merge`, the scatter
routes of `ops.merge` and `parallel.reconcile`) against the JAX package.

Every case of `tests/test_scatter_merge.py` runs here on the port's
objects, with the JAX package's function on the same numpy-seeded
inputs as the oracle and exact equality: the scatter masks equal JAX's
and the port's own sort plan, the full-plan twins and the shard kernels
decode to the same plans, deltas and digest, and the router keeps
duplicate, wide and padded batches where the reference keeps them. The
port's own cases: u64 keys at and past 2^63 and all-zero keys (the
sign-bit flip and the max identity), `Config.merge_plan`, "auto" by
device, `plan_merge_core` and `plan_batch_device`, and
`reconcile_owner_batches` through each route.

Both packages read EVOLU_MERGE_PLAN and keep a process-wide plan path:
the autouse fixture clears the variable and gives both paths back as
"auto" after each test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from _torch_jax_state import jax_process_state  # noqa: F401  (the JAX package's native libraries and ledger)
import torch

from evolu_tpu.ops import merge as jm
from evolu_tpu.ops import scatter_merge as jsm
from evolu_tpu.ops import to_host_many as jax_to_host_many
from evolu_tpu_torch.ops import columns_to_device
from evolu_tpu_torch.ops import merge as pm
from evolu_tpu_torch.ops import scatter_merge as psm
from evolu_tpu_torch.ops.merkle_ops import decode_owner_minute_deltas
from evolu_tpu_torch.parallel import reconcile as pr

from _torch_port_data import (
    BASE_MILLIS,
    as_tuples,
    jax_messages,
    message_tuples,
    port_messages,
    stored_winners,
    ts_string,
)

_PAD = int(pm._PAD_CELL)
_NAMES = ("cell_id", "k1", "k2", "ex_k1", "ex_k2")


@pytest.fixture(autouse=True)
def _plan_paths(monkeypatch):
    monkeypatch.delenv("EVOLU_MERGE_PLAN", raising=False)
    yield
    psm.set_plan_path("auto")
    jsm.set_plan_path("auto")


def _pin(path):
    psm.set_plan_path(path)
    jsm.set_plan_path(path)


def _random_columns(rng, n, cells, stored=0.6, tie_heavy=False):
    """The reference test's adversarial plan columns: heavy cell
    contention, HLC ties at every level (equal millis, equal (millis,
    counter) resolved by node, stored-winner equality), zero-key rows."""
    cell_id = rng.integers(0, cells, n).astype(np.int32)
    if tie_heavy:
        millis = 1_700_000_000_000 + rng.integers(0, 3, n).astype(np.int64)
        counter = rng.integers(0, 2, n).astype(np.int32)
        node = rng.integers(1, 5, n).astype(np.uint64)
    else:
        millis = 1_700_000_000_000 + rng.integers(0, 86_400_000, n).astype(np.int64)
        counter = rng.integers(0, 256, n).astype(np.int32)
        node = rng.integers(1, 2**63, n).astype(np.uint64)
    k1 = (millis.astype(np.uint64) << np.uint64(16)) | counter.astype(np.uint64)
    has = rng.random(cells) < stored
    w_k1 = (
        (1_700_000_000_000 + rng.integers(0, 86_400_000, cells).astype(np.uint64))
        << np.uint64(16)
    ) | rng.integers(0, 256, cells).astype(np.uint64)
    w_k2 = rng.integers(1, 2**63, cells).astype(np.uint64)
    ex_k1 = np.where(has, w_k1, 0)[cell_id].astype(np.uint64)
    ex_k2 = np.where(has, w_k2, 0)[cell_id].astype(np.uint64)
    # Rows EQUAL to their stored winner (the b-flag re-XOR quirk): the
    # scatter xor rule's only order-sensitive case.
    dup_of_winner = (rng.random(n) < 0.1) & has[cell_id]
    k1 = np.where(dup_of_winner, ex_k1, k1)
    node = np.where(dup_of_winner, ex_k2, node)
    return cell_id, k1, node, ex_k1, ex_k2


def _dedupe(cell_id, k1, k2, ex_k1, ex_k2):
    """Drop later duplicate (cell, k1, k2) rows (the scatter precondition),
    keeping the b-row ties."""
    seen = set()
    keep = np.ones(len(cell_id), bool)
    for i, key in enumerate(zip(cell_id.tolist(), k1.tolist(), k2.tolist())):
        if key in seen:
            keep[i] = False
        else:
            seen.add(key)
    return tuple(a[keep] for a in (cell_id, k1, k2, ex_k1, ex_k2))


def _pad(cols, size):
    pad = size - len(cols[0])
    return (np.concatenate([cols[0], np.full(pad, _PAD, np.int32)]),
            *(np.concatenate([c, np.zeros(pad, np.uint64)]) for c in cols[1:]))


def _table(cols):
    return psm.table_size_for(int(cols[0][cols[0] != _PAD].max()))


def _port(cols):
    t = columns_to_device(dict(zip(_NAMES, cols)), "cpu")
    return [t[k] for k in _NAMES]


def _jax(cols):
    return [jnp.asarray(c) for c in cols]


def _port_sort_masks(cols):
    xor_s, upsert_s, i_s, *_ = pm.plan_merge_sorted_flags(*_port(cols))
    return pm.unpermute_masks(xor_s.numpy(), upsert_s.numpy(), i_s.numpy())


def _jax_scatter_masks(cols, table):
    with jax.enable_x64(True):
        return jax_to_host_many(*jax.jit(jsm.scatter_plan_masks, static_argnames=("table_size",))(
            *_jax(cols), table_size=table))


def _assert_masks(got, *wants):
    for want in wants:
        np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
        np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("tie_heavy", [False, True])
def test_scatter_masks_match_jax_and_the_sort_plan(seed, tie_heavy):
    rng = np.random.default_rng(seed)
    n = 1536 if tie_heavy else 4000
    cols = _pad(_dedupe(*_random_columns(rng, n, cells=max(n // 8, 4), tie_heavy=tie_heavy)), 4096)
    table = _table(cols)
    got = [m.numpy() for m in psm.scatter_plan_masks(*_port(cols), table)]
    _assert_masks(got, _jax_scatter_masks(cols, table), _port_sort_masks(cols))


def _edge_columns(seed):
    """u64 edges: k1 ≥ 2^63 (millis ≥ 2^47), nodes ≥ 2^63, real rows whose
    keys are all zero, stored winners past 2^63 and equal to a row."""
    rng = np.random.default_rng(seed)
    n, cells = 2000, 300
    cell_id = rng.integers(0, cells, n).astype(np.int32)
    hi = np.uint64(1) << np.uint64(63)
    k1 = rng.integers(0, 2**64, n, dtype=np.uint64)
    k1[rng.random(n) < 0.4] |= hi
    k1[rng.random(n) < 0.3] = hi | np.uint64(5)  # ties on k1 past 2^63
    k2 = rng.integers(0, 2**64, n, dtype=np.uint64)
    k2[rng.random(n) < 0.4] |= hi
    k2[rng.random(n) < 0.2] = 0
    zero = np.zeros(n, bool)
    zero[rng.choice(n, 40, replace=False)] = True  # real rows with k1 = k2 = 0
    k1[zero] = 0
    k2[zero] = 0
    has = rng.random(cells) < 0.5
    w1 = rng.integers(0, 2**64, cells, dtype=np.uint64) | hi
    w2 = rng.integers(0, 2**64, cells, dtype=np.uint64)
    ex_k1 = np.where(has, w1, 0)[cell_id].astype(np.uint64)
    ex_k2 = np.where(has, w2, 0)[cell_id].astype(np.uint64)
    eq = (rng.random(n) < 0.1) & has[cell_id]
    k1 = np.where(eq, ex_k1, k1)
    k2 = np.where(eq, ex_k2, k2)
    return _pad(_dedupe(cell_id, k1, k2, ex_k1, ex_k2), 2048)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scatter_masks_on_u64_edges_match_jax_and_the_sort_plan(seed):
    cols = _edge_columns(seed)
    assert (cols[1] >= np.uint64(1) << np.uint64(63)).any() and (cols[2] >= np.uint64(1) << np.uint64(63)).any()
    table = _table(cols)
    got = [m.numpy() for m in psm.scatter_plan_masks(*_port(cols), table)]
    _assert_masks(got, _jax_scatter_masks(cols, table), _port_sort_masks(cols))


def test_scatter_masks_on_all_zero_cells():
    """Cells whose only rows have k1 = k2 = 0 and no stored winner: the
    table starts at the flipped zero, which such rows reach exactly, so
    they are their cell's max (the reference's max(0, real zeros))."""
    cell_id = np.array([0, 1, 1, 2, 3, 3], np.int32)
    k1 = np.array([0, 0, 7, 0, 0, 1 << 63], np.uint64)
    k2 = np.array([0, 0, 0, 0, 0, 0], np.uint64)
    ex_k1 = np.array([0, 0, 0, 0, 3, 3], np.uint64)
    ex_k2 = np.zeros(6, np.uint64)
    cols = _pad((cell_id, k1, k2, ex_k1, ex_k2), 64)
    got = [m.numpy() for m in psm.scatter_plan_masks(*_port(cols), 64)]
    _assert_masks(got, _jax_scatter_masks(cols, 64), _port_sort_masks(cols))
    # Row 0 equals the empty stored winner (0, 0): no XOR, no upsert.
    assert not got[0][0] and not got[1][0]


def _decoded_full(outs, size):
    xor_s, upsert_s, i_s, *segs = (np.asarray(o) for o in outs)
    return (*pm.unpermute_masks(xor_s, upsert_s, i_s),
            decode_owner_minute_deltas(np.zeros(size, np.int32), *segs))


def test_scatter_full_kernel_matches_sort_full_kernel_and_jax():
    rng = np.random.default_rng(7)
    cols = _pad(_dedupe(*_random_columns(rng, 2000, cells=256)), 2048)
    table = _table(cols)
    scatter = _decoded_full(pm.plan_full_kernel_scatter(*_port(cols), table), 2048)
    sort = _decoded_full(pm.plan_full_kernel(*_port(cols)), 2048)
    with jax.enable_x64(True):
        want = _decoded_full(jax_to_host_many(*jm._plan_full_kernel_scatter(*_jax(cols), table_size=table)),
                             2048)
    for got in (scatter, sort):
        _assert_masks(got, want)
        assert got[2] == want[2]


def _decoded_shard(outs, block_size=0):
    xor_s, upsert_s, i_s, *segs, digest = (np.asarray(o) for o in outs)
    if block_size:
        masks = jm.unpermute_masks(xor_s, upsert_s, i_s, block_size=block_size)
        return masks, decode_owner_minute_deltas(*segs), int(digest)
    return (pm.unpermute_masks(xor_s, upsert_s, i_s), decode_owner_minute_deltas(*segs),
            int(digest.view(np.uint32)[0]))


def test_shard_kernel_scatter_matches_packed_kernel_end_to_end():
    """Whole-shard parity on the bench layout: plans, per-owner minute
    deltas and the digest of the port's `_shard_kernel_scatter` equal its
    packed sort kernel's and the JAX scatter kernel's on the 8-shard
    mesh (the port runs the same flat layout as one shard)."""
    import bench
    from evolu_tpu.parallel.mesh import create_mesh, sharding
    from evolu_tpu.parallel.reconcile import _compiled_kernel, scatter_shard_kernel

    mesh = create_mesh()
    n_dev = mesh.devices.size
    cols, total = bench.shard_layout(bench.build_columns(n=2048, owners=32, stored_winners=True), n_dev)
    cols = {k: cols[k] for k in pr.COLUMN_NAMES}
    real = cols["cell_id"] != _PAD
    table = psm.table_size_for(int(cols["cell_id"].max(initial=0, where=real)))
    with jax.enable_x64(True):
        args = [jax.device_put(cols[k], sharding(mesh)) for k in pr.COLUMN_NAMES]
        want = _decoded_shard(jax_to_host_many(*_compiled_kernel(mesh, scatter_shard_kernel(table))(*args)),
                              block_size=total // n_dev)
    t = columns_to_device(cols, "cpu")
    args = [t[k] for k in pr.COLUMN_NAMES]
    for kernel in (pr.scatter_shard_kernel(table), pr._shard_kernel):
        got = _decoded_shard(kernel(*args))
        _assert_masks(got[0], want[0])
        assert got[1] == want[1]
        assert got[2] == want[2]


def test_router_rejects_duplicates_and_wide_cells():
    cell_id = np.array([1, 2, 1], np.int32)
    k1 = np.array([5, 6, 5], np.uint64)
    k2 = np.array([9, 9, 9], np.uint64)
    assert psm.batch_has_duplicate_keys(cell_id, k1, k2)
    assert jsm.batch_has_duplicate_keys(cell_id, k1, k2)
    _pin("scatter")
    assert not psm.use_scatter_plan(cell_id, k1, k2, "cpu")
    assert psm.scatter_table_for(cell_id, k1, k2, "cpu") is None
    k1u = np.array([5, 6, 7], np.uint64)
    assert not psm.batch_has_duplicate_keys(cell_id, k1u, k2)
    assert psm.use_scatter_plan(cell_id, k1u, k2, "cpu") == jsm.use_scatter_plan(cell_id, k1u, k2) is True
    assert psm.scatter_table_for(cell_id, k1u, k2, "cpu") == jsm.scatter_table_for(cell_id, k1u, k2) == 64
    wide = np.array([1 << psm.MAX_TABLE_BITS], np.int32)
    one = np.array([1], np.uint64)
    assert psm.MAX_TABLE_BITS == jsm.MAX_TABLE_BITS
    assert not psm.use_scatter_plan(wide, one, one, "cpu")
    assert psm.scatter_table_for(wide, one, one, "cpu") is None
    assert psm.table_size_for((1 << psm.MAX_TABLE_BITS) - 1) == jsm.table_size_for((1 << jsm.MAX_TABLE_BITS) - 1)


def _tiny_shard(k1):
    return {
        "cell_id": np.array([3, 3, 4], np.int32),
        "k1": np.array(k1, np.uint64),
        "k2": np.array([9, 9, 9], np.uint64),
        "ex_k1": np.zeros(3, np.uint64),
        "ex_k2": np.zeros(3, np.uint64),
        "owner_ix": np.zeros(3, np.int64),
    }


def test_reconcile_router_falls_back_on_duplicate_batch():
    """A batch with an in-batch duplicate key routes to a SORT kernel even
    when scatter is pinned, and that kernel plans it as JAX's does."""
    _pin("scatter")
    cols = _tiny_shard([5, 5, 6])
    before = dict(psm.counts["reconcile_kernel"])
    kernel = pr.shard_kernel_for(cols, "cpu")
    assert kernel in (pr._shard_kernel, pr._shard_kernel_wide)
    assert psm.counts["reconcile_kernel"]["packed"] == before["packed"] + 1
    t = columns_to_device(cols, "cpu")
    got = _decoded_shard(kernel(*(t[k] for k in pr.COLUMN_NAMES)))
    from evolu_tpu.parallel.mesh import create_mesh, sharding
    from evolu_tpu.parallel.reconcile import _compiled_kernel, _shard_kernel

    mesh = create_mesh(1)
    with jax.enable_x64(True):
        want = _decoded_shard(jax_to_host_many(*_compiled_kernel(mesh, _shard_kernel)(
            *(jax.device_put(cols[k], sharding(mesh)) for k in pr.COLUMN_NAMES))), block_size=3)
    _assert_masks(got[0], want[0])
    assert got[1:] == want[1:]
    cols["k1"] = np.array([5, 6, 7], np.uint64)
    assert pr.shard_kernel_for(cols, "cpu") is pr.scatter_shard_kernel(psm.table_size_for(4))
    assert psm.counts["reconcile_kernel"]["scatter"] == before["scatter"] + 1


def test_router_admits_padded_shard_layouts():
    """Pad rows are identical (PAD, 0, 0) triples: the duplicate screen
    leaves them out, or every padded layout would pin the sort plan."""
    cols = {
        "cell_id": np.array([3, 4, _PAD, _PAD], np.int32),
        "k1": np.array([5, 6, 0, 0], np.uint64),
        "k2": np.array([9, 9, 0, 0], np.uint64),
        "ex_k1": np.zeros(4, np.uint64),
        "ex_k2": np.zeros(4, np.uint64),
        "owner_ix": np.zeros(4, np.int64),
    }
    _pin("scatter")
    assert not psm.batch_has_duplicate_keys(cols["cell_id"], cols["k1"], cols["k2"])
    assert pr.shard_kernel_for(cols, "cpu") is pr.scatter_shard_kernel(psm.table_size_for(4))


def test_env_var_overrides_config(monkeypatch):
    _pin("sort")
    monkeypatch.setenv("EVOLU_MERGE_PLAN", "scatter")
    assert psm.merge_plan_path("cpu") == psm.merge_plan_path("cuda") == jsm.merge_plan_path() == "scatter"
    monkeypatch.setenv("EVOLU_MERGE_PLAN", "sort")
    _pin("scatter")
    assert psm.merge_plan_path("cpu") == jsm.merge_plan_path() == "sort"
    monkeypatch.setenv("EVOLU_MERGE_PLAN", "scater")  # a typo'd pin: loud in both
    with pytest.raises(ValueError):
        psm.merge_plan_path("cpu")
    with pytest.raises(ValueError):
        jsm.merge_plan_path()
    monkeypatch.delenv("EVOLU_MERGE_PLAN")
    assert psm.merge_plan_path("cpu") == jsm.merge_plan_path() == "scatter"
    with pytest.raises(ValueError):
        psm.set_plan_path("bogus")


def test_auto_resolves_by_device():
    """"auto": scatter where the plan runs on the CPU (the reference's CPU
    backend), sort on CUDA and for None, the card (the reference on any
    accelerator)."""
    assert jsm.merge_plan_path() == "scatter"  # the JAX package on its CPU backend
    assert psm.merge_plan_path("cpu") == psm.merge_plan_path(torch.device("cpu")) == "scatter"
    assert psm.merge_plan_path("cuda") == psm.merge_plan_path(torch.device("cuda", 0)) == "sort"
    assert psm.merge_plan_path(None) == psm.merge_plan_path() == "sort"
    cell_id = np.array([1, 2], np.int32)
    k = np.array([5, 6], np.uint64)
    assert psm.scatter_table_for(cell_id, k, k, "cpu") == 64
    assert psm.scatter_table_for(cell_id, k, k, "cuda") is None
    assert not psm.use_scatter_plan(cell_id, k, k, None)


def test_config_merge_plan_is_validated_and_applied():
    from evolu_tpu_torch.runtime.worker import select_planner
    from evolu_tpu_torch.utils.config import Config

    for path in ("auto", "sort", "scatter"):
        assert Config(merge_plan=path).merge_plan == path
    with pytest.raises(ValueError):
        Config(merge_plan="scater")
    select_planner(Config(backend="cuda", merge_plan="sort"), device="cpu")
    assert psm.merge_plan_path("cpu") == "sort"
    select_planner(Config(backend="cpu", merge_plan="scatter"), device="cpu")  # the host oracle: untouched
    assert psm.merge_plan_path("cpu") == "sort"
    select_planner(Config(backend="auto", merge_plan="scatter"), device="cpu")
    assert psm.merge_plan_path("cuda") == "scatter"
    select_planner(Config(backend="auto"), device="cpu")
    assert psm.merge_plan_path("cpu") == "scatter" and psm.merge_plan_path("cuda") == "sort"


def _unique_messages(seed, n=300):
    """The reference test's planner batch: timestamps unique per cell."""
    from evolu_tpu_torch.core.timestamp import Timestamp, timestamp_to_string

    rng = np.random.default_rng(seed)
    out, seen = [], set()
    for i in range(n):
        ts = timestamp_to_string(Timestamp(
            millis=BASE_MILLIS + int(rng.integers(0, 120_000)), counter=int(rng.integers(0, 4)),
            node=f"{rng.integers(1, 8):016x}"))
        t = (ts, "t", f"r{int(rng.integers(0, 40))}", "c", i)
        if t[:4] not in seen:
            seen.add(t[:4])
            out.append(t)
    return out


def test_plan_batch_device_full_identical_across_paths():
    """PlannedBatch contents (xor mask, upsert identity, deltas) equal
    under pinned sort and pinned scatter, and equal JAX's."""
    tuples = _unique_messages(11)
    msgs = port_messages(tuples)
    plans = {}
    for path in ("sort", "scatter"):
        _pin(path)
        before = psm.counts["merge_plan"][path]
        xor_mask, upserts, deltas = pm.plan_batch_device_full(msgs, {}, device="cpu")
        assert psm.counts["merge_plan"][path] == before + 1
        plans[path] = (list(xor_mask), [id(u) for u in upserts], dict(deltas))
        jx, ju, jd = jm.plan_batch_device_full(jax_messages(tuples), {})
        assert (list(xor_mask), as_tuples(upserts), dict(deltas)) == (list(jx), as_tuples(ju), dict(jd))
    assert plans["sort"] == plans["scatter"]


def _batch(seed, dup_frac, upper=False):
    rng = np.random.default_rng(seed)
    t = message_tuples(rng, 900, n_rows=40, dup_frac=dup_frac, upper_node=upper)
    return t, stored_winners(rng, t)


def test_plan_merge_core_matches_jax():
    for seed in (0, 1, 2):
        rng = np.random.default_rng(seed)
        cols = _pad(_random_columns(rng, 3000, cells=400, tie_heavy=seed == 2), 4096)  # duplicates kept
        got = [m.numpy() for m in pm.plan_merge_core(*_port(cols))]
        with jax.enable_x64(True):
            want = jax_to_host_many(*jm.plan_merge(*_jax(cols), num_segments=4096))
        _assert_masks(got, want, _port_sort_masks(cols))


@pytest.mark.parametrize("path,dup_frac,route", [
    ("scatter", 0.0, "scatter"),
    ("sort", 0.0, "sort"),
    ("scatter", 0.1, "sort"),  # exact re-deliveries: the duplicate screen keeps the sort plan
    ("auto", 0.0, "scatter"),  # "auto" on the CPU
])
def test_plan_batch_device_matches_jax(path, dup_frac, route):
    tuples, winners = _batch(3, dup_frac)
    _pin(path)
    before = dict(psm.counts["merge_plan"])
    xor_mask, upserts = pm.plan_batch_device(port_messages(tuples), winners, device="cpu")
    assert psm.counts["merge_plan"][route] == before[route] + 1
    with jax.enable_x64(True):
        jx, ju = jm.plan_batch_device(jax_messages(tuples), winners)
    assert xor_mask == list(jx)
    assert as_tuples(upserts) == as_tuples(ju)
    from evolu_tpu_torch.storage.apply import plan_batch

    hx, hu = plan_batch(port_messages(tuples), winners)  # upserts in its own order
    assert xor_mask == hx
    assert sorted(as_tuples(upserts), key=repr) == sorted(as_tuples(hu), key=repr)


def test_plan_batch_device_takes_the_host_oracle_on_non_canonical_hex():
    tuples, winners = _batch(4, 0.0, upper=True)
    before = dict(psm.counts["merge_plan"])
    got = pm.plan_batch_device(port_messages(tuples), winners, device="cpu")
    assert psm.counts["merge_plan"] == before  # no device plan
    with jax.enable_x64(True):
        jx, ju = jm.plan_batch_device(jax_messages(tuples), winners)
    assert got[0] == list(jx) and as_tuples(got[1]) == as_tuples(ju)
    assert pm.plan_batch_device([], {}, device="cpu") == ([], [])


def _fleet(seed, n_owners, per_owner, dup_frac):
    rng = np.random.default_rng(seed)
    batches, winners = {}, {}
    for i in range(n_owners):
        o = f"owner{i:05d}"
        t = message_tuples(rng, int(rng.integers(1, per_owner + 1)), n_rows=6, dup_frac=dup_frac)
        batches[o] = t
        winners[o] = stored_winners(rng, t)
    return batches, winners


@pytest.mark.parametrize("path,dup_frac,variant", [
    ("scatter", 0.0, "scatter"),
    ("sort", 0.0, "packed"),
    ("scatter", 0.1, "packed"),  # re-deliveries inside an owner's batch
])
def test_reconcile_owner_batches_through_each_route_matches_jax(path, dup_frac, variant):
    from evolu_tpu.parallel import create_mesh
    from evolu_tpu.parallel import reconcile_owner_batches as jax_reconcile

    batches, winners = _fleet(6, 30, 80, dup_frac)
    _pin(path)
    before = dict(psm.counts["reconcile_kernel"])
    got, got_digest = pr.reconcile_owner_batches(
        {o: port_messages(t) for o, t in batches.items()}, winners, device="cpu")
    assert psm.counts["reconcile_kernel"][variant] == before[variant] + 1
    with jax.enable_x64(True):
        want, want_digest = jax_reconcile(
            create_mesh(), {o: jax_messages(t) for o, t in batches.items()}, winners)
    assert got.keys() == want.keys()
    for o in want:
        (jx, ju, jd), (px, pu, pd) = want[o], got[o]
        assert px == jx, o
        assert as_tuples(pu) == as_tuples(ju), o
        assert pd == jd, o
    assert got_digest == want_digest


def test_scatter_route_on_u64_edge_messages_matches_jax():
    """Messages with millis ≥ 2^47 (k1 ≥ 2^63) and nodes ≥ 2^63 take the
    scatter route on the CPU and plan as the JAX package and the host
    oracle do."""
    rng = np.random.default_rng(9)
    tuples, seen = [], set()
    for i in range(500):
        ts = ts_string((1 << 47) + int(rng.integers(0, 5_000)), int(rng.integers(0, 3)),
                       rng.integers(1 << 63, 2**64, dtype=np.uint64))
        t = (ts, "todo", f"r{int(rng.integers(0, 30))}", "title", i)
        if t[:4] not in seen:
            seen.add(t[:4])
            tuples.append(t)
    winners = stored_winners(rng, tuples)
    before = psm.counts["merge_plan"]["scatter"]
    xor_mask, upserts, deltas = pm.plan_batch_device_full(port_messages(tuples), winners, device="cpu")
    assert psm.counts["merge_plan"]["scatter"] == before + 1
    with jax.enable_x64(True):
        jx, ju, jd = jm.plan_batch_device_full(jax_messages(tuples), winners)
    assert list(xor_mask) == list(jx) and as_tuples(upserts) == as_tuples(ju) and dict(deltas) == dict(jd)
