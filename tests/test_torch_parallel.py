"""Port parity: the owner mesh (`evolu_tpu_torch.parallel`) against the
JAX package's on the 8-device CPU mesh of `tests/conftest.py`.

The port's meshes here are CPU shards (`create_mesh(devices=["cpu"] *
n)`); the JAX side is `create_mesh(n)` over its virtual devices. Same
numpy-seeded inputs on both sides; tolerance: exact everywhere (masks,
upserts, deltas, digests, placements).

- placement: `owner_shard`, `assign_owners_to_shards`,
  `MeshContext.assign_stable` and the multihost helpers in one process;
- the sharded reconcile with stored winners at mesh sizes 2, 4 and 8,
  a high-contention tiebreak, a non-canonical owner quarantined to the
  host, one owner on a mesh of many shards and an empty batch;
- `reconcile_hot_owner` (cell-range sharding);
- the engine's hot-owner row split and its compaction-overflow rerun
  over every shard."""

import jax
import numpy as np
import pytest
from _torch_jax_state import jax_process_state  # noqa: F401  (the JAX package's native libraries and ledger)

import evolu_tpu.parallel.mesh as jmesh
from evolu_tpu.parallel import reconcile_owner_batches as jax_reconcile
from evolu_tpu.server import engine as je
from evolu_tpu_torch.core.timestamp import timestamp_to_string
from evolu_tpu_torch.core.types import Timestamp
from evolu_tpu_torch.parallel import (
    MeshContext,
    assign_owners_to_shards,
    create_mesh,
    owner_shard,
    reconcile_owner_batches,
    xor_allreduce,
)
from evolu_tpu_torch.server import engine as pe

from _torch_port_data import as_tuples, jax_messages, message_tuples, port_messages, stored_winners

BASE = 1_700_000_000_000
SIZES = [2, 4, 8]


def cpu_mesh(n=8):
    return create_mesh(devices=["cpu"] * n)


def _fleet(seed, n_owners, per_owner, non_canonical=(), n_rows=6):
    rng = np.random.default_rng(seed)
    batches, winners = {}, {}
    for i in range(n_owners):
        o = f"owner{i:05d}"
        t = message_tuples(rng, int(rng.integers(1, per_owner + 1)), n_rows=n_rows,
                           upper_node=i in non_canonical)
        batches[o] = t
        winners[o] = stored_winners(rng, t)
    return batches, winners


def _compare(batches, winners, n=8, mesh_ctx=False):
    jax_mesh = jmesh.create_mesh(n)
    with jax.enable_x64(True):
        want, want_digest = jax_reconcile(
            jax_mesh, {o: jax_messages(t) for o, t in batches.items()}, winners,
            mesh_ctx=jmesh.MeshContext(jax_mesh) if mesh_ctx else None)
    mesh = cpu_mesh(n)
    got, got_digest = reconcile_owner_batches(
        {o: port_messages(t) for o, t in batches.items()}, winners, mesh=mesh,
        mesh_ctx=MeshContext(mesh) if mesh_ctx else None)
    assert got.keys() == want.keys()
    for o in want:
        (jx, ju, jd), (px, pu, pd) = want[o], got[o]
        assert px == jx, o
        assert as_tuples(pu) == as_tuples(ju), o
        assert pd == jd, o
    assert got_digest == want_digest
    return got, got_digest


def test_placement_equals_jax():
    owners = [f"user-{i}" for i in range(200)] + ["alice", "bob", b"raw-bytes", 12345, ("hot", 0)]
    for n in (1, 2, 3, 8):
        assert [owner_shard(o, n) for o in owners] == [jmesh.owner_shard(o, n) for o in owners]
    sizes = {f"o{i}": (i * 37) % 101 + 1 for i in range(40)}
    for n in SIZES:
        assert assign_owners_to_shards(sizes, n) == jmesh.assign_owners_to_shards(sizes, n)
    ctx, jctx = MeshContext(cpu_mesh()), jmesh.MeshContext()
    assert ctx.n_shards == jctx.n_shards == 8
    units = {("hot", 0): 10, ("hot", 1): 10, ("hot", 2): 9, "cold": 1, ("warm", 0): 3}
    units.update({f"u{i}": i for i in range(30)})
    assert ctx.assign_stable(units) == jctx.assign_stable(units)
    for o in owners:
        assert ctx.place(o) == jctx.place(o)


def test_mesh_shapes_and_no_card_raise():
    mesh = cpu_mesh(4)
    assert mesh.size == len(mesh) == 4 and mesh.local_indices() == [0, 1, 2, 3]
    assert not mesh.is_multiprocess() and mesh == cpu_mesh(4) and mesh != cpu_mesh(2)
    assert create_mesh(2, devices=["cpu"] * 8).size == 2
    if not __import__("torch").cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            create_mesh()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            MeshContext()
    assert xor_allreduce([0xFFFFFFFF, 1, -1]) == (0xFFFFFFFF ^ 1 ^ 0xFFFFFFFF)


def test_multihost_helpers_single_process():
    from evolu_tpu.parallel import multihost as jmulti

    from evolu_tpu_torch.parallel import multihost

    mesh = cpu_mesh()
    assert not multihost.is_multihost() and not jmulti.is_multihost()
    assert multihost.local_shard_indices(mesh) == jmulti.local_shard_indices(jmesh.create_mesh())
    sizes = {f"o{i}": (i * 37) % 101 + 1 for i in range(10)}
    shards = assign_owners_to_shards(sizes, mesh.size)
    want = jmulti.local_owners(jmesh.create_mesh(), jmesh.assign_owners_to_shards(sizes, 8))
    assert multihost.local_owners(mesh, shards) == want
    assert sorted(want) == sorted(sizes)


@pytest.mark.parametrize("n", SIZES)
def test_sharded_reconcile_with_stored_winners_matches_jax(n):
    _compare(*_fleet(21 + n, 24, 70), n=n)


@pytest.mark.parametrize("n", SIZES)
def test_stable_placement_reconcile_matches_jax(n):
    _compare(*_fleet(31 + n, 17, 50), n=n, mesh_ctx=True)


def test_high_contention_tiebreak_matches_jax():
    """Config 4's shape: 8 replicas stamp the same 5 rows of 4 owners at a
    frozen millis, so (counter, node) alone orders them."""
    batches = {}
    for o in range(4):
        rows = []
        for r in range(8):
            node = f"{r:x}" * 16
            for i in range(25):
                rows.append((timestamp_to_string(Timestamp(BASE, i, node)), "todo", f"row{i % 5}",
                             "title", f"{o}/{r}/{i}"))
        batches[f"own{o}"] = rows
    _compare(batches, {o: {} for o in batches})


def test_non_canonical_owner_quarantined_to_host_as_jax():
    batches, winners = _fleet(41, 10, 40, non_canonical={2, 7})
    _compare(batches, winners)


def test_single_owner_on_many_shards_and_empty_batch():
    mesh = cpu_mesh()
    assert reconcile_owner_batches({}, {}, mesh=mesh) == ({}, 0)
    with jax.enable_x64(True):
        assert jax_reconcile(jmesh.create_mesh(), {}, {}) == ({}, 0)
    batches, winners = _fleet(51, 1, 30)
    _compare(batches, winners)
    _compare({"only": batches["owner00000"][:3]}, {"only": {}})


@pytest.mark.parametrize("n", SIZES)
def test_hot_owner_cell_sharding_matches_jax(n):
    """One hot owner's batch sharded by cell ranges: masks, minute deltas
    and digest equal JAX's `reconcile_hot_owner` on as many devices."""
    from evolu_tpu.parallel.hot_owner import reconcile_hot_owner as jax_hot

    from evolu_tpu_torch.parallel.hot_owner import reconcile_hot_owner

    rng = np.random.default_rng(13 + n)
    size = 3000
    cell_id = rng.integers(0, 400, size).astype(np.int32)
    millis = BASE + rng.integers(0, 10 * 60_000, size).astype(np.int64)
    counter = rng.integers(0, 16, size).astype(np.int32)
    node = rng.integers(1, 2**63, size).astype(np.uint64)
    k1 = (millis.astype(np.uint64) << np.uint64(16)) | counter.astype(np.uint64)
    ex_k1 = np.zeros(size, np.uint64)
    ex_k2 = np.zeros(size, np.uint64)
    with_winner = cell_id % 3 == 0
    ex_k1[with_winner] = (BASE + 5 * 60_000) << 16
    ex_k2[with_winner] = 7
    args = (cell_id, k1, node.copy(), ex_k1, ex_k2, millis, counter, node)
    want = jax_hot(jmesh.create_mesh(n), *args)
    got = reconcile_hot_owner(cpu_mesh(n), *args)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] and got[3] == want[3]
    assert got[2] and got[1].any() and not got[1].all()


def _rows(node, n, step_ms=7, start=BASE):
    return [timestamp_to_string(Timestamp(start + i * step_ms, 0, node)) for i in range(n)]


@pytest.mark.parametrize("stable", [False, True])
def test_engine_hot_owner_row_split_matches_jax(stable):
    """An owner with more rows than an even shard's share splits row-wise
    over the shards; its per-shard (owner, minute) partials XOR-merge to
    JAX's deltas and digest, by LPT and by stable placement."""
    rows = {"hot": _rows("a" * 16, 5000), "small": _rows("b" * 16, 40), "tiny": _rows("c" * 16, 3)}
    jax_mesh = jmesh.create_mesh()
    jctx = jmesh.MeshContext(jax_mesh) if stable else None
    want = je.owner_minute_deltas(jax_mesh, rows, ctx=jctx)
    ctx = MeshContext(cpu_mesh()) if stable else None
    got = pe.owner_minute_deltas(rows, mesh=cpu_mesh(), ctx=ctx)
    assert got == want
    assert len(rows["hot"]) > -(-sum(map(len, rows.values())) // 8)
    if stable:
        assert ctx.counts["xdev_reduce"]["owner_delta_partials"] == 1
        assert ctx.counts["xdev_reduce"]["digest"] == 1 and ctx.counts["dispatches"] == 1
        assert ctx.counts["shard_rows"] == 8 and sum(ctx.last_loads) == 5043


def test_engine_overflow_on_one_shard_reruns_every_shard_as_jax():
    """Every row of one owner in its own minute: the shard holding it
    overflows its compaction cap, so every shard reruns the full-width
    kernel; the deltas and digest equal JAX's."""
    rows = {"wide": _rows("d" * 16, 1200, step_ms=60_000)}
    rows.update({f"o{i}": _rows(f"{i + 1:016x}", 20) for i in range(6)})
    before = pe.counts["overflow"]
    got = pe.owner_minute_deltas(rows, mesh=cpu_mesh())
    assert pe.counts["overflow"] == before + 1
    assert got == je.owner_minute_deltas(jmesh.create_mesh(), rows)
