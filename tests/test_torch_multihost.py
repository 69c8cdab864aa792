"""Port parity: the multi-process pod. Two spawned processes join one
gloo group through a `file://` store in `tmp_path` (so parallel test
workers cannot collide on a port), 4 CPU shards each, an 8-shard global
mesh (`tests/_torch_multihost_worker.py`). Against the JAX package on
its 8-device CPU mesh in this process:

- `reconcile_columns_sharded`: both processes see the same digest, equal
  to JAX's `reconcile_owner_batches` digest over the same fleet, and each
  process's own owners' xor masks equal JAX's;
- `engine.reconcile_pod` (push, the same push again, cold pulls): every
  request is answered by exactly one process, the union of the answers
  is byte-identical to JAX's single-process `reconcile_pod` on the
  8-device mesh, both processes' digests equal JAX's, and each store
  holds only its process's owners.

Each process has its own join limit; tolerance: exact."""

import multiprocessing
import pickle

import numpy as np
import pytest
from _torch_jax_state import jax_process_state  # noqa: F401  (the JAX package's native libraries and ledger)

import evolu_tpu.parallel.mesh as jmesh
import evolu_tpu.sync.protocol as jp
from evolu_tpu.parallel import reconcile_owner_batches as jax_reconcile
from evolu_tpu.server.engine import reconcile_pod as jax_pod
from evolu_tpu.server.relay import ShardedRelayStore as JaxSharded

import evolu_tpu_torch.sync.protocol as pp
from evolu_tpu_torch.server.engine import owner_process

import _torch_multihost_worker as worker
from _torch_port_data import jax_messages, message_tuples

JOIN_S = 120


def _fleet():
    rng = np.random.default_rng(17)
    return {f"owner{o:02d}": message_tuples(rng, 10 + o * 3, n_rows=4) for o in range(8)}


def _run_pod(tmp_path, fleet):
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=worker.run, args=(rank, 2, str(tmp_path / "gloo.store"), str(tmp_path), fleet,
                                                  str(tmp_path / f"out{rank}.pkl")), daemon=True)
             for rank in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_S)
        codes = [p.exitcode for p in procs]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    assert codes == [0, 0], f"pod processes ended {codes}"
    outs = []
    for rank in range(2):
        with open(tmp_path / f"out{rank}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return outs


def test_two_process_pod_matches_jax(tmp_path):
    fleet = _fleet()
    outs = _run_pod(tmp_path, fleet)
    mesh = [("cpu", 0)] * 4 + [("cpu", 1)] * 4
    for rank, out in enumerate(outs):
        assert out["mesh"] == mesh and out["multihost"] is True
        assert out["local"] == list(range(4 * rank, 4 * rank + 4))
        assert "runs in one process only" in out["guard"]

    # The columns pass: one digest everywhere, and each process's owners'
    # masks, against JAX's single-process reconcile of the same fleet.
    want, want_digest = jax_reconcile(jmesh.create_mesh(), {o: jax_messages(t) for o, t in fleet.items()}, {})
    assert outs[0]["columns"]["digest"] == outs[1]["columns"]["digest"] == want_digest
    seen = {}
    for out in outs:
        for o, mask in out["columns"]["masks"].items():
            assert o not in seen and mask == want[o][0], o
            seen[o] = mask
        assert out["columns"]["local_rows"] == 4 * (out["columns"]["local_rows"] // 4) > 0
    assert sorted(seen) == sorted(fleet)

    # The pod pass, round by round, against JAX's single process on its
    # 8-device mesh over a store of its own.
    jpush, jcold = _jax_pod_requests()
    ppush, pcold = worker.pod_requests(pp)
    assert [pp.encode_sync_request(r) for r in ppush + pcold] == [jp.encode_sync_request(r) for r in jpush + jcold]
    store = JaxSharded(str(tmp_path / "ref"), shards=4, backend="native")
    try:
        for rnd, batch in (("push", jpush), ("replay", jpush), ("cold", jcold)):
            ref, ref_digest = jax_pod(jmesh.create_mesh(), store, batch, wire=True)
            union = {}
            for out in outs:
                answered, digest = out[rnd]
                assert digest == ref_digest, rnd
                for i, body in answered.items():
                    assert i not in union, f"{rnd}: request {i} answered twice"
                    union[i] = body
            assert sorted(union) == list(range(len(batch))), rnd
            assert [union[i] for i in range(len(batch))] == ref, rnd
    finally:
        store.close()
    owners = sorted({r.user_id for r in jpush})
    for rank, out in enumerate(outs):
        assert out["owners"] == sorted(o for o in owners if owner_process(o, 2) == rank)
    assert outs[0]["owners"] and outs[1]["owners"]


def _jax_pod_requests():
    from _pod_requests import build_batches

    return build_batches()


@pytest.mark.parametrize("nproc", [1, 2, 3])
def test_owner_process_equals_jax(nproc):
    from evolu_tpu.server.engine import owner_process as jax_owner_process

    owners = [f"owner{o:02d}" for o in range(40)] + ["alice", "ü-user"]
    assert [owner_process(o, nproc) for o in owners] == [jax_owner_process(o, nproc) for o in owners]


def test_single_process_pod_matches_the_plain_engine(tmp_path):
    """In one process the pod pass is the engine's: a non-canonical owner
    takes the host fold, and the wire answers equal JAX's pod answers."""
    from evolu_tpu_torch.parallel.mesh import create_mesh
    from evolu_tpu_torch.server.engine import reconcile_pod
    from evolu_tpu_torch.server.relay import ShardedRelayStore

    base = 1_700_000_000_000
    reqs = {"jax": [], "port": []}
    from evolu_tpu.core.merkle import apply_prefix_xors, merkle_tree_to_string, minute_deltas_host
    from evolu_tpu.core.timestamp import Timestamp, timestamp_to_string

    for o, canonical in ((0, True), (1, False), (2, True)):
        node = f"{0xABCDEF1234567890 + o:016x}"
        ts = [timestamp_to_string(Timestamp(base + (o * 7 + i) * 60_000, i, node)) for i in range(4)]
        if not canonical:
            ts = [t[:25] + t[25:].replace("a", "A").replace("b", "B") for t in ts]
        deltas, _ = minute_deltas_host(iter(ts))
        tree = merkle_tree_to_string(apply_prefix_xors({}, deltas))
        for side, proto in (("jax", jp), ("port", pp)):
            msgs = tuple(proto.EncryptedCrdtMessage(t, b"ct-%d" % o) for t in ts)
            reqs[side].append(proto.SyncRequest(msgs, f"owner{o}", "f" * 16, tree))
    pstore = ShardedRelayStore(str(tmp_path / "pod"), shards=2, backend="native")
    jstore = JaxSharded(str(tmp_path / "jax"), shards=2, backend="native")
    try:
        got, got_digest = reconcile_pod(create_mesh(devices=["cpu"] * 8), pstore, tuple(reqs["port"]), wire=True)
        want, want_digest = jax_pod(jmesh.create_mesh(), jstore, tuple(reqs["jax"]), wire=True)
        assert got == want and got_digest == want_digest
        assert all(b is not None for b in got)
    finally:
        pstore.close(), jstore.close()
