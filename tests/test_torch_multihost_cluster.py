"""Port twin of `tests/test_multihost_cluster.py`: the pod pass across
processes and its single-process quarantine of a non-canonical owner.

| JAX test | port test |
|---|---|
| `test_pod_server_across_two_processes` | `tests/test_torch_multihost.py::test_two_process_pod_matches_jax` (push, replay and cold rounds over two gloo processes, the union of the answers byte-equal to JAX's single process) and, as the entry point, `tests/test_torch_examples.py::test_pod_server_across_two_processes_gives_the_same_digest` |
| `test_pod_single_process_quarantines_non_canonical_owner` | `test_pod_single_process_quarantines_non_canonical_owner_as_jax` (below) |
| `test_two_process_cluster_reconcile` | `tests/test_torch_multihost.py::test_two_process_pod_matches_jax` (its columns pass: both processes' digests equal, and equal to JAX's) |

Tolerance: exact (response bytes, trees and digests)."""

from _torch_jax_state import jax_process_state  # noqa: F401  (the JAX package's native libraries and ledger)

import evolu_tpu.parallel.mesh as jmesh
import evolu_tpu.server.engine as jengine
import evolu_tpu.server.relay as jrelay
import evolu_tpu.sync.protocol as jproto
import evolu_tpu_torch.sync.protocol as pproto
from evolu_tpu_torch.core.merkle import apply_prefix_xors, merkle_tree_to_string, minute_deltas_host
from evolu_tpu_torch.core.timestamp import timestamp_to_string
from evolu_tpu_torch.core.types import Timestamp
from evolu_tpu_torch.parallel.mesh import create_mesh
from evolu_tpu_torch.server.engine import BatchReconciler, reconcile_pod
from evolu_tpu_torch.server.relay import ShardedRelayStore


def _requests(proto):
    """Three owners; owner 1's node hex is upper case, which parses but
    hashes its verbatim (non-canonical) string."""
    base = 1_700_000_000_000
    reqs = []
    for o, canonical in ((0, True), (1, False), (2, True)):
        node = f"{0xABCDEF1234567890 + o:016x}"
        ts = [timestamp_to_string(Timestamp(base + (o * 7 + i) * 60_000, i, node)) for i in range(4)]
        if not canonical:
            ts2 = [t[:25] + t[25:].replace("a", "A").replace("b", "B") for t in ts]
            assert ts2 != ts
            ts = ts2
        msgs = tuple(proto.EncryptedCrdtMessage(t, b"ct-%d" % o) for t in ts)
        deltas, _ = minute_deltas_host(iter(ts))
        tree = merkle_tree_to_string(apply_prefix_xors({}, deltas))
        reqs.append(proto.SyncRequest(msgs, f"owner{o}", "f" * 16, tree))
    return tuple(reqs)


def test_pod_single_process_quarantines_non_canonical_owner_as_jax(tmp_path):
    """In one process the non-canonical owner takes the host fold on its
    owning process: the pod's object responses equal the port's plain
    engine's and JAX's pod's, its tree equals an independent host
    recompute, and `wire=True` answers the exact encodings."""
    reqs = _requests(pproto)
    jreqs = _requests(jproto)
    assert [pproto.encode_sync_request(r) for r in reqs] == [jproto.encode_sync_request(r) for r in jreqs]
    mesh = create_mesh(devices=["cpu"] * 8)
    stores = {name: ShardedRelayStore(str(tmp_path / name), shards=2, backend="native")
              for name in ("pod", "wire", "ref")}
    jstore = jrelay.ShardedRelayStore(str(tmp_path / "jax"), shards=2, backend="native")
    eng = BatchReconciler(stores["ref"], device="cpu")
    try:
        pod_resp, digest = reconcile_pod(mesh, stores["pod"], reqs)
        ref_resp = eng.reconcile(reqs)
        jax_resp, jax_digest = jengine.reconcile_pod(jmesh.create_mesh(), jstore, jreqs)
        assert digest == jax_digest
        for i, (p, r, j) in enumerate(zip(pod_resp, ref_resp, jax_resp)):
            assert p is not None
            assert pproto.encode_sync_response(p) == pproto.encode_sync_response(r) == \
                jproto.encode_sync_response(j), f"req {i}"
        host_deltas, _ = minute_deltas_host(m.timestamp for m in reqs[1].messages)
        assert pod_resp[1].merkle_tree == merkle_tree_to_string(apply_prefix_xors({}, host_deltas))
        wire_resp, wire_digest = reconcile_pod(mesh, stores["wire"], reqs, wire=True)
        assert wire_digest == digest
        for i, (w, r) in enumerate(zip(wire_resp, ref_resp)):
            assert w == pproto.encode_sync_response(r), f"wire req {i}"
    finally:
        eng.close()
        jstore.close()
        for s in stores.values():
            s.close()
