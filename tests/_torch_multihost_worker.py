"""One process of the port's two-process pod (not collected: launched by
`tests/test_torch_multihost.py` with the `spawn` start method).

It joins a gloo group through a `file://` store, with 4 CPU shards of its
own, so the global mesh has 8 shards in rank order. Then it runs:

- `reconcile_columns_sharded` over the fleet's global layout: the digest
  (all-reduced across the two processes) and the xor masks of the owners
  its own shards hold;
- three `engine.reconcile_pod` rounds (push, the same push again, cold
  pulls) on a native 4-shard store of its own, wire responses.

It imports the port only and writes its results to `out_path` as a
pickle. `pod_requests` builds the pod batches with the port's protocol."""

import pickle

from evolu_tpu_torch.core.merkle import apply_prefix_xors, merkle_tree_to_string, minute_deltas_host
from evolu_tpu_torch.core.timestamp import timestamp_to_string
from evolu_tpu_torch.core.types import Timestamp

BASE = 1_700_000_000_000


def pod_requests(proto):
    """→ (push, cold): 12 owners push their own new messages with their
    post-apply trees (one owner with an in-batch duplicate, one split over
    two requests); then each owner pulls from a fresh node with an empty
    tree. The twin of `tests/_pod_requests.build_batches`."""
    reqs = []
    for o in range(12):
        user = f"owner{o:02d}"
        msgs = [proto.EncryptedCrdtMessage(
            timestamp_to_string(Timestamp(BASE + (o * 977 + i) * 60_000, i % 4, f"{o + 1:016x}")),
            b"ct-%d-%d" % (o, i)) for i in range(6 + o)]
        if o == 3:
            msgs.append(msgs[0])
        deltas, _ = minute_deltas_host(
            m.timestamp for j, m in enumerate(msgs) if not (o == 3 and j == len(msgs) - 1))
        tree = merkle_tree_to_string(apply_prefix_xors({}, deltas))
        if o == 7:
            reqs.append(proto.SyncRequest(tuple(msgs[:3]), user, "f" * 16, tree))
            reqs.append(proto.SyncRequest(tuple(msgs[3:]), user, "f" * 16, tree))
        else:
            reqs.append(proto.SyncRequest(tuple(msgs), user, "f" * 16, tree))
    cold = tuple(proto.SyncRequest((), f"owner{o:02d}", "e" * 16, "{}") for o in range(12))
    return tuple(reqs), cold


def run(rank, nproc, init_file, store_dir, fleet, out_path):
    import numpy as np
    import torch.distributed as dist

    from evolu_tpu_torch.core.types import CrdtMessage
    from evolu_tpu_torch.ops.merge import unpermute_masks
    from evolu_tpu_torch.parallel.mesh import assign_owners_to_shards, require_single_process
    from evolu_tpu_torch.parallel.multihost import (
        initialize_multihost,
        is_multihost,
        local_owners,
        local_shard_indices,
    )
    from evolu_tpu_torch.parallel.reconcile import build_owner_columns, reconcile_columns_sharded
    from evolu_tpu_torch.server.engine import reconcile_pod
    from evolu_tpu_torch.server.relay import ShardedRelayStore
    from evolu_tpu_torch.sync import protocol

    mesh = initialize_multihost(f"file://{init_file}", nproc, rank, devices=["cpu"] * 4, timeout_s=60)
    out = {"mesh": [(str(s.device), s.rank) for s in mesh.shards], "local": local_shard_indices(mesh),
           "multihost": is_multihost()}
    try:
        require_single_process("the test")
        out["guard"] = None
    except NotImplementedError as e:
        out["guard"] = str(e)

    batches = {o: [CrdtMessage(*t) for t in ts] for o, ts in fleet.items()}
    cols, index, _ = build_owner_columns(batches, {}, mesh)
    xor_s, upsert_s, i_s, *_, digest = reconcile_columns_sharded(mesh, cols)
    size = len(cols["cell_id"]) // mesh.size
    xor_mask, _ = unpermute_masks(xor_s, upsert_s, i_s, block_size=size)
    local = local_shard_indices(mesh)
    mine = local_owners(mesh, assign_owners_to_shards({o: len(b) for o, b in batches.items()}, mesh.size))
    masks = {}
    for o in mine:
        pos = index[o][0]
        shard = pos // size
        local_pos = np.array([local.index(s) for s in shard]) * size + pos % size
        masks[o] = xor_mask[local_pos].tolist()
    out["columns"] = {"digest": digest, "masks": masks, "local_rows": int(xor_s.shape[0])}

    push, cold = pod_requests(protocol)
    store = ShardedRelayStore(f"{store_dir}/proc{rank}", shards=4, backend="native")
    try:
        for rnd, batch in (("push", push), ("replay", push), ("cold", cold)):
            responses, digest = reconcile_pod(mesh, store, batch, wire=True)
            out[rnd] = ({i: r for i, r in enumerate(responses) if r is not None}, digest)
        out["owners"] = sorted(store.user_ids())
    finally:
        store.close()
    dist.destroy_process_group()
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
