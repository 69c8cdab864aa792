"""Pod-scale relay: one pass of the relay engine over the owner mesh
(`server.engine.reconcile_pod`), in one process or across a gloo group.

Each process stores the owners that the stable crc32 hash assigns to it
and answers their requests; the Merkle device leg runs on its own shards
of the mesh, and the batch's XOR digest, gathered over the group, lets
every process check that the pod agreed on the batch. Identical request
batches must reach every process (the broadcast-ingest model: a front
end fanning out, or a shared queue).

One process, on every visible card (or `--device cpu`):

    python -m evolu_tpu_torch.examples.pod_server

Two processes on one machine:

    python -m evolu_tpu_torch.examples.pod_server --nproc 2 --pid 0 &
    python -m evolu_tpu_torch.examples.pod_server --nproc 2 --pid 1

`--coordinator` is the group's rendezvous (`host:port`, `tcp://...` or
`file:///path`).
"""

from __future__ import annotations

import argparse


def demo_requests():
    """The demo batch: 8 owners pushing their own new messages (5 + o
    each) with their post-apply trees, the steady-state shape. In
    production this batch arrives from the ingest fabric, identical on
    every process."""
    from evolu_tpu_torch.core.merkle import apply_prefix_xors, merkle_tree_to_string, minute_deltas_host
    from evolu_tpu_torch.core.timestamp import timestamp_to_string
    from evolu_tpu_torch.core.types import Timestamp
    from evolu_tpu_torch.sync import protocol

    base = 1_700_000_000_000
    requests = []
    for o in range(8):
        msgs = [
            protocol.EncryptedCrdtMessage(
                timestamp_to_string(Timestamp(base + (o * 997 + i) * 60_000, i % 4, f"{o + 1:016x}")),
                b"ciphertext-%d-%d" % (o, i),
            )
            for i in range(5 + o)
        ]
        deltas, _ = minute_deltas_host(m.timestamp for m in msgs)
        tree = merkle_tree_to_string(apply_prefix_xors({}, deltas))
        requests.append(protocol.SyncRequest(tuple(msgs), f"owner{o}", "f" * 16, tree))
    return tuple(requests)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nproc", type=int, default=1)
    ap.add_argument("--pid", type=int, default=0)
    ap.add_argument("--coordinator", default="127.0.0.1:9765")
    ap.add_argument("--store", default=":memory:")
    ap.add_argument("--device", default=None,
                    help="this process's shard device (default: every visible CUDA card; 'cpu' runs the "
                         "plain versions)")
    args = ap.parse_args()

    devices = None if args.device is None else [args.device]
    if args.nproc > 1:
        from evolu_tpu_torch.parallel.multihost import initialize_multihost

        mesh = initialize_multihost(args.coordinator, args.nproc, args.pid, devices=devices)
    else:
        from evolu_tpu_torch.parallel.mesh import create_mesh

        mesh = create_mesh(devices=devices)

    from evolu_tpu_torch.server.engine import reconcile_pod
    from evolu_tpu_torch.server.relay import ShardedRelayStore

    # Namespace file-backed stores per process: owner → shard (crc32 % 4)
    # is independent of owner → process, so a shared path would have two
    # processes writing the same SQLite files.
    path = args.store if args.store == ":memory:" or args.nproc == 1 else f"{args.store}.p{args.pid}"
    store = ShardedRelayStore(path, backend="native", shards=4)
    requests = demo_requests()
    try:
        # wire=True: a server forwards response BYTES, so the serve skips
        # the per-message object layer.
        responses, digest = reconcile_pod(mesh, store, requests, wire=True)
    finally:
        store.close()
    mine = [i for i, r in enumerate(responses) if r is not None]
    served = sum(len(r) for r in responses if r is not None)
    print(
        f"proc {args.pid}/{args.nproc}: answered {len(mine)}/{len(requests)} "
        f"requests {mine} ({served} response bytes), "
        f"pod digest 0x{digest & 0xFFFFFFFF:08x}",
        flush=True,
    )
    if args.nproc > 1:
        import torch.distributed as dist

        dist.destroy_process_group()


if __name__ == "__main__":
    main()
