"""The port's copy of `tests/_write_behind_worker.py`: a subprocess relay
worker for the write-behind crash-and-replay episodes, and the parent's
side of one episode (`torture`). It imports neither jax nor `evolu_tpu`,
so it runs where the card is.

Mode `ingest`: opens a file-backed RelayStore (or ShardedRelayStore) + a
WriteBehindQueue with its durable log + BatchReconciler on `device`,
generates `batches` seeded request batches (the generator the parent's
synchronous twins use), serves each through the write-behind path, and
prints `ACK <i> passes=<engine dispatches> launches=<H>,<X>,<L>,<S>` once
the batch's response is produced (after the log's fsync). Every 4th batch
it also writes a checkpoint behind the drain barrier. The drain is slowed
by `drain_delay` to widen the kill windows.

Mode `finish`: reopens the store and the queue (the constructor replays the
log through the always-exact host fold), flushes, and prints `DONE
crc=<state crc> records=<replayed records> rows=<replayed rows>
replay_s=<seconds> launches=<kernel launches in this process>`.

    python tests/_torch_write_behind_worker.py ingest <db_path> <seed> <batches> <drain_delay> \
        [shards] [workers] [device] [owners max_owners max_msgs [batches_pickle]]
    python tests/_torch_write_behind_worker.py finish <db_path> [shards] [workers]

`shards` > 1 opens a ShardedRelayStore with that many shard files and
`workers` drain workers (0 = one a shard). `device` is "cpu" or "cuda".
`owners`, `max_owners` and `max_msgs` size the batches; their defaults (5,
3, 8) give the reference worker's batches exactly, and with them a drain
batch commits at most 8 rows (2^16 with a size given). `batches_pickle`
names a file where the parent (`torture`) pickled the same batches, so
they are drawn once, with `torture`'s `resend`."""

import os
import sys
import time
import zlib

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BASE = 1700000000000
WORKER = os.path.abspath(__file__)
RESEND = 0.3  # the reference worker's chance that an owner's request redelivers earlier rows


def seeded_batches(seed: int, n_batches: int, owners: int = 5, max_owners: int = 3, max_msgs: int = 8,
                   resend: float = RESEND):
    """Deterministic request batches, drawn as the reference worker draws
    them: distinct owners a batch, with chance `resend` a redelivery of an
    owner's earlier rows, canonical timestamps, and each client's in-sync
    post-push tree (from an embedded host-fold store), so fresh pushes
    never force a serve-side flush. A redelivery does: its owner's tree
    XOR-cancels, so the respond waits for the owner's shard to drain and
    re-reads it. With `resend=0` nothing waits on the drain."""
    import random

    from evolu_tpu_torch.core.merkle import merkle_tree_to_string
    from evolu_tpu_torch.core.timestamp import timestamp_to_string
    from evolu_tpu_torch.core.types import Timestamp
    from evolu_tpu_torch.server.relay import RelayStore
    from evolu_tpu_torch.sync import protocol

    rng = random.Random(seed)
    names = [f"owner{i}" for i in range(owners)]
    nodes = {o: f"{i + 1:016x}" for i, o in enumerate(names)}
    history = {o: [] for o in names}
    batches = []
    tree_oracle = RelayStore()
    for b in range(n_batches):
        reqs = []
        for o in rng.sample(names, rng.randrange(1, max_owners + 1)):
            msgs = []
            if history[o] and rng.random() < resend:
                msgs.extend(rng.sample(history[o], min(3, len(history[o]))))
            for j in range(rng.randrange(1, max_msgs + 1)):
                ts = timestamp_to_string(Timestamp(BASE + (b * 1000 + j) * 60000, rng.randrange(4), nodes[o]))
                m = protocol.EncryptedCrdtMessage(ts, b"ct-%d-%s" % (b, o.encode()))
                msgs.append(m)
                history[o].append(m)
            tree = tree_oracle.add_messages(o, msgs)
            reqs.append(protocol.SyncRequest(tuple(msgs), o, nodes[o], merkle_tree_to_string(tree)))
        batches.append(reqs)
    tree_oracle.close()
    return batches


def state_crc(store) -> int:
    crc = 0
    for u in sorted(store.user_ids()):
        crc = zlib.crc32(store.get_merkle_tree_string(u).encode(), crc)
        for m in store.replica_messages(u, ""):
            crc = zlib.crc32(m.timestamp.encode(), crc)
            crc = zlib.crc32(m.content, crc)
    return crc


def _open_store(db_path: str, shards: int):
    from evolu_tpu_torch.server.relay import RelayStore, ShardedRelayStore

    if shards > 1:
        return ShardedRelayStore(db_path, shards=shards)
    return RelayStore(db_path)


def _launches():
    """Kernel launches in this process: H, X, L, S."""
    from evolu_tpu_torch.ops import cuda_hash, cuda_scan

    return [f.launches for f in (cuda_hash.timestamp_hash_cuda, cuda_scan.segmented_xor_scan_cuda,
                                 cuda_scan.segmented_max_scan_cuda, cuda_scan.segmented_sum_scan_cuda)]


def main() -> None:
    mode, db_path = sys.argv[1], sys.argv[2]

    from evolu_tpu_torch.server.engine import BatchReconciler
    from evolu_tpu_torch.storage.write_behind import WriteBehindQueue

    if mode == "finish":
        shards = int(sys.argv[3]) if len(sys.argv) > 3 else 1
        workers = int(sys.argv[4]) if len(sys.argv) > 4 else 0
        store = _open_store(db_path, shards)
        t0 = time.perf_counter()
        wb = WriteBehindQueue(store, log_path=db_path + ".wblog", drain_workers=workers)
        replay_s = time.perf_counter() - t0
        wb.flush()
        print(f"DONE crc={state_crc(store):08x} records={wb.counts['replayed_records']} "
              f"rows={wb.counts['replayed']} replay_s={replay_s:.6f} launches={sum(_launches())}", flush=True)
        wb.close()
        store.close()
        return

    seed, n_batches, drain_delay = int(sys.argv[3]), int(sys.argv[4]), float(sys.argv[5])
    shards = int(sys.argv[6]) if len(sys.argv) > 6 else 1
    workers = int(sys.argv[7]) if len(sys.argv) > 7 else 0
    device = sys.argv[8] if len(sys.argv) > 8 else "cpu"
    size = [int(a) for a in sys.argv[9:12]]
    from evolu_tpu_torch.server import engine as engine_mod, snapshot

    if len(sys.argv) > 12:
        import pickle

        with open(sys.argv[12], "rb") as f:
            batches = pickle.load(f)
    else:
        batches = seeded_batches(seed, n_batches, *size)
    store = _open_store(db_path, shards)
    wb = WriteBehindQueue(store, log_path=db_path + ".wblog", drain_batch_rows=1 << 16 if size else 8,
                          drain_workers=workers, _drain_delay_s=drain_delay)
    eng = BatchReconciler(store, device=device, write_behind=wb)
    for i, reqs in enumerate(batches):
        eng.run_batch_wire(reqs)
        passes = sum(engine_mod.counts[k] for k in ("delta", "full", "overflow"))
        print(f"ACK {i} passes={passes} launches={','.join(map(str, _launches()))}", flush=True)
        if i and i % 4 == 0:
            snapshot.write_checkpoint(store, db_path + ".ckpt", barrier=wb.drain_barrier)
            print(f"CKPT {i}", flush=True)
    wb.flush()
    print(f"DONE crc={state_crc(store):08x}", flush=True)
    wb.close()
    eng.close()
    store.close()


def torture(db_path: str, seed: int, n_batches: int = 12, drain_delay: float = 0.15, shards: int = 1,
            workers: int = 0, device: str = "cpu", size=(), twin_device: str = "cpu",
            env=None, timeout_s: float = 300.0, resend: float = RESEND) -> dict:
    """One crash-and-replay episode: spawn an `ingest` worker, SIGKILL it at
    a seeded ACK count (after a seeded pause), replay in a fresh `finish`
    process, and compute one synchronous twin's crcs of the ACKed prefix,
    of prefix+1 (a kill between the log's fsync and the ACK print), and,
    on a sharded store, of every record prefix of batch acked+1 (a
    multi-shard append can leave a complete-frame prefix on disk). →
    {"acked", "crc", "accepted", "finish": the DONE fields, "child": the last
    ACK's passes and launches, "messages": those of the ACKed batches}."""
    import pickle
    import random
    import subprocess

    if resend != RESEND and not size:
        raise ValueError("a resend chance other than the reference's needs a size: the child reads the batches")
    rng = random.Random(seed)
    env = {**os.environ, **(env or {})}
    batches = seeded_batches(seed, n_batches, *size, resend=resend)
    argv = [sys.executable, WORKER, "ingest", db_path, str(seed), str(n_batches), str(drain_delay),
            str(shards), str(workers), device, *[str(x) for x in size]]
    if size:
        with open(db_path + ".batches", "wb") as f:
            pickle.dump(batches, f)
        argv.append(db_path + ".batches")
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE, text=True, env=env)
    kill_after = rng.randrange(1, n_batches - 1)
    pause = rng.random() * 0.3
    acked, child = -1, {}
    try:
        for line in proc.stdout:
            if line.startswith("ACK "):
                acked = int(line.split()[1])
                child = dict(kv.split("=", 1) for kv in line.split()[2:])
                if acked >= kill_after:
                    time.sleep(pause)
                    proc.kill()  # SIGKILL: no teardown, no flush
                    break
            elif line.startswith("DONE"):
                break
        # ACK lines already in the pipe are durable batches too.
        for line in proc.stdout:
            if line.startswith("ACK "):
                acked = int(line.split()[1])
                child = dict(kv.split("=", 1) for kv in line.split()[2:])
        proc.wait(timeout=timeout_s)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    if acked < 0:
        raise AssertionError("the worker never ACKed a batch")
    out = subprocess.run([sys.executable, WORKER, "finish", db_path, str(shards), str(workers)],
                         capture_output=True, text=True, timeout=timeout_s, env=env, check=True)
    done = [ln for ln in out.stdout.splitlines() if ln.startswith("DONE crc=")]
    if not done:
        raise AssertionError(out.stdout + out.stderr)
    finish = dict(kv.split("=", 1) for kv in done[-1].split()[1:])

    from evolu_tpu_torch.server.engine import BatchReconciler
    from evolu_tpu_torch.server.relay import RelayStore

    # One twin: the ACKed prefix, then batch acked+1 (on a sharded store
    # shard by shard, in the order the append framed its records: owners
    # never span shards, so each shard prefix is a state a partial append
    # can leave), with the crc after each step.
    steps = []
    if acked + 1 < len(batches):  # every request of a seeded batch carries messages
        nxt = batches[acked + 1]
        shard = {r.user_id: zlib.crc32(r.user_id.encode("utf-8")) % shards for r in nxt}
        steps = [[r for r in nxt if shard[r.user_id] == si] for si in sorted(set(shard.values()))]
    oracle = RelayStore()
    eng = BatchReconciler(oracle, device=twin_device)
    for reqs in batches[: acked + 1]:
        eng.run_batch_wire(reqs)
    accepted = {f"{state_crc(oracle):08x}"}
    for reqs in steps:
        eng.run_batch_wire(reqs)
        accepted.add(f"{state_crc(oracle):08x}")
    eng.close()
    oracle.close()
    return {"acked": acked, "crc": finish["crc"], "accepted": accepted, "finish": finish, "child": child,
            "messages": sum(len(r.messages) for b in batches[: acked + 1] for r in b)}


if __name__ == "__main__":
    main()
