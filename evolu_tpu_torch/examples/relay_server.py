"""Deployable relay server: `POST /` takes a protobuf SyncRequest and
answers a SyncResponse, `GET /ping` answers liveness; storage is one
SQLite file. The relay is E2EE-blind: it sees timestamps and ciphertext
only.

    python -m evolu_tpu_torch.examples.relay_server [--db relay.db] [--port 4000]
        [--device cuda|cpu]

PORT may also come from the environment. `--device` is where the relay's
device work runs, the scoped folds of sync-scope-v1 pulls (default: the
CUDA card, which it then requires).
"""

from __future__ import annotations

import argparse
import os
import threading


def main() -> None:
    from evolu_tpu_torch import RelayServer, RelayStore, resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--db", default="relay.db")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=int(os.environ.get("PORT", 4000)))
    ap.add_argument("--checkpoint-interval", type=float, default=None,
                    help="write a local snapshot checkpoint every N seconds "
                         "(crash-consistent fast restart; server/snapshot.py)")
    ap.add_argument("--device", default=None,
                    help="where the device work runs (default: the CUDA card; 'cpu' runs the plain versions)")
    args = ap.parse_args()

    device = resolve_device(args.device)
    server = RelayServer(RelayStore(args.db), host=args.host, port=args.port,
                         checkpoint_interval_s=args.checkpoint_interval, device=device)
    server.start()
    print(f"relay listening on {server.url} (db: {args.db}, device: {device})", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()


if __name__ == "__main__":
    main()
