"""Worker-process entry point of `relay.MultiprocessRelay`:

    python -m evolu_tpu_torch.server.relay_worker HOST PORT PATH SHARDS BACKEND

Its own module, so `-m` does not re-execute relay.py under runpy. A
worker serves the per-request path on the host and never touches the
card."""

import sys

from evolu_tpu_torch.server.relay import _mp_worker_main


def main() -> None:
    host, port, path, shards, backend = sys.argv[1:6]
    _mp_worker_main(host, int(port), path, int(shards), backend)


if __name__ == "__main__":
    main()
