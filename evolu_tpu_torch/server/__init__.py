"""The relay: message and Merkle storage for many owners and the HTTP
server (`relay`, with `relay_worker` for its pre-forked processes), the
batched reconcile engine whose Merkle leg runs on the card (`engine`),
the continuous-batching scheduler between them (`scheduler`), and the
relay tier (`replicate`, `snapshot`, `fleet`, `push`, `conn`, `scope`).

The names load on first access: the pre-forked workers and the host-only
observability imports go through this package, and an eager import here
would load the engine and torch in each of them."""

from evolu_tpu_torch.utils.lazy import lazy_getattr

_LAZY = {
    "RelayStore": ("evolu_tpu_torch.server.relay", "RelayStore"),
    "RelayServer": ("evolu_tpu_torch.server.relay", "RelayServer"),
    "serve": ("evolu_tpu_torch.server.relay", "serve"),
    "SyncScheduler": ("evolu_tpu_torch.server.scheduler", "SyncScheduler"),
    "SchedulerQueueFull": ("evolu_tpu_torch.server.scheduler", "SchedulerQueueFull"),
    "ReplicationManager": ("evolu_tpu_torch.server.replicate", "ReplicationManager"),
}

__all__ = [
    "RelayStore", "RelayServer", "serve", "SyncScheduler", "SchedulerQueueFull",
    "ReplicationManager",
]

__getattr__ = lazy_getattr(__name__, _LAZY)
