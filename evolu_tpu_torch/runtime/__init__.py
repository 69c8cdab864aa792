"""The client runtime: the `Evolu` handle (`client`), the single-writer
`DbWorker` and its command protocol.

The names load on first access: the worker imports the planners and
torch, which a host-only import of this package must not."""

from evolu_tpu_torch.utils.lazy import lazy_getattr

_LAZY = {
    "DbWorker": ("evolu_tpu_torch.runtime.worker", "DbWorker"),
    "Evolu": ("evolu_tpu_torch.runtime.client", "Evolu"),
    "create_evolu": ("evolu_tpu_torch.runtime.client", "create_evolu"),
}

__all__ = ["DbWorker", "Evolu", "create_evolu"]

__getattr__ = lazy_getattr(__name__, _LAZY)
