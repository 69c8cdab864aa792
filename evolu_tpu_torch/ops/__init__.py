"""Device plumbing shared by the port's kernels and planners.

Dtype conventions (torch has no unsigned 64/32-bit arithmetic on the
CPU, so the port carries bit patterns in signed types):

- u64 HLC keys (`k1 = millis << 16 | counter`, `k2 = node`, and the
  stored-winner keys) ride as int64 bit patterns. Every ORDER compare
  goes through `u64_order`, which flips the sign bit so a signed
  compare gives the unsigned order; equality needs no flip. Right
  shifts of a key are arithmetic in torch, so they mask afterwards.
- u32 murmur hashes ride as int32 bit patterns (XOR and equality are
  sign-agnostic); the plain hash computes in int64 with `& 0xFFFFFFFF`.
- Masks are bool; cell ids int32; owner indices int64.

`columns_to_device` / `columns_to_numpy` are the bridge between these
tensors and the host numpy column layout (u64 as `np.uint64`), bit for
bit.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from evolu_tpu_torch.obs import anatomy as _anatomy
from evolu_tpu_torch.obs import metrics as _metrics

# Columns whose numpy form is np.uint64 (int64 bit patterns on device).
U64_COLUMNS = frozenset({"k1", "k2", "ex_k1", "ex_k2", "node"})

_SIGN = -(1 << 63)


def resolve_device(device=None) -> torch.device:
    """`None` means CUDA; without a card that raises instead of quietly
    running the plain versions — the caller must ask for the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "evolu_tpu_torch: CUDA is not available; pass device='cpu' "
                "to run the plain PyTorch versions of the kernels"
            )
        return torch.device("cuda")
    return torch.device(device)


def u64_order(x: torch.Tensor) -> torch.Tensor:
    """int64 bit pattern of a u64 → int64 whose signed order is the u64's
    unsigned order (sign bit flipped)."""
    return x ^ _SIGN


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 → int32 keeping the low 32 bits (two's-complement wrap, like
    `.astype(int32)` in numpy/JAX)."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def to_host_many(*xs):
    """One synchronize, then one `.cpu()` wave for every output. Tensors
    become numpy arrays, pulls begun by `start_host_transfer` are waited
    for; anything else passes through.

    Instrumented like the reference's: pull bytes, the wave-size
    histogram and pull seconds, and one `pull_wave` stage record a wave.
    The instrumentation is host-side, after the pull materialized — it
    reads `.nbytes` off the returned numpy arrays and costs a few dict
    ops per WAVE (tests/test_torch_obs_liveness.py)."""
    t0 = time.perf_counter()
    if any(isinstance(x, torch.Tensor) and x.is_cuda for x in xs):
        torch.cuda.synchronize()
    out = tuple(
        x.cpu().numpy() if isinstance(x, torch.Tensor)
        else x.wait() if isinstance(x, HostTransfer) else x
        for x in xs
    )
    record_pull_wave(time.perf_counter() - t0, out)
    return out


def to_host(x):
    """One tensor's pull: a wave of one (`to_host_many`)."""
    return to_host_many(x)[0]


class HostTransfer:
    """A device → host copy begun on a side stream: `wait()` waits for its
    event and gives the numpy array."""

    def __init__(self, host: torch.Tensor, event):
        self.host, self.event = host, event

    def wait(self) -> np.ndarray:
        self.event.synchronize()
        return self.host.numpy()


_side_streams: Dict[torch.device, "torch.cuda.Stream"] = {}


def start_host_transfer(*xs):
    """The starting half of `to_host_many`: begin every CUDA tensor's copy
    into pinned host memory on a side stream (after the work queued so
    far on the current stream) and return a `HostTransfer` for each; CPU
    tensors and anything else come back untouched. A later
    `to_host_many` on the results is the counted pull wave."""
    out = []
    for x in xs:
        if not (isinstance(x, torch.Tensor) and x.is_cuda):
            out.append(x)
            continue
        side = _side_streams.get(x.device)
        if side is None:
            side = _side_streams.setdefault(x.device, torch.cuda.Stream(x.device))
        side.wait_stream(torch.cuda.current_stream(x.device))
        with torch.cuda.stream(side):
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            host.copy_(x, non_blocking=True)
            x.record_stream(side)
            event = torch.cuda.Event()
            event.record(side)
        out.append(HostTransfer(host, event))
    return tuple(out)


def record_pull_wave(seconds: float, arrays) -> None:
    """One pull wave's telemetry: its bytes, the wave-size histogram, its
    seconds, and a `pull_wave` stage record."""
    if _metrics.registry.enabled:
        wave_bytes = sum(int(getattr(a, "nbytes", 0)) for a in arrays)
        _metrics.inc("evolu_pull_bytes_total", wave_bytes)
        _metrics.inc("evolu_pull_seconds_total", seconds)
        _metrics.observe("evolu_pull_wave_bytes", wave_bytes,
                         buckets=_metrics.SIZE_BUCKETS)
        _anatomy.record_stage("pull_wave", seconds, nbytes=wave_bytes)


def bucket_size(n: int, multiple: int = 64) -> int:
    """Power-of-two batch bucket ≥ max(n, multiple)."""
    size = multiple
    while size < n:
        size *= 2
    return size


def columns_to_device(cols: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Host numpy columns (u64 as np.uint64) → the port's tensors on
    `device` (u64 as int64 bit patterns), bit for bit."""
    device = resolve_device(device)
    out = {}
    for name, a in cols.items():
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint64:
            a = a.view(np.int64)
        out[name] = torch.from_numpy(a).to(device)
    return out


def columns_to_numpy(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Inverse of `columns_to_device`: the columns named in U64_COLUMNS
    come back as np.uint64, the rest in their own dtype."""
    names = list(tensors)
    arrays = to_host_many(*(tensors[k] for k in names))
    return {
        k: a.view(np.uint64) if k in U64_COLUMNS else a
        for k, a in zip(names, arrays)
    }
