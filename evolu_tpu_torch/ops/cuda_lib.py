"""Build and load the port's CUDA kernels (`csrc/*.cu`).

The sources are compiled with nvcc for `sm_90a` at first use, one nvcc
process per source, all started together, then linked into one shared
library with a plain C interface that `ctypes` loads. Nothing includes
PyTorch's headers, so a build takes seconds. The library lands in
`evolu_tpu_torch/_build/<content hash>/`, keyed by the sources and the
flags, so an edited source never loads a stale build. Pointers and the
stream cross the boundary as `c_void_p`; every entry point returns a
`cudaError_t`, which `check` turns into a `KernelError`, as it does a
failed build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from contextlib import contextmanager
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = ("seg_scan.cu", "ts_hash.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib = None


class KernelError(RuntimeError):
    """A kernel could not be built or launched, or the card failed its
    work. A RuntimeError, so callers that catch that keep working; the
    relay's scheduler tells it apart from a request that poisons a batch."""

build_info = {"seconds": None, "log": "", "path": None}


def nvcc() -> str:
    """The path of nvcc: on PATH, else the CUDA toolkit's default place."""
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise KernelError("evolu_tpu_torch: nvcc not found; the CUDA kernels cannot be built")


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _build(out_dir: Path) -> str:
    """Compile every source in parallel, link, and move the library into
    `out_dir` atomically. Returns the compiler's log."""
    compiler = nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_ROOT) as tmp:
        procs = []
        for name in SOURCES:
            obj = os.path.join(tmp, name + ".o")
            cmd = [compiler, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", obj]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for name, _, p in procs:
            out, _ = p.communicate()
            log.append(f"== {name}\n{out}")
            if p.returncode != 0:
                failed.append(name)
        if failed:
            raise KernelError("nvcc failed for " + ", ".join(failed) + "\n" + "\n".join(log))
        lib_tmp = os.path.join(tmp, "libevolu_kernels.so")
        link = subprocess.run(
            [compiler, "-shared", "-o", lib_tmp, *(obj for _, obj, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        log.append(f"== link\n{link.stdout}")
        if link.returncode != 0:
            raise KernelError("nvcc link failed\n" + "\n".join(log))
        text = "\n".join(log)
        Path(tmp, "build.log").write_text(text)
        staged = Path(tmp, "out")
        staged.mkdir()
        os.replace(lib_tmp, staged / "libevolu_kernels.so")
        os.replace(Path(tmp, "build.log"), staged / "build.log")
        try:
            os.replace(staged, out_dir)
        except OSError:
            if not (out_dir / "libevolu_kernels.so").exists():  # not a lost race
                raise
    return text


def _bind(lib):
    vp, ll, i, u = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint
    lib.evolu_seg_scan_tile_rows.argtypes = []
    lib.evolu_seg_scan_tile_rows.restype = ll
    lib.evolu_seg_scan_lookback_bytes.argtypes = [ll]
    lib.evolu_seg_scan_lookback_bytes.restype = ll
    lib.evolu_seg_lex_max_scan.argtypes = [vp, vp, vp, vp, vp, ll, i, vp, ll, u, vp]
    lib.evolu_seg_lex_max_scan.restype = i
    lib.evolu_seg_sum_scan.argtypes = [vp, vp, vp, ll, vp, ll, u, vp]
    lib.evolu_seg_sum_scan.restype = i
    lib.evolu_seg_xor_scan.argtypes = [vp, vp, vp, ll, vp, ll, u, vp]
    lib.evolu_seg_xor_scan.restype = i
    lib.evolu_ts_hash_scratch_bytes.argtypes = []
    lib.evolu_ts_hash_scratch_bytes.restype = ll
    lib.evolu_ts_hash.argtypes = [vp, vp, vp, vp, vp, vp, ll, vp]
    lib.evolu_ts_hash.restype = i
    return lib


def load():
    """The kernel library, built on first call. Raises if nvcc or the
    build fails; there is no fallback."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            out_dir = _build_dir()
            so = out_dir / "libevolu_kernels.so"
            t0 = time.perf_counter()
            if not so.exists():
                build_info["log"] = _build(out_dir)
            else:
                build_info["log"] = (out_dir / "build.log").read_text()
            _lib = _bind(ctypes.CDLL(str(so)))
            build_info["seconds"] = time.perf_counter() - t0
            build_info["path"] = str(so)
        return _lib


@contextmanager
def device_work(what: str):
    """The device leg of a caller's work: upload, kernels, pull. Its
    inputs are host columns that parsed already, so a failure inside (a
    CUDA error, sticky or not, an out-of-memory, a kernel that did not
    build or launch) is the device's, never the input's, and leaves as a
    KernelError: the relay's scheduler then fails the batch instead of
    serving its requests again as singletons on the host, and nothing
    falls back to a host route."""
    try:
        yield
    except KernelError:
        raise
    except Exception as e:
        raise KernelError(f"evolu_tpu_torch: {what}'s device work failed: {e!r}") from e


def check(rc: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if rc != 0:
        raise KernelError(f"evolu_tpu_torch: {what} launch failed: cudaError_t {rc}")


def require(t, dtype, n: int, what: str) -> None:
    """Raise unless `t` is a contiguous 1-D CUDA tensor of `dtype` and length n."""
    if not t.is_cuda or t.dtype != dtype or t.shape != (n,) or not t.is_contiguous():
        raise ValueError(
            f"{what}: expected a contiguous CUDA {dtype} tensor of shape ({n},), got "
            f"{t.dtype} {tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})"
        )


def stream_handle(t) -> int:
    """The current PyTorch stream of `t`'s device, as a raw handle.
    `torch.cuda.current_stream` would build a Stream object on every call,
    a large share of a small call's host cost."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.device.index)


_stream_states = {}  # (kind, device index, stream handle) -> state
_stream_states_lock = threading.Lock()


def stream_state_count() -> int:
    """How many per-(kind, device, stream) kernel states exist: what the
    kernels keep per launch shape (`server.engine.observe_jit_caches`)."""
    with _stream_states_lock:
        return len(_stream_states)


def stream_state(kind: str, t, update, *args):
    """(view, stream) for one launch on `t`'s device and current stream.
    `update(state or None, device, *args)` returns the `kind` scratch state,
    which is stored, and the view of it that the launch uses; both happen
    under one lock, so a launch never reads the shared state after another
    host thread on the same stream has changed it. Two streams never share
    a state, so their calls cannot overlap on it."""
    stream = stream_handle(t)
    key = (kind, t.device.index, stream)
    with _stream_states_lock:
        _stream_states[key], view = update(_stream_states.get(key), t.device, *args)
    return view, stream
