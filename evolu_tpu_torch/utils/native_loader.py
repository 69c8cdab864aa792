"""Build and load the native host libraries (`native/*.cpp`, `csrc/*.cpp`)
for the port.

Three bindings use it: `storage.native` over `libevolu_host.so` (the C++
SQLite host layer) and `sync.native_crypto` over `libevolu_crypto.so`
(the batched OpenPGP and AES-GCM legs), whose C++ sources are the
reference's in `native/`, and `sync.wire_scan` over
`libevolu_wire_scan.so` (the relay front's scan of a sync POST), whose
source is the port's own in `evolu_tpu_torch/csrc/`. Each is compiled
unchanged with `g++` and the flags of `native/Makefile` at first use;
nothing is ever written into a source directory.

Each library lands in `evolu_tpu_torch/_build/native/<hash>/`, keyed by
its sources, the flags, the linked soname and the compiler's version,
so an edited source or another toolchain never loads a stale build. The
compiler writes a temporary name that is renamed into place under an
`fcntl` lock, so concurrent processes (test workers) never load a
half-written library.

A failed build is kept with the compiler's log: `load_native_library`
raises it to every caller that asked for the native route, and
`try_load_native_library` answers None for the callers whose "auto"
choice falls back (the reference's semantics). `build_info` keeps each
library's path, build time and log.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Optional

_PKG = Path(__file__).resolve().parent.parent
NATIVE_DIR = _PKG.parent / "native"
CSRC_DIR = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build" / "native"
CXX = "g++"
CXXFLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared")
# so_name -> (source directory, source, headers it includes, candidate
# sonames to link: the first that links wins; an empty tuple links none)
TARGETS = {
    "libevolu_host.so": (NATIVE_DIR, "evolu_host.cpp", ("wire.h",), ("libsqlite3.so.0",)),
    "libevolu_crypto.so": (NATIVE_DIR, "evolu_crypto.cpp", ("wire.h",),
                           ("libcrypto.so.3", "libcrypto.so.1.1", "libcrypto.so")),
    "libevolu_wire_scan.so": (CSRC_DIR, "wire_scan.cpp", (), ()),
}


class NativeBuildError(RuntimeError):
    """A native library could not be built or loaded; the message holds
    the compiler's log."""


_lock = threading.Lock()
_cache: Dict[str, object] = {}  # so_name -> CDLL, or the NativeBuildError
build_info: Dict[str, dict] = {}  # so_name -> {"path", "seconds", "log", "linked"}


def _run(cmd, **kw) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, **kw)


def _linkable(candidates) -> Optional[str]:
    """The first soname a trivial program links against (the Makefile's
    probe: the image ships versioned sonames without dev symlinks)."""
    for soname in candidates:
        probe = _run([CXX, "-x", "c++", "-", "-o", os.devnull, f"-l:{soname}"],
                     input="int main(){return 0;}", timeout=120)
        if probe.returncode == 0:
            return soname
    return None


def _compiler_version() -> str:
    try:
        return _run([CXX, "--version"], timeout=60).stdout.splitlines()[0]
    except (OSError, IndexError) as e:
        raise NativeBuildError(f"evolu_tpu_torch: no usable {CXX}: {e}") from e


def toolchain() -> dict:
    """What this machine offers the build: the compiler's version line and,
    for each library that links one, the soname it links (None where none
    links)."""
    return {"compiler": _compiler_version(),
            "links": {so: _linkable(t[3]) for so, t in TARGETS.items() if t[3]}}


def _build(so_name: str):
    """Compile `so_name` into its hashed directory (or find it there).
    → (the library's path, the soname it links, "" for none); raises
    NativeBuildError with the log."""
    src_dir, source, headers, candidates = TARGETS[so_name]
    version = _compiler_version()
    linked = _linkable(candidates) if candidates else ""
    if linked is None:
        raise NativeBuildError(
            f"evolu_tpu_torch: {so_name}: none of {', '.join(candidates)} links with {CXX} ({version})")
    h = hashlib.sha256("\0".join((version, linked, *CXXFLAGS)).encode())
    for name in (source, *headers):
        h.update(name.encode())
        h.update((src_dir / name).read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    so = out_dir / so_name
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():
            return so, linked
        tmp = out_dir / f".{so_name}.{os.getpid()}.tmp"
        cmd = [CXX, *CXXFLAGS, "-o", str(tmp), str(src_dir / source)] + ([f"-l:{linked}"] if linked else [])
        result = _run(cmd, timeout=600)
        log = " ".join(cmd) + "\n" + result.stdout
        (out_dir / f"{so_name}.log").write_text(log)
        if result.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise NativeBuildError(f"evolu_tpu_torch: building {so_name} failed\n{log}")
        os.replace(tmp, so)
    return so, linked


def load_native_library(so_name: str, configure: Callable[[ctypes.CDLL], Optional[str]]) -> ctypes.CDLL:
    """The library `so_name`, built on first use. `configure(lib)` sets
    the argtypes and returns None, or a reason the library cannot serve
    (a failed runtime probe). Raises NativeBuildError on any failure,
    the same one on every later call."""
    with _lock:
        cached = _cache.get(so_name)
        if cached is None:
            t0 = time.perf_counter()
            try:
                so, linked = _build(so_name)
                lib = ctypes.CDLL(str(so))
                veto = configure(lib)
                if veto is not None:
                    raise NativeBuildError(f"evolu_tpu_torch: {so_name}: {veto}")
            except NativeBuildError as e:
                cached = e
            except (OSError, AttributeError) as e:  # a dlopen or symbol failure
                cached = NativeBuildError(f"evolu_tpu_torch: loading {so_name} failed: {e}")
            else:
                cached = lib
                log = so.parent / f"{so_name}.log"
                build_info[so_name] = {"path": str(so), "linked": linked,
                                       "seconds": time.perf_counter() - t0,
                                       "log": log.read_text() if log.exists() else ""}
            if isinstance(cached, NativeBuildError):
                build_info[so_name] = {"path": None, "linked": None,
                                       "seconds": time.perf_counter() - t0, "log": str(cached)}
            _cache[so_name] = cached
    if isinstance(cached, NativeBuildError):
        raise cached
    return cached


def try_load_native_library(so_name: str, configure) -> Optional[ctypes.CDLL]:
    """`load_native_library`, or None when the library is unavailable
    (its log stays in `build_info`)."""
    try:
        return load_native_library(so_name, configure)
    except NativeBuildError:
        return None
