"""A module fixture for the port's parity tests that drive the JAX
package: it sets up and gives back the JAX package's process-wide state.

- Its native libraries. `evolu_tpu/utils/native_loader.py` builds each
  with `make` on first use, with no lock between processes, and caches a
  failed load as None for the rest of the process. Test workers that start
  together in a fresh checkout can load a library another worker is still
  writing (ROADMAP queue 3 item 8), and every later call of that worker
  then takes the JAX package's non-native path or returns None. The
  fixture loads both libraries under a lock that the port's test
  processes share, and loads one again after a None while `make` is
  there.
- Its conservation ledger (`evolu_tpu.obs.ledger`). Every JAX flow posts
  there, and a JAX test that runs later in the same process may audit it
  at a barrier (`tests/test_bench_liveness.py` does, without resetting
  it). A parity file's JAX episodes end wherever their checks end: a
  replayed log, a forwarded request or a shed one leaves the ledger out of
  balance. The fixture gives the ledger back as the file found it.

Each such file imports `jax_process_state`."""

import fcntl
import os
import shutil
import tempfile
import time

import pytest

LOAD_TRIES = 5


def _load_jax_native() -> None:
    from evolu_tpu.storage import native as host
    from evolu_tpu.sync import native_crypto as crypto
    from evolu_tpu.utils import native_loader

    if shutil.which("make") is None:
        return
    with open(os.path.join(tempfile.gettempdir(), "evolu_tpu_native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        for so, load in (("libevolu_host.so", host.load_library), ("libevolu_crypto.so", crypto.load_library)):
            for _ in range(LOAD_TRIES):
                if load() is not None:
                    break
                native_loader._cache.pop(so, None)  # a None cached while another process wrote the file
                time.sleep(1.0)


@pytest.fixture(scope="module", autouse=True)
def jax_process_state():
    from evolu_tpu.obs import ledger

    _load_jax_native()
    led = ledger.ledger
    with led._lock:
        counts, owners = dict(led._counts), {o: dict(sub) for o, sub in led._owners.items()}
    enabled = led.enabled
    yield
    with led._lock:
        led._counts.clear()
        led._counts.update(counts)
        led._owners.clear()
        led._owners.update(owners)
    led.enabled = enabled
