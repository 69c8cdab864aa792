"""The look-back scratch that kernels L, X and S share per (device,
stream), taken by two host threads on one stream.

The look-back in `csrc/seg_scan.cu` waits for status words carrying its
own call's epoch, so two launches must never carry one epoch. The test
runs on the CPU: a fake library answers the two size queries, and the
lock of `cuda_lib.stream_state` makes each thread wait, after it lets
go, until the other has been through it too. A launch that read the
shared state after the lock would then see the other thread's epoch."""

import threading

import torch

from evolu_tpu_torch.ops import cuda_lib, cuda_scan


class _FakeLib:
    @staticmethod
    def evolu_seg_scan_tile_rows():
        return 2048

    @staticmethod
    def evolu_seg_scan_lookback_bytes(tiles):
        return 16 * tiles


class _LockThatWaitsAfterRelease:
    """A lock whose release lets go, then waits for the other thread to
    have released it too."""

    def __init__(self, parties):
        self._lock = threading.Lock()
        self._barrier = threading.Barrier(parties, timeout=30)

    def __enter__(self):
        self._lock.acquire()

    def __exit__(self, *exc):
        self._lock.release()
        self._barrier.wait()


def test_two_threads_on_one_stream_take_distinct_epochs(monkeypatch):
    monkeypatch.setattr(cuda_lib, "stream_handle", lambda t: 0)
    monkeypatch.setattr(cuda_scan, "load", lambda: _FakeLib)
    monkeypatch.setattr(cuda_lib, "_stream_states", {})
    monkeypatch.setattr(cuda_lib, "_stream_states_lock", _LockThatWaitsAfterRelease(2))
    got, errors = [None, None], []

    def launch(i):
        try:
            got[i] = cuda_scan._lookback_scratch(torch.zeros(100, dtype=torch.int32), 100)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=launch, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    # One scratch buffer (no grow), so the two launches need two epochs.
    assert sorted(g[2] for g in got) == [1, 2]
