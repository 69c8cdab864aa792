"""The device trace of a measured window: busy time, idle gaps and the
device operations that took most of it, from torch.profiler (CUPTI).

The session runs on the profiler's schedule: a warm-up step whose
records are dropped, then the active step that covers the window. Kernels
run on the relay's dispatcher and pull threads, which CUPTI traces once a
session has run on the main thread, so `prepare()` runs one there during
set-up. A session is kept only if it caught every launch of the port's
hash kernel (H) that the program's own launch counter counted in the
window: some sessions catch a part of the records, and a busy time from
those would be too low.
"""

from __future__ import annotations

import collections
import sys
import time
from typing import List, Optional, Tuple


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class DeviceTrace:
    """One scheduled session around a window (`prepare`, `start`, `stop`)."""

    HASH_KERNEL = "ts_hash_kernel"

    def __init__(self, torch):
        self.torch = torch
        self.events = None
        self.prof = None

    def prepare(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            self.torch.zeros(1, device="cuda").add_(1)
            self.torch.cuda.synchronize()

    def _launches(self) -> int:
        from evolu_tpu_torch.ops.cuda_hash import timestamp_hash_cuda

        return timestamp_hash_cuda.launches

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, schedule

        self.prof = profile(activities=[ProfilerActivity.CUDA],
                            schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                            on_trace_ready=self._ready)
        self.prof.start()
        time.sleep(0.05)
        self.launches0 = self._launches()
        self.prof.step()
        self.t0 = time.perf_counter()
        self.wall0 = time.time()

    def _ready(self, prof) -> None:
        self.events = prof.events()
        try:
            self.trace_start_ns = prof.profiler.kineto_results.trace_start_ns()
        except AttributeError:
            self.trace_start_ns = None

    def stop(self) -> None:
        self.torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.launches = self._launches() - self.launches0
        self.prof.step()
        self.prof.stop()

    def summary(self) -> Optional[dict]:
        """{busy_s, window_s, hash_records, hash_launches, ops, gaps} or
        None when the session missed device records (said on stderr)."""
        torch = self.torch
        dev = [e for e in self.events or () if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False) and not e.name.startswith("ProfilerStep")]
        hashes = sum(1 for e in dev if self.HASH_KERNEL in e.name)
        if hashes != self.launches:
            print(f"portbench: the profiler caught {hashes} records of {self.HASH_KERNEL}, the program "
                  f"launched it {self.launches} times in the window; device metrics not measured",
                  file=sys.stderr)
            return None
        spans = _union([(e.time_range.start / 1e6, e.time_range.end / 1e6) for e in dev])
        busy = sum(b - a for a, b in spans)
        by_name = collections.Counter()
        for e in dev:
            by_name[e.name] += e.time_range.elapsed_us() / 1e6
        # Idle gaps between device work, as epoch seconds where the trace's
        # start is known (so host spans can name them).
        base = None
        if self.trace_start_ns:
            base = self.trace_start_ns / 1e9
            if abs(base - self.wall0) > 3600:
                base = None
        gaps = []
        for (a0, a1), (b0, _b1) in zip(spans, spans[1:]):
            gaps.append((b0 - a1, None if base is None else base + a1, None if base is None else base + b0))
        return {"busy_s": busy, "window_s": self.t1 - self.t0, "hash_records": hashes,
                "hash_launches": self.launches, "ops": by_name.most_common(10),
                "gaps": sorted(gaps, reverse=True)[:200], "wall0": self.wall0}
