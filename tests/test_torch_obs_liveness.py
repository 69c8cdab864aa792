"""The port's liveness fence for its observability, the twin of
tests/test_bench_liveness.py's metrics and tracing fences: the columns
pass (`parallel.reconcile.reconcile_owner_batches`) and the engine's
`deltas_dispatch` / `deltas_finish` run with every plane on (metrics,
tracing at 100% sampling under a root span, the stage anatomy, span
annotations) and then with every plane off. The outputs are equal bit
for bit, the passes pull in the same number of `to_host_many` waves, and
on the CPU no plane adds a `.cpu()` or `.numpy()` of a tensor. The planes
are shown to have recorded while on, so the fence is not vacuous. The
card-side half (equal `.launches` of kernels L, X and H) is
tests/test_torch_cuda.py's."""

import contextlib

import numpy as np
import pytest
import torch

from _torch_port_data import message_tuples, port_messages, stored_winners
from evolu_tpu_torch.obs import anatomy, metrics, trace
from evolu_tpu_torch.ops.host_parse import parse_timestamp_strings
from evolu_tpu_torch.parallel import reconcile as pr
from evolu_tpu_torch.server import engine as eng
from evolu_tpu_torch.utils import log as log_mod
from evolu_tpu_torch.utils.log import logger


@pytest.fixture(autouse=True)
def _clean_slate():
    logger.clear()
    yield
    metrics.set_enabled(True)
    trace.set_enabled(True)
    trace.set_sample_rate(1.0)
    log_mod.enable_trace_annotations(False)
    logger.clear()


def _fleet(seed=7, n_owners=24, per_owner=80):
    rng = np.random.default_rng(seed)
    batches, winners = {}, {}
    for i in range(n_owners):
        o = f"owner{i:05d}"
        t = message_tuples(rng, int(rng.integers(1, per_owner + 1)), n_rows=6, upper_node=i == 3)
        batches[o] = port_messages(t)
        winners[o] = stored_winners(rng, t)
    return batches, winners


def _planes(on: bool) -> None:
    metrics.set_enabled(on)
    trace.set_enabled(on)
    trace.set_sample_rate(1.0)
    log_mod.enable_trace_annotations(on)


@contextlib.contextmanager
def _counting(monkeypatch):
    """Counts `to_host_many` waves at their call sites and every
    `Tensor.cpu` / `Tensor.numpy` call."""
    counts = {"waves": 0, "cpu": 0, "numpy": 0}
    for mod in (pr, eng):
        orig = mod.to_host_many

        def wave(*xs, _orig=orig):
            counts["waves"] += 1
            return _orig(*xs)

        monkeypatch.setattr(mod, "to_host_many", wave)
    for name in ("cpu", "numpy"):
        orig = getattr(torch.Tensor, name)

        def call(self, *a, _orig=orig, _name=name, **kw):
            counts[_name] += 1
            return _orig(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, call)
    yield counts


def _run(batches, winners, on: bool, monkeypatch):
    _planes(on)
    root = trace.start_span("fence.pass")
    with monkeypatch.context() as m, _counting(m) as counts, trace.use(root.context):
        plan = pr.reconcile_owner_batches(batches, winners, device="cpu")
        rows = {o: [msg.timestamp for msg in ms] for o, ms in batches.items()}
        flat = [t for o in rows for t in rows[o]]
        all_m, all_c, all_n, case_ok = parse_timestamp_strings(flat, with_case=True)
        index, pos = {}, 0
        for o, ts in rows.items():
            index[o] = np.arange(pos, pos + len(ts))
            pos += len(ts)
        state = eng.deltas_dispatch(index, all_m, all_c, all_n, case_ok, flat, device="cpu")
        deltas = eng.deltas_finish(state)
    root.end()
    return (plan, deltas), counts


def test_every_plane_on_changes_no_output_wave_or_copy(monkeypatch):
    batches, winners = _fleet()
    off1, c_off1 = _run(batches, winners, False, monkeypatch)
    assert metrics.registry.snapshot()["counters"] == {} and trace.recorder.dump() == []
    on, c_on = _run(batches, winners, True, monkeypatch)
    off2, c_off2 = _run(batches, winners, False, monkeypatch)
    assert on == off1 == off2
    assert c_on == c_off1 == c_off2
    assert c_on["waves"] >= 2
    # The planes recorded while on: the kernel spans, their trace spans
    # under the root, the pull waves and the stage anatomy.
    _planes(True)
    assert metrics.registry.get_histogram("evolu_kernel_span_ms", target="kernel:reconcile")[3] == 1
    assert metrics.registry.get_histogram("evolu_kernel_span_ms", target="kernel:merkle") is None
    assert metrics.get_counter("evolu_reconcile_kernel_total", variant="packed") == 1
    assert metrics.get_counter("evolu_pull_bytes_total") > 0
    names = {s.name for s in trace.recorder.dump()}
    assert {"fence.pass", "kernel:reconcile|reconcile_owner_batches"} <= names
    stages = anatomy.stages_payload()["stages"]
    assert stages["pull_wave"]["count"] == c_on["waves"]
    assert stages["kernel:reconcile"]["count"] == 1


def test_annotations_add_no_copy_under_a_profile(monkeypatch):
    """Under a torch.profiler capture the annotated pass gives the same
    outputs and copies as the bare one, and the capture holds its
    `kernel:reconcile` range."""
    from torch.profiler import ProfilerActivity, profile

    batches, winners = _fleet(seed=9, n_owners=8)
    bare, c_bare = _run(batches, winners, False, monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        annotated, c_annotated = _run(batches, winners, True, monkeypatch)
    assert annotated == bare and c_annotated == c_bare
    assert "kernel:reconcile|reconcile_owner_batches" in {e.name for e in prof.events()}
