"""The port's logger (`evolu_tpu_torch.utils.log`), the twin of
tests/test_log.py: target gating, span durations, the clock targets, the
bounded ring, and span annotations, which in the port are
`torch.profiler.record_function` ranges."""

import pytest

from evolu_tpu_torch.core.types import CrdtClock
from evolu_tpu_torch.storage.clock import read_clock, update_clock
from evolu_tpu_torch.storage.schema import init_db_model
from evolu_tpu_torch.storage.sqlite import PySqliteDatabase
from evolu_tpu_torch.utils.log import Logger, logger


@pytest.fixture(autouse=True)
def _clean_slate():
    logger.clear()
    yield
    logger.configure(False)
    logger.clear()


def test_target_gating():
    lg = Logger(enabled=False)
    lg.log("dev", "hidden")
    assert lg.recent_events() == []
    lg.configure("dev")
    lg.log("dev", "shown")
    lg.log("clock:read", "not this target")
    assert [e.message for e in lg.recent_events()] == ["shown"]
    lg.configure(True)
    lg.log("clock:read", "now everything")
    assert len(lg.recent_events()) == 2


def test_span_records_duration_even_when_disabled():
    lg = Logger(enabled=False)
    with lg.span("kernel:merge", "plan", n=3):
        pass
    stats = lg.duration_stats("kernel:merge")
    assert stats is not None and stats[0] == 1 and stats[1] >= 0
    (ev,) = lg.recent_events("kernel:merge")
    assert ev.duration_ms is not None and ev.fields == {"n": 3}


def test_clock_targets_fire(capsys):
    logger.configure(["clock:read", "clock:update"])
    try:
        db = PySqliteDatabase()
        init_db_model(db, mnemonic=None)
        clock = read_clock(db)
        update_clock(db, CrdtClock(clock.timestamp, clock.merkle_tree))
        out = capsys.readouterr().out
        assert "[clock:read]" in out and "[clock:update]" in out
        targets = [e.target for e in logger.recent_events()]
        assert "clock:read" in targets and "clock:update" in targets
    finally:
        logger.configure(False)
        logger.clear()


def test_ring_is_bounded():
    lg = Logger(enabled=True, capacity=4)
    for i in range(10):
        lg.log("dev", str(i))
    msgs = [e.message for e in lg.recent_events()]
    assert msgs == ["6", "7", "8", "9"]


def test_span_trace_annotations_fire_under_the_target_name():
    """With annotations enabled every span opens an annotation named by
    the SAME target the log/metrics surfaces use; disabled spans touch
    nothing."""
    import evolu_tpu_torch.utils.log as log_mod

    entered = []

    class FakeAnnotation:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            entered.append(("enter", self.name))
            return self

        def __exit__(self, *exc):
            entered.append(("exit", self.name))

    lg = Logger()
    orig = log_mod._trace_annotation_cls
    try:
        log_mod._trace_annotation_cls = FakeAnnotation
        with lg.span("kernel:merkle", "reconcile_ingest", n=3):
            pass
        with lg.span("kernel:merge"):
            pass
    finally:
        log_mod._trace_annotation_cls = orig
    assert entered == [
        ("enter", "kernel:merkle|reconcile_ingest"),
        ("exit", "kernel:merkle|reconcile_ingest"),
        ("enter", "kernel:merge"),
        ("exit", "kernel:merge"),
    ]
    entered.clear()
    with lg.span("kernel:merge"):
        pass
    assert entered == []


def test_enable_trace_annotations_real_record_function():
    """The real `torch.profiler.record_function` binds, and a profile
    taken around an annotated span holds a range under the span's
    `<target>|<message>` name; disabling unbinds it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import evolu_tpu_torch.utils.log as log_mod
    from evolu_tpu_torch.utils.log import enable_trace_annotations

    try:
        enable_trace_annotations(True)
        assert log_mod._trace_annotation_cls is torch.profiler.record_function
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with Logger().span("kernel:merge", "smoke"):
                torch.arange(8).sum()
    finally:
        enable_trace_annotations(False)
    assert log_mod._trace_annotation_cls is None
    names = {e.name for e in prof.events()}
    assert "kernel:merge|smoke" in names, sorted(names)[:20]


def test_trace_annotations_env_switch_at_import():
    """EVOLU_TRACE_ANNOTATIONS=1 turns annotations on when the module is
    imported, as in the reference; the import itself loads no torch."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = ("import json, sys\n"
              "import evolu_tpu_torch.utils.log as m\n"
              "print(json.dumps([m._trace_annotation_cls is not None, 'torch' in sys.modules]))\n")
    out = {}
    for flag in ("1", "0"):
        env = {**os.environ, "PYTHONPATH": repo, "EVOLU_TRACE_ANNOTATIONS": flag}
        run = subprocess.run([sys.executable, "-c", script], cwd=repo, env=env, capture_output=True,
                             text=True, timeout=120)
        assert run.returncode == 0, run.stderr
        out[flag] = json.loads(run.stdout.strip().splitlines()[-1])
    assert out["1"][0] is True and out["0"] == [False, False]
