"""The scheduler's queue wait (`server/scheduler`): the median over the
window's requests of their `sched.queue` span."""

import importlib.util
import os

_spec = importlib.util.spec_from_file_location("portbench_metric_spans", os.path.join(os.path.dirname(__file__), "_spans.py"))
_spans = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_spans)


def read(obs):
    return _spans.median(r["queue"] for r in _spans.requests(obs.get("spans") or ()))
