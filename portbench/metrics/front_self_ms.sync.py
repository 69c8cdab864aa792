"""The relay front's own time a sync POST (`server/relay._Handler`,
`server/conn`): the median over the window's requests of the `relay.sync`
span less its `sched.queue` span and the engine pass that served it."""

import importlib.util
import os

_spec = importlib.util.spec_from_file_location("portbench_metric_spans", os.path.join(os.path.dirname(__file__), "_spans.py"))
_spans = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_spans)


def read(obs):
    rows = [r for r in _spans.requests(obs.get("spans") or ()) if r["queue"] is not None and r["pass"] is not None]
    return _spans.median(r["sync"] - r["queue"] - r["pass"] for r in rows)
