"""Tiny sizes for the CPU tests, and a checkout that also holds the pull
cell (`relay-c3.pull_catchup`, kept out of BENCHMARK.json: PERF.md says
why), made of the files that are already there."""

import json
import shutil

from portbench import harness

TINY = {"config": {"owners": 8, "messages_per_owner": 40, "content_pool": 64},
        "traffic": {"devices": 3}}
PULL = "relay-c3.pull_catchup"


def tiny(workload: str) -> dict:
    out = {"config": dict(TINY["config"]), "traffic": dict(TINY["traffic"])}
    if "push_burst" in workload:
        out["traffic"]["push_sizes"] = [16, 64]
    return out


def checkout_with_pull(root):
    """A copy of portbench and BENCHMARK.json under `root` in which the pull
    cell is named like the push cell, with the same metrics. → root."""
    shutil.copytree(harness.PKG, root / "portbench", ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    bench = harness.load_benchmark()
    bench["workloads"].append({"name": PULL, "config": "relay-c3", "traffic": "pull_catchup", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(PULL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
