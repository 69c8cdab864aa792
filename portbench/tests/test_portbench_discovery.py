"""A configuration, a traffic mix and a per-layer metric are added by
adding files: the harness finds each by the name in BENCHMARK.json, with
no edit to a file it already has."""

import json
import shutil
import time

from _tiny import tiny
from portbench import harness


def _tree_with_new_files(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.PKG, root / "portbench", ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    bench = harness.load_benchmark()
    before = {p.relative_to(root): p.read_bytes() for p in (root / "portbench").rglob("*") if p.is_file()}
    config = json.loads((root / "portbench/configs/relay-c3.json").read_text())
    config.update(name="relay-c3-wide", devices_per_owner=6)
    (root / "portbench/configs/relay-c3-wide.json").write_text(json.dumps(config))
    mix = dict(harness.load_traffic("pull_catchup"), push_share=0.5, pull_missing=[1, 8])
    (root / "portbench/traffic/half_push.json").write_text(json.dumps(mix))
    (root / "portbench/metrics/served_share.sync.py").write_text(
        "def read(obs):\n    t = obs.get('traffic', {})\n    return 100.0 * t['requests'] / max(1, t['requests'])\n")
    bench["configs"].append({"name": "relay-c3-wide", "source": "test", "file": "portbench/configs/relay-c3-wide.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "relay-c3-wide.half_push", "config": "relay-c3-wide",
                               "traffic": "half_push", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("relay-c3-wide.half_push")
    bench["per_layer"].append({"name": "served_share.sync", "unit": "%", "better": "higher",
                               "source": "host_clock", "layer": "relay front", "moves": "sync_msgs_s",
                               "workloads": ["relay-c3-wide.half_push"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root, before


def test_new_files_are_found_by_name_and_no_file_changes(tmp_path):
    root, before = _tree_with_new_files(tmp_path)
    bench = harness.load_benchmark(root)
    assert harness.load_config(bench, "relay-c3-wide", root)["devices_per_owner"] == 6
    assert harness.load_traffic("half_push", root)["push_share"] == 0.5
    assert harness.metric_reader("served_share.sync", root)({"traffic": {"requests": 3}}) == 100.0
    names = [m["name"] for m in harness.metrics_of(bench, "relay-c3-wide.half_push", True)]
    assert names == ["served_share.sync"]
    after = {p.relative_to(root): p.read_bytes() for p in (root / "portbench").rglob("*") if p.is_file()}
    assert {k: v for k, v in after.items() if k in before} == before


def test_a_cell_made_of_new_files_runs(tmp_path):
    root, _ = _tree_with_new_files(tmp_path)
    over = tiny("half_push")
    r = harness.run_workload("relay-c3-wide.half_push", 2**31 + 5, 1.5, True, t_start=time.perf_counter(),
                             device="cpu", overrides=over, root=root)
    assert r["correct"], r["checks"]
    assert r["metrics"]["served_share.sync"]["value"] == 100.0
