"""Finds a cell's configuration, traffic, runner and metric readers by the
names in BENCHMARK.json, runs it once and assembles the result line.

Everything is found by name, so a later change adds files and edits none:

- `portbench/configs/<config>.json` (the `file` of the configuration):
  a deployment, with `kind` naming its runner, `portbench/cells/<kind>.py`;
- `portbench/traffic/<traffic>.json`: a mix's parameters, with
  `generator` naming the general generator that reads them;
- `portbench/metrics/<metric>.py`: a per-layer metric's reader, a
  `read(obs)` that returns a number or None when it finds nothing to read.

A runner's `run(ctx)` returns the run's readings: `attempted`, `failed`,
`e2e` (every end-to-end metric it measures), `obs` (what the readers
read), `memory_peak_bytes` and `checks`, each number compared as (value,
limit). The run is correct when no value is above its limit.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Optional

PKG = Path(__file__).resolve().parent
REPO = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "evolu_tpu")


class NoCard(RuntimeError):
    """The machine has fewer CUDA cards than the cell asks for."""


def require_cuda(chips: int) -> None:
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        raise NoCard(f"the cell needs {chips} CUDA card(s); this machine has {have}")


def load_benchmark(root: Path = REPO) -> dict:
    with open(root / "BENCHMARK.json", encoding="utf-8") as f:
        return json.load(f)


def find_cell(bench: dict, workload: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    raise KeyError(f"no workload named {workload!r} in BENCHMARK.json")


def load_config(bench: dict, name: str, root: Path = REPO) -> dict:
    entry = next(c for c in bench["configs"] if c["name"] == name)
    with open(root / entry["file"], encoding="utf-8") as f:
        return json.load(f)


def load_traffic(name: str, root: Path = REPO) -> dict:
    with open(root / "portbench" / "traffic" / f"{name}.json", encoding="utf-8") as f:
        return json.load(f)


def runner(kind: str):
    return importlib.import_module(f"portbench.cells.{kind}")


def metric_reader(name: str, root: Path = REPO):
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metrics_of(bench: dict, workload: str, trace: bool):
    """The metrics a run of `workload` reports: its end-to-end metrics, or
    with `trace` its per-layer ones (an entry without `workloads` applies
    to every cell that reports the end-to-end metric it moves)."""
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in names)]


def forbidden_modules() -> list:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def run_workload(workload: str, seed: int, seconds: float, trace: bool, *, t_start: float,
                 device: str = "cuda", overrides: Optional[dict] = None, fault: Optional[str] = None,
                 root: Path = REPO) -> dict:
    """One run of one cell. `overrides` replaces keys of the configuration
    and of the mix (tests shrink a cell with it). → the result object, with
    `checks` last."""
    bench = load_benchmark(root)
    cell = find_cell(bench, workload)
    config = {**load_config(bench, cell["config"], root), **(overrides or {}).get("config", {})}
    mix = {**load_traffic(cell["traffic"], root), **(overrides or {}).get("traffic", {})}
    ctx = {"cell": cell, "config": config, "mix": mix, "seed": int(seed), "seconds": float(seconds),
           "trace": bool(trace), "device": device, "fault": fault, "t_start": t_start}
    got = runner(config["kind"]).run(ctx)
    metrics = {}
    for m in metrics_of(bench, workload, trace):
        value = got["e2e"].get(m["name"]) if not trace else metric_reader(m["name"], root)(got["obs"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = got["checks"]
    result = {"correct": all(v <= limit for v, limit in checks.values()),
              "attempted": got["attempted"], "failed": got["failed"], "metrics": metrics,
              "device": device_info(device, got, trace)}
    if trace and got["obs"].get("device"):
        result["breakdown"] = breakdown(got["obs"])
    result["checks"] = {k: {"value": v, "limit": limit} for k, (v, limit) in checks.items()}
    return result


def device_info(device: str, got: dict, trace: bool) -> dict:
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    import torch

    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
           "memory_peak_bytes": got["memory_peak_bytes"]}
    dev = got["obs"].get("device") if trace else None
    if dev:
        out["busy_s"] = dev["busy_s"] / max(1, out["count"])
        out["window_s"] = dev["window_s"]
    return out


def breakdown(obs: dict) -> dict:
    """The device operations that took most time, and the longest idle
    gaps named by the host span that covered each gap's middle."""
    dev = obs["device"]
    spans = obs.get("spans") or []
    batches = [(s.t_start, s.t_start + s.duration_ms / 1e3) for s in spans if s.name == "engine.batch"]
    fronts = [(s.t_start, s.t_start + s.duration_ms / 1e3) for s in spans if s.name == "relay.sync"]

    def named(a, b):
        if a is None:
            return "unaligned"
        mid = (a + b) / 2
        if any(s <= mid <= e for s, e in batches):
            return "engine.batch host"
        if any(s <= mid <= e for s, e in fronts):
            return "relay.sync front"
        return "no request"

    gaps: dict = {}
    for length, a, b in dev["gaps"]:
        name = named(a, b)
        gaps[name] = gaps.get(name, 0.0) + length
    return {"device_ops": [[n, s] for n, s in dev["ops"]],
            "idle_gaps": sorted(([n, s] for n, s in gaps.items()), key=lambda x: -x[1])[:10]}
