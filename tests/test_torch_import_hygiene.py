"""`evolu_tpu_torch` imports neither jax, `evolu_tpu` nor `ml_dtypes`
(the card's machine has none of them), directly or transitively, and
importing it does not initialize CUDA."""

import json
import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib, json, pkgutil, sys
import evolu_tpu_torch

names = sorted(
    {"evolu_tpu_torch"}
    | {m.name for m in pkgutil.walk_packages(evolu_tpu_torch.__path__, "evolu_tpu_torch.")}
)
for name in names:
    importlib.import_module(name)
import torch
print("RESULT:" + json.dumps({
    "modules": names,
    "forbidden": sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "evolu_tpu", "ml_dtypes")),
    "cuda_initialized": torch.cuda.is_initialized(),
}))
"""


def test_port_imports_no_jax_and_touches_no_card():
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT], cwd=_REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": _REPO},
    )
    assert out.returncode == 0, out.stderr
    line = next(l for l in out.stdout.splitlines() if l.startswith("RESULT:"))
    result = json.loads(line[len("RESULT:"):])
    assert "evolu_tpu_torch.parallel.reconcile" in result["modules"]
    assert "evolu_tpu_torch.storage.apply" in result["modules"]
    assert "evolu_tpu_torch.ops.crdt_merge" in result["modules"]
    assert "evolu_tpu_torch.core.crdt_tensor" in result["modules"]
    assert "evolu_tpu_torch.runtime.worker" in result["modules"]
    assert "evolu_tpu_torch.ops.winner_cache" in result["modules"]
    assert "evolu_tpu_torch.server.relay" in result["modules"]
    assert "evolu_tpu_torch.server.engine" in result["modules"]
    assert result["forbidden"] == []
    assert result["cuda_initialized"] is False
