"""What the harness may load: no module of JAX or of the JAX package
anywhere, and nothing of the program in the traffic generators and the
plain references. Top-level names are compared whole: the program's
package name begins with the JAX package's."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

PKG = Path(harness.__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "evolu_tpu"}
YARDSTICK = ["gen", "reference", "peaks.py", "metrics"]


def _imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _files(*parts):
    for p in parts:
        p = PKG / p
        yield from ([p] if p.is_file() else sorted(p.rglob("*.py")))


def test_no_file_of_the_harness_imports_jax_or_the_jax_package():
    for f in _files("."):
        if "tests" in f.parts:
            continue
        assert not FORBIDDEN.intersection(_imports(f)), f


def test_generators_and_references_import_nothing_of_the_program():
    for f in _files(*YARDSTICK):
        assert "evolu_tpu_torch" not in set(_imports(f)), f


def test_loading_the_yardstick_loads_no_program_module():
    code = ("import sys; sys.path.insert(0, %r); import portbench.gen.load, portbench.gen.relay_sync, "
            "portbench.reference.relay, portbench.peaks; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'evolu_tpu_torch', 'evolu_tpu', 'jax', 'torch'}))"
            % str(PKG.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("loaded,bad", [(["evolu_tpu_torch.ops"], []), (["evolu_tpu.core"], ["evolu_tpu"]),
                                        (["jaxlib.xla_client"], ["jaxlib"]), (["flax"], ["flax"])])
def test_the_run_guard_compares_whole_top_level_names(monkeypatch, loaded, bad):
    for name in loaded:
        monkeypatch.setitem(sys.modules, name, object())
    assert harness.forbidden_modules() == bad
