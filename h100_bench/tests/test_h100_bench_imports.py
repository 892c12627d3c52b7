"""Nothing the benchmark runs imports JAX or the JAX package, and the reference
imports nothing of the port. Modules are compared by their whole top-level
name: the port's name begins with the JAX package's."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "diffusion_model_project_tpu"}
PORT = "diffusion_model_project_tpu_torch"


def imported(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_in_the_harness(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_the_reference_takes_nothing_of_the_port(path):
    assert PORT not in imported(path) and not imported(path) & FORBIDDEN
    assert "h100_bench" not in imported(path)


def test_only_port_py_imports_the_port():
    users = {p.name for p in SOURCES if PORT in imported(p)}
    assert users == {"port.py"}


def test_a_run_s_process_loads_no_jax():
    code = ("import sys, importlib, pkgutil, h100_bench, h100_bench.entries\n"
            "for m in ['run', 'calibrate', 'sweep', 'readers', 'port']:\n"
            "    importlib.import_module('h100_bench.' + m)\n"
            "for m in pkgutil.iter_modules(h100_bench.entries.__path__):\n"
            "    importlib.import_module('h100_bench.entries.' + m.name)\n"
            "from h100_bench import port, weights\n"
            "from h100_bench.tests import tiny\n"
            "import torch\n"
            "port.predictor(tiny.ldm(), weights.make(tiny.ldm(), 1, 'cpu'), torch.device('cpu'))\n"
            "port.stage1(tiny.vae(), weights.make(tiny.vae(), 1, 'cpu'), torch.device('cpu'))\n"
            "import h100_bench.run as r\n"
            "print(sorted({n.split('.')[0] for n in sys.modules} & set(%r)))\n" % sorted(FORBIDDEN))
    out = subprocess.run([sys.executable, "-c", code], cwd=HERE.parent, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
