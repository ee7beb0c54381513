"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program. Module names are compared by their
top-level name (the part before the first dot) as a whole: the port's name
begins with the JAX package's."""

import ast
import pathlib
import subprocess
import sys

import pytest

HERE = pathlib.Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "vdm4cdm_tpu"}
SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_source_imports_jax(path):
    found = set(_imports(path))
    assert not found & FORBIDDEN
    if "reference" in path.parts:
        assert "vdm4cdm_torch" not in found
        assert found <= {"__future__", "contextlib", "dataclasses", "math",
                         "typing", "torch"}


def test_a_run_loads_no_jax():
    """Imports everything a run imports, the port with it, and reads the
    interpreter's modules."""
    code = (
        "import sys, importlib, pathlib\n"
        "from portbench import run, harness, timeline, flops\n"
        "from portbench.kinds import train, sample\n"
        "import vdm4cdm_torch, vdm4cdm_torch.ops.kernels\n"
        "for p in pathlib.Path('portbench/metrics').glob('*.py'):\n"
        "    run.load_metric(p.stem)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & FORBIDDEN
    from portbench import run

    assert run.jax_modules() == sorted(
        {m.split(".")[0] for m in sys.modules} & FORBIDDEN)
