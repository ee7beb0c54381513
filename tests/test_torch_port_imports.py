"""The port stands alone: no module of ``vdm4cdm_torch/`` and not
``chip_smoke.py`` imports jax, flax or the JAX package (checked on the
source, so a lazy import inside a function counts too)."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "vdm4cdm_tpu")


def _sources():
    files = sorted((ROOT / "vdm4cdm_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", None))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    assert path.exists(), path
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_catches_a_jax_import(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("def f():\n    from vdm4cdm_tpu.ops import conv\n"
                 "import importlib\nimportlib.import_module('jax.numpy')\n")
    assert {m.split(".")[0] for m in _imports(p)} == {
        "vdm4cdm_tpu", "importlib", "jax"}


def test_the_parallel_modules_are_scanned():
    """The sharded path (``vdm4cdm_torch/parallel/``) is held to the same
    rule, and so is the rank-function module its CPU tests spawn."""
    scanned = {str(p.relative_to(ROOT)) for p in _sources()}
    for name in ("__init__", "halo", "shard", "sampling", "launch"):
        assert f"vdm4cdm_torch/parallel/{name}.py" in scanned
    worker = ROOT / "tests" / "_torch_dist_worker.py"
    assert not [m for m in _imports(worker) if m.split(".")[0] in FORBIDDEN]


def test_the_chain_modules_are_scanned():
    """The trained-model chain, its bless tool and the profiling helpers
    stand alone too."""
    scanned = {str(p.relative_to(ROOT)) for p in _sources()}
    for path in ("vdm4cdm_torch/utils/profiling.py",
                 "vdm4cdm_torch/cli/bless.py",
                 "vdm4cdm_torch/cli/blessed_chain.py",
                 "vdm4cdm_torch/evals/acceptance.py"):
        assert path in scanned


def test_the_sharded_cli_modules_are_scanned():
    """The sharded CLI (its job, mesh and figure hook, the trainer's slab
    feed and rank-0 checkpoints, the sharded campaign) and the conv
    forward's sums fold stand alone too."""
    scanned = {str(p.relative_to(ROOT)) for p in _sources()}
    for path in ("vdm4cdm_torch/cli/_common.py", "vdm4cdm_torch/cli/train.py",
                 "vdm4cdm_torch/cli/generate.py",
                 "vdm4cdm_torch/train/loop.py",
                 "vdm4cdm_torch/train/checkpoint.py",
                 "vdm4cdm_torch/ops/kernels/conv3d.py", "chip_smoke.py"):
        assert path in scanned


def test_the_dry_run_and_example_modules_are_scanned():
    """The multi-rank dry run and the user examples stand alone too."""
    scanned = {str(p.relative_to(ROOT)) for p in _sources()}
    for path in ("vdm4cdm_torch/parallel/dryrun.py",
                 "vdm4cdm_torch/examples/__init__.py",
                 "vdm4cdm_torch/examples/smoke_test.py",
                 "vdm4cdm_torch/examples/ddnm_inpainting.py",
                 "vdm4cdm_torch/examples/check_cc.py",
                 "vdm4cdm_torch/examples/make_generation_jobs.py"):
        assert path in scanned
