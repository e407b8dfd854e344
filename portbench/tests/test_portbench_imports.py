"""What the harness loads: never jax, jaxlib, flax or the JAX package
(compared by whole top-level names: the port, jepa_tpu_torch, is allowed);
the references load none of these nor the port. Without a card a run fails
and prints no result."""

import ast
import os
import subprocess
import sys

import pytest

from portbench.tests.conftest import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "jepa_tpu"}
HARNESS = ["portbench.run", "portbench.kinds.pretrain", "portbench.kinds.serve_video",
           "portbench.trace", "portbench.control", "portbench.faults", "portbench.readers",
           "portbench.program"]
REFERENCE = ["portbench.reference.vjepa", "portbench.reference.train",
             "portbench.reference.numerics", "portbench.compare", "portbench.flops",
             "portbench.masks", "portbench.weights"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(p.relative_to(REPO) for p in
                                        (REPO / "portbench").rglob("*.py")
                                        if "tests" not in p.parts), ids=str)
def test_sources_import_nothing_forbidden(path):
    names = set(_imports(REPO / path))
    assert not names & FORBIDDEN
    if path.parts[1] == "reference" or path.name in ("compare.py", "flops.py", "masks.py",
                                                      "weights.py"):
        assert "jepa_tpu_torch" not in names


def _loaded(modules):
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "print(sorted({k.split('.')[0] for k in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(REPO), env={**os.environ, "PYTHONPATH": str(REPO)}, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_the_port_and_nothing_forbidden():
    loaded = _loaded(HARNESS + ["jepa_tpu_torch.api", "jepa_tpu_torch.train.step"])
    assert "jepa_tpu_torch" in loaded and not loaded & FORBIDDEN


def test_references_load_neither_jax_nor_a_package():
    loaded = _loaded(REFERENCE)
    assert not loaded & (FORBIDDEN | {"jepa_tpu_torch"})


def test_run_without_a_card_fails_and_prints_nothing():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "vitl16.train",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], capture_output=True,
                         text=True, cwd=str(REPO), env={**os.environ, "PYTHONPATH": ""},
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_run_with_only_the_benchmark_files_fails(tmp_path):
    import shutil

    (tmp_path / "BENCHMARK.json").write_text((REPO / "BENCHMARK.json").read_text())
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "vitl16.serve",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], capture_output=True,
                         text=True, cwd=str(tmp_path), env={**os.environ, "PYTHONPATH": ""},
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
