"""The PyTorch port imports torch and numpy only: no JAX, no jepa_tpu.
That holds for the package and for chip_smoke.py, including imports made
inside functions."""

import ast
import pathlib
import subprocess
import sys

_REPO = pathlib.Path(__file__).resolve().parent.parent

_SCRIPT = """
import importlib, pkgutil, sys
import jepa_tpu_torch
names = [m.name for m in pkgutil.walk_packages(jepa_tpu_torch.__path__, "jepa_tpu_torch.")]
for need in ("train.step", "train.optimizer", "train.losses", "masks.multiblock3d",
             "models.predictor", "utils.schedulers"):
    assert "jepa_tpu_torch." + need in names, need
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "jepa_tpu" or m.startswith("jepa_tpu."))
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_no_jax():
    res = subprocess.run([sys.executable, "-c", _SCRIPT], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    n_modules = int(res.stdout.split()[0])
    assert n_modules >= 24, res.stdout  # serving and the training slice


def test_port_sources_import_no_jax():
    files = sorted((_REPO / "jepa_tpu_torch").rglob("*.py")) + [_REPO / "chip_smoke.py"]
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            bad += [f"{path.name}: {m}" for m in mods
                    if m.split(".")[0] in ("jax", "jaxlib", "jepa_tpu")]
    assert len(files) > 25 and not bad, bad
