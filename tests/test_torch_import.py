"""The PyTorch port imports torch and numpy only (and PIL inside the image
loader, psutil inside the resource monitor, the native decoder through
ctypes, libzstd through ctypes): no JAX, no jepa_tpu, and none of orbax,
tensorstore, zarr or zstandard (orbax checkpoints are read and written by
the port's own utils/ocdbt.py and utils/orbax.py).
That holds for the package and for chip_smoke.py, including imports made
inside functions."""

import ast
import pathlib
import subprocess
import sys

_REPO = pathlib.Path(__file__).resolve().parent.parent
_BANNED = ("jax", "jaxlib", "jepa_tpu", "orbax", "tensorstore", "zarr", "zstandard")

_SCRIPT = """
import importlib, pkgutil, sys
import jepa_tpu_torch
names = [m.name for m in pkgutil.walk_packages(jepa_tpu_torch.__path__, "jepa_tpu_torch.")]
for need in ("train.step", "train.optimizer", "train.losses", "masks.multiblock3d",
             "models.predictor", "utils.schedulers", "masks.padding", "data.loader",
             "data.video_dataset", "data.manager", "data.synthetic", "data.transforms",
             "utils.logging", "utils.checkpoint", "configs", "apps.scaffold", "apps.main",
             "apps.vjepa.train", "data.randaugment", "data.image_dataset", "evals.aggregation",
             "evals.video_classification_frozen", "evals.image_classification_frozen",
             "evals.scaffold", "evals.main", "native", "native.build", "native.videodec",
             "utils.monitoring", "models.pos_embed", "models.vit", "utils.zstd",
             "utils.ocdbt", "utils.orbax", "utils.port_cli"):
    assert "jepa_tpu_torch." + need in names, need
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_no_jax():
    script = _SCRIPT.replace("BANNED", repr(_BANNED))
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    n_modules = int(res.stdout.split()[0])
    assert n_modules >= 51, res.stdout  # serving, the training step, the app, the evals, the decoder


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
                    if m.split(".")[0] in _BANNED]
    assert len(files) > 49 and not bad, bad
