"""The PyTorch port imports torch and numpy only: no JAX, no jepa_tpu."""

import subprocess
import sys

_SCRIPT = """
import importlib, pkgutil, sys
import jepa_tpu_torch
names = [m.name for m in pkgutil.walk_packages(jepa_tpu_torch.__path__, "jepa_tpu_torch.")]
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
    assert n_modules >= 15, res.stdout
