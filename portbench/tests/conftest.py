"""Fixtures of the benchmark's own tests: a benchmark root whose cells run
the tiny configurations of this folder on the CPU, through the real
harness, traffic, metrics and reference."""

import json
import os
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
REPO = HERE.parent.parent
TINY = ("tiny", "tiny32")
SERVE_METRICS = [("end_to_end", "serve_clips_per_s", "clips/s"), ("end_to_end", "serve_p90_ms", "ms"),
                 ("per_layer", "mfu.serve", "%"), ("per_layer", "glue_ms_per_clip.serve", "ms/clip"),
                 ("per_layer", "attn_roofline.serve", "%"), ("per_layer", "mlp_roofline.serve", "%"),
                 ("per_layer", "device_idle_pct.serve", "%"), ("per_layer", "peak_gib.serve", "GiB")]


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """Skips the test where no CUDA card is present."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the H100 (python3 -m pytest -m card "
                    "portbench/tests)")


def tiny_bench() -> dict:
    """BENCHMARK.json with its cells replaced by the tiny configurations'."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": n, "source": "tests", "file": f"portbench/tests/{n}.json",
                         "reduced": [], "why": "CPU tests"} for n in TINY]
    bench["workloads"] = [{"name": f"{n}.{k}", "config": n, "traffic": t, "chips": 1,
                           "why": "CPU tests"}
                          for n in TINY for k, t in (("train", "pretrain_fixed"),
                                                     ("serve", "serve_video"))]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            kinds = {w.split(".", 1)[1] for w in m["workloads"]}
            m["workloads"] = [f"{n}.{k}" for n in TINY for k in sorted(kinds)]
    serve = [f"{n}.serve" for n in TINY]
    names = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}
    for group, name, unit in SERVE_METRICS:  # readers kept for the serving cells to come
        if name not in names:
            bench[group].append({"name": name, "unit": unit, "better": "higher",
                                 "source": "host_clock", "workloads": serve})
    return bench


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """A benchmark root (BENCHMARK.json + portbench/) for the tiny cells."""
    root = tmp_path_factory.mktemp("bench_root")
    (root / "BENCHMARK.json").write_text(json.dumps(tiny_bench()))
    os.symlink(REPO / "portbench", root / "portbench")
    return root


RUNNER = """
import sys
from pathlib import Path
from portbench import faults, run
kind, fault, root, *argv = sys.argv[1:]
if fault == "-":
    sys.exit(run.main(argv, device="cpu", root=Path(root)))
with faults.FAULTS[kind][fault]():
    sys.exit(run.main(argv, device="cpu", root=Path(root)))
"""


def run_cell(root, workload, seed=5, seconds=1.0, trace=0, fault=None, kind=None):
    """(exit code, result dict or None, stderr) of one harness run on the CPU,
    in a process of its own (the test process has JAX loaded, which the
    harness refuses), with ``fault`` (portbench.faults) planted."""
    import subprocess
    import sys

    env = {**os.environ, "PYTHONPATH": str(REPO)}
    cmd = [sys.executable, "-c", RUNNER, kind or "-", fault or "-", str(root),
           "--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
           "--trace", str(trace)]
    p = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=str(REPO), timeout=600)
    result = json.loads(p.stdout.strip().splitlines()[-1]) if p.stdout.strip() else None
    return p.returncode, result, p.stderr
