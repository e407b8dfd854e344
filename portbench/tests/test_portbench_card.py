"""On the card (skipped without one): each cell of BENCHMARK.json runs a
short window through the harness and comes out correct.

    python3 -m pytest -q -m card portbench/tests/test_portbench_card.py
"""

import json
import subprocess
import sys

import pytest

from portbench.tests.conftest import REPO

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct_on_the_card(card, workload):
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", workload,
                          "--seed", "2147483659", "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, cwd=str(REPO), timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu", res
