"""BENCHMARK.json against the benchmark's contract: every cell resolves to
its configuration, traffic and metric files by name, and every name, unit
and field keeps to the allowed characters and sizes."""

import importlib
import json
import re

import pytest

from portbench import run
from portbench.tests.conftest import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) for p in BENCH["paths"])
    assert all(".." not in p.split("/") and not p.startswith("/") for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(1 <= len(w) <= 200 and "\t" not in w for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_allowed(group):
    names = [e["name"] for e in BENCH[group]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names), names


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"].startswith("portbench/") and c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        width = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|proj|head|ratio|expert")
        assert not any(width.search(k) for k in c["reduced"])
        for k in c["reduced"]:  # a reduced key is in the file, as run
            assert k in cfg
        for field in ("source", "why"):
            assert 1 <= len(c[field]) <= 200 and "\n" not in c[field] and "\t" not in c[field]


def test_workloads_resolve():
    assert 1 <= len(BENCH["workloads"]) <= 24
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        bench, cell, config, traffic = run.load_cell(REPO, w["name"])
        importlib.import_module(f"portbench.kinds.{traffic['kind']}").Cell
        assert set(config["limits"][traffic["kind"]])  # the numbers compared, with limits
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_metrics_resolve_and_report_where_listed():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert "setup_s" in e2e and 1 <= len(BENCH["end_to_end"]) <= 16
    assert 1 <= len(BENCH["per_layer"]) <= 128
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25 and m["bound"] >= 0.01
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
        for w in m.get("workloads", []):  # each cell listed reports what it moves
            mv = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
            assert w in mv.get("workloads", cells)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= cells
        assert callable(run.reader(REPO, m["name"]))
    for w in cells:  # setup_s, another end-to-end metric and a per-layer one
        assert len(run.cell_metrics(BENCH, {"name": w}, False)) >= 2
        assert len(run.cell_metrics(BENCH, {"name": w}, True)) >= 1


def test_layers_are_perf_md_layers():
    """Each per-layer metric names its layer as PERF.md's list of layers does."""
    perf = (REPO / "PERF.md").read_text()
    for m in BENCH["per_layer"]:
        assert f"| {m['layer']} |" in perf, m["layer"]


def test_files_under_paths_are_named_from_name_characters():
    for p in (REPO / "portbench").rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        assert PATH.match(str(p.relative_to(REPO))), p
