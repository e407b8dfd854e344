"""Whole runs of the harness on the CPU at test size (the tiny
configurations of this folder, the port on its plain versions): a sound
run is correct and reports its metrics; the fp32 port agrees with the
reference to rounding; each fault planted underneath a run makes it
incorrect; the control, the reference with fp8 products in the program's
place, fails a limit the program keeps."""

import json
from pathlib import Path

import pytest

from portbench.tests.conftest import HERE, run_cell, tiny_bench

BENCH = tiny_bench()


@pytest.mark.parametrize("workload", ["tiny.train", "tiny.serve"])
@pytest.mark.parametrize("trace", [0, 1])
def test_sound_run_is_correct_and_reports(tiny_root, workload, trace):
    rc, res, err = run_cell(tiny_root, workload, seed=2**31 + 7, trace=trace)
    assert rc == 0, err[-3000:]
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks" and res["checks"]
    limits = json.loads((HERE / "tiny.json").read_text())["limits"]
    kind = "pretrain" if workload.endswith("train") else "serve_video"
    assert list(res["checks"]) == list(limits[kind])
    for name, c in res["checks"].items():  # the last lines of stderr name each number
        assert f"{name} {c['value']!r} limit {c['limit']!r} ok" in err
    group = BENCH["per_layer" if trace else "end_to_end"]
    names = {m["name"] for m in group}
    assert set(res["metrics"]) <= names
    if trace:
        assert {"device_ops", "idle_gaps"} <= set(res["breakdown"])
        assert res["device"]["window_s"] > 0
    else:
        assert "setup_s" in res["metrics"]
        assert any(k.endswith("clips_per_s") for k in res["metrics"])


@pytest.mark.parametrize("workload,bounds", [
    ("tiny32.train", {"loss_gap": 1e-5, "grad_gap": 1e-4, "grad_diff": 1e-3, "change_gap": 1e-3}),
    ("tiny32.serve", {"logp_gap": 1e-5})])
def test_fp32_port_agrees_with_the_reference(tiny_root, workload, bounds):
    rc, res, err = run_cell(tiny_root, workload, seed=9)
    assert rc == 0, err[-3000:]
    for name, bound in bounds.items():
        assert res["checks"][name]["value"] <= bound, (name, res["checks"][name])


@pytest.mark.parametrize("workload,kind,fault", [
    ("tiny.train", "pretrain", "unchanged_state"), ("tiny.train", "pretrain", "half_batch"),
    ("tiny.train", "pretrain", "clip_always"),
    ("tiny.serve", "serve_video", "altered_answer"), ("tiny.serve", "serve_video", "half_batch")])
def test_a_planted_fault_is_not_correct(tiny_root, workload, kind, fault):
    rc, res, err = run_cell(tiny_root, workload, seed=13, fault=fault, kind=kind)
    assert rc == 0, err[-3000:]
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("workload", ["tiny.train", "tiny.serve"])
def test_the_control_fails_where_the_program_holds(tiny_root, workload):
    from portbench import compare, control

    limits = json.loads((HERE / "tiny.json").read_text())["limits"]
    for seed in (21, 22):
        run, kind = control.build(Path(tiny_root), workload, seed, "cpu", seconds=1.0)
        program = control.readings(run, kind, "program")
        ctl = control.readings(run, kind, "control")
        assert compare.judge(program, limits[kind])[1], program
        assert not compare.judge(ctl, limits[kind])[1], ctl
