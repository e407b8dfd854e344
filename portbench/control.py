"""Readings that set a cell's limits: the program's numbers over many seeds
(the lower readings), the control's (the fp32 reference computed with fp8
products, put in the program's place) and, for pretraining, the program's
with a fault planted (the upper readings). One process serves every seed.

    python3 -m portbench.control --workload vitl16.train --seeds 1-12 \
        --control-seeds 1-3 --fault-seeds 1-3 --out readings.jsonl

Pretraining needs no window: the numbers come from the updates set-up
follows. Serving runs a window of ``--seconds`` (long enough to serve every
pool entry once) before its check. Each reading is one JSON line in
``--out`` and on standard output.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import sys
import time
import types
from pathlib import Path

import torch

from portbench import faults
from portbench.kinds.pretrain import to_host
from portbench.reference.numerics import Numerics
from portbench.run import ROOT, load_cell


def seeds(text: str):
    out = []
    for part in filter(None, text.split(",")):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def build(root, name, seed, device, seconds, fault=None):
    """A cell set up (and, for serving, run for ``seconds``) at ``seed``."""
    _, cell, config, traffic = load_cell(root, name)
    dev = torch.device(device)
    ctx = types.SimpleNamespace(cfg=config, traffic=traffic, seed=seed, device=dev,
                                sync=torch.cuda.synchronize if dev.type == "cuda" else lambda: None)
    run = importlib.import_module(f"portbench.kinds.{traffic['kind']}").Cell(ctx)
    plant = faults.FAULTS[traffic["kind"]][fault] if fault else None
    with (plant() if plant else _nothing()):
        run.setup({})
        if traffic["kind"] == "serve_video":
            run.window(seconds)
    run.release()
    free()
    return run, traffic["kind"]


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def readings(run, kind, which):
    """{number: value} of the program (``which`` 'program'), or of the
    control in its place ('control'), against the fp32 reference."""
    if kind == "pretrain":
        ref = run.reference_numbers(Numerics("fp32"))
        if which == "control":  # the fp32 side's leaves wait on the host meanwhile
            ref.update(grads=to_host(ref["grads"]), deltas=to_host(ref["deltas"]))
            free()
        got = run.followed if which == "program" else run.reference_numbers(Numerics("fp8"))
        out = run.numbers(got, ref)
    else:
        entries = run.checked_entries()
        ref = run.reference_probs(Numerics("fp32"), entries)
        if which == "program":
            answers = {i: run.answers[i] for i in entries}
        else:
            ctl = run.reference_probs(Numerics("fp8"), entries)
            answers = {i: [ctl[i].cpu().numpy()] for i in entries}
        from portbench import compare

        out = {"logp_gap": max(compare.serve_gap(answers[i], ref[i]) for i in entries)}
    free()
    return out


def main(argv=None, device="cuda", root: Path = ROOT) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--faults", default=None, help="comma-separated; default: every fault "
                    "of the traffic's kind")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    out = open(a.out, "a") if a.out else None
    plan = [(s, "program", None) for s in seeds(a.seeds)]
    plan += [(s, "control", None) for s in seeds(a.control_seeds)]
    _, _, _, traffic = load_cell(root, a.workload)
    for f in (a.faults.split(",") if a.faults else faults.FAULTS[traffic["kind"]]):
        plan += [(s, "fault", f) for s in seeds(a.fault_seeds)]
    for seed, which, fault in plan:
        t0 = time.perf_counter()
        run, kind = build(root, a.workload, seed, device, a.seconds, fault)
        nums = readings(run, kind, "control" if which == "control" else "program")
        del run
        free()
        line = {"workload": a.workload, "seed": seed, "which": which, "fault": fault,
                "seconds": round(time.perf_counter() - t0, 3),
                **{k: v for k, v in nums.items()}}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
