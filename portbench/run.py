"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell names a configuration (its file under portbench/configs/) and a
traffic mix (portbench/traffic/<name>.json, whose ``kind`` names the module
in portbench/kinds/); each metric is read by portbench/metrics/<name>.py.
A run: set-up (imports, the kernel library, the seed's weights and inputs,
warm-up of every shape the traffic uses); the window of ``--seconds``; with
``--trace 1`` a short profiled slice after it; then, the program freed, the
comparison with the fp32 reference that decides ``correct``. The last line
of standard output is one JSON object; the numbers compared, each beside
its limit, are the last lines of standard error and the line's last key.
Without a CUDA card (or with fewer than the cell asks for) it prints no
result and exits 2; on the card, where a metric that BENCHMARK.json lists
for the cell reads nothing (say, attention's kernels no longer launched
from the entry points that portbench/trace.py wraps), it exits 4.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "jepa_tpu")  # top-level module names
ROOT = Path(__file__).resolve().parent.parent


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def load_cell(root: Path, name: str):
    """(benchmark, cell, config, traffic) of a cell by name."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no cell {name!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "portbench" / "traffic" / f"{cell['traffic']}.json").read_text())
    return bench, cell, config, traffic


def reader(root: Path, metric: str):
    path = root / "portbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: dict, traced: bool):
    """The metrics a run of ``cell`` reports: end-to-end without the trace,
    per-layer with it, each where its ``workloads`` (if any) name the cell."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group if "workloads" not in m or cell["name"] in m["workloads"]]


def read_metrics(root: Path, bench: dict, cell: dict, meas: dict, traced: bool):
    """({name: {"value", "unit"}}, [names of the cell's metrics that read nothing])."""
    metrics, missing = {}, []
    for m in cell_metrics(bench, cell, traced):
        value = reader(root, m["name"])(meas)
        if value is None:
            missing.append(m["name"])
        else:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return metrics, missing


def forbidden_modules():
    return sorted({k.split(".")[0] for k in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as err:
        return f"nvidia-smi: {err}"


def main(argv=None, device: str = None, root: Path = ROOT) -> int:
    """``device`` None takes the card (and insists on one); tests pass "cpu"
    to drive the rest of a run on the port's plain versions."""
    args = parse(argv)
    bench, cell, config, traffic = load_cell(Path(root), args.workload)
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            log(f"needs {cell['chips']} CUDA device(s); torch.cuda.is_available() "
                f"{torch.cuda.is_available()}, device_count {torch.cuda.device_count()}")
            return 2
        device = "cuda"
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    ctx = types.SimpleNamespace(cfg=config, traffic=traffic, seed=args.seed, device=dev,
                                sync=(torch.cuda.synchronize if cuda else (lambda: None)))
    kind = importlib.import_module(f"portbench.kinds.{traffic['kind']}")
    run = kind.Cell(ctx)
    parts = {}
    run.setup(parts)
    ctx.sync()
    setup_s = time.perf_counter() - T_START
    parts["other_s"] = setup_s - sum(parts.values())
    log(f"set-up {setup_s:.3f} s: " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()))

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    win = run.window(args.seconds)
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    meas = {"cell": cell["name"], "kind": traffic["kind"], "setup_s": setup_s, "window": win,
            "peak_window_bytes": memory_peak}
    log(f"window: {win['units']} {'updates' if win['kind'] == 'pretrain' else 'requests'}, "
        f"{win['items']} clips in {win['window_s']:.3f} s")
    breakdown = None
    if args.trace:
        with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as tmp:
            from portbench import trace

            units, reduced = trace.profile_slice(
                lambda: run.run_units(int(traffic["profile_units"])), torch, tmp)
        meas["slice"] = {**units, "trace": reduced}
        log(f"traced slice: {units['units']} units, {reduced['window_ms']:.3f} ms, device busy "
            f"{reduced['busy_ms']:.3f} ms, kernel ms by caller {reduced['kernel_ms']}, "
            f"{reduced['unattributed_kernels']} kernels without a traced launch; "
            f"trace processing {reduced['processing_s']}")
        breakdown = {"device_ops": reduced["device_ops"], "idle_gaps": reduced["idle_gaps"]}
    if cuda:
        log(f"card after the window: {card_line()}")  # off the set-up's clock

    metrics, missing = read_metrics(Path(root), bench, cell, meas, bool(args.trace))
    if missing and cuda:  # on the CPU the port launches none of its kernels
        log(f"metrics that BENCHMARK.json lists for {cell['name']} read nothing: {missing}; "
            "kernel ms by caller " + str(meas.get("slice", {}).get("trace", {}).get("kernel_ms")))
        return 4

    run.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers = run.check()
    from portbench import compare

    limits = config["limits"][traffic["kind"]]
    rows, ok = compare.judge(numbers, limits)
    log(f"check against the fp32 reference {time.perf_counter() - t0:.3f} s; "
        f"{numbers.get('_where', '')}")
    failed = int(win["failed"])
    correct = bool(ok and failed == 0)
    result = {"correct": correct, "attempted": int(win["units"]), "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else dev.type,
                         "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                         "count": int(cell["chips"]), "memory_peak_bytes": int(memory_peak)}}
    if args.trace:
        result["device"]["busy_s"] = meas["slice"]["trace"]["busy_ms"] / 1e3
        result["device"]["window_s"] = meas["slice"]["trace"]["window_ms"] / 1e3
        result["breakdown"] = breakdown
    found = forbidden_modules()
    if found:
        log(f"modules loaded that the port must not load: {found}")
        return 3
    finite = lambda v: v if v == v and abs(v) != float("inf") else repr(v)  # strict JSON
    result["checks"] = {name: {"value": finite(value), "limit": limit}
                        for name, value, limit in rows}
    for name, value, limit in rows:
        print(f"{name} {value!r} limit {limit!r} {'ok' if value <= limit else 'FAILED'}",
              file=sys.stderr, flush=True)
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
