"""The traced slice: the port's attention and fc1 entry points wrapped in
``torch.profiler.record_function`` ranges, and the profiler's Chrome trace
reduced to what the per-layer metrics read.

A kernel is attributed by the call that launched it, never by its name: its
launch (the CUDA runtime or driver API call with the kernel's correlation
id) lies on some host thread at some time, and the first of these ranges
on that thread that holds it decides:

  * ``attn``: the port's attention entry points below the qkv projection
    (the token-major forward, the flash Function's backward, the
    head-major forward and the head-major Functions' backward);
  * ``fc1``: the fused fc1 + GELU entry point;
  * ``gemm``: a matmul aten op (``aten::mm``, ``addmm``, ``bmm``, ...);
  * ``glue``: anything else.
Device busy time is the union of kernels, copies and sets in the slice; an
idle gap is named by the innermost host event, on any thread, that holds
its middle.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import heapq
import importlib
import json
import re
import time
from typing import Dict

ATTN, FC1 = "portbench.attn", "portbench.fc1"
SLICE = "portbench.slice"
# (module, attribute path) of each wrapped entry point; a traced run stops
# with an error where the program lacks one, so that work it reroutes is
# never counted as glue unseen
ENTRIES = {
    ATTN: [("jepa_tpu_torch.ops.flash_attention", "flash_self_attention_cuda"),
           ("jepa_tpu_torch.ops.flash_attention", "FlashSelfAttentionFn.backward"),
           ("jepa_tpu_torch.ops.flash_attention", "flash_fwd_hm_cuda"),
           ("jepa_tpu_torch.ops.flash_attention", "FlashAttentionHmFn.backward"),
           ("jepa_tpu_torch.ops.flash_attention", "FlashAttentionPackedFn.backward")],
    FC1: [("jepa_tpu_torch.ops.fused_mlp", "linear_gelu")],
}
GEMM_OPS = {"aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm", "aten::matmul",
            "aten::_addmm_activation", "aten::linear", "aten::_scaled_mm"}
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}


def _wrap(fn, label):
    import torch

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)

    return wrapped


@contextlib.contextmanager
def entry_ranges():
    """The entry points of ``ENTRIES`` wrapped while the context is open."""
    undo = []
    try:
        for label, entries in ENTRIES.items():
            for mod_name, path in entries:
                owner = importlib.import_module(mod_name)
                *outer, attr = path.split(".")
                for part in outer:
                    owner = getattr(owner, part, None)
                if owner is None or attr not in vars(owner):
                    raise RuntimeError(f"{mod_name}.{path}, an entry point that {label} "
                                       "counts, is not in the program")
                raw = vars(owner)[attr]
                if isinstance(raw, staticmethod):
                    setattr(owner, attr, staticmethod(_wrap(raw.__func__, label)))
                else:
                    setattr(owner, attr, _wrap(raw, label))
                undo.append((owner, attr, raw))
        yield
    finally:
        for owner, attr, raw in reversed(undo):
            setattr(owner, attr, raw)


class _Intervals:
    """Union of [start, end) intervals, for containment tests."""

    def __init__(self, spans):
        merged = []
        for s, e in sorted(spans):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.starts = [m[0] for m in merged]
        self.spans = merged

    def holds(self, t: float) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t < self.spans[i][1]


def _innermost(host, points):
    """For each of ``points``, the name of the shortest host event that holds
    it: a sweep over the events sorted by start, with the started ones in a
    heap by duration (an event that ended before a point ended before every
    later one)."""
    order = sorted(range(len(points)), key=points.__getitem__)
    events = sorted(host)
    out, active, i = [None] * len(points), [], 0
    for j in order:
        t = points[j]
        while i < len(events) and events[i][0] <= t:
            s0, s1, name = events[i]
            heapq.heappush(active, (s1 - s0, s1, name))
            i += 1
        while active and active[0][1] <= t:
            heapq.heappop(active)
        out[j] = active[0][2] if active else "host (no op traced)"
    return out


@functools.lru_cache(maxsize=4096)
def short_name(name: str) -> str:
    """A kernel's name without its parameter list and return type."""
    name = re.sub(r"^void\s+", "", name)
    depth, out = 0, []
    for ch in name:  # cut at the '(' of the parameter list, outside template brackets
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth <= 0:
            break
        out.append(ch)
    return "".join(out)[:160]


def reduce(trace: dict) -> Dict:
    """What the metrics read from one traced slice (times in ms)."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    slices = [e for e in events if e.get("name") == SLICE]
    if not slices:
        raise RuntimeError(f"the trace has no {SLICE} range")
    sl = slices[0]
    w0, w1 = float(sl["ts"]), float(sl["ts"]) + float(sl["dur"])
    ranges: Dict[str, Dict] = {ATTN: {}, FC1: {}, "gemm": {}}
    launches = {}
    host = []
    for e in events:
        cat, name = e.get("cat", ""), e.get("name", "")
        key = (e.get("pid"), e.get("tid"))
        span = (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
        if cat in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = (key, span[0])
        if cat == "user_annotation" and name in (ATTN, FC1):
            ranges[name].setdefault(key, []).append(span)
        elif cat == "cpu_op" and name in GEMM_OPS:
            ranges["gemm"].setdefault(key, []).append(span)
        if cat in ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
                   "python_function") and name != SLICE:
            host.append((span[0], span[1], name))
    spans = {c: {k: _Intervals(v) for k, v in by.items()} for c, by in ranges.items()}

    ms = {ATTN: 0.0, FC1: 0.0, "gemm": 0.0, "glue": 0.0}
    by_name: Dict[str, float] = {}
    busy, unattributed = [], 0
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s, d = float(e["ts"]), float(e.get("dur", 0))
        lo, hi = max(s, w0), min(s + d, w1)
        if hi <= lo:
            continue
        busy.append((lo, hi))
        if e.get("cat") != "kernel":
            name = short_name(e.get("name", ""))
            by_name[name] = by_name.get(name, 0.0) + (hi - lo)
            continue
        launch = launches.get((e.get("args") or {}).get("correlation"))
        cat = "glue"
        if launch is None:
            unattributed += 1
        else:
            key, t = launch
            for c in (ATTN, FC1, "gemm"):
                iv = spans[c].get(key)
                if iv is not None and iv.holds(t):
                    cat = c
                    break
        ms[cat] += (hi - lo) / 1e3
        name = short_name(e.get("name", "")) or f"({cat} kernel, unnamed)"
        by_name[name] = by_name.get(name, 0.0) + (hi - lo)
    union = _Intervals(busy).spans
    busy_ms = sum(e - s for s, e in union) / 1e3
    gaps, prev = [], w0
    for s, e in union + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    idle: Dict[str, float] = {}
    for (g0, g1), name in zip(gaps, _innermost(host, [0.5 * (a + b) for a, b in gaps])):
        idle[name] = idle.get(name, 0.0) + (g1 - g0)
    top = lambda d: [[k, v / 1e6] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"window_ms": (w1 - w0) / 1e3, "busy_ms": busy_ms, "kernel_ms": ms,
            "unattributed_kernels": unattributed, "device_ops": top(by_name),
            "idle_gaps": top(idle)}


def load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def profile_slice(run, torch, tmpdir: str):
    """``run()`` under the profiler with the entry points wrapped, between a
    synchronisation and another inside the slice range; returns (run's
    result, the reduced trace)."""
    import os

    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with entry_ranges():
        with profile(activities=acts) as prof:
            with record_function(SLICE):
                torch.cuda.synchronize() if torch.cuda.is_available() else None
                out = run()
                torch.cuda.synchronize() if torch.cuda.is_available() else None
            t_run = time.perf_counter()
    t0 = time.perf_counter()
    path = os.path.join(tmpdir, "slice_trace.json")
    prof.export_chrome_trace(path)
    t1 = time.perf_counter()
    try:
        reduced = reduce(load(path))
    finally:
        size = os.path.getsize(path)
        os.remove(path)
    reduced["processing_s"] = {"stop": t0 - t_run, "export": t1 - t0,
                               "reduce": time.perf_counter() - t1, "trace_mb": size / 1e6}
    return out, reduced
