"""The trace reduction: kernels attributed by the range their launch lies
in, busy time as the union of device operations, idle gaps named by what
the host ran; and the entry points wrapped only while the context is open."""

import pytest

from portbench import trace

MAIN, BWD = 10, 11  # host threads: the loop's and the autograd engine's


def ev(cat, name, ts, dur, tid=MAIN, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def kernel(name, ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 7,
            "args": {"correlation": corr}}


def synthetic():
    return {"traceEvents": [
        ev("user_annotation", trace.SLICE, 0, 1000),
        ev("cpu_op", "aten::mm", 10, 20),
        ev("cuda_runtime", "cudaLaunchKernel", 12, 2, corr=1),
        ev("user_annotation", trace.ATTN, 40, 30),
        ev("cuda_runtime", "cudaLaunchKernel", 45, 2, corr=2),
        ev("cpu_op", "aten::mul", 80, 10),
        ev("cuda_runtime", "cudaLaunchKernel", 82, 2, corr=3),
        ev("user_annotation", trace.ATTN, 100, 50, tid=BWD),  # a backward, on its own thread
        ev("cuda_runtime", "cuLaunchKernelEx", 110, 2, tid=BWD, corr=4),
        ev("user_annotation", trace.FC1, 200, 10),
        ev("cuda_runtime", "cudaLaunchKernel", 202, 2, corr=5),
        ev("cpu_op", "aten::item", 600, 380),
        kernel("void sm90_xmma_gemm_bf16(int)", 100, 100, 1),   # gemm
        kernel("void jt::flash_fwd<64>(Args)", 200, 200, 2),    # attn
        kernel("void at::elementwise<float>(x)", 400, 50, 3),   # glue
        kernel("void jt::flash_bwd<64, 2>(Args)", 450, 100, 4),  # attn (backward thread)
        kernel("void jt::linear_gelu(Args)", 550, 50, 5),       # fc1
        kernel("void unknown()", 1990, 20, 99),                 # outside the slice
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 950, "dur": 40, "pid": 0,
         "tid": 7},
    ]}


def test_attribution_by_launch():
    r = trace.reduce(synthetic())
    assert r["window_ms"] == pytest.approx(1.0)
    assert r["kernel_ms"] == pytest.approx({trace.ATTN: 0.3, trace.FC1: 0.05, "gemm": 0.1,
                                            "glue": 0.05})
    assert r["busy_ms"] == pytest.approx(0.54)  # 100-600 and 950-990
    assert r["unattributed_kernels"] == 0
    gaps = dict(r["idle_gaps"])
    assert gaps["aten::item"] == pytest.approx(350e-6)  # 600-950
    assert gaps[trace.ATTN] == pytest.approx(100e-6)  # 0-100: its middle in the range
    assert gaps["host (no op traced)"] == pytest.approx(10e-6)  # 990-1000
    names = dict(r["device_ops"])
    assert names["jt::flash_fwd<64>"] == pytest.approx(200e-6)


def test_short_names_keep_templates():
    assert trace.short_name("void a::b<c<1>, 2>(int, float)") == "a::b<c<1>, 2>"


def test_entry_ranges_wrap_and_restore():
    from jepa_tpu_torch.ops import flash_attention as fa
    from jepa_tpu_torch.ops import fused_mlp as fm

    fwd, bwd, fc1 = (fa.flash_self_attention_cuda, vars(fa.FlashSelfAttentionFn)["backward"],
                     fm.linear_gelu)
    with trace.entry_ranges():
        assert fa.flash_self_attention_cuda is not fwd and fm.linear_gelu is not fc1
        assert vars(fa.FlashSelfAttentionFn)["backward"] is not bwd
        assert fa.flash_self_attention_cuda.__wrapped__ is fwd
    assert fa.flash_self_attention_cuda is fwd and fm.linear_gelu is fc1
    assert vars(fa.FlashSelfAttentionFn)["backward"] is bwd


def test_wrapped_entries_keep_results():
    import torch

    from jepa_tpu_torch.ops import fused_mlp as fm

    x, w, b = torch.randn(8, 128), torch.randn(256, 128), torch.randn(256)
    want = fm.linear_gelu(x, w, b)
    with trace.entry_ranges():
        got = fm.linear_gelu(x, w, b)
    assert torch.equal(got, want)


def test_a_missing_entry_point_stops_the_trace(monkeypatch):
    from jepa_tpu_torch.ops import flash_attention as fa

    fwd = fa.flash_self_attention_cuda
    entries = {**trace.ENTRIES,
               trace.ATTN: trace.ENTRIES[trace.ATTN] + [(fa.__name__, "renamed_attention")]}
    monkeypatch.setattr(trace, "ENTRIES", entries)
    with pytest.raises(RuntimeError, match="renamed_attention"):
        with trace.entry_ranges():
            pass
    assert fa.flash_self_attention_cuda is fwd  # what was wrapped is restored


def test_a_listed_metric_that_reads_nothing_is_named():
    """Attention's work moved off its entry points leaves its roofline with
    nothing to read: the harness names it (and fails the run on the card)."""
    from portbench import run
    from portbench.tests.conftest import REPO, tiny_bench

    bench = tiny_bench()
    cell = next(w for w in bench["workloads"] if w["name"] == "tiny.train")
    reduced = trace.reduce(synthetic())
    meas = {"kind": "pretrain", "peak_window_bytes": 2**30,
            "window": {"kind": "pretrain", "items": 8, "window_s": 1.0, "flops": 1e12},
            "slice": {"units": 1, "items": 4, "attn_bound_ms": 0.1, "fc1_bound_ms": None,
                      "trace": reduced}}
    metrics, missing = run.read_metrics(REPO, bench, cell, meas, traced=True)
    assert missing == [] and "attn_roofline.train" in metrics
    reduced["kernel_ms"] = {**reduced["kernel_ms"], trace.ATTN: 0.0}
    metrics, missing = run.read_metrics(REPO, bench, cell, meas, traced=True)
    assert missing == ["attn_roofline.train"] and "glue_ms_per_clip.train" in metrics
