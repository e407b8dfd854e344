#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (jepa_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. device: require CUDA, print the card's name and power limit, turn
     TF32 off;
  2. build the hand-written kernels from jepa_tpu_torch/csrc (nvcc);
  3. hold each kernel against its plain PyTorch version on the card at the
     shapes the serving path gives it, and time both;
  4. serve 4 requests through jepa_tpu_torch.api: a seeded ViT-L/16
     (224 px, 16 frames, tubelet 2, uniform_power) and a 400-class
     attentive probe, written as .pth.tar files and loaded back; each
     request classifies 2 uint8 clips. Checks the probabilities, that
     every encoder block launched each kernel once per request, and that
     the features and probabilities agree with the same model run through
     the plain versions on the card.
The line before the last is a JSON summary of the kernels; the last line
is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np

SEED = 0
DEPTH = 24  # vit_large
# tolerances of kernel vs plain version on the card (reasons in PERF.md)
H1_O_TOL = 2e-2    # |o| abs, unit-scale inputs: p rounds to bf16 against a
                   # running max in the kernel, the global max in the plain version
H1_LSE_TOL = 1e-2  # base-2 lse abs: the same p rounding moves log2(l) by <= ~2^-8/ln2
H3_REL = 2.0**-6   # |d| <= 2^-6 * max(|ref|, 1): z rounds to bf16 before the GELU,
                   # so a rare flip of that rounding (fp32 sums in another order)
                   # costs <= 1.13 ulp(z) on top of the output's own ulp
FEAT_COS_MIN = 0.999
PROB_TOL = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() by CUDA events over `iters` back-to-back runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device(torch):
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build():
    from jepa_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_library(verbose=True)
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc {_build.build_seconds} s)")


def phase_kernels(torch):
    """Each kernel vs its plain version at the serving shapes."""
    from jepa_tpu_torch.ops import flash_attention as fa
    from jepa_tpu_torch.ops import fused_mlp as fm

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(SEED)
    report = {}

    h1 = {"max_abs_err": 0.0}
    for b, n, h, c in ((2, 1568, 16, 64), (1, 4608, 16, 80), (2, 1570, 16, 64)):
        qkv = torch.randn((b, n, 3 * h * c), generator=gen, device=dev).to(torch.bfloat16)
        scale = c**-0.5
        o, lse = fa.flash_self_attention_cuda(qkv, h, scale)
        o_ref, lse_ref = fa.flash_self_attention_ref(qkv, h, scale)
        torch.cuda.synchronize()
        if not (torch.isfinite(o.float()).all() and torch.isfinite(lse).all()):
            raise RuntimeError(f"H1 B={b} N={n} c={c}: non-finite output")
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_l = (lse - lse_ref).abs().max().item()
        log(f"H1 B={b} N={n} H={h} c={c}: max|do| {err_o:.3e} (tol {H1_O_TOL}) "
            f"max|dlse| {err_l:.3e} (tol {H1_LSE_TOL})")
        if not (err_o <= H1_O_TOL and err_l <= H1_LSE_TOL):
            raise RuntimeError(f"H1 B={b} N={n} c={c} disagrees with its plain version")
        h1["max_abs_err"] = max(h1["max_abs_err"], err_o)
        if (b, n, c) == (2, 1568, 64):
            h1["ms"] = time_ms(torch, lambda: fa.flash_self_attention_cuda(qkv, h, scale))
            h1["plain_ms"] = time_ms(torch, lambda: fa.flash_self_attention_ref(qkv, h, scale))
            log(f"H1 ViT-L time: kernel {h1['ms']:.4f} ms, plain {h1['plain_ms']:.4f} ms")
    report["h1"] = h1

    h3 = {"max_abs_err": 0.0}
    k, f = 1024, 4096
    w = (torch.randn((f, k), generator=gen, device=dev) / 32).to(torch.bfloat16)
    bias = torch.randn((f,), generator=gen, device=dev) * 0.1
    for m in (2 * 1568, 1570):
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        y = fm.linear_gelu_cuda(x, w, bias)
        y_ref = fm.linear_gelu_ref(x, w, bias)
        torch.cuda.synchronize()
        if not torch.isfinite(y.float()).all():
            raise RuntimeError(f"H3 M={m}: non-finite output")
        d = (y.float() - y_ref.float()).abs()
        err = d.max().item()
        excess = (d - H3_REL * y_ref.float().abs().clamp(min=1)).max().item()
        differ = (d > 0).float().mean().item()
        log(f"H3 M={m} K={k} F={f}: max|d| {err:.3e}, worst margin {excess:.3e} "
            f"(tol |d| <= 2^-6*max(|ref|,1)), share of elements that differ {differ:.2e}")
        if excess > 0 or differ > 1e-2:  # differences must be rare rounding flips
            raise RuntimeError(f"H3 M={m} disagrees with its plain version")
        h3["max_abs_err"] = max(h3["max_abs_err"], err)
        if m == 2 * 1568:
            h3["ms"] = time_ms(torch, lambda: fm.linear_gelu_cuda(x, w, bias))
            h3["plain_ms"] = time_ms(torch, lambda: fm.linear_gelu_ref(x, w, bias))
            log(f"H3 ViT-L fc1 time: kernel {h3['ms']:.4f} ms, plain {h3['plain_ms']:.4f} ms")
    report["h3"] = h3
    return report


def plain_versions():
    """Context in which the kernel launchers run their plain versions
    (for comparison only; nothing is counted)."""
    from jepa_tpu_torch.ops import flash_attention as fa
    from jepa_tpu_torch.ops import fused_mlp as fm

    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(
        fa, "flash_self_attention_cuda", fa.flash_self_attention_ref))
    stack.enter_context(mock.patch.object(fm, "linear_gelu_cuda", fm.linear_gelu_ref))
    return stack


def phase_serve(torch, workdir: str):
    from jepa_tpu_torch import api
    from jepa_tpu_torch.models.attentive import AttentiveCfg, init_attentive_classifier
    from jepa_tpu_torch.models.factory import vit_cfg
    from jepa_tpu_torch.models.vit import init_vit
    from jepa_tpu_torch.ops import flash_attention as fa
    from jepa_tpu_torch.ops import fused_mlp as fm

    geo = dict(img_size=224, num_frames=16, tubelet_size=2, uniform_power=True)
    cfg = vit_cfg("vit_large", **geo)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    enc_path = os.path.join(workdir, "vitl16.pth.tar")
    model = init_vit(cfg, gen, device="cuda")
    torch.save({"target_encoder": {k: v.cpu() for k, v in model.state_dict().items()},
                "epoch": 0}, enc_path)
    acfg = AttentiveCfg(embed_dim=cfg.embed_dim, num_heads=cfg.num_heads, num_classes=400)
    probe = init_attentive_classifier(acfg, gen, device="cuda")
    probe_path = os.path.join(workdir, "probe.pth.tar")
    torch.save({"classifier": {k: v.cpu() for k, v in probe.state_dict().items()}},
               probe_path)
    del model, probe
    enc = api.load_encoder(enc_path, "vit_large", **geo)  # device="cuda"
    clf = api.load_classifier(probe_path, enc, num_classes=400)
    torch.cuda.synchronize()
    log(f"serve: seeded ViT-L/16 + probe written and loaded in "
        f"{time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(SEED)
    requests = [rng.integers(0, 256, size=(2, 16, 224, 224, 3), dtype=np.uint8)
                for _ in range(4)]
    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0
    fm.launches = 0
    times, deltas, probs_all = [], [], []
    for clips in requests:
        a0, f0 = fa.launches, fm.launches
        t0 = time.perf_counter()
        probs = clf.classify(clips)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        deltas.append((fa.launches - a0, fm.launches - f0))
        probs_all.append(probs)
    launches = {"h1": fa.launches, "h3": fm.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"serve: per-request launches (H1, H3) {deltas}")
    if any(d != (DEPTH, DEPTH) for d in deltas):
        raise RuntimeError(f"expected {DEPTH} H1 and {DEPTH} H3 launches per request")
    for probs in probs_all:
        if tuple(probs.shape) != (2, 400) or not torch.isfinite(probs).all():
            raise RuntimeError(f"bad probabilities: shape {tuple(probs.shape)}")
        s_err = (probs.sum(-1) - 1).abs().max().item()
        if s_err > 1e-4:
            raise RuntimeError(f"probabilities sum to 1 +- {s_err}")
    med = statistics.median(times[1:])
    log(f"serve: ms/request (B=2) {[round(t, 3) for t in times]}; median after "
        f"warm-up {med:.3f} ms; peak allocated {peak_gib:.3f} GiB")

    # the same model through the plain versions on the card
    feats = enc.encode(requests[0])
    with plain_versions():
        feats_ref = enc.encode(requests[0])
        probs_ref = clf.classify(requests[0])
    torch.cuda.synchronize()
    if tuple(feats.shape) != (2, cfg.num_patches, cfg.embed_dim):
        raise RuntimeError(f"feature shape {tuple(feats.shape)}")
    if not torch.isfinite(feats).all():
        raise RuntimeError("non-finite features")
    cos = torch.nn.functional.cosine_similarity(feats, feats_ref, dim=-1).min().item()
    f_err = (feats - feats_ref).abs().max().item()
    p_err = (probs_all[0] - probs_ref).abs().max().item()
    log(f"serve: kernel vs plain path, features min cosine {cos:.6f} (min "
        f"{FEAT_COS_MIN}), max|d| {f_err:.3e}; probabilities max|d| {p_err:.3e} "
        f"(tol {PROB_TOL})")
    if cos < FEAT_COS_MIN or p_err > PROB_TOL:
        raise RuntimeError("serving path disagrees with its plain version")
    return {"launches": launches, "median_ms": med, "peak_gib": peak_gib}


def main() -> int:
    import torch

    card = phase_device(torch)
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    phase_build()
    kern = phase_kernels(torch)
    with tempfile.TemporaryDirectory(dir=repo, prefix=".chip_smoke_") as workdir:
        serve = phase_serve(torch, workdir)
    kernels = [
        {"name": "flash_self_attention_fwd", "route": "cuda",
         "source": "jepa_tpu_torch/csrc/flash_attention.cu",
         "replaces": "jepa_tpu/ops/flash_attention.py:955",
         "launches": serve["launches"]["h1"],
         "max_abs_err": kern["h1"]["max_abs_err"],
         "ms": kern["h1"]["ms"], "plain_ms": kern["h1"]["plain_ms"]},
        {"name": "linear_gelu_fwd", "route": "cuda",
         "source": "jepa_tpu_torch/csrc/fused_mlp.cu",
         "replaces": "jepa_tpu/ops/fused_mlp.py:92",
         "launches": serve["launches"]["h3"],
         "max_abs_err": kern["h3"]["max_abs_err"],
         "ms": kern["h3"]["ms"], "plain_ms": kern["h3"]["plain_ms"]},
    ]
    log(f"card: {card}; serve median {serve['median_ms']:.3f} ms/request (B=2), "
        f"peak {serve['peak_gib']:.3f} GiB")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
