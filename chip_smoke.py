#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (jepa_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. device: require CUDA, print the card's name and power limit, turn
     TF32 off;
  2. build the hand-written kernels from jepa_tpu_torch/csrc (one nvcc per
     source, in parallel);
  3. autograd: one backward through the port's linear (matmul_f32) on the
     card, against the fp32 products;
  4. hold each kernel against its plain PyTorch version on the card and
     time both, with its bound and a library call where one exists: H1
     (flash attention forward) and H3 (fc1 + GELU) at the serving shapes
     and the training target's (B=24, N=1568; H3 at M=24*1568); H2 (flash
     attention backward, dk/dv and dq kernels) and H1 at the training
     shapes (the predictor's head dim 24 padded to 32, the encoder
     context, and a ragged N at head dim 80);
  5. serve 4 requests through jepa_tpu_torch.api: a seeded ViT-L/16
     (224 px, 16 frames, tubelet 2, uniform_power) and a 400-class
     attentive probe, written as .pth.tar files and loaded back; each
     request classifies 2 uint8 clips. Checks the probabilities, that
     every encoder block launched H1 and H3 once per request, and that the
     features and probabilities agree with the same model run through the
     plain versions on the card;
  6. train: TRAIN_STEPS pretraining updates of configs/pretrain/vitl16.yaml
     (ViT-L/16 + the 12 x 384 predictor, full width and depth, seeded
     weights and normalized clips, TRAIN_BATCH clips) through
     jepa_tpu_torch.train.step; checks finite loss and grad norms and the
     H1/H2/H3 launches per step the path implies, times the steps,
     profiles one more, then holds one B=2 update through the kernels
     against the same update through the plain versions (loss, grad norms,
     and the change of the encoder, the predictor and the EMA target);
  7. masked kernels: H1 (c=64 and c=24->32) and both H2 kernels with a key
     mask, against their plain versions at the padded mode's shapes
     (B=24; context N 128/384/640 at c=64, predictor N 1152/1664 at
     c=24->32), each mask with a mid-sequence run of pads and a ragged
     tail; the masked keys' dk and dv must be exactly 0;
  8. the pretrain app (jepa_tpu_torch.apps.vjepa.train.main) on
     configs/pretrain/vitl16.yaml with synthetic data and APP_IPE updates
     per epoch, in a temporary folder: fixed mode for 2 epochs, a resume
     to 3 (step count, CSV rows, and api.load_encoder reading the app's
     checkpoint), then padded mode for 1 epoch with the launches of the
     masked kernels per update checked;
  9. fp32 kernels (the frozen evals with use_bfloat16: false): H1-fp32 at
     (B=2, N=1568, c=64) and (B=1, N=1568, c=80), H3-fp32 at ViT-L's and
     ViT-H's fc1, against their plain versions in fp32 (TF32 off), timed
     beside SDPA / cuBLASLt in fp32 and their FFMA bounds; K2's and K3's
     geometry (B=1, N=4608, c=80) is timed in phases 4 and 4b;
 10. the video eval (jepa_tpu_torch.evals.video_classification_frozen.main)
     on configs/evals/vitl16_k400_16x8x3.yaml at full ViT-L width and depth
     with the seeded encoder and synthetic videos: bf16 at the config's
     batch 4 for 1 epoch, then a resume to 2 (per train step 32 clips, per
     val step 96 clips, 24 H1 and 24 H3 launches each), then fp32 at batch 1
     (24 H1-fp32 and 24 H3-fp32 per step, the bf16 counters still);
 11. the image probe's device path at configs/evals/vitl16_in1k.yaml's
     geometry: 16 images at 224 px repeated over 16 frames, AutoAugment
     'original' on the card, 2 train steps and 1 val step through the
     module-level steps the image eval's main calls, and the features
     against the plain versions.
Phases 9-11 run after phase 4 and phase 5 (sharing its seeded encoder).
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
H2_REL = 2.0**-6   # |d| <= 2^-6 * max|ref| per gradient: p and ds round to bf16
                   # in both versions, so a rare flip of a rounding (fp32 sums in
                   # another order) moves a term by one bf16 ulp
FEAT_COS_MIN = 0.999
TRAIN_BATCH = 24   # clips per card (configs/pretrain/vitl16.yaml data.batch_size)
TRAIN_STEPS = 4    # one warm-up update, then the timed ones
# B=2 update, kernels vs plain versions on the card (reasons in PERF.md):
TRAIN_LOSS_REL = 1e-4     # measured 7.9e-6: the kernels' roundings sit where the
                          # plain versions' do, so only sums run in another order
TRAIN_GNORM_REL = 2e-3    # measured <= 1.95e-4, the same, through the backward
TRAIN_UPDATE_COS = 0.9999  # update direction of the encoder, the predictor and
                           # the EMA target; measured >= 0.9999908 (predictor)
# |d_kernels - d_plain| / |d_plain| of each module's change in the update;
# measured 1.490e-3, 4.267e-3 and 2.378e-4 (the target's change is mostly
# the encoder-target gap, the same in both runs)
TRAIN_UPDATE_REL = {"encoder": 1.5e-2, "predictor": 4e-2, "target": 2.5e-3}
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core peak (data sheet)
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_EXP2_PER_S = 132 * 16 * 1.98e9  # 132 SMs x 16 exp2/clock/SM (sm_90 SFU
                                     # throughput) at the 1,980 MHz max SM clock
PEAK_F32_FLOPS = 132 * 128 * 2 * 1.98e9  # fp32 FFMA on the CUDA cores: 132 SMs x
                                         # 128 lanes x 2 flops at 1,980 MHz = 66.9e12
F32_TOL = 1e-4     # H1-fp32 |o|, |lse| abs; H3-fp32 |d| <= 1e-4 * max(|ref|, 1): fp32
                   # everywhere, so only the order of the fp32 sums differs
# (B, N, H, c) of H1-fp32 and (M, K, F) of H3-fp32: ViT-L and ViT-H, then
# the fp32 video eval's launch shapes (batch 1: the train step's 8 clips,
# the val step's 24). The first shape of each is the one the JSON line reports.
F32_H1_SHAPES = ((2, 1568, 16, 64), (1, 1568, 16, 80), (8, 1568, 16, 64), (24, 1568, 16, 64))
F32_H3_SHAPES = ((8 * 1568, 1024, 4096), (4 * 1568, 1280, 5120), (24 * 1568, 1024, 4096))
F32_FEAT_COS_MIN = 0.99999  # fp32 eval features, kernels vs plain: only the order
                            # of fp32 sums differs
PROB_TOL = 1e-3
EVAL_BF16_ENTRIES = (8, 6)  # (train, val) synthetic videos of the bf16 video eval at
                            # batch 4: 2 train steps, 2 val steps (the last one padded)
EVAL_F32_ENTRIES = (2, 1)   # the fp32 video eval at batch 1: 2 train, 1 val step
IMAGE_TRAIN_STEPS = 2
APP_IPE = 5        # app updates per epoch (the config's ipe is 300)


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


def phase_kernels(torch, n_train):
    """H1 (c=64/80) and H3 vs their plain versions at the serving shapes
    and at the training target's (TRAIN_BATCH clips of n_train tokens)."""
    from jepa_tpu_torch.ops import flash_attention as fa
    from jepa_tpu_torch.ops import fused_mlp as fm

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(SEED)
    report = {}

    h1 = {"max_abs_err": 0.0}
    for b, n, h, c in ((2, 1568, 16, 64), (1, 4608, 16, 80), (2, 1570, 16, 64),
                       (TRAIN_BATCH, n_train, 16, 64)):
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
        if (b, n, c) == (1, 4608, 80):  # K2's geometry (the vith16_384 encoder)
            k2 = dict(ms=time_ms(torch, lambda: fa.flash_self_attention_cuda(qkv, h, scale)),
                      plain_ms=time_ms(torch, lambda: fa.flash_self_attention_ref(qkv, h, scale)),
                      library_ms=_sdpa_fwd_ms(torch, qkv, h, scale),
                      bound=attn_bound_ms(b, n, h, c, 2, qkv.numel() * 2,
                                          b * n * h * c * 2 + b * h * n * 4))
            report["k2"] = k2
            log(f"K2 geometry, H1 B={b} N={n} H={h} c={c} time: kernel {k2['ms']:.4f} ms, "
                f"plain {k2['plain_ms']:.4f} ms, library (SDPA forward) "
                f"{k2['library_ms']:.4f} ms, bound "
                f"{k2['bound'][0]:.4f} ms ({k2['bound'][2]})")
        if (b, n, c) == (2, 1568, 64):
            h1["ms"] = time_ms(torch, lambda: fa.flash_self_attention_cuda(qkv, h, scale))
            h1["plain_ms"] = time_ms(torch, lambda: fa.flash_self_attention_ref(qkv, h, scale))
            h1["library_ms"] = _sdpa_fwd_ms(torch, qkv, h, scale)
            h1["bound"] = attn_bound_ms(b, n, h, c, 2, qkv.numel() * 2,
                                        b * n * h * c * 2 + b * h * n * 4)
            log(f"H1 ViT-L time: kernel {h1['ms']:.4f} ms, plain {h1['plain_ms']:.4f} ms, "
                f"library (SDPA forward) {h1['library_ms']:.4f} ms, bound "
                f"{h1['bound'][0]:.4f} ms ({h1['bound'][2]})")
        del qkv, o, lse, o_ref, lse_ref
    report["h1"] = h1

    h3 = {"max_abs_err": 0.0}
    k, f = 1024, 4096
    w = (torch.randn((f, k), generator=gen, device=dev) / 32).to(torch.bfloat16)
    bias = torch.randn((f,), generator=gen, device=dev) * 0.1
    for m in (2 * 1568, 1570, TRAIN_BATCH * n_train):
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
            bias_lp = bias.to(x.dtype)
            # library: cuBLASLt's GEMM + bias + GELU epilogue (tanh-approximated
            # GELU, so not H3's function to the bit; timed only, never used)
            h3["library_ms"] = time_ms(torch, lambda: torch._addmm_activation(
                bias_lp, x, w.t(), use_gelu=True))
            gemm_ms = time_ms(torch, lambda: torch.nn.functional.linear(x, w, bias_lp))
            t_ops = 2.0 * m * k * f / PEAK_BF16_FLOPS * 1e3
            t_bytes = (2 * m * k + 2 * f * k + 4 * f + 2 * m * f) / PEAK_BYTES_PER_S * 1e3
            h3["bound"] = ((t_ops, "operations", "MMA") if t_ops >= t_bytes
                           else (t_bytes, "bytes", "bytes"))
            log(f"H3 ViT-L fc1 time: kernel {h3['ms']:.4f} ms, plain {h3['plain_ms']:.4f} ms, "
                f"bound {h3['bound'][0]:.4f} ms ({h3['bound'][2]}); library "
                f"(_addmm_activation, tanh-GELU epilogue) {h3['library_ms']:.4f} ms; the bf16 "
                f"F.linear GEMM alone (a floor) {gemm_ms:.4f} ms")
        del x, y, y_ref, d
    report["h3"] = h3
    return report


def phase_f32_kernels(torch):
    """H1-fp32 and H3-fp32 (the frozen evals with use_bfloat16: false)
    against their plain versions on the card, in fp32 on both sides, with
    times, bounds (FFMA peak, exp2, bytes) and the fp32 library calls."""
    from jepa_tpu_torch.ops import flash_attention as fa
    from jepa_tpu_torch.ops import fused_mlp as fm

    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError("TF32 is on: the fp32 plain versions would not be fp32")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rep = {"h1": {"max_abs_err": 0.0}, "h3": {"max_abs_err": 0.0}}
    for b, n, h, c in F32_H1_SHAPES:
        qkv = torch.randn((b, n, 3 * h * c), generator=gen, device="cuda")
        scale = c**-0.5
        o, lse = fa.flash_self_attention_cuda(qkv, h, scale)
        o_ref, lse_ref = fa.flash_self_attention_ref(qkv, h, scale)
        torch.cuda.synchronize()
        if not (torch.isfinite(o).all() and torch.isfinite(lse).all()):
            raise RuntimeError(f"H1-fp32 B={b} N={n} c={c}: non-finite output")
        err_o = (o - o_ref).abs().max().item()
        err_l = (lse - lse_ref).abs().max().item()
        del o_ref, lse_ref
        log(f"H1-fp32 B={b} N={n} H={h} c={c}: max|do| {err_o:.3e} max|dlse| {err_l:.3e} "
            f"(tol {F32_TOL} each)")
        if not (err_o <= F32_TOL and err_l <= F32_TOL):
            raise RuntimeError(f"H1-fp32 B={b} N={n} c={c} disagrees with its plain version")
        rep["h1"]["max_abs_err"] = max(rep["h1"]["max_abs_err"], err_o, err_l)
        flops = 4.0 * b * h * n * n * c
        io = 4 * (qkv.numel() + b * n * h * c + b * h * n)
        r = dict(ms=time_ms(torch, lambda: fa.flash_self_attention_cuda(qkv, h, scale)),
                 plain_ms=time_ms(torch, lambda: fa.flash_self_attention_ref(qkv, h, scale)),
                 library_ms=_sdpa_fwd_ms(torch, qkv, h, scale),
                 bound=f32_bound_ms(flops, b * h * n * n, io))
        log(f"H1-fp32 B={b} N={n} c={c} time: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library (SDPA fp32) {r['library_ms']:.4f} ms, bound "
            f"{r['bound'][0]:.4f} ms ({r['bound'][2]}); {flops / r['ms'] / 1e9:.1f} TFLOP/s")
        if "ms" not in rep["h1"]:
            rep["h1"].update(r)
        del qkv, o, lse
    for m, k, f in F32_H3_SHAPES:
        x = torch.randn((m, k), generator=gen, device="cuda")
        w = torch.randn((f, k), generator=gen, device="cuda") / 32
        bias = torch.randn((f,), generator=gen, device="cuda") * 0.1
        y = fm.linear_gelu_cuda(x, w, bias)
        y_ref = fm.linear_gelu_ref(x, w, bias)
        torch.cuda.synchronize()
        if not torch.isfinite(y).all():
            raise RuntimeError(f"H3-fp32 M={m}: non-finite output")
        d = (y - y_ref).abs()
        err = d.max().item()
        excess = (d - F32_TOL * y_ref.abs().clamp(min=1)).max().item()
        log(f"H3-fp32 M={m} K={k} F={f}: max|d| {err:.3e}, worst margin {excess:.3e} "
            f"(tol |d| <= {F32_TOL}*max(|ref|,1))")
        if excess > 0:
            raise RuntimeError(f"H3-fp32 M={m} disagrees with its plain version")
        rep["h3"]["max_abs_err"] = max(rep["h3"]["max_abs_err"], err)
        flops = 2.0 * m * k * f
        r = dict(ms=time_ms(torch, lambda: fm.linear_gelu_cuda(x, w, bias)),
                 plain_ms=time_ms(torch, lambda: fm.linear_gelu_ref(x, w, bias)),
                 # cuBLASLt's fp32 GEMM + bias + tanh-GELU epilogue (timed only)
                 library_ms=time_ms(torch, lambda: torch._addmm_activation(
                     bias, x, w.t(), use_gelu=True)),
                 bound=f32_bound_ms(flops, 0, 4 * (m * k + f * k + f + m * f)))
        log(f"H3-fp32 M={m} K={k} F={f} time: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library (_addmm_activation fp32) {r['library_ms']:.4f} "
            f"ms, bound {r['bound'][0]:.4f} ms ({r['bound'][2]}); "
            f"{flops / r['ms'] / 1e9:.1f} TFLOP/s")
        if "ms" not in rep["h3"]:
            rep["h3"].update(r)
        del x, w, bias, y, y_ref, d
    return rep


def f32_bound_ms(flops, exp2s, io_bytes):
    """Least time of an fp32 kernel: its FLOP at the CUDA-core FFMA peak, its
    exp2 at the SFU rate, or its bytes, whichever is largest."""
    t = {"FFMA": flops / PEAK_F32_FLOPS * 1e3, "exp2": exp2s / PEAK_EXP2_PER_S * 1e3,
         "bytes": io_bytes / PEAK_BYTES_PER_S * 1e3}
    which = max(t, key=t.get)
    return t[which], ("bytes" if which == "bytes" else "operations"), which


def phase_autograd(torch):
    """One backward through the port's linear on the card (cuBLAS's
    fp32-output bf16 GEMM has no autograd formula of its own), held
    against the same products upcast to fp32."""
    from jepa_tpu_torch.models.transformer import matmul_f32

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn((4, 96, 1024), generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn((3072, 1024), generator=gen, device="cuda") / 32).to(torch.bfloat16)
    x.requires_grad_(True)
    w.requires_grad_(True)
    y = matmul_f32(x, w)
    g = torch.randn(y.shape, generator=gen, device="cuda").to(torch.bfloat16).float()
    (y * g).sum().backward()
    torch.cuda.synchronize()
    dx_ref = (g.reshape(-1, 3072) @ w.detach().float()).reshape(x.shape)
    dw_ref = g.reshape(-1, 3072).t() @ x.detach().float().reshape(-1, 1024)
    ex = ((x.grad.float() - dx_ref).abs() / dx_ref.abs().clamp(min=1)).max().item()
    ew = ((w.grad.float() - dw_ref).abs() / dw_ref.abs().clamp(min=1)).max().item()
    log(f"autograd: matmul_f32 backward on the card, max rel err dx {ex:.3e} "
        f"dw {ew:.3e} (tol 2^-7: one bf16 rounding of an fp32 sum)")
    if not (ex <= 2.0**-7 and ew <= 2.0**-7):
        raise RuntimeError("matmul_f32 backward disagrees with the fp32 products")


def _attn_inputs(torch, gen, b, n, h, c, c_real=None):
    """Seeded bf16 qkv [B, N, 3*H*c] (pad lanes past c_real zero, as the
    padded projection gives them) and do [B, N, H*c]."""
    c_real = c_real or c
    qkv = torch.randn((b, n, 3, h, c), generator=gen, device="cuda")
    qkv[..., c_real:] = 0
    do = torch.randn((b, n, h, c), generator=gen, device="cuda")
    do[..., c_real:] = 0
    return (qkv.reshape(b, n, 3 * h * c).to(torch.bfloat16),
            do.reshape(b, n, h * c).to(torch.bfloat16))


def _sdpa_bwd_ms(torch, qkv, do, h, scale):
    """Library yardstick: the backward of torch's scaled_dot_product_attention
    on the same q/k/v (timed only; the port never calls it)."""
    b, n, w3 = qkv.shape
    c = w3 // (3 * h)
    q, k, v = (t.transpose(1, 2).contiguous().requires_grad_(True)
               for t in qkv.reshape(b, n, 3, h, c).unbind(2))
    out = torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=scale)
    g = do.reshape(b, n, h, c).transpose(1, 2).contiguous()
    return time_ms(torch, lambda: torch.autograd.grad(out, (q, k, v), g,
                                                      retain_graph=True))


def _sdpa_fwd_ms(torch, qkv, h, scale):
    b, n, w3 = qkv.shape
    c = w3 // (3 * h)
    q, k, v = (t.transpose(1, 2).contiguous()
               for t in qkv.reshape(b, n, 3, h, c).unbind(2))
    f = torch.nn.functional.scaled_dot_product_attention
    return time_ms(torch, lambda: f(q, k, v, scale=scale))


def attn_bound_ms(b, n, h, c, products, in_bytes, out_bytes, pairs=None):
    """Least time for one attention kernel: the largest of `products`
    N x N x c matmuls per (batch, head) at the bf16 tensor-core peak (c the
    real head dim: pad lanes are zeros), one exp2 per score (p, computed or
    recomputed once by every kernel here) at the SFU rate, and moving the
    inputs and outputs once. ``pairs``: the (query, valid key) pairs summed
    over the batch where a key mask leaves fewer than b*N*N scores to
    compute. Returns (ms, "operations" or "bytes", which)."""
    pairs = b * n * n if pairs is None else pairs
    t = {"MMA": products * 2.0 * h * pairs * c / PEAK_BF16_FLOPS * 1e3,
         "exp2": 1.0 * h * pairs / PEAK_EXP2_PER_S * 1e3,
         "bytes": (in_bytes + out_bytes) / PEAK_BYTES_PER_S * 1e3}
    which = max(t, key=t.get)
    return t[which], ("bytes" if which == "bytes" else "operations"), which


def phase_bwd_kernels(torch, shapes):
    """H2 (both kernels) against their plain versions, and H1 at c=32, on
    the card at the training path's shapes; times and bounds.

    shapes: list of (label, B, N, H, c, c_real); the first predictor
    shape is the one timed for the summary line."""
    from jepa_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rep = {"dkv": {"max_abs_err": 0.0}, "dq": {"max_abs_err": 0.0},
           "h1_c32": {"max_abs_err": 0.0}, "h1": {"max_abs_err": 0.0}}
    timed = False
    for label, b, n, h, c, c_real in shapes:
        qkv, do = _attn_inputs(torch, gen, b, n, h, c, c_real)
        scale = c_real**-0.5
        o, lse = fa.flash_self_attention_cuda(qkv, h, scale)
        o_ref, lse_ref = fa.flash_self_attention_ref(qkv, h, scale)
        torch.cuda.synchronize()
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_l = (lse - lse_ref).abs().max().item()
        del o_ref, lse_ref
        log(f"H1 c={c} {label} B={b} N={n} H={h}: max|do| {err_o:.3e} (tol "
            f"{H1_O_TOL}) max|dlse| {err_l:.3e} (tol {H1_LSE_TOL})")
        if not (err_o <= H1_O_TOL and err_l <= H1_LSE_TOL):
            raise RuntimeError(f"H1 c={c} {label} disagrees with its plain version")
        h1 = rep["h1_c32" if c == 32 else "h1"]
        h1["max_abs_err"] = max(h1["max_abs_err"], err_o)
        delta = fa.attention_delta(do, o, h)
        dqkv = fa.flash_self_attention_bwd_cuda(qkv, do, lse, delta, h, scale)
        ref = fa.flash_self_attention_bwd_ref(qkv, do, lse, delta, h, scale)
        torch.cuda.synchronize()
        if not torch.isfinite(dqkv.float()).all():
            raise RuntimeError(f"H2 {label}: non-finite output")
        hc = h * c
        for i, name in enumerate(("dq", "dk", "dv")):
            got = dqkv[..., i * hc:(i + 1) * hc].float()
            want = ref[..., i * hc:(i + 1) * hc].float()
            err = (got - want).abs().max().item()
            tol = H2_REL * want.abs().max().item()
            pad = got.reshape(b, n, h, c)[..., c_real:].abs().max().item() if c_real < c else 0.0
            log(f"H2 {label} B={b} N={n} H={h} c={c_real}->{c}: {name} max|d| {err:.3e} "
                f"(tol {tol:.3e} = 2^-6 * max|ref|), pad lanes max {pad:.1e}")
            if not (err <= tol and pad == 0.0):
                raise RuntimeError(f"H2 {label} {name} disagrees with its plain version")
            kern = "dq" if name == "dq" else "dkv"
            rep[kern]["max_abs_err"] = max(rep[kern]["max_abs_err"], err)
        if label.startswith("predictor") and not timed:
            timed = True
            el = 2  # bf16 bytes
            qkv_b, o_b = b * n * 3 * hc * el, b * n * hc * el
            vec_b = b * h * n * 4
            out = torch.empty_like(qkv)
            rep["dkv"].update(
                ms=time_ms(torch, lambda: fa.flash_bwd_dkv_cuda(qkv, do, lse, delta, out, h, scale)),
                plain_ms=time_ms(torch, lambda: fa.flash_bwd_dkv_ref(qkv, do, lse, delta, h, scale)),
                bound=attn_bound_ms(b, n, h, c_real, 4, qkv_b + o_b + 2 * vec_b, 2 * o_b))
            rep["dq"].update(
                ms=time_ms(torch, lambda: fa.flash_bwd_dq_cuda(qkv, do, lse, delta, out, h, scale)),
                plain_ms=time_ms(torch, lambda: fa.flash_bwd_dq_ref(qkv, do, lse, delta, h, scale)),
                bound=attn_bound_ms(b, n, h, c_real, 3, qkv_b + o_b + 2 * vec_b, o_b))
            lib = _sdpa_bwd_ms(torch, qkv, do, h, scale)
            rep["dkv"]["library_ms"] = rep["dq"]["library_ms"] = lib
            rep["h1_c32"].update(
                ms=time_ms(torch, lambda: fa.flash_self_attention_cuda(qkv, h, scale)),
                plain_ms=time_ms(torch, lambda: fa.flash_self_attention_ref(qkv, h, scale)),
                library_ms=_sdpa_fwd_ms(torch, qkv, h, scale),
                bound=attn_bound_ms(b, n, h, c_real, 2, qkv_b, o_b + vec_b))
            rep["shape"] = (b, n, h, c)
            whole = attn_bound_ms(b, n, h, c_real, 5, qkv_b + o_b + 2 * vec_b, qkv_b)
            log(f"H2 {label} whole backward: dkv + dq {rep['dkv']['ms'] + rep['dq']['ms']:.4f} "
                f"ms, SDPA backward {lib:.4f} ms, bound {whole[0]:.4f} ms ({whole[2]}; "
                f"5 products of 2*N^2*c per head at c={c_real}, one exp2 per score)")
            for k in ("dkv", "dq", "h1_c32"):
                r = rep[k]
                log(f"{k} {label} B={b} N={n} H={h} c={c_real}->{c} time: kernel "
                    f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
                    f"{r['library_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms ({r['bound'][2]})")
        else:
            out = torch.empty_like(qkv)
            ms_dkv = time_ms(torch, lambda: fa.flash_bwd_dkv_cuda(qkv, do, lse, delta, out, h, scale))
            ms_dq = time_ms(torch, lambda: fa.flash_bwd_dq_cuda(qkv, do, lse, delta, out, h, scale))
            log(f"H2 {label} B={b} N={n} time: dkv {ms_dkv:.4f} ms, dq {ms_dq:.4f} ms")
            if label.startswith("vith16_384"):  # K3's geometry: the merged backward's work
                el = 2
                qkv_b, o_b, vec_b = b * n * 3 * h * c * el, b * n * h * c * el, b * h * n * 4
                rep["k3"] = dict(ms=ms_dkv + ms_dq, library_ms=_sdpa_bwd_ms(torch, qkv, do, h, scale),
                                 plain_ms=time_ms(torch, lambda: fa.flash_self_attention_bwd_ref(
                                     qkv, do, lse, delta, h, scale)),
                                 bound=attn_bound_ms(b, n, h, c_real, 5,
                                                     qkv_b + o_b + 2 * vec_b, qkv_b))
                k3 = rep["k3"]
                log(f"K3 geometry, H2 {label} B={b} N={n} H={h} c={c}: dkv + dq "
                    f"{k3['ms']:.4f} ms, plain {k3['plain_ms']:.4f} ms, library (SDPA "
                    f"backward) {k3['library_ms']:.4f} ms, "
                    f"bound {k3['bound'][0]:.4f} ms ({k3['bound'][2]})")
        del qkv, do, o, lse, delta, dqkv, ref
    return rep


def padded_key_mask(torch, rng, b, n, mid_run):
    """[B, N] bool key mask on the card: per sample a run of pads starting
    at ``mid_run`` (the predictor's context pads, or a random run) and a
    ragged tail of pads, key 0 always valid."""
    m = np.ones((b, n), dtype=bool)
    for i in range(b):
        a = mid_run if mid_run else int(rng.integers(1, n // 2))
        m[i, a:a + int(rng.integers(1, n // 4))] = False
        m[i, n - int(rng.integers(1, n // 8)):] = False
    return torch.from_numpy(m).to("cuda")


def _sdpa_masked_ms(torch, qkv, do, h, scale, mask):
    """Library yardstick with the key mask: SDPA with a boolean attn_mask,
    (forward ms, backward-alone ms); timed only, the port never calls it."""
    b, n, w3 = qkv.shape
    c = w3 // (3 * h)
    q, k, v = (t.transpose(1, 2).contiguous().requires_grad_(True)
               for t in qkv.reshape(b, n, 3, h, c).unbind(2))
    am = mask[:, None, None, :]
    f = torch.nn.functional.scaled_dot_product_attention
    with torch.no_grad():
        fwd = time_ms(torch, lambda: f(q, k, v, attn_mask=am, scale=scale))
    out = f(q, k, v, attn_mask=am, scale=scale)
    g = do.reshape(b, n, h, c).transpose(1, 2).contiguous()
    bwd = time_ms(torch, lambda: torch.autograd.grad(out, (q, k, v), g, retain_graph=True))
    return fwd, bwd


def phase_masked_kernels(torch, shapes):
    """H1 and both H2 kernels with a key mask (the padded mask mode)
    against their plain versions on the card.

    shapes: (label, B, N, H, c, c_real, mid_run); the first of each head
    dim is timed for the summary line."""
    from jepa_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    rng = np.random.default_rng(SEED + 2)
    rep = {k: {"max_abs_err": 0.0} for k in ("h1_c64", "h1_c32", "dkv", "dq")}
    for label, b, n, h, c, c_real, mid_run in shapes:
        qkv, do = _attn_inputs(torch, gen, b, n, h, c, c_real)
        mask = padded_key_mask(torch, rng, b, n, mid_run)
        scale = c_real**-0.5
        o, lse = fa.flash_self_attention_cuda(qkv, h, scale, mask)
        o_ref, lse_ref = fa.flash_self_attention_ref(qkv, h, scale, mask)
        torch.cuda.synchronize()
        if not (torch.isfinite(o.float()).all() and torch.isfinite(lse).all()):
            raise RuntimeError(f"masked H1 {label}: non-finite output")
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_l = (lse - lse_ref).abs().max().item()
        del o_ref, lse_ref
        valid = mask.float().mean().item()
        log(f"masked H1 c={c} {label} B={b} N={n}: valid keys {valid:.3f}, max|do| "
            f"{err_o:.3e} (tol {H1_O_TOL}) max|dlse| {err_l:.3e} (tol {H1_LSE_TOL})")
        if not (err_o <= H1_O_TOL and err_l <= H1_LSE_TOL):
            raise RuntimeError(f"masked H1 {label} disagrees with its plain version")
        h1 = rep[f"h1_c{c}"]
        h1["max_abs_err"] = max(h1["max_abs_err"], err_o)
        delta = fa.attention_delta(do, o, h)
        dqkv = fa.flash_self_attention_bwd_cuda(qkv, do, lse, delta, h, scale, mask)
        ref = fa.flash_self_attention_bwd_ref(qkv, do, lse, delta, h, scale, mask)
        torch.cuda.synchronize()
        if not torch.isfinite(dqkv.float()).all():
            raise RuntimeError(f"masked H2 {label}: non-finite output")
        hc = h * c
        for i, name in enumerate(("dq", "dk", "dv")):
            got = dqkv[..., i * hc:(i + 1) * hc].float()
            want = ref[..., i * hc:(i + 1) * hc].float()
            err = (got - want).abs().max().item()
            tol = H2_REL * want.abs().max().item()
            masked = got[~mask].abs().max().item() if name != "dq" else 0.0
            log(f"masked H2 {label} c={c_real}->{c}: {name} max|d| {err:.3e} (tol "
                f"{tol:.3e}), masked keys max|{name}| {masked:.1e} (must be 0)")
            if not (err <= tol and masked == 0.0):
                raise RuntimeError(f"masked H2 {label} {name} disagrees with its plain version")
            kern = "dq" if name == "dq" else "dkv"
            rep[kern]["max_abs_err"] = max(rep[kern]["max_abs_err"], err)
        el = 2
        qkv_b, o_b, vec_b, m_b = b * n * 3 * hc * el, b * n * hc * el, b * h * n * 4, b * n
        pairs = int(mask.sum().item()) * n  # every query row against the valid keys
        if "ms" not in h1:
            fwd_lib, bwd_lib = _sdpa_masked_ms(torch, qkv, do, h, scale, mask)
            h1.update(
                ms=time_ms(torch, lambda: fa.flash_self_attention_cuda(qkv, h, scale, mask)),
                plain_ms=time_ms(torch, lambda: fa.flash_self_attention_ref(qkv, h, scale, mask)),
                library_ms=fwd_lib,
                bound=attn_bound_ms(b, n, h, c_real, 2, qkv_b + m_b, o_b + vec_b, pairs),
                shape=(b, n, h, c_real))
            log(f"masked H1 c={c_real}->{c} {label} B={b} N={n} time: kernel {h1['ms']:.4f} ms, "
                f"plain {h1['plain_ms']:.4f} ms, library (SDPA fwd, bool mask) {fwd_lib:.4f} "
                f"ms, bound {h1['bound'][0]:.4f} ms ({h1['bound'][2]})")
            if c == 32:
                out = torch.empty_like(qkv)
                rep["dkv"].update(
                    ms=time_ms(torch, lambda: fa.flash_bwd_dkv_cuda(qkv, do, lse, delta, out, h, scale, mask)),
                    plain_ms=time_ms(torch, lambda: fa.flash_bwd_dkv_ref(qkv, do, lse, delta, h, scale, mask)),
                    library_ms=bwd_lib,
                    bound=attn_bound_ms(b, n, h, c_real, 4, qkv_b + o_b + 2 * vec_b + m_b, 2 * o_b, pairs),
                    shape=(b, n, h, c_real))
                rep["dq"].update(
                    ms=time_ms(torch, lambda: fa.flash_bwd_dq_cuda(qkv, do, lse, delta, out, h, scale, mask)),
                    plain_ms=time_ms(torch, lambda: fa.flash_bwd_dq_ref(qkv, do, lse, delta, h, scale, mask)),
                    library_ms=bwd_lib,
                    bound=attn_bound_ms(b, n, h, c_real, 3, qkv_b + o_b + 2 * vec_b + m_b, o_b, pairs),
                    shape=(b, n, h, c_real))
                for k in ("dkv", "dq"):
                    r = rep[k]
                    log(f"masked {k} {label} B={b} N={n} c={c_real}->{c} time: kernel "
                        f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library (SDPA "
                        f"backward, bool mask) {bwd_lib:.4f} ms, bound {r['bound'][0]:.4f} ms "
                        f"({r['bound'][2]})")
        del qkv, do, o, lse, delta, dqkv, ref, mask
    return rep


def plain_versions():
    """Context in which the kernel launchers run their plain versions
    (for comparison only; nothing is counted)."""
    from jepa_tpu_torch.ops import flash_attention as fa
    from jepa_tpu_torch.ops import fused_mlp as fm

    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(
        fa, "flash_self_attention_cuda", fa.flash_self_attention_ref))
    stack.enter_context(mock.patch.object(
        fa, "flash_self_attention_bwd_cuda", fa.flash_self_attention_bwd_ref))
    stack.enter_context(mock.patch.object(fm, "linear_gelu_cuda", fm.linear_gelu_ref))
    return stack


VITL16_GEO = dict(img_size=224, num_frames=16, tubelet_size=2, uniform_power=True)


def write_seeded_encoder(torch, workdir: str) -> str:
    """A seeded ViT-L/16 (224 px, 16 frames, tubelet 2, uniform_power) as
    a zoo-layout .pth.tar in workdir; returns its path."""
    from jepa_tpu_torch.models.factory import vit_cfg
    from jepa_tpu_torch.models.vit import init_vit

    path = os.path.join(workdir, "vitl16.pth.tar")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = init_vit(vit_cfg("vit_large", **VITL16_GEO), gen, device="cuda")
    torch.save({"target_encoder": {k: v.cpu() for k, v in model.state_dict().items()},
                "epoch": 0}, path)
    return path


def phase_serve(torch, workdir: str):
    """Serving through jepa_tpu_torch.api on a seeded ViT-L/16 .pth.tar,
    which it writes to workdir and returns (``enc_path``) for the evals."""
    from jepa_tpu_torch import api
    from jepa_tpu_torch.models.attentive import AttentiveCfg, init_attentive_classifier
    from jepa_tpu_torch.models.factory import vit_cfg
    from jepa_tpu_torch.ops import flash_attention as fa
    from jepa_tpu_torch.ops import fused_mlp as fm

    geo = VITL16_GEO
    cfg = vit_cfg("vit_large", **geo)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    enc_path = write_seeded_encoder(torch, workdir)
    acfg = AttentiveCfg(embed_dim=cfg.embed_dim, num_heads=cfg.num_heads, num_classes=400)
    probe = init_attentive_classifier(acfg, gen, device="cuda")
    probe_path = os.path.join(workdir, "probe.pth.tar")
    torch.save({"classifier": {k: v.cpu() for k, v in probe.state_dict().items()}},
               probe_path)
    del probe
    enc = api.load_encoder(enc_path, "vit_large", **geo)  # device="cuda"
    clf = api.load_classifier(probe_path, enc, num_classes=400)
    torch.cuda.synchronize()
    log(f"serve: seeded ViT-L/16 + probe written and loaded in "
        f"{time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(SEED)
    requests = [rng.integers(0, 256, size=(2, 16, 224, 224, 3), dtype=np.uint8)
                for _ in range(4)]
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(fa, fm)
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
    return {"launches": launches, "median_ms": med, "peak_gib": peak_gib, "enc_path": enc_path}


def train_setup(repo: str):
    """Configs of configs/pretrain/vitl16.yaml (model, data geometry, mask,
    loss and optimization sections): ViT-L/16 + the 12 x 384 predictor at
    full width and depth, fixed masks with K calibrated at the config's
    per-card batch, the config's schedules (ipe 300, warmup 40)."""
    import yaml

    from jepa_tpu_torch.masks.multiblock3d import MaskGrid, MaskSpec, calibrate_keep_counts
    from jepa_tpu_torch.models.factory import predictor_cfg_for, vit_cfg
    from jepa_tpu_torch.train.step import TrainCfg, build_train_step
    from jepa_tpu_torch.utils.schedulers import build_schedules

    with open(os.path.join(repo, "configs", "pretrain", "vitl16.yaml")) as f:
        cfg = yaml.safe_load(f)
    m, d, lo, o = cfg["model"], cfg["data"], cfg["loss"], cfg["optimization"]
    enc_cfg = vit_cfg(m["model_name"], img_size=d["crop_size"], patch_size=d["patch_size"],
                      num_frames=d["num_frames"], tubelet_size=d["tubelet_size"],
                      uniform_power=m["uniform_power"])
    pred_cfg = predictor_cfg_for(enc_cfg, predictor_embed_dim=m["pred_embed_dim"],
                                 depth=m["pred_depth"], use_mask_tokens=m["use_mask_tokens"],
                                 num_mask_tokens=len(cfg["mask"]),
                                 zero_init_mask_tokens=m["zero_init_mask_tokens"])
    specs = [MaskSpec.from_cfg(x) for x in cfg["mask"]]
    grid = MaskGrid.from_data_cfg(d["crop_size"], d["patch_size"], d["num_frames"],
                                  d["tubelet_size"])
    keep = [calibrate_keep_counts(s, grid, d["batch_size"]) for s in specs]
    ipe, warmup = int(o["ipe"]), float(o["warmup"])
    scheds = build_schedules(ipe=ipe, num_epochs=int(o["epochs"]), warmup_epochs=warmup,
                             start_lr=o["start_lr"], ref_lr=o["lr"], final_lr=o["final_lr"],
                             wd=o["weight_decay"], final_wd=o["final_weight_decay"],
                             ema=tuple(o["ema"]), ipe_scale=o["ipe_scale"])
    tc = TrainCfg(loss_exp=lo["loss_exp"], reg_coeff=lo["reg_coeff"],
                  clip_grad=o["clip_grad"], clip_after_step=int((warmup + 1) * ipe),
                  num_clips=d["num_clips"], mask_mode=cfg["meta"]["mask_mode"],
                  seed=cfg["meta"]["seed"])
    step_fn = build_train_step(enc_cfg, pred_cfg, tc, *scheds, specs, grid, keep)
    return dict(enc_cfg=enc_cfg, pred_cfg=pred_cfg, keep=keep, step_fn=step_fn,
                specs=specs, grid=grid, yaml_batch=d["batch_size"], clip_shape=(d["num_frames"], d["crop_size"],
                                                        d["crop_size"], 3))


def expected_train_launches(setup) -> dict:
    """Per-step launches the path implies: H1 once per flash block forward
    (target always; a context or predictor sequence when it has >= 128
    tokens, the flash rule), H2 dk/dv and dq once per differentiated H1,
    H3 once per target block."""
    depth, pdepth = setup["enc_cfg"].depth, setup["pred_cfg"].depth
    ctx = sum(depth for ke, _ in setup["keep"] if ke >= 128)
    pred = sum(pdepth for ke, kp in setup["keep"] if ke + kp >= 128)
    return {"h1": depth + ctx + pred, "dkv": ctx + pred, "dq": ctx + pred, "h3": depth}


def _counts(fa, fm) -> dict:
    return {"h1": fa.launches, "dkv": fa.dkv_launches, "dq": fa.dq_launches,
            "h3": fm.launches, "h1_c32": fa.launches_by_head_dim[32],
            "h1_c64": fa.launches_by_head_dim[64],
            "h1_f32": fa.f32_launches_by_head_dim[64], "h3_f32": fm.f32_launches}


def _reset_counts(fa, fm) -> None:
    fa.reset_launch_counts()
    fm.launches = fm.f32_launches = 0


def phase_train(torch, setup):
    """TRAIN_STEPS pretraining updates of vitl16.yaml (``train_setup``) at
    TRAIN_BATCH clips per card, then one update at B=2 through the kernels
    and through their plain versions from the same state and batch."""
    import copy

    from jepa_tpu_torch.ops import flash_attention as fa
    from jepa_tpu_torch.ops import fused_mlp as fm
    from jepa_tpu_torch.train.step import init_train_state

    want = expected_train_launches(setup)
    log(f"train: vitl16.yaml, ViT-L/16 + predictor {setup['pred_cfg'].depth}x"
        f"{setup['pred_cfg'].predictor_embed_dim}, batch {TRAIN_BATCH} (config "
        f"{setup['yaml_batch']}), keep counts {setup['keep']}, expected launches/step {want}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    state = init_train_state(setup["enc_cfg"], setup["pred_cfg"], gen)  # device="cuda"
    clips = torch.randn((TRAIN_BATCH, *setup["clip_shape"]), generator=gen, device="cuda")
    torch.cuda.synchronize()
    log(f"train: seeded state and clips in {time.perf_counter() - t0:.1f} s")

    step_fn = setup["step_fn"]
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(fa, fm)
    times, per_step = [], []
    for _ in range(TRAIN_STEPS):
        before = _counts(fa, fm)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, {"clips": clips})
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        after = _counts(fa, fm)
        per_step.append({k: after[k] - before[k] for k in want})
        vals = {k: metrics[k].item() for k in ("loss", "enc_grad_norm", "pred_grad_norm", "lr")}
        log(f"train: step {state.step}: {times[-1]:.1f} ms, " +
            ", ".join(f"{k} {v:.6g}" for k, v in vals.items()))
        if not all(np.isfinite(v) for v in vals.values()):
            raise RuntimeError(f"non-finite training metrics {vals}")
    launches = _counts(fa, fm)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if any(p != want for p in per_step):
        raise RuntimeError(f"launches per step {per_step} != expected {want}")
    med = statistics.median(times[1:])
    log(f"train: ms/step {[round(t, 1) for t in times]}; median after warm-up "
        f"{med:.1f} ms ({TRAIN_BATCH / med * 1e3:.2f} clips/s); peak allocated "
        f"{peak_gib:.2f} GiB; launches {launches}")
    prof = profile_step(torch, step_fn, state, clips)

    # one update at B=2, kernels vs plain versions, from the same state and batch
    twin = copy.deepcopy(state)
    small = {"clips": clips[:2].contiguous()}
    del clips
    modules = ("encoder", "predictor", "target")
    before = {m: [p.detach().clone() for p in getattr(state, m).parameters()]
              for m in modules}
    state, mk = step_fn(state, small)
    with plain_versions():
        twin, mp = step_fn(twin, small)
    torch.cuda.synchronize()
    cmp = {}
    for k in ("loss", "enc_grad_norm", "pred_grad_norm"):
        a, b = mk[k].item(), mp[k].item()
        cmp[k] = abs(a - b) / abs(b)
    log(f"train B=2, kernels vs plain versions: loss {mk['loss'].item():.6f} vs "
        f"{mp['loss'].item():.6f} (rel {cmp['loss']:.2e}, tol {TRAIN_LOSS_REL}); "
        f"enc_grad_norm rel {cmp['enc_grad_norm']:.2e}, pred_grad_norm rel "
        f"{cmp['pred_grad_norm']:.2e} (tol {TRAIN_GNORM_REL})")
    ok = (cmp["loss"] <= TRAIN_LOSS_REL and cmp["enc_grad_norm"] <= TRAIN_GNORM_REL
          and cmp["pred_grad_norm"] <= TRAIN_GNORM_REL)
    for m in modules:  # each module's change in this update, kernels vs plain
        dk = torch.cat([(p.detach() - p0).flatten()
                        for p, p0 in zip(getattr(state, m).parameters(), before[m])])
        dp = torch.cat([(p.detach() - p0).flatten()
                        for p, p0 in zip(getattr(twin, m).parameters(), before[m])])
        cos = torch.nn.functional.cosine_similarity(dk, dp, dim=0).item()
        rel = ((dk - dp).norm() / dp.norm()).item()
        log(f"train B=2, {m} update: cosine {cos:.7f} (min {TRAIN_UPDATE_COS}), "
            f"|dk - dp|/|dp| {rel:.3e} (tol {TRAIN_UPDATE_REL[m]})")
        ok = ok and cos >= TRAIN_UPDATE_COS and rel <= TRAIN_UPDATE_REL[m]
    if not ok:
        raise RuntimeError("the B=2 update through the kernels disagrees with the plain versions")
    return {"launches": launches, "median_ms": med, "peak_gib": peak_gib, "prof": prof,
            "keep": setup["keep"]}


def profile_step(torch, step_fn, state, clips):
    """One more update under torch.profiler: device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step_fn(state, {"clips": clips})
        torch.cuda.synchronize()
    from torch.autograd import DeviceType

    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    total = sum(r[1] for r in rows)
    groups = {"H1 flash_fwd": 0.0, "H2 flash_bwd_dkv": 0.0, "H2 flash_bwd_dq": 0.0,
              "H3 linear_gelu": 0.0, "GEMM (cuBLAS)": 0.0, "other": 0.0}
    for name, ms, _ in rows:
        if "flash_fwd_kernel" in name:
            groups["H1 flash_fwd"] += ms
        elif "flash_bwd_dkv" in name:
            groups["H2 flash_bwd_dkv"] += ms
        elif "flash_bwd_dq" in name:
            groups["H2 flash_bwd_dq"] += ms
        elif "linear_gelu" in name:
            groups["H3 linear_gelu"] += ms
        elif any(t in name.lower() for t in ("gemm", "xmma", "cutlass", "nvjet")):
            groups["GEMM (cuBLAS)"] += ms
        else:
            groups["other"] += ms
    log(f"train profile: device self time {total:.1f} ms in one step; " + "; ".join(
        f"{k} {v:.1f} ms ({100 * v / max(total, 1e-9):.1f} %)" for k, v in groups.items()))
    for name, ms, n in sorted(rows, key=lambda r: -r[1])[:12]:
        log(f"  {ms:9.3f} ms  x{n:<5d} {name[:110]}")
    ops = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
           if e.device_type == DeviceType.CPU and e.key.startswith("aten::")
           and e.self_device_time_total > 0]
    log("train profile, device time by the aten op that launched it:")
    for name, ms, n in sorted(ops, key=lambda r: -r[1])[:10]:
        log(f"  {ms:9.3f} ms  x{n:<5d} {name}")
    return {"device_ms": total, "groups": groups}


def expected_padded_launches(setup, ladder_caps) -> dict:
    """Per-update launches of the padded mode: the unmasked H1 and H3 of
    the target, a masked H1 per context block whose cap is >= 128 (c=64)
    and per predictor block (c=32), a masked dk/dv and dq per masked H1."""
    depth, pdepth = setup["enc_cfg"].depth, setup["pred_cfg"].depth
    ctx = sum(depth for ce, _ in ladder_caps if ce >= 128)
    pred = sum(pdepth for ce, cp in ladder_caps if ce + cp >= 128)
    return {"h1_c64": depth, "h1_c32": 0, "h1_c64_masked": ctx, "h1_c32_masked": pred,
            "dkv_masked": ctx + pred, "dq_masked": ctx + pred, "dkv": ctx + pred,
            "dq": ctx + pred, "h3": depth}


def _app_counts(fa, fm) -> dict:
    return {**_counts(fa, fm), "h1_c64_masked": fa.masked_launches_by_head_dim[64],
            "h1_c32_masked": fa.masked_launches_by_head_dim[32],
            "dkv_masked": fa.dkv_masked_launches, "dq_masked": fa.dq_masked_launches}


def _csv_times(path):
    """(median step ms, median wall ms, median host share of the wall) over
    the rows after each run's first (the CSV's own integer ms)."""
    rows = [r.split(",") for r in open(path).read().strip().splitlines()]
    body, first = [], True
    for r in rows:
        if r[0] == "epoch":
            first = True
            continue
        if not first:
            body.append((float(r[7]), float(r[8])))
        first = False
    step = statistics.median(b[0] for b in body)
    wall = statistics.median(b[1] for b in body)
    host = statistics.median((b[1] - b[0]) / b[1] for b in body)
    return step, wall, host, len(rows) - rows.count(rows[0])


def phase_app(torch, repo, setup, workdir):
    """The pretrain app on vitl16.yaml with synthetic data, APP_IPE updates
    per epoch: fixed mode 2 epochs, a resume to 3, then padded mode 1
    epoch, each with the launch counts set to 0 just before and read just
    after; api.load_encoder reads the fixed run's checkpoint."""
    import shutil

    import yaml

    from jepa_tpu_torch import api
    from jepa_tpu_torch.apps.vjepa.train import main as train_main
    from jepa_tpu_torch.masks.multiblock3d import calibrate_pad_ladders
    from jepa_tpu_torch.ops import flash_attention as fa
    from jepa_tpu_torch.ops import fused_mlp as fm

    with open(os.path.join(repo, "configs", "pretrain", "vitl16.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["data"]["dataset_type"] = "synthetic"
    cfg["optimization"]["ipe"] = APP_IPE
    cfg["optimization"]["epochs"] = 2
    cfg["logging"]["folder"] = os.path.join(workdir, "fixed")
    torch.cuda.empty_cache()  # a fresh allocator, as the app has in its own process
    retries0 = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    log(f"app: vitl16.yaml, synthetic data, ipe {APP_IPE}, batch {cfg['data']['batch_size']}, "
        f"{cfg['data']['num_workers']} loader workers; free disk "
        f"{shutil.disk_usage(workdir).free / 2**30:.1f} GiB")
    out = {}
    want_fixed = expected_train_launches(setup)

    torch.cuda.reset_peak_memory_stats()
    _reset_counts(fa, fm)
    t0 = time.perf_counter()
    state = train_main(cfg)  # device="cuda"
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = _counts(fa, fm)
    steps = 2 * APP_IPE
    if state.step != steps:
        raise RuntimeError(f"app fixed: step {state.step} != {steps}")
    if any(got[k] != steps * v for k, v in want_fixed.items()):
        raise RuntimeError(f"app fixed: launches {got} != {steps} x {want_fixed}")
    tag = cfg["logging"]["write_tag"]
    csv = os.path.join(cfg["logging"]["folder"], f"{tag}_r0.csv")
    ckpt = os.path.join(cfg["logging"]["folder"], f"{tag}-latest.pth.tar")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"app fixed: {steps} updates in {secs:.1f} s (build of state, loader, checkpoints "
        f"included); checkpoint {os.path.getsize(ckpt) / 2**30:.2f} GiB; launches {got}")

    # the app's checkpoint through the serving API: the EMA target's features
    geo = VITL16_GEO
    clips = np.random.default_rng(SEED).integers(0, 256, size=(2, 16, 224, 224, 3),
                                                 dtype=np.uint8)
    feats = api.load_encoder(ckpt, "vit_large", **geo).encode(clips)
    want = api.Encoder(model=state.target, cfg=setup["enc_cfg"]).encode(clips)
    err = (feats - want).abs().max().item()
    log(f"app: api.load_encoder on {os.path.basename(ckpt)} vs the state's target, "
        f"features max|d| {err:.3e} (tol 1e-3)")
    if not (torch.isfinite(feats).all() and err <= 1e-3):
        raise RuntimeError("api.load_encoder does not read the app's checkpoint")
    del state, feats, want

    # resume to 3 epochs
    cfg["optimization"]["epochs"] = 3
    _reset_counts(fa, fm)
    state = train_main(cfg)
    got = _counts(fa, fm)
    if state.step != 3 * APP_IPE or any(got[k] != APP_IPE * v for k, v in want_fixed.items()):
        raise RuntimeError(f"app resume: step {state.step}, launches {got}")
    step_ms, wall_ms, host, n_rows = _csv_times(csv)
    if n_rows != 3 * APP_IPE:
        raise RuntimeError(f"app: {n_rows} CSV rows != {3 * APP_IPE}")
    out["fixed"] = dict(step_ms=step_ms, wall_ms=wall_ms, host=host, peak_gib=peak)
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries0
    log(f"app fixed + resume: step {state.step}, {n_rows} CSV rows; median step "
        f"{step_ms:.0f} ms, wall {wall_ms:.0f} ms, host (loader + augment) share of the "
        f"wall {100 * host:.1f} %, peak allocated {peak:.2f} GiB, allocator retries {retries}")
    del state
    shutil.rmtree(cfg["logging"]["folder"])
    torch.cuda.empty_cache()

    # padded mode, one epoch
    cfg["meta"]["mask_mode"] = "padded"
    cfg["optimization"]["epochs"] = 1
    cfg["logging"]["folder"] = os.path.join(workdir, "padded")
    specs_caps = calibrate_pad_ladders(
        setup["specs"], setup["grid"], cfg["data"]["batch_size"])
    want_padded = expected_padded_launches(setup, [rungs[0] for rungs in specs_caps])
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(fa, fm)
    state = train_main(cfg)
    torch.cuda.synchronize()
    got = _app_counts(fa, fm)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if state.step != APP_IPE or any(got[k] != APP_IPE * v for k, v in want_padded.items()):
        raise RuntimeError(f"app padded: step {state.step}, launches {got} != "
                           f"{APP_IPE} x {want_padded}")
    step_ms, wall_ms, host, n_rows = _csv_times(
        os.path.join(cfg["logging"]["folder"], f"{tag}_r0.csv"))
    out["padded"] = dict(step_ms=step_ms, wall_ms=wall_ms, host=host, peak_gib=peak,
                         launches=got, ladders=specs_caps)
    log(f"app padded: step {state.step}, cap ladders {specs_caps}; launches per update "
        f"{ {k: v // APP_IPE for k, v in got.items()} }; median step {step_ms:.0f} ms, wall "
        f"{wall_ms:.0f} ms, host share {100 * host:.1f} %, peak allocated {peak:.2f} GiB")
    del state
    torch.cuda.empty_cache()
    return out


def eval_config(repo, workdir, name, enc_path, n_train, n_val, **opt):
    """configs/evals/vitl16_k400_16x8x3.yaml with the seeded encoder, the
    synthetic decode and CSV manifests of n_train / n_val synthetic videos
    (seeded labels in [0, 400)) in workdir/name; ``opt`` overrides keys of
    its optimization section."""
    import yaml

    with open(os.path.join(repo, "configs", "evals", "vitl16_k400_16x8x3.yaml")) as f:
        cfg = yaml.safe_load(f)
    folder = os.path.join(workdir, name)
    os.makedirs(folder)
    rng = np.random.default_rng(SEED)
    for split, n in (("train", n_train), ("val", n_val)):
        path = os.path.join(folder, f"{split}.csv")
        with open(path, "w") as f:
            f.writelines(f"synthetic://{name}-{split}{i} {rng.integers(0, 400)}\n"
                         for i in range(n))
        cfg["data"][f"dataset_{split}"] = path
    cfg["data"]["decode_backend"] = "synthetic"
    cfg["pretrain"].update(folder=folder, checkpoint=enc_path)
    cfg["optimization"].update(opt)
    return cfg


@contextlib.contextmanager
def spy_steps(torch, module, fa, fm):
    """Record every call of ``module.train_step`` / ``module.val_step``:
    its device-synchronised time, the interval since the start of the
    previous step of the same kind when it came right before (the step's
    wall time), the device-synchronised time of the transforms on the card
    (``pretrain_augment``, ``multiview_crops``) since the previous step, the kernel
    launches in it, the rows M of each H3 launch, the probe's step before
    it, and its result; ``rec["inputs"][kind]`` keeps the (probe, clips on
    the host, keywords) of the first step of each kind since it was last
    emptied."""
    kinds = ("train_step", "val_step")
    rec = {k: [] for k in kinds}
    rec["inputs"] = {}
    real = {k: getattr(module, k) for k in kinds}
    real_h3 = fm.linear_gelu_cuda
    transforms = [k for k in ("pretrain_augment", "multiview_crops") if hasattr(module, k)]
    h3_rows = []
    prev = [None, 0.0, 0.0]  # kind, start and time of the previous step
    aug_ms = [0.0]  # transforms on the card since the previous step

    def h3_spy(x, w, b):
        h3_rows.append(x.shape[0])
        return real_h3(x, w, b)

    def aug_spy(fn):
        def transform(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            aug_ms[0] += (time.perf_counter() - t0) * 1e3
            return out
        return transform

    def wrap(kind):
        def step(probe, *args, **kw):
            if kind not in rec["inputs"]:  # kept on the host: no device memory held
                rec["inputs"][kind] = (probe, args[0].cpu(), kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            c0, r0, before = _counts(fa, fm), len(h3_rows), probe.step
            out = real[kind](probe, *args, **kw)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            c1 = _counts(fa, fm)
            wall = (t0 - prev[1]) * 1e3 if prev[0] == kind else None
            rec[kind].append(dict(ms=ms, wall_ms=wall, prev_ms=prev[2], aug_ms=aug_ms[0],
                                  out=out, step_before=before,
                                  launches={k: c1[k] - c0[k] for k in c1},
                                  h3_rows=sorted(set(h3_rows[r0:]))))
            prev[:] = [kind, t0, ms]
            aug_ms[0] = 0.0
            return out
        return step

    with contextlib.ExitStack() as stack:
        for kind in kinds:
            stack.enter_context(mock.patch.object(module, kind, wrap(kind)))
        stack.enter_context(mock.patch.object(fm, "linear_gelu_cuda", h3_spy))
        for k in transforms:
            stack.enter_context(mock.patch.object(module, k, aug_spy(getattr(module, k))))
        yield rec


def _check_steps(rec, want, label):
    """Every recorded step launched exactly ``want[kind]`` (zeros elsewhere)
    and ran H3 at the expected rows; returns per kind (median step ms,
    median host share, median augmentation share) of the wall of the
    steps that came back to back: the wall between two step starts holds
    the previous step, this step's transforms on the card, and the host
    (the loader's decode, the copies to the card, the Python between)."""
    out = {}
    for kind, (launches, rows) in want.items():
        steps = rec[kind]
        for i, s in enumerate(steps):
            got = {k: v for k, v in s["launches"].items() if v}
            if got != launches or s["h3_rows"] != [rows]:
                raise RuntimeError(f"{label} {kind} {i}: launches {got}, H3 rows "
                                   f"{s['h3_rows']} != {launches}, [{rows}]")
        walls = [s for s in steps if s["wall_ms"]]
        host = [(s["wall_ms"] - s["prev_ms"] - s["aug_ms"]) / s["wall_ms"] for s in walls]
        aug = [s["aug_ms"] / s["wall_ms"] for s in walls]
        out[kind] = (statistics.median(s["ms"] for s in steps),
                     statistics.median(host) if walls else None,
                     statistics.median(aug) if walls else None)
    return out


def eval_features_vs_plain(torch, vcf, inputs, cos_min, label):
    """The frozen features of an eval run's first train and first val batch
    (its steps' launch shapes) through the kernels, against the plain
    versions on the same clips. The plain side takes one sample at a time:
    the encoder sees each clip alone, so that is the same function at a
    fraction of the plain attention's memory. Returns the min cosine per
    kind."""
    out = {}
    with torch.no_grad():
        for kind, (probe, clips, kw) in inputs.items():
            clips = clips.cuda()
            across, pos, ci = (kw["attend_across_segments"], kw.get("pos_table"),
                               kw.get("clip_indices"))
            feats = vcf.encode_views(probe, clips, across, pos, ci)
            with plain_versions():
                per_sample = [vcf.encode_views(probe, clips[i:i + 1], across, pos,
                                               None if ci is None else ci[i:i + 1])
                              for i in range(clips.shape[0])]
            refs = [torch.cat(views) for views in zip(*per_sample)]
            finite = all(torch.isfinite(f).all().item() for f in feats)
            cos = min(torch.nn.functional.cosine_similarity(f.float(), r.float(), dim=-1)
                      .min().item() for f, r in zip(feats, refs))
            err = max((f.float() - r.float()).abs().max().item() for f, r in zip(feats, refs))
            log(f"eval {label} {kind} batch ({clips.shape[0] * clips.shape[1] * clips.shape[2]} "
                f"clips) features, kernels vs plain: min cosine {cos:.7f} (min {cos_min}), "
                f"max|d| {err:.3e}, {len(feats)} x {tuple(feats[0].shape)}")
            if not finite or cos < cos_min:
                raise RuntimeError(f"eval {label} {kind} features disagree with the plain versions")
            out[kind] = cos
            del feats, per_sample, refs
    return out


def _fmt_host(share):
    return "not measured (no back-to-back steps)" if share is None else f"{100 * share:.1f} %"


def phase_eval_video(torch, repo, workdir, enc_path, bf16: bool):
    """The video eval (jepa_tpu_torch.evals.video_classification_frozen.main)
    on vitl16_k400_16x8x3.yaml at full ViT-L width and depth. bf16: the
    config's batch 4, EVAL_BF16_ENTRIES synthetic videos, 1 epoch then a
    resume to 2. fp32 (use_bfloat16: false): batch 1, EVAL_F32_ENTRIES, 1
    epoch. Checks the launches and H3 rows of every step, the resume step,
    the CSV, the probe checkpoint and finite results, then the features of
    the first train and val batch against the plain versions."""
    from jepa_tpu_torch.evals import video_classification_frozen as vcf
    from jepa_tpu_torch.ops import flash_attention as fa
    from jepa_tpu_torch.ops import fused_mlp as fm

    batch = 4 if bf16 else 1
    n_train, n_val = EVAL_BF16_ENTRIES if bf16 else EVAL_F32_ENTRIES
    name = "k400_bf16" if bf16 else "k400_fp32"
    cfg = eval_config(repo, workdir, name, enc_path, n_train, n_val, batch_size=batch,
                      num_epochs=1, use_bfloat16=bf16)
    d = cfg["data"]
    s, v = d["num_segments"], d["num_views_per_segment"]
    n_tok = (d["frames_per_clip"] // 2) * (224 // 16) ** 2
    keys = ("h1_c64", "h3") if bf16 else ("h1_f32", "h3_f32")
    per_step = {k: DEPTH for k in keys}
    if bf16:
        per_step["h1"] = DEPTH  # the bf16 total counter moves with its c=64 instance
    want = {"train_step": (per_step, batch * s * n_tok),
            "val_step": (per_step, batch * s * v * n_tok)}
    log(f"eval {name}: vitl16_k400_16x8x3.yaml, batch {batch}, {s} segments x {v} views, "
        f"{n_train} train / {n_val} val synthetic videos; expected per step {per_step}, "
        f"H3 rows train {want['train_step'][1]} / val {want['val_step'][1]}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(fa, fm)
    t0 = time.perf_counter()
    with spy_steps(torch, vcf, fa, fm) as rec:
        accs = vcf.main(cfg)  # device="cuda"
        if bf16:  # resume to 2 epochs from the probe checkpoint
            cfg["optimization"]["num_epochs"] = 2
            cfg["resume_checkpoint"] = True
            rec["inputs"].clear()  # so the first run's probe and encoder can go
            accs += vcf.main(cfg)
    secs = time.perf_counter() - t0
    launches = _counts(fa, fm)
    peak = torch.cuda.max_memory_allocated() / 2**30
    cos = eval_features_vs_plain(torch, vcf, rec.pop("inputs"),
                                 FEAT_COS_MIN if bf16 else F32_FEAT_COS_MIN, name)
    epochs = 2 if bf16 else 1
    ipe, n_val_steps = n_train // batch, -(-n_val // batch)
    if len(rec["train_step"]) != epochs * ipe or len(rec["val_step"]) != epochs * n_val_steps:
        raise RuntimeError(f"eval {name}: {len(rec['train_step'])} train and "
                           f"{len(rec['val_step'])} val steps")
    times = _check_steps(rec, want, f"eval {name}")
    losses = [float(s["out"]["loss"]) for s in rec["train_step"]]
    if not (all(np.isfinite(losses)) and len(accs) == epochs
            and all(0.0 <= a <= 100.0 for a in accs)):
        raise RuntimeError(f"eval {name}: losses {losses}, val accs {accs}")
    folder = os.path.join(cfg["pretrain"]["folder"], "video_classification_frozen",
                          cfg["tag"])
    tag = cfg["pretrain"]["write_tag"]
    saved = torch.load(os.path.join(folder, f"{tag}-latest.pth.tar"), weights_only=True)
    rows = open(os.path.join(folder, f"{tag}_r0.csv")).read().strip().splitlines()
    if (saved["opt"]["step"] != epochs * ipe or saved["epoch"] != epochs
            or len([r for r in rows if r[0].isdigit()]) != epochs):
        raise RuntimeError(f"eval {name}: checkpoint step {saved['opt']['step']} epoch "
                           f"{saved['epoch']}, CSV {rows}")
    if bf16 and rec["train_step"][ipe]["step_before"] != ipe:
        raise RuntimeError(f"eval {name}: the resumed run started at probe step "
                           f"{rec['train_step'][ipe]['step_before']}, not {ipe}")
    (tr_ms, tr_host, tr_aug), (va_ms, va_host, _) = times["train_step"], times["val_step"]
    log(f"eval {name}: {epochs} epoch(s) in {secs:.1f} s (loaders and checkpoints "
        f"included){'; resumed at probe step ' + str(ipe) if bf16 else ''}; train losses "
        f"{[round(x, 4) for x in losses]}, val accs {accs}; median train step {tr_ms:.1f} ms "
        f"(host share of the wall {_fmt_host(tr_host)}, augmentation on the card "
        f"{_fmt_host(tr_aug)}), median val step {va_ms:.1f} ms "
        f"(host share {_fmt_host(va_host)}); peak allocated {peak:.2f} GiB; launches "
        f"{ {k: x for k, x in launches.items() if x} }")
    return dict(launches=launches, train_ms=tr_ms, val_ms=va_ms, train_host=tr_host,
                train_aug=tr_aug, val_host=va_host, peak_gib=peak, feat_cos=cos)


def phase_image_probe(torch, repo, enc_path):
    """The image probe's device path at vitl16_in1k.yaml's geometry: B=16
    images at 224 px through the seeded ViT-L/16 (each image repeated over
    16 frames), AutoAugment 'original' on the card, IMAGE_TRAIN_STEPS train
    steps and one val step through the module-level steps the image eval's
    main calls; then the features through the kernels against the plain
    versions."""
    import yaml

    from jepa_tpu_torch.data.transforms import normalize
    from jepa_tpu_torch.evals import image_classification_frozen as icf
    from jepa_tpu_torch.evals.video_classification_frozen import (
        load_frozen_encoder,
        make_probe,
        probe_schedules,
    )
    from jepa_tpu_torch.models.factory import vit_cfg
    from jepa_tpu_torch.ops import flash_attention as fa
    from jepa_tpu_torch.ops import fused_mlp as fm
    from jepa_tpu_torch.train.step import step_generator

    with open(os.path.join(repo, "configs", "evals", "vitl16_in1k.yaml")) as f:
        cfg = yaml.safe_load(f)
    p, d, o = cfg["pretrain"], cfg["data"], cfg["optimization"]
    res, b = d["resolution"], o["batch_size"]
    enc_cfg = vit_cfg(p["model_name"], img_size=res, patch_size=p["patch_size"],
                      num_frames=p["frames_per_clip"], tubelet_size=p["tubelet_size"],
                      uniform_power=p["uniform_power"], compute_dtype=torch.bfloat16,
                      fused_mlp=True)
    encoder = load_frozen_encoder(enc_path, enc_cfg, p["checkpoint_key"], "cuda")
    scheds = probe_schedules(IMAGE_TRAIN_STEPS, o["num_epochs"], 0.0, o["start_lr"], o["lr"],
                             o["final_lr"], o["weight_decay"])
    probe = make_probe(encoder, enc_cfg, d["num_classes"], *scheds, "cuda")
    aug_cfg = icf.train_augment_cfg(res)  # the config's default: AutoAugment 'original'
    rng = np.random.default_rng(SEED)
    # host loader outputs: train images at 256/224 of the resolution, val at it
    train_imgs = torch.from_numpy(rng.integers(0, 256, (b, res * 256 // 224, res * 256 // 224, 3),
                                               dtype=np.uint8)).cuda()
    val_imgs = torch.from_numpy(rng.integers(0, 256, (b, res, res, 3), dtype=np.uint8)).cuda()
    labels = torch.from_numpy(rng.integers(0, d["num_classes"], b)).cuda()
    weights = torch.ones(b, device="cuda")
    per_step = {"h1": DEPTH, "h1_c64": DEPTH, "h3": DEPTH}
    want = {"train_step": (per_step, b * enc_cfg.num_patches),
            "val_step": (per_step, b * enc_cfg.num_patches)}
    log(f"image probe: vitl16_in1k.yaml geometry, B={b} images at {res} px x "
        f"{enc_cfg.num_frames} frames, auto_augment {aug_cfg.auto_augment!r}; expected "
        f"per step {per_step}, H3 rows {want['train_step'][1]}")
    _reset_counts(fa, fm)
    with spy_steps(torch, icf, fa, fm) as rec:
        for step in range(IMAGE_TRAIN_STEPS):
            imgs = icf.augment_images(step_generator(icf.AUG_SEED, step, "cuda"), train_imgs,
                                      aug_cfg, torch.bfloat16)
            icf.train_step(probe, imgs, labels)
        val_in = normalize(val_imgs.float()).to(torch.bfloat16)
        correct, total = icf.val_step(probe, val_in, labels, weights)
    launches = _counts(fa, fm)
    times = _check_steps(rec, want, "image probe")
    losses = [float(s["out"]["loss"]) for s in rec["train_step"]]
    if not (all(np.isfinite(losses)) and float(total) == b and 0 <= float(correct) <= b):
        raise RuntimeError(f"image probe: losses {losses}, correct {correct} of {total}")

    # the features of the augmented batch, kernels vs plain versions
    with torch.no_grad():
        feats = icf.encode_images(probe, imgs)
        with plain_versions():
            feats_ref = icf.encode_images(probe, imgs)
    cos = torch.nn.functional.cosine_similarity(feats, feats_ref, dim=-1).min().item()
    log(f"image probe: train losses {[round(x, 4) for x in losses]}, val correct "
        f"{float(correct):.0f} of {float(total):.0f}; step ms train "
        f"{[round(s['ms'], 1) for s in rec['train_step']]}, val "
        f"{[round(s['ms'], 1) for s in rec['val_step']]}; features kernels vs plain "
        f"min cosine {cos:.6f} (min {FEAT_COS_MIN}); launches "
        f"{ {k: x for k, x in launches.items() if x} }")
    if not (torch.isfinite(feats).all() and cos >= FEAT_COS_MIN):
        raise RuntimeError("image probe features disagree with the plain versions")
    return dict(launches=launches, train_ms=times["train_step"][0],
                val_ms=times["val_step"][0])


def kernel_entry(name, source, replaces, launches, rep) -> dict:
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": rep["max_abs_err"], "ms": rep["ms"],
            "plain_ms": rep["plain_ms"], "bound_ms": rep["bound"][0],
            "bound_by": rep["bound"][1], "library_ms": rep.get("library_ms")}


def main() -> int:
    import torch

    card = phase_device(torch)
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    phase_build()
    phase_autograd(torch)
    setup = train_setup(repo)
    kern = phase_kernels(torch, setup["enc_cfg"].num_patches)
    f32 = phase_f32_kernels(torch)
    (ke0, kp0), (ke1, kp1) = setup["keep"]
    bwd = phase_bwd_kernels(torch, [
        ("predictor, mask 1", TRAIN_BATCH, ke0 + kp0, 16, 32, 24),
        ("predictor, mask 2", TRAIN_BATCH, ke1 + kp1, 16, 32, 24),
        ("encoder context", TRAIN_BATCH, ke0, 16, 64, 64),
        ("ragged c=80", 1, 333, 16, 80, 80),
        ("vith16_384 encoder geometry", 1, 4608, 16, 80, 80),
        ("384px predictor geometry", 1, 4608, 16, 32, 24),
    ])
    kern["h1"]["max_abs_err"] = max(kern["h1"]["max_abs_err"], bwd["h1"]["max_abs_err"])
    masked = phase_masked_kernels(torch, [
        ("context, short-range rung", TRAIN_BATCH, 384, 16, 64, 64, 0),
        ("context, long-range rung", TRAIN_BATCH, 128, 16, 64, 64, 0),
        ("context, top rung", TRAIN_BATCH, 640, 16, 64, 64, 0),
        ("predictor, short-range", TRAIN_BATCH, 384 + 768, 16, 32, 24, 384),
        ("predictor, top rungs", TRAIN_BATCH, 256 + 1408, 16, 32, 24, 256),
    ])
    with tempfile.TemporaryDirectory(dir=repo, prefix=".chip_smoke_") as workdir:
        serve = phase_serve(torch, workdir)
        enc_path = serve["enc_path"]
        ev16 = phase_eval_video(torch, repo, workdir, enc_path, bf16=True)
        ev32 = phase_eval_video(torch, repo, workdir, enc_path, bf16=False)
        img = phase_image_probe(torch, repo, enc_path)
    train = phase_train(torch, setup)
    with tempfile.TemporaryDirectory(dir=repo, prefix=".chip_smoke_") as workdir:
        app = phase_app(torch, repo, setup, workdir)
    sl, tl, al = serve["launches"], train["launches"], app["padded"]["launches"]
    el, fl, il = ev16["launches"], ev32["launches"], img["launches"]
    fa_src, bwd_src = "jepa_tpu_torch/csrc/flash_attention.cu", "jepa_tpu_torch/csrc/flash_attention_bwd.cu"
    fa_py = "jepa_tpu/ops/flash_attention.py"
    kernels = [
        kernel_entry("flash_self_attention_fwd", fa_src, f"{fa_py}:955",
                     sl["h1"] + tl["h1_c64"] + el["h1_c64"] + il["h1_c64"], kern["h1"]),
        kernel_entry("flash_self_attention_fwd_c32", fa_src, f"{fa_py}:955",
                     tl["h1_c32"], bwd["h1_c32"]),
        kernel_entry("flash_bwd_dkv", bwd_src, f"{fa_py}:1452", tl["dkv"], bwd["dkv"]),
        kernel_entry("flash_bwd_dq", bwd_src, f"{fa_py}:1400", tl["dq"], bwd["dq"]),
        kernel_entry("linear_gelu_fwd", "jepa_tpu_torch/csrc/fused_mlp.cu",
                     "jepa_tpu/ops/fused_mlp.py:92", sl["h3"] + tl["h3"] + el["h3"] + il["h3"],
                     kern["h3"]),
        # the fp32 instances: the fp32 video eval's launches
        kernel_entry("flash_self_attention_fwd_f32", fa_src, f"{fa_py}:955", fl["h1_f32"],
                     f32["h1"]),
        kernel_entry("linear_gelu_fwd_f32", "jepa_tpu_torch/csrc/fused_mlp.cu",
                     "jepa_tpu/ops/fused_mlp.py:92", fl["h3_f32"], f32["h3"]),
        # the key-masked instances: the padded-mode app's launches
        kernel_entry("flash_self_attention_fwd_masked", fa_src, f"{fa_py}:955",
                     al["h1_c64_masked"], masked["h1_c64"]),
        kernel_entry("flash_self_attention_fwd_masked_c32", fa_src, f"{fa_py}:955",
                     al["h1_c32_masked"], masked["h1_c32"]),
        kernel_entry("flash_bwd_dkv_masked", bwd_src, f"{fa_py}:1452", al["dkv_masked"],
                     masked["dkv"]),
        kernel_entry("flash_bwd_dq_masked", bwd_src, f"{fa_py}:1400", al["dq_masked"],
                     masked["dq"]),
    ]
    log(f"card: {card}; serve median {serve['median_ms']:.3f} ms/request (B=2), "
        f"peak {serve['peak_gib']:.3f} GiB; train median {train['median_ms']:.1f} "
        f"ms/step (B={TRAIN_BATCH}), peak {train['peak_gib']:.2f} GiB")
    for name, e in (("bf16, batch 4", ev16), ("fp32, batch 1", ev32)):
        log(f"card: {card}; K400 16x8x3 eval {name}: median train step {e['train_ms']:.1f} ms "
            f"(host share {_fmt_host(e['train_host'])}, augmentation "
            f"{_fmt_host(e['train_aug'])}), val step {e['val_ms']:.1f} ms (host share "
            f"{_fmt_host(e['val_host'])}), peak {e['peak_gib']:.2f} GiB; features vs plain "
            f"min cosine train {e['feat_cos']['train_step']:.7f} / val "
            f"{e['feat_cos']['val_step']:.7f}")
    log(f"card: {card}; image probe (B=16): median train step {img['train_ms']:.1f} ms, "
        f"val step {img['val_ms']:.1f} ms")
    for k, r in (("K2 (H1, B=1 N=4608 c=80)", kern["k2"]),
                 ("K3 (H2 dkv + dq, B=1 N=4608 c=80)", bwd["k3"])):
        log(f"card: {card}; {k}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms ({r['bound'][2]})")
    for mode in ("fixed", "padded"):
        a = app[mode]
        log(f"card: {card}; app {mode} (B={TRAIN_BATCH}): median step {a['step_ms']:.0f} ms, "
            f"wall {a['wall_ms']:.0f} ms, host share {100 * a['host']:.1f} %, peak "
            f"{a['peak_gib']:.2f} GiB")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
