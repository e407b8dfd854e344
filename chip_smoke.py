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
     and the change of the encoder, the predictor and the EMA target).
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


def attn_bound_ms(b, n, h, c, products, in_bytes, out_bytes):
    """Least time for one attention kernel: the largest of `products`
    N x N x c matmuls per (batch, head) at the bf16 tensor-core peak (c the
    real head dim: pad lanes are zeros), one exp2 per score (p, computed or
    recomputed once by every kernel here) at the SFU rate, and moving the
    inputs and outputs once. Returns (ms, "operations" or "bytes", which)."""
    t = {"MMA": products * 2.0 * b * h * n * n * c / PEAK_BF16_FLOPS * 1e3,
         "exp2": 1.0 * b * h * n * n / PEAK_EXP2_PER_S * 1e3,
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
        del qkv, do, o, lse, delta, dqkv, ref
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
    return {"launches": launches, "median_ms": med, "peak_gib": peak_gib}


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
                yaml_batch=d["batch_size"], clip_shape=(d["num_frames"], d["crop_size"],
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
            "h1_c64": fa.launches_by_head_dim[64]}


def _reset_counts(fa, fm) -> None:
    fa.reset_launch_counts()
    fm.launches = 0


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
    (ke0, kp0), (ke1, kp1) = setup["keep"]
    bwd = phase_bwd_kernels(torch, [
        ("predictor, mask 1", TRAIN_BATCH, ke0 + kp0, 16, 32, 24),
        ("predictor, mask 2", TRAIN_BATCH, ke1 + kp1, 16, 32, 24),
        ("encoder context", TRAIN_BATCH, ke0, 16, 64, 64),
        ("ragged c=80", 1, 333, 16, 80, 80),
        ("384px predictor geometry", 1, 4608, 16, 32, 24),
    ])
    kern["h1"]["max_abs_err"] = max(kern["h1"]["max_abs_err"], bwd["h1"]["max_abs_err"])
    with tempfile.TemporaryDirectory(dir=repo, prefix=".chip_smoke_") as workdir:
        serve = phase_serve(torch, workdir)
    train = phase_train(torch, setup)
    sl, tl = serve["launches"], train["launches"]
    fa_src, bwd_src = "jepa_tpu_torch/csrc/flash_attention.cu", "jepa_tpu_torch/csrc/flash_attention_bwd.cu"
    fa_py = "jepa_tpu/ops/flash_attention.py"
    kernels = [
        kernel_entry("flash_self_attention_fwd", fa_src, f"{fa_py}:955",
                     sl["h1"] + tl["h1_c64"], kern["h1"]),
        kernel_entry("flash_self_attention_fwd_c32", fa_src, f"{fa_py}:955",
                     tl["h1_c32"], bwd["h1_c32"]),
        kernel_entry("flash_bwd_dkv", bwd_src, f"{fa_py}:1452", tl["dkv"], bwd["dkv"]),
        kernel_entry("flash_bwd_dq", bwd_src, f"{fa_py}:1400", tl["dq"], bwd["dq"]),
        kernel_entry("linear_gelu_fwd", "jepa_tpu_torch/csrc/fused_mlp.cu",
                     "jepa_tpu/ops/fused_mlp.py:92", sl["h3"] + tl["h3"], kern["h3"]),
    ]
    log(f"card: {card}; serve median {serve['median_ms']:.3f} ms/request (B=2), "
        f"peak {serve['peak_gib']:.3f} GiB; train median {train['median_ms']:.1f} "
        f"ms/step (B={TRAIN_BATCH}), peak {train['peak_gib']:.2f} GiB")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
