#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (jepa_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                   # the smoke run below
    python3 chip_smoke.py --b2-spread [--seeds 0,1,2] [--other DIR]...
                                            # only the spread of phase 6's B=2
                                            # check (phase_b2_spread)
    python3 chip_smoke.py --kernel-ab --other DIR...
                                            # only H1-H8, H1-fp32, H3-fp32 and
                                            # H8-fp32 against another
                                            # checkout's (phase_kernel_ab)
    python3 chip_smoke.py --update-ab --other DIR
                                            # only the 1-rank vit_tiny and
                                            # ViT-L updates of this checkout
                                            # and DIR's in turns
                                            # (phase_update_ab)
    python3 chip_smoke.py --remat-peak vith16.yaml [--padded]
                                            # only a pretrain config with
                                            # remat False: its ms and peak
                                            # memory (phase_remat_peak)

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
     then (phase_edges) the Hopper kernels at their tiles' edges: H1 and
     H2 at N = 40 and N = 129 (1 mod 128) for every head dim, and with two
     whole 128-key tiles of pads mid-sequence at c = 24->32, 64 and 128;
     H4 at N = 40 and 129, 1 and 376 queries over 1568 keys, on permuted
     views and on the planes of a packed qkv; H6 likewise at c = 32 and
     64, masked with two all-pad key tiles into the planes of a packed
     dqkv; H5 likewise (also 376 queries over 1568 keys at c = 32, and
     the 1-query probe masked); H1-fp32 at N = 40, 129 and 333 at c = 64 and 80; H3 and H8 at
     M = 8, 200 and 2305; H7 at N = 40 and 129 at c = 64 and 32, at 1 and
     376 queries over 640 keys, and masked into the planes of a packed
     dqkv; H3-fp32 and H8-fp32 at M = 8, 200, 333 and 2305 with ViT-L's and
     ViT-H's fc1;
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
     profiles one more, and holds one B=2 update through the kernels
     against the same update through the plain versions from the seeded
     state and from the trained state (loss and grad norms at both; from
     the trained state also the change of the encoder, the predictor and
     the EMA target; ``check_b2`` says why);
  7. masked kernels: H1 (c=64 and c=24->32) and both H2 kernels with a key
     mask, against their plain versions at the padded mode's shapes
     (B=24; context N 128/384/640 at c=64, predictor N 1152/1664 at
     c=24->32), each mask with a mid-sequence run of pads and a ragged
     tail; the masked keys' dk and dv must be exactly 0;
  8. the pretrain app (jepa_tpu_torch.apps.vjepa.train.main) on
     configs/pretrain/vitl16.yaml with synthetic data and APP_IPE updates
     per epoch, in a temporary folder: fixed mode for 1 epoch, a resume
     to 2 (step count, CSV rows, and api.load_encoder reading the app's
     checkpoint), then padded mode for 1 epoch with the launches of the
     masked kernels per update checked;
  9. fp32 kernels (the frozen evals with use_bfloat16: false): H1-fp32 at
     (B=2, N=1568, c=64) and (B=1, N=1568, c=80), H3-fp32 at ViT-L's and
     ViT-H's fc1, against their plain versions in fp32 (TF32 off), each
     called twice for bit-equal outputs, timed
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
 12. head-major kernels (vit_tiny's encoder, 3 heads of 64, which has no
     token-major head split): H4 (forward) at vit_tiny's serving and target
     shapes, the padded context rungs with a key mask and a 1-query
     cross-attention; H7 (merged backward) at the fixed contexts and the
     masked rungs (timed through its C entry, queued behind a spin kernel,
     beside its Python wrapper); H5 + H6 (the split backward) at (24, 3, 1568, 64), once
     alone and through flash_attention_packed under autograd without and
     with a key mask (the launches the JSON line reports), and H5 in each
     instance (c = 64 and c = 32 at 6 heads, masked and not); masked keys'
     dk and dv exactly 0;
 13. H1 and H2 at head dim 128 (vit_tiny's 384-wide predictor, 3 heads),
     masked and not, at the predictor's shapes;
 14. vit_tiny serving: a seeded vit_tiny .pth.tar and probe through
     api.load_encoder / load_classifier, 12 H4 and no H1 or H3 per request,
     features against the plain versions;
 15. vit_tiny pretraining: vitl16.yaml with model_name vit_tiny through
     build_train_step (TRAIN_STEPS updates at B=24, profile, the B=2 update
     against the plain versions) and through the app (fixed 1 epoch, a
     resume, padded 1 epoch), with the launches per update of the routes:
     H4 for the target and the contexts, H7 for the contexts' backward, H1
     and H2 c=128 for the predictor, no H3 (K=192 takes the eager fc1).
 16. K11: H8 (fc1 + A&S erf GELU writing z) and H8-fp32 against their
     plain version at the force update's context fc1 shapes (M = 24 x 376
     and 24 x 96, K=1024, F=4096), LinearGelu's gradients through H8
     against the plain version (bf16 and fp32, the fp32 launches those of
     linear_gelu under autograd), then, after phase 6, the vitl16.yaml
     update with the encoder's ``fused_mlp='force'`` (TRAIN_STEPS updates,
     profile, the B=2 check; H8 24 per context forward, H3 24 for the
     target) and the A/B against the default update in turns, with each
     variant's peak memory.
 17. the tube mask mode (data.mask_type random_tube, one mask of ratio
     0.9, the reference's default) at vitl16.yaml: 3 updates at B=24
     (context 152 tokens, predictor 1568), one B=2 update against the
     plain versions from the seeded state, then the app fixed 1 epoch and
     padded 1 epoch (one tier of static caps, 256 and 1536: the masked
     H1/H2);
 18. activation checkpointing at vitl16.yaml, B=24: from one seeded
     state, one update with remat False, True and 'attn' (encoder and
     predictor) each, whose loss, metrics, parameters and AdamW moments
     must be bit-equal, then two more of each in turns (ms, peak
     memory) and one profiled; the launches per update those of False
     ('attn') or one more H1 per trainable attention block (True);
 19. ViT-H: H1 c=80 at the vith16 target (B=24, N=1568) and the
     vith16_384 target (B=10, N=4608), both H2 kernels at c=80 at the
     vith16 context and H3 at ViT-H's fc1, against their plain versions
     and timed; every other token-major call shape of both configs'
     updates (the vith16_384 contexts, c=80, and predictors, c=24->32, at
     B=10: H1 and both H2 kernels) and the vith16_384 fp32 eval's train
     step (H1-fp32 c=80 at B=8, N=4608; H3-fp32 at M=8*4608) against their
     plain versions (one sample at a time where a batch's fp32 scores pass
     PLAIN_BATCH_BYTES); then vith16.yaml (B=24) and vith16_384.yaml (B=10) with the app's
     default remat ('attn'): TRAIN_STEPS updates each through
     build_train_step (one profiled more) and the app (vith16: fixed 1 epoch of 2 updates, a
     resume to 2 epochs, padded 1 epoch; vith16_384: fixed 1 epoch), each
     ~10 GB checkpoint written in the temporary folder and removed;
 20. the K400 16x8x3 evals of ViT-H (vith16_k400_16x8x3.yaml,
     vith16_384_k400_16x8x3.yaml) in bf16 (batch 4: 2 train steps, 1 val
     step) and fp32 (batch 1: 2 and 1) on a seeded ViT-H .pth.tar, the
     features of each first train and val batch's first VITH_VIEWS_CHECKED
     (segments, views) through the kernels against the plain versions.
 21. data parallelism (``phase_dist``), after phase 8: a vitl16.yaml
     update at B=24 in a 1-rank NCCL group (its collectives run) against
     the same update with no group, bit for bit; 2 gloo ranks sharing the
     card (spawned, the kernels built once by this process), 12 clips
     each, against the 1-rank update of their 24 clips, within limits
     DIST_LIMIT_FACTOR times the plain versions' spread on the same
     inputs (measured first and printed), then fsdp=2 against fsdp=1 after
     2 updates, bit-equal; the 2-rank app on vitl16.yaml (24 clips a rank,
     fixed, a resume, padded) through apps/main_distributed.py's
     in-cluster mode (a SLURM environment of two one-GPU nodes): one
     checkpoint writer, equal CSV losses, each rank's launches those of
     the 1-rank app; the 2-rank K400 16x8x3 bf16 eval, whose val pass
     over 10 videos counts each once and matches a 1-rank val pass of the
     same probe.
 22. off-size serving (``phase_serve_off_size``), after phase 5: the seeded
     ViT-L/16 (224 px, 16 frames) encodes clips of 16 x 256 px (N=2048)
     and 8 x 224 px (N=784) through api.Encoder.encode, the pos-embed
     table resized as jax.image.resize does; each request's launches
     checked whole (H1 c=64 counted at its N), the features against the
     plain versions;
 23. the image eval through evals.main (``phase_image_eval``), after phase
     11: vitl16_in1k.yaml's geometry on 48 + 16 seeded 320x240 JPEGs in 4
     classes written with PIL, 8 loader workers in the default process
     pool (forked after CUDA is up), then in threads; each step's launches,
     the probe checkpoint, the host share of each, the process pool's
     features against the plain versions;
 24. the diffusion-mode predictor (``phase_diffusion``, use_mask_tokens
     false), after phase 16: 3 vitl16.yaml updates at B=24, one profiled,
     and the B=2 checks from the seeded and the trained state;
 25. the app with logging.profile_steps [1, 1] and log_resources
     (``phase_app_instruments``), after phase 8: vitl16.yaml, synthetic,
     2 updates; the Chrome trace of the second and the resource CSV
     written, the device's busy share of the traced window.
The native decoder has no phase: the card's machine has no FFmpeg
libraries (PERF.md §6), so it is held against the JAX package's on the
CPU only (tests/test_torch_native.py).
Phases 12-13 run after phase 7, phases 14-15 after phase 8, phase 16's
kernel checks after phase 9, phases 17-20 after phase 15. Launch counts are checked as whole dicts of
every counter (``_counts``): a kernel that should not run must count 0.
H1 (each head dim, masked or not), H1-fp32, H2 likewise, H3, H4, H5, H6,
H7, H8 and H8-fp32 are each called a second time on the same inputs wherever
they are held against their plain versions, and must give bit-equal outputs,
and vit_tiny's B=2 update is taken twice from one state and must give
bit-equal metrics, parameters and moments.
The line before the last is a JSON summary of the kernels; the last line
is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import json
import os
import re
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
H8_GRAD_REL = 2.0**-6  # LinearGelu's dx, dw, db through H8 vs its plain version, per
                       # gradient |d| <= 2^-6 * max|ref| (bf16): the backward is the same
                       # plain torch; only the rare z rounding flips of H3_REL enter it
F32_TOL = 1e-4     # H1-fp32 |o|, |lse| abs; H3-fp32 |d| <= 1e-4 * max(|ref|, 1): fp32
                   # everywhere, so only the order of the fp32 sums differs
# (B, N, H, c) of H1-fp32 and (M, K, F) of H3-fp32: ViT-L and ViT-H, then
# the fp32 video eval's launch shapes (batch 1: the train step's 8 clips,
# the val step's 24). The first shape of each is the one the JSON line reports.
F32_H1_SHAPES = ((2, 1568, 16, 64), (1, 1568, 16, 80), (8, 1568, 16, 64), (24, 1568, 16, 64))
F32_H3_SHAPES = ((8 * 1568, 1024, 4096), (4 * 1568, 1280, 5120), (24 * 1568, 1024, 4096))
# (M, K, F, outputs) of the A/B mode's fp32 fc1 rows: H3-fp32 at every
# F32_H3_SHAPES row, H8-fp32 at the force update's long context
F32_H3_SHAPES_AB = tuple(s + (1,) for s in F32_H3_SHAPES) + ((9024, 1024, 4096, 2),)
F32_FEAT_COS_MIN = 0.99999  # fp32 eval features, kernels vs plain: only the order
                            # of fp32 sums differs
PROB_TOL = 1e-3
EVAL_BF16_ENTRIES = (8, 6)  # (train, val) synthetic videos of the bf16 video eval at
                            # batch 4: 2 train steps, 2 val steps (the last one padded)
EVAL_F32_ENTRIES = (2, 1)   # the fp32 video eval at batch 1: 2 train, 1 val step
IMAGE_TRAIN_STEPS = 2
APP_IPE = 3        # app updates per epoch (the config's ipe is 300)
TUBE_MASKS = [{"ratio": 0.9}]  # data.mask_type random_tube at the reference's default ratio
VITH_EVALS = ("vith16_k400_16x8x3.yaml", "vith16_384_k400_16x8x3.yaml")
VITH_EVAL_ENTRIES = (8, 4)  # the ViT-H bf16 evals at batch 4: 2 train steps, 1 val step
VITH_VIEWS_CHECKED = (2, 1)  # (segments, views) of each ViT-H eval sample whose features
                             # are held against the plain versions
# (c, N) of the H1 launches that stand in for K2: where the JAX package's
# _pick_tm_fwd takes the kv-tiled forward on a driven path, vith16_384's
# encoder (tests/test_torch_dispatch.py::test_jax_tm_kernel_picks); counted
# at the launch by fa.launches_by_tokens
K2_C, K2_N = 80, 4608
K2_KEY = f"h1_c{K2_C}_n{K2_N}"
HM_O_TOL, HM_LSE_TOL = H1_O_TOL, H1_LSE_TOL  # H4 vs its plain version: the same p rounding
                                             # against a running vs the global max as H1


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
        o, lse, err_o = _check_h1(torch, f"H1 B={b} N={n} H={h} c={c}", qkv, h, scale)
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
        del qkv, o, lse
    report["h1"] = h1

    h3 = {"max_abs_err": 0.0}
    k, f = 1024, 4096
    w = (torch.randn((f, k), generator=gen, device=dev) / 32).to(torch.bfloat16)
    bias = torch.randn((f,), generator=gen, device=dev) * 0.1
    for m in (2 * 1568, 1570, TRAIN_BATCH * n_train):
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        err = _check_h3(torch, f"H3 M={m} K={k} F={f}", x, w, bias)
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
            h3["bound"] = fc1_bound_ms(m, k, f, outputs=1)
            log(f"H3 ViT-L fc1 time: kernel {h3['ms']:.4f} ms, plain {h3['plain_ms']:.4f} ms, "
                f"bound {h3['bound'][0]:.4f} ms ({h3['bound'][2]}); library "
                f"(_addmm_activation, tanh-GELU epilogue) {h3['library_ms']:.4f} ms; the bf16 "
                f"F.linear GEMM alone (a floor) {gemm_ms:.4f} ms")
        del x
    report["h3"] = h3
    return report


def phase_f32_kernels(torch):
    """H1-fp32 and H3-fp32 (the frozen evals with use_bfloat16: false)
    against their plain versions on the card, in fp32 on both sides (each
    called twice for bit-equal outputs), with times, bounds (FFMA peak,
    exp2, bytes) and the fp32 library calls."""
    from jepa_tpu_torch.ops import flash_attention as fa
    from jepa_tpu_torch.ops import fused_mlp as fm

    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError("TF32 is on: the fp32 plain versions would not be fp32")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rep = {"h1": {"max_abs_err": 0.0}, "h3": {"max_abs_err": 0.0}, "by_shape": {}}
    for b, n, h, c in F32_H1_SHAPES:
        qkv = torch.randn((b, n, 3 * h * c), generator=gen, device="cuda")
        scale = c**-0.5
        err = _check_h1_f32(torch, f"H1-fp32 B={b} N={n} H={h} c={c}", qkv, h, scale)
        rep["h1"]["max_abs_err"] = max(rep["h1"]["max_abs_err"], err)
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
        rep["by_shape"][(b, n, h, c)] = dict(r, max_abs_err=err)
        del qkv
    for m, k, f in F32_H3_SHAPES:
        x = torch.randn((m, k), generator=gen, device="cuda")
        w = torch.randn((f, k), generator=gen, device="cuda") / 32
        bias = torch.randn((f,), generator=gen, device="cuda") * 0.1
        err = _check_f32_fc1(torch, f"H3-fp32 M={m} K={k} F={f}", x, w, bias)
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
        rep["by_shape"][(m, k, f)] = dict(r, max_abs_err=err)
        del x, w, bias
    return rep


def _check_flips(label, got, ref) -> float:
    """A bf16 fc1 output against its plain version: every |d| <= H3_REL *
    max(|ref|, 1) and under 1 % of the elements differing (rare flips of
    z's bf16 rounding, the fp32 sums running in another order). Returns
    max |d|."""
    if not _finite(got):
        raise RuntimeError(f"{label}: non-finite output")
    d = (got.float() - ref.float()).abs()
    err = d.max().item()
    excess = (d - H3_REL * ref.float().abs().clamp(min=1)).max().item()
    differ = (d > 0).float().mean().item()
    log(f"{label}: max|d| {err:.3e}, worst margin {excess:.3e} (tol |d| <= "
        f"2^-6*max(|ref|,1)), share of elements that differ {differ:.2e}")
    if excess > 0 or differ > 1e-2:
        raise RuntimeError(f"{label} disagrees with its plain version")
    return err


def _same_bits(label, first, second) -> None:
    """A kernel called twice on the same inputs must give bit-equal outputs."""
    same = [a.equal(b) for a, b in zip(first, second)]
    log(f"{label}: second call on the same inputs bit-equal {same}")
    if not all(same):
        raise RuntimeError(f"{label} is not deterministic: a second call differs")


def _by_sample(torch, by_sample, fn, *args):
    """fn(*args), or with ``by_sample`` fn on each sample of the batched
    tensor arguments (None and numbers passed as they are) and the results
    concatenated: the same function at a sample's share of the plain
    attention's fp32 scores."""
    if not by_sample:
        return fn(*args)
    b = args[0].shape[0]
    part = lambda a, i: a[i:i + 1] if torch.is_tensor(a) else a
    outs = [fn(*(part(a, i) for a in args)) for i in range(b)]
    if torch.is_tensor(outs[0]):
        return torch.cat(outs)
    return tuple(torch.cat(t) for t in zip(*outs))


def _check_h1(torch, label, qkv, h, scale, mask=None, by_sample=False):
    """H1 on qkv (with a key mask or none) against its plain version on the
    card (finite, |do| <= H1_O_TOL, |dlse| <= H1_LSE_TOL; ``by_sample``: the
    plain version one sample at a time), then called a second time on the
    same inputs, which must give bit-equal o and lse. Returns (o, lse,
    max|do|)."""
    from jepa_tpu_torch.ops import flash_attention as fa

    o, lse = fa.flash_self_attention_cuda(qkv, h, scale, mask)
    o_ref, lse_ref = _by_sample(torch, by_sample, fa.flash_self_attention_ref, qkv, h, scale,
                                mask)
    torch.cuda.synchronize()
    if not (_finite(o) and _finite(lse)):
        raise RuntimeError(f"{label}: non-finite output")
    err_o = (o.float() - o_ref.float()).abs().max().item()
    err_l = (lse - lse_ref).abs().max().item()
    log(f"{label}: max|do| {err_o:.3e} (tol {H1_O_TOL}) max|dlse| {err_l:.3e} "
        f"(tol {H1_LSE_TOL})")
    if not (err_o <= H1_O_TOL and err_l <= H1_LSE_TOL):
        raise RuntimeError(f"{label} disagrees with its plain version")
    _same_bits(label, (o, lse), fa.flash_self_attention_cuda(qkv, h, scale, mask))
    return o, lse, err_o


def _check_h2(torch, label, qkv, do, o, lse, h, scale, c_real, mask=None, by_sample=False):
    """Both H2 kernels on qkv (with a key mask or none) against their plain
    versions on the card (``by_sample``: one sample at a time): finite, each
    gradient within H2_REL * max|ref|, the pad lanes past c_real exactly 0
    and, with a mask, the masked keys' dk and dv exactly 0; then a second
    call on the same inputs, which must be bit-equal. Returns (delta,
    {gradient: max|d|})."""
    from jepa_tpu_torch.ops import flash_attention as fa

    delta = fa.attention_delta(do, o, h)
    dqkv = fa.flash_self_attention_bwd_cuda(qkv, do, lse, delta, h, scale, mask)
    ref = _by_sample(torch, by_sample, fa.flash_self_attention_bwd_ref, qkv, do, lse, delta, h,
                     scale, mask)
    torch.cuda.synchronize()
    if not _finite(dqkv):
        raise RuntimeError(f"{label}: non-finite output")
    _same_bits(f"{label} dq/dk/dv", (dqkv,),
               (fa.flash_self_attention_bwd_cuda(qkv, do, lse, delta, h, scale, mask),))
    b, n, w3 = qkv.shape
    hc = w3 // 3
    c = hc // h
    errs = {}
    for i, name in enumerate(("dq", "dk", "dv")):
        got = dqkv[..., i * hc:(i + 1) * hc].float()
        want = ref[..., i * hc:(i + 1) * hc].float()
        err = (got - want).abs().max().item()
        tol = H2_REL * want.abs().max().item()
        pad = got.reshape(b, n, h, c)[..., c_real:].abs().max().item() if c_real < c else 0.0
        keys = mask is not None and name != "dq"
        masked = got[~mask].abs().max().item() if keys else 0.0
        log(f"{label} c={c_real}->{c}: {name} max|d| {err:.3e} (tol {tol:.3e} = 2^-6 * "
            f"max|ref|), pad lanes max {pad:.1e}"
            + (f", masked keys max|{name}| {masked:.1e} (must be 0)" if keys else ""))
        if not (err <= tol and pad == 0.0 and masked == 0.0):
            raise RuntimeError(f"{label} {name} disagrees with its plain version")
        errs[name] = err
    return delta, errs


def _check_h4(torch, label, q, k, v, scale, mask=None):
    """H4 on head-major q, k, v (with a key mask or none) against its plain
    version on the card (finite, |do| <= HM_O_TOL, |dlse| <= HM_LSE_TOL),
    then a second call on the same inputs, which must be bit-equal.
    Returns (o, lse, max|do|)."""
    from jepa_tpu_torch.ops import flash_attention as fa

    o, lse = fa.flash_fwd_hm_cuda(q, k, v, scale, mask)
    o_ref, lse_ref = fa.flash_fwd_hm_ref(q, k, v, scale, mask)
    torch.cuda.synchronize()
    err_o = (o.float() - o_ref.float()).abs().max().item()
    err_l = (lse - lse_ref).abs().max().item()
    log(f"{label}: max|do| {err_o:.3e} (tol {HM_O_TOL}) max|dlse| {err_l:.3e} (tol {HM_LSE_TOL})")
    if not (_finite(o) and _finite(lse) and err_o <= HM_O_TOL and err_l <= HM_LSE_TOL):
        raise RuntimeError(f"{label} disagrees with its plain version")
    _same_bits(label, (o, lse), fa.flash_fwd_hm_cuda(q, k, v, scale, mask))
    return o, lse, err_o


def _check_h1_f32(torch, label, qkv, h, scale, by_sample=False):
    """H1-fp32 on fp32 qkv against its plain version on the card (finite,
    |do| and |dlse| <= F32_TOL; ``by_sample``: the plain version one sample
    at a time), then a second call on the same inputs, which must be
    bit-equal. Returns max(|do|, |dlse|)."""
    from jepa_tpu_torch.ops import flash_attention as fa

    o, lse = fa.flash_self_attention_cuda(qkv, h, scale)
    o_ref, lse_ref = _by_sample(torch, by_sample, fa.flash_self_attention_ref, qkv, h, scale)
    torch.cuda.synchronize()
    if not (_finite(o) and _finite(lse)):
        raise RuntimeError(f"{label}: non-finite output")
    err_o = (o - o_ref).abs().max().item()
    err_l = (lse - lse_ref).abs().max().item()
    del o_ref, lse_ref
    log(f"{label}: max|do| {err_o:.3e} max|dlse| {err_l:.3e} (tol {F32_TOL} each)")
    if not (err_o <= F32_TOL and err_l <= F32_TOL):
        raise RuntimeError(f"{label} disagrees with its plain version")
    _same_bits(label, (o, lse), fa.flash_self_attention_cuda(qkv, h, scale))
    return max(err_o, err_l)


def _check_h3(torch, label, x, w, bias) -> float:
    """H3 against its plain version under the flip rule, then called a
    second time on the same inputs, which must be bit-equal. Returns max|d|."""
    from jepa_tpu_torch.ops import fused_mlp as fm

    y = fm.linear_gelu_cuda(x, w, bias)
    torch.cuda.synchronize()
    err = _check_flips(label, y, fm.linear_gelu_ref(x, w, bias))
    _same_bits(label, (y,), (fm.linear_gelu_cuda(x, w, bias),))
    return err


def _check_h8(torch, label, x, w, bias) -> float:
    """H8's o and z against its plain version under the flip rule, then a
    second call, bit-equal. Returns max|d| over o and z."""
    from jepa_tpu_torch.ops import fused_mlp as fm

    o, z = fm.linear_gelu_z_cuda(x, w, bias)
    torch.cuda.synchronize()
    o_ref, z_ref = fm.linear_gelu_z_ref(x, w, bias)
    err = max(_check_flips(f"{label} o", o, o_ref), _check_flips(f"{label} z", z, z_ref))
    _same_bits(label, (o, z), fm.linear_gelu_z_cuda(x, w, bias))
    return err


def _check_f32_fc1(torch, label, x, w, bias, z=False) -> float:
    """H3-fp32 (or, with ``z``, H8-fp32's o and z) on fp32 x, w, b against
    its plain version on the card: finite, |d| <= F32_TOL * max(|ref|, 1);
    then a second call on the same inputs, which must be bit-equal.
    Returns max|d|."""
    from jepa_tpu_torch.ops import fused_mlp as fm

    if z:
        got, want = fm.linear_gelu_z_cuda(x, w, bias), fm.linear_gelu_z_ref(x, w, bias)
    else:
        got, want = (fm.linear_gelu_cuda(x, w, bias),), (fm.linear_gelu_ref(x, w, bias),)
    torch.cuda.synchronize()
    worst = 0.0
    for name, a, b in zip(("o", "z"), got, want):
        d = (a - b).abs()
        err = d.max().item()
        excess = (d - F32_TOL * b.abs().clamp(min=1)).max().item()
        log(f"{label}{f' {name}' if z else ''}: max|d| {err:.3e}, worst margin {excess:.3e} "
            f"(tol |d| <= {F32_TOL}*max(|ref|,1))")
        if not (_finite(a) and excess <= 0):
            raise RuntimeError(f"{label} {name} disagrees with its plain version")
        worst = max(worst, err)
    del want
    _same_bits(label, got, fm.linear_gelu_z_cuda(x, w, bias) if z
               else (fm.linear_gelu_cuda(x, w, bias),))
    return worst


HM_BWD_GRADS = {"dq": ("dq",), "dkv": ("dk", "dv"), "dqkv": ("dq", "dk", "dv")}


def _check_hm_bwd(torch, kind, label, q, k, v, do, scale, mask=None, out=None):
    """A head-major backward, H5 (``kind`` "dq", the split dq), H6 ("dkv",
    the split dk/dv) or H7 ("dqkv", merged), on q, k, v and do, its lse and
    delta from H4, against its plain version on the card: each gradient
    within H2_REL * max|ref| and, with a key mask, the masked keys' dk and
    dv exactly 0 (``_check_grads``); written into ``out`` when given; then
    a second call on the same inputs, which must be bit-equal. Returns
    (lse, delta, max|d|)."""
    from jepa_tpu_torch.ops import flash_attention as fa

    cuda = getattr(fa, f"flash_bwd_{kind}_hm_cuda")
    grads = lambda t: t if isinstance(t, tuple) else (t,)  # noqa: E731
    o, lse = fa.flash_fwd_hm_cuda(q, k, v, scale, mask)
    delta = fa.hm_delta(do, o)
    got = grads(cuda(q, k, v, do, lse, delta, scale, mask, out=out))
    want = grads(getattr(fa, f"flash_bwd_{kind}_hm_ref")(q, k, v, do, lse, delta, scale, mask))
    torch.cuda.synchronize()
    got = tuple(t.clone() for t in got)
    _same_bits(label, got, grads(cuda(q, k, v, do, lse, delta, scale, mask, out=out)))
    return lse, delta, _check_grads(label, got, want, HM_BWD_GRADS[kind], mask)


def _hm_args(fa, q, k, v, scale, mask=None, **ops):
    """The HmArgs of one head-major C entry call (``ops``: o, do, lse, delta,
    dq, dk, dv, ws), for timing the entry without its Python wrapper."""
    b, h, nq, _ = q.shape
    hm = fa._HmArgs(B=b, H=h, Nq=nq, Nk=k.shape[2], qscale=scale * fa._LOG2E, scale=scale)
    m8 = None if mask is None else mask.byte().contiguous()
    for name, t in dict(q=q, k=k, v=v, kvm=m8, **ops).items():
        if t is not None:
            setattr(hm, name, t.data_ptr())
            if t.dim() == 4:
                setattr(hm, f"{name}_s", (ctypes.c_int * 3)(*t.stride()[:3]))
    hm._keep = m8  # the mask's uint8 copy lives as long as the struct
    return hm


def hm_entry(torch, kind, c, hm):
    """A zero-argument call of the head-major C entry ``kind`` (fwd, dq, dkv,
    dqkv) at head dim c on ``hm`` (``_hm_args``), on the current stream."""
    from jepa_tpu_torch.ops import _build

    entry = f"jt_flash_hm_{kind}_c{c}"
    fn = getattr(_build.load_library(), entry)
    return lambda: _build.check(fn(ctypes.addressof(hm), torch.cuda.current_stream().cuda_stream),
                                entry)


def phase_edges(torch):
    """The Hopper kernels at the edges of their tiles (H1: 128 query rows
    and 128 keys a tile; H2: 128 rows a block, 64-key stages in dq, 64- or
    32-row q stages in dk/dv; H4: 128 query rows, 128 keys a stage; H3 and
    H8: 128 x 128 output tiles, 64-deep k panels), each against its plain
    version and called twice for bit-equal outputs: H1 and H2 at N = 40
    (one partial tile) and at N = 129 (1 mod 128) for every head dim; H1
    and H2 with a key mask whose keys [128, 384), two whole key tiles
    mid-sequence, are all pads, at c = 24->32, 64 and 128 (H2's masked
    keys' dk and dv exactly 0); H4 at N = 40 and 129 on permuted views of
    a token-major projection, at 1 and 376 queries over 1568 keys, and
    masked on the planes of a packed [3, B, H, N, c] qkv; H6 (128 kv rows
    a block, 64-row q stages) at N = 40 and 129 at c = 64 and 32 on
    permuted views, at 1 and 376 queries over 1568 keys, and masked with
    keys [128, 384) all pads on the planes of a packed qkv, writing the
    planes of a packed dqkv (masked keys' dk and dv exactly 0); H5 (128 q
    rows a block, 64-key stages) likewise, also at 376 queries over 1568
    keys at c = 32 and with the 1-query probe masked, writing the dq plane
    of a packed dqkv; H1-fp32 (128 query rows a block, 32-key tiles) at N
    = 40, 129 and 333 at c = 64 and 80; H3 and H8 at M = 8, 200 and 2305;
    H8 at an identity probe that feeds its epilogue every bf16 z; H7 (H6's
    blocks, each consumer warpgroup's 64 kv rows a dQ k-block) at N = 40
    and 129 at c = 64 and 32 on permuted views, at 1 and 376 queries over
    640 keys, and masked with
    keys [128, 384) all pads on the planes of a packed qkv, writing the
    planes of a packed dqkv in place (masked keys' dk and dv exactly 0);
    H3-fp32 and H8-fp32 (128 x 128 output tiles, 16-deep k panels) at M =
    8, 200, 333 and 2305 with ViT-L's (K=1024, F=4096) and ViT-H's (K=1280,
    F=5120) fc1."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    rng = np.random.default_rng(SEED + 7)
    for b, n, h, c, c_real in ((2, 40, 16, 32, 24), (2, 40, 16, 64, 64), (1, 40, 16, 80, 80),
                               (2, 40, 3, 128, 128), (2, 129, 16, 32, 24), (2, 129, 16, 64, 64),
                               (1, 129, 16, 80, 80), (2, 129, 3, 128, 128)):
        qkv, do = _attn_inputs(torch, gen, b, n, h, c, c_real)
        label = f"B={b} N={n} H={h}"
        o, lse, _ = _check_h1(torch, f"H1 edge {label} c={c_real}->{c}", qkv, h, c_real**-0.5)
        _check_h2(torch, f"H2 edge {label}", qkv, do, o, lse, h, c_real**-0.5, c_real)
    for b, n, h, c, c_real in ((4, 640, 16, 32, 24), (4, 640, 16, 64, 64), (4, 640, 3, 128, 128)):
        qkv, do = _attn_inputs(torch, gen, b, n, h, c, c_real)
        mask = padded_key_mask(torch, rng, b, n, 0)
        mask[:, 128:384] = False
        label = f"B={b} N={n} H={h}, keys [128, 384) all pads"
        o, lse, _ = _check_h1(torch, f"masked H1 edge {label}, c={c_real}->{c}", qkv, h,
                              c_real**-0.5, mask)
        _check_h2(torch, f"masked H2 edge {label},", qkv, do, o, lse, h, c_real**-0.5, c_real,
                  mask)
    for b, h, nq, nk, c in ((2, 3, 40, 40, 64), (2, 3, 129, 129, 64), (2, 3, 129, 129, 32),
                            (2, 3, 1, 1568, 64), (2, 3, 376, 1568, 64)):
        q, k, v, _ = _hm_inputs(torch, gen, b, h, nq, nk, c)
        mask = padded_key_mask(torch, rng, b, nk, 0) if nq == 1 else None
        how = "permuted views of [B, N, 3, H, c]" if nq == nk else "[B, H, N, c] tensors"
        _check_h4(torch, f"H4 edge B={b} H={h} Nq={nq} Nk={nk} c={c}{' masked' if nq == 1 else ''}"
                  f", {how}", q, k, v, c**-0.5, mask)
    q, k, v = torch.randn((3, 4, 3, 640, 64), generator=gen, device="cuda").to(
        torch.bfloat16).unbind(0)
    mask = padded_key_mask(torch, rng, 4, 640, 0)
    mask[:, 128:384] = False
    _check_h4(torch, "masked H4 edge B=4 H=3 N=640 c=64, planes of a packed [3, B, H, N, c], "
              "keys [128, 384) all pads", q, k, v, 64**-0.5, mask)
    # H6 (128 kv rows a block, 64-row q stages: the grid runs over Nk, the
    # stages over Nq) and H5 (128 q rows a block, 64-key stages: the grid
    # runs over Nq, the stages over Nk); H5 also masked at the 1-query probe
    for kind, name, more in (("dkv", "H6", ()), ("dq", "H5", ((2, 3, 376, 1568, 32),))):
        for b, h, nq, nk, c in ((2, 3, 40, 40, 64), (2, 3, 129, 129, 64), (2, 3, 40, 40, 32),
                                (2, 3, 129, 129, 32), (2, 3, 1, 1568, 64),
                                (2, 3, 376, 1568, 64)) + more:
            q, k, v, do = _hm_inputs(torch, gen, b, h, nq, nk, c)
            mask = padded_key_mask(torch, rng, b, nk, 0) if kind == "dq" and nq == 1 else None
            how = "permuted views of [B, N, 3, H, c]" if nq == nk else "[B, H, N, c] tensors"
            _check_hm_bwd(torch, kind, f"{name} edge B={b} H={h} Nq={nq} Nk={nk} c={c}"
                          f"{'' if mask is None else ' masked'}, {how}", q, k, v, do, c**-0.5,
                          mask)
        for c in (64, 32):
            qkv = torch.randn((3, 4, 3, 640, c), generator=gen, device="cuda").to(torch.bfloat16)
            do = torch.randn((4, 3, 640, c), generator=gen, device="cuda").to(torch.bfloat16)
            mask = padded_key_mask(torch, rng, 4, 640, 0)
            mask[:, 128:384] = False
            dqkv = torch.zeros_like(qkv)
            _check_hm_bwd(torch, kind, f"masked {name} edge B=4 H=3 N=640 c={c}, planes of a "
                          "packed [3, B, H, N, c] in and out, keys [128, 384) all pads",
                          *qkv.unbind(0), do, c**-0.5, mask,
                          out=(dqkv[1], dqkv[2]) if kind == "dkv" else dqkv[0])
    # H1-fp32: 128 query rows a block, 32-key tiles
    for b, n, h, c in ((2, 40, 16, 64), (2, 129, 16, 64), (2, 333, 16, 64), (1, 40, 16, 80),
                       (1, 129, 16, 80), (1, 333, 16, 80)):
        qkv = torch.randn((b, n, 3 * h * c), generator=gen, device="cuda")
        _check_h1_f32(torch, f"H1-fp32 edge B={b} N={n} H={h} c={c}", qkv, h, c**-0.5)
    k, f = 1024, 4096
    w = (torch.randn((f, k), generator=gen, device="cuda") / 32).to(torch.bfloat16)
    bias = torch.randn((f,), generator=gen, device="cuda") * 0.1
    for m in (8, 200, 2305):
        x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        _check_h3(torch, f"H3 edge M={m} K={k} F={f}", x, w, bias)
        _check_h8(torch, f"H8 edge M={m} K={k} F={f}", x, w, bias)
    # an identity probe: x holds every finite bf16 value once (non-finite
    # patterns as 0), w = I, b = 0, so z = x and H8's epilogue meets every
    # bf16 z
    bits = torch.arange(-32768, 32768, dtype=torch.int32, device="cuda").to(torch.int16)
    x = bits.view(torch.bfloat16).reshape(512, 128)
    x = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
    eye = torch.eye(128, device="cuda", dtype=torch.bfloat16)
    _check_h8(torch, "H8 identity probe, every bf16 z", x, eye, torch.zeros(128, device="cuda"))
    # H7: 128 kv rows a block, 64-row q stages, 64-row dQ k-blocks
    for b, h, nq, nk, c in ((2, 3, 40, 40, 64), (2, 3, 129, 129, 64), (2, 3, 40, 40, 32),
                            (2, 3, 129, 129, 32), (2, 3, 1, 640, 64), (2, 3, 376, 640, 64)):
        q, k, v, do = _hm_inputs(torch, gen, b, h, nq, nk, c)
        how = "permuted views of [B, N, 3, H, c]" if nq == nk else "[B, H, N, c] tensors"
        _check_hm_bwd(torch, "dqkv", f"H7 edge B={b} H={h} Nq={nq} Nk={nk} c={c}, {how}", q, k, v,
                      do, c**-0.5)
    for c in (64, 32):
        qkv = torch.randn((3, 4, 3, 640, c), generator=gen, device="cuda").to(torch.bfloat16)
        do = torch.randn((4, 3, 640, c), generator=gen, device="cuda").to(torch.bfloat16)
        mask = padded_key_mask(torch, rng, 4, 640, 0)
        mask[:, 128:384] = False
        dqkv = torch.zeros_like(qkv)
        _check_hm_bwd(torch, "dqkv", f"masked H7 edge B=4 H=3 N=640 c={c}, planes of a packed "
                      "[3, B, H, N, c] in and out, keys [128, 384) all pads", *qkv.unbind(0), do,
                      c**-0.5, mask, out=dqkv.unbind(0))
    # H3-fp32 and H8-fp32: 128 x 128 output tiles, 16-deep k panels
    for k, f in ((1024, 4096), (1280, 5120)):
        w = torch.randn((f, k), generator=gen, device="cuda") / 32
        bias = torch.randn((f,), generator=gen, device="cuda") * 0.1
        for m in (8, 200, 333, 2305):
            x = torch.randn((m, k), generator=gen, device="cuda")
            _check_f32_fc1(torch, f"H3-fp32 edge M={m} K={k} F={f}", x, w, bias)
            _check_f32_fc1(torch, f"H8-fp32 edge M={m} K={k} F={f}", x, w, bias, z=True)


def _linear_gelu_grads(torch, fm, x, w, bias, dy):
    """(o, dx, dw, db) of the public linear_gelu under autograd."""
    x, w, bias = (t.detach().requires_grad_(True) for t in (x, w, bias))
    o = fm.linear_gelu(x, w, bias)
    o.backward(dy)
    return o.detach(), x.grad, w.grad, bias.grad


def phase_k11(torch, ms):
    """H8 (K11's port: fc1 + A&S erf GELU writing z) against
    linear_gelu_z_ref at the force update's context fc1 shapes (``ms`` =
    TRAIN_BATCH x each context's tokens, K=1024, F=4096), o and z under
    H3's flip rule, each called twice for bit-equal outputs; LinearGelu's
    gradients through H8 against the plain version; H8-fp32 the same at
    the first shape, its launches those of linear_gelu under autograd here.
    Times by CUDA events, bounds (MMA or FFMA FLOP, or the bytes of x, w, b,
    o and z), and the library's GEMM + GELU epilogue, which writes no z."""
    from jepa_tpu_torch.ops import flash_attention as fa
    from jepa_tpu_torch.ops import fused_mlp as fm

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    k, f = 1024, 4096
    rep = {"z": {"max_abs_err": 0.0}, "z_f32": {"max_abs_err": 0.0}, "rows": {}}
    w = (torch.randn((f, k), generator=gen, device="cuda") / 32).to(torch.bfloat16)
    bias = torch.randn((f,), generator=gen, device="cuda") * 0.1
    for m in ms:
        x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        err = _check_h8(torch, f"H8 M={m} K={k} F={f}", x, w, bias)
        rep["z"]["max_abs_err"] = max(rep["z"]["max_abs_err"], err)
        bias_lp = bias.to(torch.bfloat16)
        r = dict(ms=time_ms(torch, lambda: fm.linear_gelu_z_cuda(x, w, bias)),
                 plain_ms=time_ms(torch, lambda: fm.linear_gelu_z_ref(x, w, bias)),
                 # cuBLASLt's GEMM + bias + tanh-GELU epilogue: no z, not H8's
                 # GELU to the bit; timed only, never used
                 library_ms=time_ms(torch, lambda: torch._addmm_activation(
                     bias_lp, x, w.t(), use_gelu=True)),
                 bound=fc1_bound_ms(m, k, f, outputs=2))
        log(f"H8 M={m} K={k} F={f} time: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library (_addmm_activation, no z) {r['library_ms']:.4f} ms, bound "
            f"{r['bound'][0]:.4f} ms ({r['bound'][2]})")
        rep["rows"][m] = r
        del x
    rep["z"].update(rep["rows"][ms[0]])

    # LinearGelu's gradients through H8, then through the plain version
    m = ms[0]
    x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    dy = torch.randn((m, f), generator=gen, device="cuda").to(torch.bfloat16)
    got = _linear_gelu_grads(torch, fm, x, w, bias, dy)
    with plain_versions():
        want = _linear_gelu_grads(torch, fm, x, w, bias, dy)
    torch.cuda.synchronize()
    _check_flips(f"LinearGelu o M={m}", got[0], want[0])
    for name, g, r in zip(("dx", "dw", "db"), got[1:], want[1:]):
        err = (g.float() - r.float()).abs().max().item()
        tol = H8_GRAD_REL * r.float().abs().max().item()
        log(f"LinearGelu M={m} through H8 vs plain: {name} max|d| {err:.3e} (tol {tol:.3e} = "
            f"2^-6 * max|ref|)")
        if not (_finite(g) and g.dtype == r.dtype and err <= tol):
            raise RuntimeError(f"LinearGelu {name} through H8 disagrees with the plain version")
    del x, dy, got, want

    # fp32: H8-fp32 against its plain version, then linear_gelu under autograd
    xf = torch.randn((m, k), generator=gen, device="cuda")
    wf = torch.randn((f, k), generator=gen, device="cuda") / 32
    dyf = torch.randn((m, f), generator=gen, device="cuda")
    rep["z_f32"]["max_abs_err"] = _check_f32_fc1(torch, f"H8-fp32 M={m} K={k} F={f}", xf, wf,
                                                 bias, z=True)
    flops = 2.0 * m * k * f
    rep["z_f32"].update(
        ms=time_ms(torch, lambda: fm.linear_gelu_z_cuda(xf, wf, bias)),
        plain_ms=time_ms(torch, lambda: fm.linear_gelu_z_ref(xf, wf, bias)),
        library_ms=time_ms(torch, lambda: torch._addmm_activation(bias, xf, wf.t(), use_gelu=True)),
        bound=f32_bound_ms(flops, 0, 4 * (m * k + f * k + f + 2 * m * f)))
    r = rep["z_f32"]
    log(f"H8-fp32 M={m} time: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
        f"(_addmm_activation fp32, no z) {r['library_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms "
        f"({r['bound'][2]}); {flops / r['ms'] / 1e9:.1f} TFLOP/s")
    _reset_counts(fa, fm)
    got = _linear_gelu_grads(torch, fm, xf, wf, bias, dyf)
    torch.cuda.synchronize()
    rep["f32_launches"] = {k: v for k, v in _counts(fa, fm).items() if v}
    with plain_versions():
        want = _linear_gelu_grads(torch, fm, xf, wf, bias, dyf)
    for name, g, r in zip(("o", "dx", "dw", "db"), got, want):
        err = (g - r).abs().max().item()
        tol = F32_TOL * r.abs().max().item()
        log(f"LinearGelu fp32 M={m} through H8-fp32 vs plain: {name} max|d| {err:.3e} "
            f"(tol {tol:.3e} = {F32_TOL} * max|ref|)")
        if not (_finite(g) and err <= tol):
            raise RuntimeError(f"LinearGelu fp32 {name} disagrees with the plain version")
    if rep["f32_launches"] != {"h8_f32": 1}:
        raise RuntimeError(f"linear_gelu fp32 under autograd launched {rep['f32_launches']}")
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


def fc1_bound_ms(m, k, f, outputs):
    """Least time of a bf16 fc1 (H3: ``outputs`` 1; H8, which also writes
    z: 2): the product at the bf16 tensor-core peak, or reading x, w and
    the fp32 bias and writing the bf16 outputs once."""
    t_ops = 2.0 * m * k * f / PEAK_BF16_FLOPS * 1e3
    t_bytes = (2 * m * k + 2 * f * k + 4 * f + outputs * 2 * m * f) / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations", "MMA") if t_ops >= t_bytes else (t_bytes, "bytes", "bytes")


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
        o, lse, err_o = _check_h1(torch, f"H1 c={c} {label} B={b} N={n} H={h}", qkv, h, scale)
        h1 = rep["h1_c32" if c == 32 else "h1"]
        h1["max_abs_err"] = max(h1["max_abs_err"], err_o)
        delta, errs = _check_h2(torch, f"H2 {label} B={b} N={n} H={h}", qkv, do, o, lse, h,
                                scale, c_real)
        for name, err in errs.items():
            kern = "dq" if name == "dq" else "dkv"
            rep[kern]["max_abs_err"] = max(rep[kern]["max_abs_err"], err)
        hc = h * c
        # every row: both kernels' times and bounds beside SDPA's whole backward
        el = 2  # bf16 bytes
        qkv_b, o_b, vec_b = b * n * 3 * hc * el, b * n * hc * el, b * h * n * 4
        out = torch.empty_like(qkv)
        t = {"dkv": dict(ms=time_ms(torch, lambda: fa.flash_bwd_dkv_cuda(
                              qkv, do, lse, delta, out, h, scale)),
                          bound=attn_bound_ms(b, n, h, c_real, 4, qkv_b + o_b + 2 * vec_b,
                                              2 * o_b)),
             "dq": dict(ms=time_ms(torch, lambda: fa.flash_bwd_dq_cuda(
                             qkv, do, lse, delta, out, h, scale)),
                        bound=attn_bound_ms(b, n, h, c_real, 3, qkv_b + o_b + 2 * vec_b, o_b))}
        lib = _sdpa_bwd_ms(torch, qkv, do, h, scale)
        whole = attn_bound_ms(b, n, h, c_real, 5, qkv_b + o_b + 2 * vec_b, qkv_b)
        log(f"H2 {label} B={b} N={n} H={h} c={c_real}->{c} time: dkv {t['dkv']['ms']:.4f} ms "
            f"(bound {t['dkv']['bound'][0]:.4f}, {t['dkv']['bound'][2]}), dq {t['dq']['ms']:.4f} "
            f"ms (bound {t['dq']['bound'][0]:.4f}, {t['dq']['bound'][2]}); dkv + dq "
            f"{t['dkv']['ms'] + t['dq']['ms']:.4f} ms, library (SDPA backward) {lib:.4f} ms, "
            f"bound {whole[0]:.4f} ms ({whole[2]}; 5 products of 2*N^2*c per head at "
            f"c={c_real}, one exp2 per score)")
        if label.startswith("predictor") and not timed:
            timed = True
            rep["dkv"].update(
                plain_ms=time_ms(torch, lambda: fa.flash_bwd_dkv_ref(qkv, do, lse, delta, h, scale)),
                library_ms=lib, **t["dkv"])
            rep["dq"].update(
                plain_ms=time_ms(torch, lambda: fa.flash_bwd_dq_ref(qkv, do, lse, delta, h, scale)),
                library_ms=lib, **t["dq"])
            rep["h1_c32"].update(
                ms=time_ms(torch, lambda: fa.flash_self_attention_cuda(qkv, h, scale)),
                plain_ms=time_ms(torch, lambda: fa.flash_self_attention_ref(qkv, h, scale)),
                library_ms=_sdpa_fwd_ms(torch, qkv, h, scale),
                bound=attn_bound_ms(b, n, h, c_real, 2, qkv_b, o_b + vec_b))
            rep["shape"] = (b, n, h, c)
            for k in ("dkv", "dq", "h1_c32"):
                r = rep[k]
                log(f"{k} {label} B={b} N={n} H={h} c={c_real}->{c} time: kernel "
                    f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
                    f"{r['library_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms ({r['bound'][2]})")
        if label.startswith("vith16_384"):  # K3's geometry: the merged backward's work
            rep["k3"] = dict(ms=t["dkv"]["ms"] + t["dq"]["ms"], library_ms=lib, bound=whole,
                             plain_ms=time_ms(torch, lambda: fa.flash_self_attention_bwd_ref(
                                 qkv, do, lse, delta, h, scale)))
            k3 = rep["k3"]
            log(f"K3 geometry, H2 {label} B={b} N={n} H={h} c={c}: dkv + dq "
                f"{k3['ms']:.4f} ms, plain {k3['plain_ms']:.4f} ms, library (SDPA "
                f"backward) {k3['library_ms']:.4f} ms, "
                f"bound {k3['bound'][0]:.4f} ms ({k3['bound'][2]})")
        del qkv, do, o, lse, delta
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

    shapes: (label, B, N, H, c, c_real, mid_run); H1 and both H2 kernels
    are timed at the first of each head dim (c=32's H2 under "dkv" and
    "dq" for the summary line, c=64's under "dkv_c64" and "dq_c64")."""
    from jepa_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    rng = np.random.default_rng(SEED + 2)
    rep = {k: {"max_abs_err": 0.0} for k in ("h1_c64", "h1_c32", "h1_c80", "dkv", "dq")}
    for label, b, n, h, c, c_real, mid_run in shapes:
        qkv, do = _attn_inputs(torch, gen, b, n, h, c, c_real)
        mask = padded_key_mask(torch, rng, b, n, mid_run)
        scale = c_real**-0.5
        valid = mask.float().mean().item()
        o, lse, err_o = _check_h1(torch, f"masked H1 c={c} {label} B={b} N={n}, valid keys "
                                  f"{valid:.3f}", qkv, h, scale, mask)
        h1 = rep[f"h1_c{c}"]
        h1["max_abs_err"] = max(h1["max_abs_err"], err_o)
        delta, errs = _check_h2(torch, f"masked H2 {label}", qkv, do, o, lse, h, scale, c_real,
                                mask)
        for name, err in errs.items():
            kern = "dq" if name == "dq" else "dkv"
            rep[kern]["max_abs_err"] = max(rep[kern]["max_abs_err"], err)
        hc = h * c
        el = 2
        qkv_b, o_b, vec_b, m_b = b * n * 3 * hc * el, b * n * hc * el, b * h * n * 4, b * n
        pairs = int(mask.sum().item()) * n  # every query row against the valid keys
        names = ("dkv", "dq") if c == 32 else (f"dkv_c{c}", f"dq_c{c}")  # c=32: the JSON line's
        if "ms" not in h1 or "ms" not in rep.get(names[0], {}):
            fwd_lib, bwd_lib = _sdpa_masked_ms(torch, qkv, do, h, scale, mask)
        if "ms" not in h1:
            h1.update(
                ms=time_ms(torch, lambda: fa.flash_self_attention_cuda(qkv, h, scale, mask)),
                plain_ms=time_ms(torch, lambda: fa.flash_self_attention_ref(qkv, h, scale, mask)),
                library_ms=fwd_lib,
                bound=attn_bound_ms(b, n, h, c_real, 2, qkv_b + m_b, o_b + vec_b, pairs),
                shape=(b, n, h, c_real))
            log(f"masked H1 c={c_real}->{c} {label} B={b} N={n} time: kernel {h1['ms']:.4f} ms, "
                f"plain {h1['plain_ms']:.4f} ms, library (SDPA fwd, bool mask) {fwd_lib:.4f} "
                f"ms, bound {h1['bound'][0]:.4f} ms ({h1['bound'][2]})")
        if "ms" not in rep.get(names[0], {}):  # H2 at the first rung of each head dim
            out = torch.empty_like(qkv)
            for name, fn, plain, products, outs in (
                    (names[0], fa.flash_bwd_dkv_cuda, fa.flash_bwd_dkv_ref, 4, 2),
                    (names[1], fa.flash_bwd_dq_cuda, fa.flash_bwd_dq_ref, 3, 1)):
                r = rep.setdefault(name, {})
                r.update(
                    ms=time_ms(torch, lambda: fn(qkv, do, lse, delta, out, h, scale, mask)),
                    plain_ms=time_ms(torch, lambda: plain(qkv, do, lse, delta, h, scale, mask)),
                    library_ms=bwd_lib, shape=(b, n, h, c_real),
                    bound=attn_bound_ms(b, n, h, c_real, products,
                                        qkv_b + o_b + 2 * vec_b + m_b, outs * o_b, pairs))
                log(f"masked {name} {label} B={b} N={n} c={c_real}->{c} time: kernel "
                    f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library (SDPA "
                    f"backward, bool mask) {bwd_lib:.4f} ms, bound {r['bound'][0]:.4f} ms "
                    f"({r['bound'][2]})")
        del qkv, do, o, lse, delta, mask
    return rep


def _hm_inputs(torch, gen, b, h, nq, nk, c):
    """Seeded bf16 operands as the head-major path sees them: for self-attention
    the q, k, v planes of a token-major [B, N, 3, H, c] projection (strided
    views), else separate [B, H, N, c] tensors; do [B, H, Nq, c] token-major
    (as o's gradient arrives through the transpose back)."""
    if nq == nk:
        qkv = torch.randn((b, nq, 3, h, c), generator=gen, device="cuda").to(torch.bfloat16)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    else:
        q, k, v = (torch.randn((b, h, n, c), generator=gen, device="cuda").to(torch.bfloat16)
                   for n in (nq, nk, nk))
    do = torch.randn((b, nq, h, c), generator=gen, device="cuda").to(torch.bfloat16)
    return q, k, v, do.transpose(1, 2)


def _sdpa_hm_ms(torch, q, k, v, do, scale, mask=None):
    """Library yardstick on head-major operands: SDPA (bool mask where
    masked), (forward ms, backward-alone ms); timed only."""
    q, k, v = (t.contiguous().requires_grad_(True) for t in (q, k, v))
    am = None if mask is None else mask[:, None, None, :]
    f = torch.nn.functional.scaled_dot_product_attention
    with torch.no_grad():
        fwd = time_ms(torch, lambda: f(q, k, v, attn_mask=am, scale=scale))
    out = f(q, k, v, attn_mask=am, scale=scale)
    g = do.contiguous()
    bwd = time_ms(torch, lambda: torch.autograd.grad(out, (q, k, v), g, retain_graph=True))
    return fwd, bwd


def _check_grads(label, got, want, names, mask=None):
    """Each gradient within H2_REL * max|ref| of its plain version; with a
    key mask the masked keys' dk and dv exactly 0. Returns the max |d|."""
    worst = 0.0
    for name, g, w in zip(names, got, want):
        err = (g.float() - w.float()).abs().max().item()
        tol = H2_REL * w.float().abs().max().item()
        masked = 0.0
        if mask is not None and name in ("dk", "dv"):
            masked = g.transpose(1, 2)[~mask].abs().max().item()
        log(f"{label}: {name} max|d| {err:.3e} (tol {tol:.3e} = 2^-6 * max|ref|)"
            + ("" if mask is None or name == "dq" else f", masked keys max|{name}| {masked:.1e}"))
        if not (_finite(g) and err <= tol and masked == 0.0):
            raise RuntimeError(f"{label} {name} disagrees with its plain version")
        worst = max(worst, err)
    return worst


def _finite(t) -> bool:
    return bool(t.float().isfinite().all().item())


def phase_hm_kernels(torch, setup, caps):
    """H4-H7 (the head-major kernels) against their plain versions on the
    card at vit_tiny's shapes: ``setup`` the vit_tiny train setup (its fixed
    contexts), ``caps`` the padded mode's context rungs. Returns a report per
    kernel (H4, H4 masked, H5, H5 masked, H6, H7, H7 masked) and the
    launches of the split backward driven through flash_attention_packed
    under autograd, without and with a key mask."""
    from jepa_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    rng = np.random.default_rng(SEED + 4)
    h, c = setup["enc_cfg"].num_heads, setup["enc_cfg"].embed_dim // setup["enc_cfg"].num_heads
    n_full = setup["enc_cfg"].num_patches
    scale = c**-0.5
    rep = {k: {"max_abs_err": 0.0} for k in ("fwd", "fwd_masked", "dq", "dkv", "dqkv",
                                             "dqkv_masked")}

    def io_bytes(b, nq, nk, outs):  # bf16 [B, H, N, c] operands, fp32 [B, H, Nq] rows
        return b * h * c * 2 * (nq + 2 * nk), b * h * c * 2 * outs, b * h * nq * 4

    # H4: serving, the target, the padded contexts (masked), a 1-query probe
    fwd_shapes = ([("serving", 2, n_full, n_full, False), ("target", TRAIN_BATCH, n_full, n_full, False)]
                  + [(f"context rung {n}", TRAIN_BATCH, n, n, True) for n in caps]
                  + [("probe cross-attention", 2, 1, n_full, True)])
    for label, b, nq, nk, masked in fwd_shapes:
        q, k, v, do = _hm_inputs(torch, gen, b, h, nq, nk, c)
        mask = padded_key_mask(torch, rng, b, nk, 0) if masked else None
        o, lse, err_o = _check_h4(torch, f"H4 {label} B={b} H={h} Nq={nq} Nk={nk} c={c}"
                                  f"{' masked' if masked else ''}", q, k, v, scale, mask)
        r = rep["fwd_masked" if masked else "fwd"]
        r["max_abs_err"] = max(r["max_abs_err"], err_o)
        pairs = int(mask.sum().item()) * nq if masked else b * nq * nk
        in_b, out_b, vec_b = io_bytes(b, nq, nk, 1)
        t = dict(ms=time_ms(torch, lambda: fa.flash_fwd_hm_cuda(q, k, v, scale, mask)),
                 plain_ms=time_ms(torch, lambda: fa.flash_fwd_hm_ref(q, k, v, scale, mask)),
                 library_ms=_sdpa_hm_ms(torch, q, k, v, do, scale, mask)[0],
                 bound=attn_bound_ms(b, nq, h, c, 2, in_b + (b * nk if masked else 0),
                                     out_b + vec_b, pairs), shape=(b, h, nq, nk, c))
        log(f"H4 {label} time: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library "
            f"(SDPA fwd) {t['library_ms']:.4f} ms, bound {t['bound'][0]:.4f} ms ({t['bound'][2]})")
        if label == "target" or (masked and "ms" not in r):
            r.update(t)
        rep.setdefault("fwd_times", {})[label] = t
        del q, k, v, do, o, lse

    # H7: the fixed contexts unmasked, the padded rungs masked
    bwd_shapes = ([(f"context {i}", ke, False) for i, (ke, _) in enumerate(setup["keep"])
                   if ke >= 128]  # shorter contexts run eager
                  + [(f"context rung {n}", n, True) for n in caps])
    for label, n, masked in bwd_shapes:
        if not fa.merged_bwd(n, n, c):
            raise RuntimeError(f"H7 {label}: N={n} does not take the merged backward")
        q, k, v, do = _hm_inputs(torch, gen, TRAIN_BATCH, h, n, n, c)
        mask = padded_key_mask(torch, rng, TRAIN_BATCH, n, 0) if masked else None
        lse, delta, err = _check_hm_bwd(torch, "dqkv", f"H7 {label} B={TRAIN_BATCH} N={n}", q, k,
                                        v, do, scale, mask)
        r = rep["dqkv_masked" if masked else "dqkv"]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if "ms" not in r:
            b = TRAIN_BATCH
            in_b, out_b, vec_b = io_bytes(b, n, n, 3)
            pairs = int(mask.sum().item()) * n if masked else b * n * n
            outs = dict(dq=fa._alloc_like(q), dk=fa._alloc_like(k), dv=fa._alloc_like(v),
                        ws=torch.empty((-(-n // 64), *q.shape), device="cuda"))
            hm = _hm_args(fa, q, k, v, scale, mask, do=do, lse=lse, delta=delta, **outs)
            # the C entry's time (queued behind a spin kernel: the kernels
            # alone), beside the Python wrapper's, whose host time can exceed it
            call = hm_entry(torch, "dqkv", c, hm)
            r.update(ms=queued_ms(torch, call), kernels_ms=kernel_split_ms(torch, call),
                     wrapper_ms=time_ms(torch, lambda: fa.flash_bwd_dqkv_hm_cuda(
                         q, k, v, do, lse, delta, scale, mask)),
                     plain_ms=time_ms(torch, lambda: fa.flash_bwd_dqkv_hm_ref(
                         q, k, v, do, lse, delta, scale, mask)),
                     library_ms=_sdpa_hm_ms(torch, q, k, v, do, scale, mask)[1],
                     bound=attn_bound_ms(b, n, h, c, 5, in_b + b * n * c * h * 2 + 2 * vec_b
                                         + (b * n if masked else 0), out_b, pairs),
                     shape=(b, h, n, n, c))
            log(f"H7 {label} time: C entry {r['ms']:.4f} ms (queued; by kernel, profiled: "
                + ", ".join(f"{k} {v:.4f}" for k, v in r["kernels_ms"].items())
                + f"), wrapper {r['wrapper_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
                f"(SDPA backward) {r['library_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms "
                f"({r['bound'][2]})")
            del outs, hm, call
        del q, k, v, do, lse, delta

    # H5 + H6: the split backward at (24, 3, 1568, 64); H5 also at c=32 (6
    # heads) and each with a key mask
    n, b = n_full, TRAIN_BATCH
    for cc in (c, 32):
        if fa.merged_bwd(n, n, cc):
            raise RuntimeError(f"N={n} c={cc} takes the merged backward, not H5 + H6")
    q, k, v, do = _hm_inputs(torch, gen, b, h, n, n, c)
    rep["dkv"]["max_abs_err"] = _check_hm_bwd(torch, "dkv", f"H6 B={b} N={n}", q, k, v, do,
                                              scale)[2]
    in_b, out_b, vec_b = io_bytes(b, n, n, 1)
    lib = _sdpa_hm_ms(torch, q, k, v, do, scale)[1]
    rep["dq_masked"] = {"max_abs_err": 0.0}
    masks = {}  # the c=64 instances' key masks, for the packed runs below
    for hh, cc, masked in ((h, c, False), (h, c, True), (6, 32, False), (6, 32, True)):
        qi, ki, vi, doi = (q, k, v, do) if (hh, cc) == (h, c) else _hm_inputs(
            torch, gen, b, hh, n, n, cc)
        mask = padded_key_mask(torch, rng, b, n, 0) if masked else None
        label = f"H5 B={b} N={n} H={hh} c={cc}{' masked' if masked else ''}"
        r = rep["dq_masked" if masked else "dq"]
        r["max_abs_err"] = max(r["max_abs_err"], _check_hm_bwd(
            torch, "dq", label, qi, ki, vi, doi, cc**-0.5, mask)[2])
        if cc == c:  # the reported instances: c=64, masked and not
            o, lse = fa.flash_fwd_hm_cuda(q, k, v, scale, mask)
            delta = fa.hm_delta(do, o)
            pairs = int(mask.sum().item()) * n if masked else b * n * n
            r.update(
                ms=time_ms(torch, lambda: fa.flash_bwd_dq_hm_cuda(q, k, v, do, lse, delta, scale,
                                                                  mask)),
                plain_ms=time_ms(torch, lambda: fa.flash_bwd_dq_hm_ref(q, k, v, do, lse, delta,
                                                                       scale, mask)),
                library_ms=_sdpa_hm_ms(torch, q, k, v, do, scale, mask)[1] if masked else lib,
                shape=(b, h, n, n, c),
                bound=attn_bound_ms(b, n, h, c, 3, in_b + out_b + 2 * vec_b
                                    + (b * n if masked else 0), out_b, pairs))
            log(f"{label} time: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
                f"(SDPA backward) {r['library_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms "
                f"({r['bound'][2]})")
            del o, lse, delta
            masks[masked] = mask
        del qi, ki, vi, doi
    o, lse = fa.flash_fwd_hm_cuda(q, k, v, scale)
    delta = fa.hm_delta(do, o)
    rep["dkv"].update(
        ms=time_ms(torch, lambda: fa.flash_bwd_dkv_hm_cuda(q, k, v, do, lse, delta, scale)),
        plain_ms=time_ms(torch, lambda: fa.flash_bwd_dkv_hm_ref(q, k, v, do, lse, delta, scale)),
        library_ms=lib, shape=(b, h, n, n, c),
        bound=attn_bound_ms(b, n, h, c, 4, in_b + out_b + 2 * vec_b, 2 * out_b))
    r = rep["dkv"]
    log(f"H6 B={b} N={n} time: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
        f"(SDPA backward) {lib:.4f} ms, bound {r['bound'][0]:.4f} ms ({r['bound'][2]})")
    del o, lse, delta

    # the split backward driven through the public op under autograd, with
    # and without the c=64 key mask, its launches counted (every counter set
    # to 0 just before); the same op through the plain versions holds its grads
    want = {"fwd": 1, "dq": 1, "dkv": 1, "dqkv": 0}
    for masked in (False, True):
        mask = masks[masked]
        grads = []
        for plain in (False, True):
            # the token-major projection [B, N, 3, H, c] and its [3, B, H, N, c] view
            tok = torch.stack((q, k, v)).permute(1, 3, 0, 2, 4).contiguous().requires_grad_(True)
            with plain_versions() if plain else contextlib.nullcontext():
                fa.reset_launch_counts()
                o = fa.flash_attention_packed(tok.permute(2, 0, 3, 1, 4), kv_mask=mask,
                                              scale=scale)
                o.backward(do)
                torch.cuda.synchronize()
                if not plain:
                    launches = {k: fa.hm_launches[k] for k in fa.HM_KINDS}
                    masked_launches = {k: fa.hm_masked_launches[k] for k in fa.HM_KINDS}
            grads.append(tok.grad.permute(2, 0, 3, 1, 4))
        key = "split_masked_launches" if masked else "split_launches"
        rep[key] = masked_launches if masked else launches
        want_masked = want if masked else dict.fromkeys(want, 0)
        if launches != want or masked_launches != want_masked:
            raise RuntimeError(f"flash_attention_packed's split backward"
                               f"{' with a key mask' if masked else ''} launched {launches}, "
                               f"masked {masked_launches}")
        _check_grads(f"flash_attention_packed B={b} N={n}{' masked' if masked else ''} under "
                     f"autograd, kernels vs plain", grads[0].unbind(0), grads[1].unbind(0),
                     ("dq", "dk", "dv"), mask)
        log(f"H5 + H6 through flash_attention_packed{' with a key mask' if masked else ''}: "
            f"launches {launches}, masked {masked_launches}")
    return rep


def phase_c128_kernels(torch, setup, pred_caps):
    """H1 and both H2 kernels at head dim 128 (vit_tiny's 384-wide
    predictor, 3 heads) against their plain versions on the card: the fixed
    predictor sequences unmasked, the padded predictor rungs ``pred_caps``
    ((context cap, target cap) pairs) with the key mask."""
    from jepa_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    rng = np.random.default_rng(SEED + 5)
    h = setup["pred_cfg"].num_heads
    c = setup["pred_cfg"].predictor_embed_dim // h
    if c != 128:
        raise RuntimeError(f"the predictor's head dim is {c}, not 128")
    scale = c**-0.5
    rep = {k: {"max_abs_err": 0.0} for k in ("fwd", "fwd_masked", "dkv", "dq", "dkv_masked",
                                             "dq_masked")}
    shapes = ([(f"predictor, mask {i}", ke + kp, 0) for i, (ke, kp) in enumerate(setup["keep"])]
              + [(f"predictor rung {ce}+{cp}", ce + cp, ce) for ce, cp in pred_caps])
    b = TRAIN_BATCH
    for label, n, mid in shapes:
        masked = mid > 0
        sfx = "_masked" if masked else ""
        qkv, do = _attn_inputs(torch, gen, b, n, h, c)
        mask = padded_key_mask(torch, rng, b, n, mid) if masked else None
        o, lse, err_o = _check_h1(torch, f"H1 c=128 {label} B={b} N={n}", qkv, h, scale, mask)
        rep["fwd" + sfx]["max_abs_err"] = max(rep["fwd" + sfx]["max_abs_err"], err_o)
        delta = fa.attention_delta(do, o, h)
        dqkv = fa.flash_self_attention_bwd_cuda(qkv, do, lse, delta, h, scale, mask)
        ref = fa.flash_self_attention_bwd_ref(qkv, do, lse, delta, h, scale, mask)
        torch.cuda.synchronize()
        _same_bits(f"H2 c=128 {label}", (dqkv,),
                   (fa.flash_self_attention_bwd_cuda(qkv, do, lse, delta, h, scale, mask),))
        hc = h * c
        got, want = ([t[..., i * hc:(i + 1) * hc].reshape(b, n, h, c).transpose(1, 2)
                      for i in range(3)] for t in (dqkv, ref))
        for kind, sl, names in (("dq", slice(0, 1), ("dq",)), ("dkv", slice(1, 3), ("dk", "dv"))):
            r = rep[kind + sfx]
            r["max_abs_err"] = max(r["max_abs_err"], _check_grads(
                f"H2 c=128 {label} B={b} N={n}", got[sl], want[sl], names, mask))
        if "ms" not in rep["fwd" + sfx]:
            fwd_lib, bwd_lib = (_sdpa_masked_ms(torch, qkv, do, h, scale, mask) if masked
                                else (_sdpa_fwd_ms(torch, qkv, h, scale),
                                      _sdpa_bwd_ms(torch, qkv, do, h, scale)))
            qkv_b, o_b, vec_b = b * n * 3 * hc * 2, b * n * hc * 2, b * h * n * 4
            m_b = b * n if masked else 0
            pairs = int(mask.sum().item()) * n if masked else b * n * n
            out = torch.empty_like(qkv)
            for kind, fn, plain, lib, bound in (
                    ("fwd", lambda: fa.flash_self_attention_cuda(qkv, h, scale, mask),
                     lambda: fa.flash_self_attention_ref(qkv, h, scale, mask), fwd_lib,
                     attn_bound_ms(b, n, h, c, 2, qkv_b + m_b, o_b + vec_b, pairs)),
                    ("dkv", lambda: fa.flash_bwd_dkv_cuda(qkv, do, lse, delta, out, h, scale, mask),
                     lambda: fa.flash_bwd_dkv_ref(qkv, do, lse, delta, h, scale, mask), bwd_lib,
                     attn_bound_ms(b, n, h, c, 4, qkv_b + o_b + 2 * vec_b + m_b, 2 * o_b, pairs)),
                    ("dq", lambda: fa.flash_bwd_dq_cuda(qkv, do, lse, delta, out, h, scale, mask),
                     lambda: fa.flash_bwd_dq_ref(qkv, do, lse, delta, h, scale, mask), bwd_lib,
                     attn_bound_ms(b, n, h, c, 3, qkv_b + o_b + 2 * vec_b + m_b, o_b, pairs))):
                r = rep[kind + sfx]
                r.update(ms=time_ms(torch, fn), plain_ms=time_ms(torch, plain), library_ms=lib,
                         bound=bound, shape=(b, n, h, c))
                log(f"{kind}{sfx} c=128 {label} B={b} N={n} time: kernel {r['ms']:.4f} ms, "
                    f"plain {r['plain_ms']:.4f} ms, library (SDPA) {lib:.4f} ms, bound "
                    f"{r['bound'][0]:.4f} ms ({r['bound'][2]})")
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
    for kind in ("fwd", "bwd_dq", "bwd_dkv", "bwd_dqkv"):
        stack.enter_context(mock.patch.object(
            fa, f"flash_{kind}_hm_cuda", getattr(fa, f"flash_{kind}_hm_ref")))
    stack.enter_context(mock.patch.object(fm, "linear_gelu_cuda", fm.linear_gelu_ref))
    stack.enter_context(mock.patch.object(fm, "linear_gelu_z_cuda", fm.linear_gelu_z_ref))
    return stack


VITL16_GEO = dict(img_size=224, num_frames=16, tubelet_size=2, uniform_power=True)


def write_seeded_encoder(torch, workdir: str, model_name: str = "vit_large") -> str:
    """A seeded encoder (224 px, 16 frames, tubelet 2, uniform_power) as a
    zoo-layout .pth.tar in workdir; returns its path."""
    from jepa_tpu_torch.models.factory import vit_cfg
    from jepa_tpu_torch.models.vit import init_vit

    path = os.path.join(workdir, f"{model_name}.pth.tar")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = init_vit(vit_cfg(model_name, **VITL16_GEO), gen, device="cuda")
    torch.save({"target_encoder": {k: v.cpu() for k, v in model.state_dict().items()},
                "epoch": 0}, path)
    return path


def phase_serve(torch, workdir: str, model_name: str = "vit_large"):
    """Serving through jepa_tpu_torch.api on a seeded encoder .pth.tar (at
    vitl16_k400_16x8x3.yaml's geometry), which it writes to workdir and
    returns (``enc_path``) for the evals: 4 requests of 2 clips, each
    launching exactly the kernels the routes give (``expected_launches``)."""
    from jepa_tpu_torch import api
    from jepa_tpu_torch.models.attentive import AttentiveCfg, init_attentive_classifier
    from jepa_tpu_torch.models.factory import vit_cfg
    from jepa_tpu_torch.ops import flash_attention as fa
    from jepa_tpu_torch.ops import fused_mlp as fm

    geo = VITL16_GEO
    cfg = vit_cfg(model_name, **geo)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    enc_path = write_seeded_encoder(torch, workdir, model_name)
    acfg = AttentiveCfg(embed_dim=cfg.embed_dim, num_heads=cfg.num_heads, num_classes=400)
    probe = init_attentive_classifier(acfg, gen, device="cuda")
    probe_path = os.path.join(workdir, f"{model_name}_probe.pth.tar")
    torch.save({"classifier": {k: v.cpu() for k, v in probe.state_dict().items()}},
               probe_path)
    del probe
    enc = api.load_encoder(enc_path, model_name, **geo)  # device="cuda"
    clf = api.load_classifier(probe_path, enc, num_classes=400)
    torch.cuda.synchronize()
    want = expected_launches(cfg)
    log(f"serve {model_name}: seeded encoder + probe written and loaded in "
        f"{time.perf_counter() - t0:.1f} s; expected launches per request {want}")

    rng = np.random.default_rng(SEED)
    requests = [rng.integers(0, 256, size=(2, 16, 224, 224, 3), dtype=np.uint8)
                for _ in range(4)]
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(fa, fm)
    times, deltas, probs_all = [], [], []
    for clips in requests:
        c0 = _counts(fa, fm)
        t0 = time.perf_counter()
        probs = clf.classify(clips)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        deltas.append(_launch_diff(c0, _counts(fa, fm)))
        probs_all.append(probs)
    launches = _counts(fa, fm)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"serve {model_name}: per-request launches {deltas}")
    if any(d != want for d in deltas):
        raise RuntimeError(f"expected {want} launches per request")
    for probs in probs_all:
        if tuple(probs.shape) != (2, 400) or not torch.isfinite(probs).all():
            raise RuntimeError(f"bad probabilities: shape {tuple(probs.shape)}")
        s_err = (probs.sum(-1) - 1).abs().max().item()
        if s_err > 1e-4:
            raise RuntimeError(f"probabilities sum to 1 +- {s_err}")
    med = statistics.median(times[1:])
    log(f"serve {model_name}: ms/request (B=2) {[round(t, 3) for t in times]}; median after "
        f"warm-up {med:.3f} ms; peak allocated {peak_gib:.3f} GiB")
    prof = profile_device(torch, lambda: clf.classify(requests[0]), f"serve {model_name}")

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
    log(f"serve {model_name}: kernel vs plain path, features min cosine {cos:.6f} (min "
        f"{FEAT_COS_MIN}), max|d| {f_err:.3e}; probabilities max|d| {p_err:.3e} "
        f"(tol {PROB_TOL})")
    if cos < FEAT_COS_MIN or p_err > PROB_TOL:
        raise RuntimeError("serving path disagrees with its plain version")
    return {"launches": launches, "median_ms": med, "peak_gib": peak_gib, "enc_path": enc_path,
            "feat_cos": cos, "prof": prof}


def train_setup(repo: str, model_name: str = None, fused_mlp=False, config="vitl16.yaml",
                tube=None, remat=False, layout=None, use_mask_tokens=None):
    """Configs of configs/pretrain/<config> (model, data geometry, mask,
    loss and optimization sections; default vitl16.yaml): its encoder (or
    ``model_name``) + the 12 x 384 predictor at full width and depth,
    fixed masks with K calibrated at the config's per-card batch, the
    config's schedules (ipe 300, warmup 40); ``fused_mlp`` the encoder's
    (``'force'``: the context encoder's fc1 fused and differentiated, H8);
    ``tube``: a ``mask`` list of random-tube configs in place of the
    config's (``data.mask_type: random_tube``, the step's 'tube' mode);
    ``remat``: the encoder's and the predictor's activation checkpointing
    (the app's default is ``'attn'``); ``layout``: the step's data-parallel
    layout (``parallel.mesh.make_layout``); ``use_mask_tokens``: the
    config's ``model.use_mask_tokens`` overridden (False: the diffusion-mode
    predictor)."""
    import yaml

    from jepa_tpu_torch.masks.multiblock3d import MaskGrid, MaskSpec, calibrate_keep_counts
    from jepa_tpu_torch.masks.random_tube import TubeSpec
    from jepa_tpu_torch.masks.random_tube import keep_counts as tube_keep_counts
    from jepa_tpu_torch.models.factory import predictor_cfg_for, vit_cfg
    from jepa_tpu_torch.train.step import TrainCfg, build_train_step
    from jepa_tpu_torch.utils.schedulers import build_schedules

    with open(os.path.join(repo, "configs", "pretrain", config)) as f:
        cfg = yaml.safe_load(f)
    m, d, lo, o = cfg["model"], cfg["data"], cfg["loss"], cfg["optimization"]
    m["model_name"] = model_name or m["model_name"]
    if use_mask_tokens is not None:
        m["use_mask_tokens"] = use_mask_tokens
    enc_cfg = vit_cfg(m["model_name"], img_size=d["crop_size"], patch_size=d["patch_size"],
                      num_frames=d["num_frames"], tubelet_size=d["tubelet_size"],
                      uniform_power=m["uniform_power"], fused_mlp=fused_mlp, remat=remat)
    if tube is not None:
        cfg["mask"] = tube
    pred_cfg = predictor_cfg_for(enc_cfg, predictor_embed_dim=m["pred_embed_dim"],
                                 depth=m["pred_depth"], use_mask_tokens=m["use_mask_tokens"],
                                 num_mask_tokens=len(cfg["mask"]),
                                 zero_init_mask_tokens=m["zero_init_mask_tokens"])
    grid = MaskGrid.from_data_cfg(d["crop_size"], d["patch_size"], d["num_frames"],
                                  d["tubelet_size"])
    if tube is not None:
        specs = [TubeSpec.from_cfg(x) for x in tube]
        keep = [tube_keep_counts(s, grid) for s in specs]
        cfg["meta"]["mask_mode"] = "tube"
    else:
        specs = [MaskSpec.from_cfg(x) for x in cfg["mask"]]
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
    step_fn = build_train_step(enc_cfg, pred_cfg, tc, *scheds, specs, grid, keep, layout=layout)
    return dict(enc_cfg=enc_cfg, pred_cfg=pred_cfg, keep=keep, step_fn=step_fn, tc=tc,
                scheds=scheds,
                specs=specs, grid=grid, yaml_batch=d["batch_size"], model_name=m["model_name"],
                clip_shape=(d["num_frames"], d["crop_size"], d["crop_size"], 3),
                config=config, tube=tube, remat=remat, use_mask_tokens=m["use_mask_tokens"])


def attention_calls(enc_cfg, pred_cfg=None, pairs=()):
    """(N, heads, head dim, depth, grad, cfg) of each attention stack of one
    request of a grad-free encoder (``enc_cfg`` alone) or of one update
    (with ``pred_cfg`` and ``pairs``, the (context, target) token counts of
    each mask config): the target forward, then per mask the context
    encoder and the predictor, forward and backward."""
    c = enc_cfg.embed_dim // enc_cfg.num_heads
    calls = [(enc_cfg.num_patches, enc_cfg.num_heads, c, enc_cfg.depth, False, enc_cfg)]
    for ke, kp in pairs:
        calls.append((ke, enc_cfg.num_heads, c, enc_cfg.depth, True, enc_cfg))
        calls.append((ke + kp, pred_cfg.num_heads,
                      pred_cfg.predictor_embed_dim // pred_cfg.num_heads, pred_cfg.depth, True,
                      pred_cfg))
    return calls


def expected_launches(enc_cfg, pred_cfg=None, pairs=(), masked=False) -> dict:
    """The launches the routes imply, zero counters left out, per request or
    per update of ``attention_calls``, with the key mask on the trainable
    calls in the padded mode (``masked``). A sequence under 128 tokens runs
    eager (the flash rule); otherwise ``self_attention_route`` picks H1/H2
    ('tm', at the padded head dim; unmasked at (K2_C, K2_N) also counted
    under K2_KEY) or H4 with H7 or H5 + H6 ('hm', ``merged_bwd``).
    H3 runs in the grad-free encoder where its tiling takes the fc1, H8 in
    the context encoder under ``fused_mlp='force'`` (LinearGelu's forward).
    A trainable net with remat True / 'full' recomputes every block in the
    backward, so each of its attention forwards launches twice (H8 too);
    'attn' keeps the forward's (o, lse) and launches no more than False."""
    from jepa_tpu_torch.ops import flash_attention as fa
    from jepa_tpu_torch.ops.fused_mlp import fused_tiling

    want = {}

    def add(key, n):
        want[key] = want.get(key, 0) + n

    full = lambda cfg: cfg.remat not in (False, None, "attn")  # recomputes the forward

    def attn(n, heads, c, depth, grad, mask, recompute=False):
        route = fa.self_attention_route(heads, c, n)
        if n < 128 or route == "eager":
            return
        sfx = "_masked" if mask else ""
        fwd = depth * (2 if grad and recompute else 1)
        if route == "tm":
            cp = fa.padded_head_dim(c)
            add("h1", fwd)
            add(f"h1_c{cp}{sfx}", fwd)
            if not mask and (cp, n) == (K2_C, K2_N):
                add(K2_KEY, fwd)
            for k in ("dkv", "dq") if grad else ():
                add(k, depth)
                add(f"{k}_c{cp}", depth)
                if mask:
                    add(f"{k}_masked", depth)
            return
        kinds = ["fwd"] + (["dqkv"] if fa.merged_bwd(n, n, c) else ["dq", "dkv"]) * grad
        for k in kinds:
            add(f"hm_{k}", fwd if k == "fwd" else depth)
            if mask:
                add(f"hm_{k}_masked", fwd if k == "fwd" else depth)

    for n, heads, c, depth, grad, cfg in attention_calls(enc_cfg, pred_cfg, pairs):
        attn(n, heads, c, depth, grad, masked and grad, full(cfg))
    if fused_tiling(8, enc_cfg.embed_dim, enc_cfg.mlp_hidden):
        add("h3", enc_cfg.depth)
        if pairs and enc_cfg.fused_mlp == "force":
            add("h8", enc_cfg.depth * len(pairs) * (2 if full(enc_cfg) else 1))
    return want


def _counts(fa, fm) -> dict:
    """Every wrapper's launch counter, by kernel, instance and mask."""
    c = {"h1": fa.launches, "dkv": fa.dkv_launches, "dq": fa.dq_launches,
         "dkv_masked": fa.dkv_masked_launches, "dq_masked": fa.dq_masked_launches,
         "h3": fm.launches, "h3_f32": fm.f32_launches,
         "h8": fm.z_launches, "h8_f32": fm.z_f32_launches,
         "h1_f32": fa.f32_launches_by_head_dim[64], "h1_f32_c80": fa.f32_launches_by_head_dim[80],
         K2_KEY: fa.launches_by_tokens[K2_C, K2_N]}
    for hd in fa.KERNEL_HEAD_DIMS:
        c.update({f"h1_c{hd}": fa.launches_by_head_dim[hd],
                  f"h1_c{hd}_masked": fa.masked_launches_by_head_dim[hd],
                  f"dkv_c{hd}": fa.dkv_launches_by_head_dim[hd],
                  f"dq_c{hd}": fa.dq_launches_by_head_dim[hd]})
    for k in fa.HM_KINDS:
        c.update({f"hm_{k}": fa.hm_launches[k], f"hm_{k}_masked": fa.hm_masked_launches[k]})
    return c


def _launch_diff(before: dict, after: dict, steps: int = 1) -> dict:
    """The counters that moved between two ``_counts`` (``before`` {}: since
    zero), per step."""
    return {k: (v - before.get(k, 0)) / steps for k, v in after.items()
            if v != before.get(k, 0)}


def _reset_counts(fa, fm) -> None:
    fa.reset_launch_counts()
    fm.reset_launch_counts()


def phase_train(torch, setup, determinism=False, steps=TRAIN_STEPS, b2=(False, True)):
    """``steps`` pretraining updates of the config of ``train_setup`` at its
    batch (vitl16.yaml: TRAIN_BATCH clips per card), with the launches of
    every update checked whole, one more update profiled, and held against
    the plain versions by one update at B=2 through both, from the seeded
    state and from the state the timed updates leave (``check_b2``; ``b2``
    holds the ``trained`` flags of those it takes); with ``determinism``, first
    two B=2 updates through the kernels from copies of the trained state,
    which must agree to the bit."""
    from jepa_tpu_torch.ops import flash_attention as fa
    from jepa_tpu_torch.ops import fused_mlp as fm
    from jepa_tpu_torch.train.step import init_train_state

    batch = setup["yaml_batch"]
    want = expected_launches(setup["enc_cfg"], setup["pred_cfg"], setup["keep"])
    log(f"train: {setup['config']}{' (tube masks)' if setup['tube'] else ''}"
        f"{'' if setup['use_mask_tokens'] else ' (diffusion-mode predictor)'}, "
        f"{setup['model_name']} (fused_mlp {setup['enc_cfg'].fused_mlp!r}, remat "
        f"{setup['remat']!r}) + predictor {setup['pred_cfg'].depth}x"
        f"{setup['pred_cfg'].predictor_embed_dim}, batch {batch}, keep counts "
        f"{setup['keep']}, expected launches/step {want}")
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    state = init_train_state(setup["enc_cfg"], setup["pred_cfg"], gen)  # device="cuda"
    clips = torch.randn((batch, *setup["clip_shape"]), generator=gen, device="cuda")
    torch.cuda.synchronize()
    log(f"train: seeded state and clips in {time.perf_counter() - t0:.1f} s")

    step_fn = setup["step_fn"]
    small = {"clips": clips[:2].contiguous()}
    if False in b2:
        check_b2(torch, step_fn, state, small, trained=False)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(fa, fm)
    times, per_step = [], []
    for _ in range(steps):
        before = _counts(fa, fm)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, {"clips": clips})
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        per_step.append(_launch_diff(before, _counts(fa, fm)))
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
        f"{med:.1f} ms ({batch / med * 1e3:.2f} clips/s); peak allocated "
        f"{peak_gib:.2f} GiB; launches {launches}")
    prof = profile_step(torch, step_fn, state, clips)
    del clips
    if determinism:
        check_update_determinism(torch, step_fn, state, small)
    if True in b2:
        check_b2(torch, step_fn, state, small, trained=True)
    del state, small
    torch.cuda.empty_cache()
    return {"launches": launches, "median_ms": med, "peak_gib": peak_gib, "prof": prof,
            "keep": setup["keep"], "per_step": want, "steps": steps}


def check_b2(torch, step_fn, state, batch, trained):
    """One update of ``batch`` (B=2) through the kernels and through the plain
    versions, each from a copy of ``state``. The loss and both grad norms
    are held at both states (the seeded one and the one the timed updates
    leave). Each module's change (cosine, relative distance) is held from
    the trained state: the first AdamW step is ~sign(g), which flips on
    gradients near 0, so from the seeded state it is logged.
    ``phase_b2_spread`` measures how far these numbers move when only the
    order of the plain versions' sums changes (PERF.md §6)."""
    import copy

    modules = ("encoder", "predictor", "target")
    label = "trained state" if trained else "seeded state"
    before = {m: [p.detach().clone() for p in getattr(state, m).parameters()]
              for m in modules}
    kern, mk = step_fn(copy.deepcopy(state), batch)
    with plain_versions():
        twin, mp = step_fn(copy.deepcopy(state), batch)
    torch.cuda.synchronize()
    cmp = {k: abs(mk[k].item() - mp[k].item()) / abs(mp[k].item())
           for k in ("loss", "enc_grad_norm", "pred_grad_norm")}
    log(f"train B={batch['clips'].shape[0]}, {label}, kernels vs plain versions: loss "
        f"{mk['loss'].item():.6f} vs {mp['loss'].item():.6f} (rel {cmp['loss']:.2e}, tol "
        f"{TRAIN_LOSS_REL}); enc_grad_norm {mk['enc_grad_norm'].item():.6g} vs "
        f"{mp['enc_grad_norm'].item():.6g} (rel {cmp['enc_grad_norm']:.2e}), "
        f"pred_grad_norm rel {cmp['pred_grad_norm']:.2e} (tol {TRAIN_GNORM_REL})")
    ok = (cmp["loss"] <= TRAIN_LOSS_REL and cmp["enc_grad_norm"] <= TRAIN_GNORM_REL
          and cmp["pred_grad_norm"] <= TRAIN_GNORM_REL)
    for m in modules:  # each module's change in this update, kernels vs plain
        dk = torch.cat([(p.detach() - p0).flatten()
                        for p, p0 in zip(getattr(kern, m).parameters(), before[m])])
        dp = torch.cat([(p.detach() - p0).flatten()
                        for p, p0 in zip(getattr(twin, m).parameters(), before[m])])
        cos = torch.nn.functional.cosine_similarity(dk, dp, dim=0).item()
        rel = ((dk - dp).norm() / dp.norm()).item()
        held = (f"min {TRAIN_UPDATE_COS}, tol {TRAIN_UPDATE_REL[m]}" if trained
                else "not held: the first AdamW step is ~sign(g)")
        log(f"train B={batch['clips'].shape[0]}, {label}, {m} update: cosine {cos:.7f}, "
            f"|dk - dp|/|dp| {rel:.3e} ({held})")
        ok = ok and (not trained or (cos >= TRAIN_UPDATE_COS and rel <= TRAIN_UPDATE_REL[m]))
    del kern, twin, before
    if not ok:
        raise RuntimeError(f"the B=2 update from the {label} through the kernels disagrees "
                           "with the plain versions")


def check_update_determinism(torch, step_fn, state, batch):
    """Two updates from copies of ``state`` on ``batch``: the metrics, the
    encoder, predictor and target and the AdamW moments must be bit-equal
    (every kernel on the path sums in a fixed order)."""
    import copy

    runs = []
    for _ in range(2):
        twin = copy.deepcopy(state)
        twin, metrics = step_fn(twin, batch)
        runs.append((twin, metrics))
    torch.cuda.synchronize()
    (a, ma), (b, mb) = runs
    differ = [k for k, v in ma.items() if torch.is_tensor(v) and not v.equal(mb[k])]
    for m in ("encoder", "predictor", "target"):
        differ += [f"{m}.{n}" for (n, p), q in zip(getattr(a, m).named_parameters(),
                                                  getattr(b, m).parameters())
                   if not p.equal(q)]
    differ += [f"moments of {n}" for n in a.mu
               if not (a.mu[n].equal(b.mu[n]) and a.nu[n].equal(b.nu[n]))]
    log(f"train B={batch['clips'].shape[0]}: two updates from one state, losses "
        f"{ma['loss'].item():.9g} / {mb['loss'].item():.9g}; metrics, parameters and "
        f"moments that differ: {len(differ)}")
    if differ:
        raise RuntimeError(f"two updates from one state differ: {differ[:8]}")


def phase_force_ab(torch, setup, force):
    """The A/B of the trainable fc1 on one seeded state at TRAIN_BATCH: the
    default update (eager fc1 + GeluFast) and the ``fused_mlp='force'``
    update (H8 + LinearGelu's backward) in turns, D F F D after one
    warm-up of each; each update timed by the host clock to a synchronise,
    with its own peak of allocated memory."""
    from jepa_tpu_torch.train.step import init_train_state

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    state = init_train_state(setup["enc_cfg"], setup["pred_cfg"], gen)
    batch = {"clips": torch.randn((TRAIN_BATCH, *setup["clip_shape"]), generator=gen,
                                  device="cuda")}
    fns = {"default": setup["step_fn"], "force": force["step_fn"]}
    times = {k: [] for k in fns}
    peaks = dict.fromkeys(fns, 0.0)
    for i, name in enumerate(("default", "force", "default", "force", "force", "default")):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, _ = fns[name](state, batch)
        torch.cuda.synchronize()
        if i >= 2:  # after each variant's warm-up
            times[name].append((time.perf_counter() - t0) * 1e3)
            peaks[name] = max(peaks[name], torch.cuda.max_memory_allocated() / 2**30)
    out = {k: dict(median_ms=statistics.median(v), times=v, peak_gib=peaks[k])
           for k, v in times.items()}
    d, f = out["default"], out["force"]
    log(f"A/B fused trainable fc1 (B={TRAIN_BATCH}, in turns): default "
        f"{[round(t, 1) for t in d['times']]} ms, median {d['median_ms']:.1f} ms, peak "
        f"{d['peak_gib']:.2f} GiB; force {[round(t, 1) for t in f['times']]} ms, median "
        f"{f['median_ms']:.1f} ms, peak {f['peak_gib']:.2f} GiB; force - default "
        f"{f['median_ms'] - d['median_ms']:+.1f} ms")
    return out


def profile_step(torch, step_fn, state, clips):
    """One more update under torch.profiler: device time by kernel."""
    return profile_device(torch, lambda: step_fn(state, {"clips": clips}), "train")


def profile_device(torch, fn, label):
    """fn() once under torch.profiler: device self time by kernel group, the
    top kernels and the aten ops that launched the most device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    from torch.autograd import DeviceType

    averages = prof.key_averages()  # aggregating the events is the slow part: once
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in averages
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    total = sum(r[1] for r in rows)
    groups = {"H1 flash_fwd": 0.0, "H2 flash_bwd_dkv": 0.0, "H2 flash_bwd_dq": 0.0,
              "H4-H7 flash_hm": 0.0, "H3/H8 linear_gelu": 0.0, "GEMM (cuBLAS)": 0.0,
              "other": 0.0}
    for name, ms, _ in rows:
        if "flash_hm" in name:
            groups["H4-H7 flash_hm"] += ms
        elif "flash_fwd_kernel" in name:
            groups["H1 flash_fwd"] += ms
        elif "flash_bwd_dkv" in name:
            groups["H2 flash_bwd_dkv"] += ms
        elif "flash_bwd_dq" in name:
            groups["H2 flash_bwd_dq"] += ms
        elif "linear_gelu" in name:
            groups["H3/H8 linear_gelu"] += ms
        elif any(t in name.lower() for t in ("gemm", "xmma", "cutlass", "nvjet")):
            groups["GEMM (cuBLAS)"] += ms
        else:
            groups["other"] += ms
    log(f"{label} profile: device self time {total:.2f} ms in one call; " + "; ".join(
        f"{k} {v:.2f} ms ({100 * v / max(total, 1e-9):.1f} %)" for k, v in groups.items()))
    for name, ms, n in sorted(rows, key=lambda r: -r[1])[:12]:
        log(f"  {ms:9.3f} ms  x{n:<5d} {name[:110]}")
    ops = [(e.key, e.self_device_time_total / 1e3, e.count) for e in averages
           if e.device_type == DeviceType.CPU and e.key.startswith("aten::")
           and e.self_device_time_total > 0]
    log(f"{label} profile, device time by the aten op that launched it:")
    for name, ms, n in sorted(ops, key=lambda r: -r[1])[:10]:
        log(f"  {ms:9.3f} ms  x{n:<5d} {name}")
    return {"device_ms": total, "groups": groups}


def kernel_split_ms(torch, fn, n=10):
    """{kernel name: device ms per call of fn} over n calls under
    torch.profiler (the kernels one entry launches, each timed alone)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()

    def name(key):  # the kernel's name and template arguments
        m = re.search(r"([A-Za-z_]\w*(?:<[^>]*>)?)\(", key)
        return m[1] if m else key

    return {name(e.key): e.self_device_time_total / 1e3 / n
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


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


def phase_app(torch, repo, setup, workdir, ipe=APP_IPE, epochs=1, resume=True, padded=True):
    """The pretrain app on ``setup``'s config (``train_setup``: its model,
    its tube masks if any) on synthetic data, ``ipe`` updates per epoch:
    fixed mode ``epochs`` epochs, a resume to one more, then padded mode 1
    epoch, each with the launch counts set to 0 just before and read just
    after; api.load_encoder reads the fixed run's checkpoint. The app runs
    its default activation checkpointing (meta.remat absent: 'attn')."""
    import shutil

    import yaml

    from jepa_tpu_torch import api
    from jepa_tpu_torch.apps.vjepa.train import main as train_main
    from jepa_tpu_torch.masks.multiblock3d import calibrate_pad_ladders
    from jepa_tpu_torch.masks.padding import static_cap
    from jepa_tpu_torch.ops import flash_attention as fa
    from jepa_tpu_torch.ops import fused_mlp as fm

    with open(os.path.join(repo, "configs", "pretrain", setup["config"])) as f:
        cfg = yaml.safe_load(f)
    cfg["data"]["dataset_type"] = "synthetic"
    cfg["model"]["model_name"] = setup["model_name"]
    if setup["tube"]:
        cfg["data"]["mask_type"] = "random_tube"
        cfg["mask"] = setup["tube"]
    cfg["optimization"]["ipe"] = ipe
    cfg["optimization"]["epochs"] = epochs
    cfg["logging"]["folder"] = os.path.join(workdir, "fixed")
    d = cfg["data"]
    label = f"{setup['config']}{' (tube masks)' if setup['tube'] else ''} with {setup['model_name']}"
    torch.cuda.empty_cache()  # a fresh allocator, as the app has in its own process
    retries0 = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    log(f"app: {label}, synthetic data, ipe {ipe}, batch {d['batch_size']}, "
        f"{d['num_workers']} loader workers; free disk "
        f"{shutil.disk_usage(workdir).free / 2**30:.1f} GiB")
    out = {}
    want_fixed = expected_launches(setup["enc_cfg"], setup["pred_cfg"], setup["keep"])

    torch.cuda.reset_peak_memory_stats()
    _reset_counts(fa, fm)
    t0 = time.perf_counter()
    state = train_main(cfg)  # device="cuda"
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = _counts(fa, fm)
    steps = epochs * ipe
    if state.step != steps:
        raise RuntimeError(f"app fixed: step {state.step} != {steps}")
    per_update = _launch_diff({}, got, steps)
    if per_update != want_fixed:
        raise RuntimeError(f"app fixed: launches per update {per_update} != {want_fixed}")
    tag = cfg["logging"]["write_tag"]
    csv = os.path.join(cfg["logging"]["folder"], f"{tag}_r0.csv")
    ckpt = os.path.join(cfg["logging"]["folder"], f"{tag}-latest.pth.tar")
    peak = torch.cuda.max_memory_allocated() / 2**30
    remat = (state.encoder.cfg.remat, state.predictor.cfg.remat)
    log(f"app fixed: {steps} updates in {secs:.1f} s (build of state, loader, checkpoints "
        f"included); remat (encoder, predictor) {remat}; checkpoint "
        f"{os.path.getsize(ckpt) / 2**30:.2f} GiB; launches per update {per_update}")
    if remat != ("attn", "attn"):
        raise RuntimeError(f"app: remat {remat}, not the JAX app's default ('attn', 'attn')")

    # the app's checkpoint through the serving API: the EMA target's features
    geo = dict(VITL16_GEO, img_size=d["crop_size"])
    clips = np.random.default_rng(SEED).integers(
        0, 256, size=(2, 16, d["crop_size"], d["crop_size"], 3), dtype=np.uint8)
    feats = api.load_encoder(ckpt, setup["model_name"], **geo).encode(clips)
    want = api.Encoder(model=state.target, cfg=setup["enc_cfg"]).encode(clips)
    err = (feats - want).abs().max().item()
    log(f"app: api.load_encoder on {os.path.basename(ckpt)} vs the state's target, "
        f"features max|d| {err:.3e} (tol 1e-3)")
    if not (torch.isfinite(feats).all() and err <= 1e-3):
        raise RuntimeError("api.load_encoder does not read the app's checkpoint")
    del state, feats, want
    torch.cuda.empty_cache()

    fixed_launches = got
    if resume:  # to one more epoch
        cfg["optimization"]["epochs"] = epochs + 1
        _reset_counts(fa, fm)
        state = train_main(cfg)
        got = _counts(fa, fm)
        if (state.step != (epochs + 1) * ipe
                or _launch_diff({}, got, ipe) != want_fixed):
            raise RuntimeError(f"app resume: step {state.step}, launches {got}")
        fixed_launches = {k: v + got[k] for k, v in fixed_launches.items()}
        steps = state.step
        del state
    step_ms, wall_ms, host, n_rows = _csv_times(csv)
    if n_rows != steps:
        raise RuntimeError(f"app: {n_rows} CSV rows != {steps}")
    out["fixed"] = dict(step_ms=step_ms, wall_ms=wall_ms, host=host, peak_gib=peak,
                        launches=fixed_launches, updates=steps)
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries0
    log(f"app fixed{' + resume' if resume else ''}: step {steps}, {n_rows} CSV rows; median "
        f"step {step_ms:.0f} ms, wall {wall_ms:.0f} ms, host (loader + augment) share of the "
        f"wall {100 * host:.1f} %, peak allocated {peak:.2f} GiB, allocator retries {retries}")
    shutil.rmtree(cfg["logging"]["folder"])
    torch.cuda.empty_cache()
    if not padded:
        return out

    # padded mode, one epoch
    cfg["meta"]["mask_mode"] = "padded"
    cfg["optimization"]["epochs"] = 1
    cfg["logging"]["folder"] = os.path.join(workdir, "padded")
    grid = setup["grid"]
    if setup["tube"]:  # one tier of static caps (the app's rule for exact-K masks)
        specs_caps = [[(static_cap(grid.n, ke / grid.n), static_cap(grid.n, kp / grid.n))]
                      for ke, kp in setup["keep"]]
    else:
        specs_caps = calibrate_pad_ladders(setup["specs"], grid, d["batch_size"])
    want_padded = expected_launches(setup["enc_cfg"], setup["pred_cfg"],
                                    [rungs[0] for rungs in specs_caps], masked=True)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(fa, fm)
    state = train_main(cfg)
    torch.cuda.synchronize()
    got = _counts(fa, fm)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if state.step != ipe or _launch_diff({}, got, ipe) != want_padded:
        raise RuntimeError(f"app padded: step {state.step}, launches {got} != "
                           f"{ipe} x {want_padded}")
    step_ms, wall_ms, host, n_rows = _csv_times(
        os.path.join(cfg["logging"]["folder"], f"{tag}_r0.csv"))
    out["padded"] = dict(step_ms=step_ms, wall_ms=wall_ms, host=host, peak_gib=peak,
                         launches=got, ladders=specs_caps, updates=ipe)
    log(f"app padded: step {state.step}, caps {specs_caps}; launches per update "
        f"{_launch_diff({}, got, ipe)}; median step {step_ms:.0f} ms, wall "
        f"{wall_ms:.0f} ms, host share {100 * host:.1f} %, peak allocated {peak:.2f} GiB")
    del state
    shutil.rmtree(cfg["logging"]["folder"])
    torch.cuda.empty_cache()
    return out


def eval_config(repo, workdir, name, enc_path, n_train, n_val,
                config="vitl16_k400_16x8x3.yaml", **opt):
    """configs/evals/<config> with the seeded encoder, the synthetic decode
    and CSV manifests of n_train / n_val synthetic videos (seeded labels in
    [0, 400)) in workdir/name; ``opt`` overrides keys of its optimization
    section."""
    import yaml

    with open(os.path.join(repo, "configs", "evals", config)) as f:
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


def eval_features_vs_plain(torch, vcf, inputs, cos_min, label, checked=None):
    """The frozen features of an eval run's first train and first val batch
    through the kernels (``vcf.encode_views`` on the batch, its steps'
    launch shapes), against the plain versions on the same clips, one
    sample at a time: the encoder sees each clip alone, so that is the
    same function at a fraction of the plain attention's memory.
    ``checked``: (segments, views), the batch's first that many of each
    (ViT-H: a whole sample's plain attention does not fit). Returns the
    min cosine per kind."""
    out = {}
    with torch.no_grad():
        for kind, (probe, clips, kw) in inputs.items():
            across, pos, ci = (kw["attend_across_segments"], kw.get("pos_table"),
                               kw.get("clip_indices"))
            if checked:
                clips = clips[:, :checked[0], :checked[1]]
                ci = None if ci is None else ci[:, :checked[0]]
            clips = clips.cuda()
            feats = vcf.encode_views(probe, clips, across, pos, ci)
            with plain_versions():
                per_sample = [vcf.encode_views(probe, clips[i:i + 1], across, pos,
                                               None if ci is None else ci[i:i + 1])
                              for i in range(clips.shape[0])]
            refs = [torch.cat(views) for views in zip(*per_sample)]
            del per_sample
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
            del feats, refs
    return out


def _fmt_host(share):
    return "not measured (no back-to-back steps)" if share is None else f"{100 * share:.1f} %"


def phase_eval_video(torch, repo, workdir, enc_path, bf16: bool,
                     config="vitl16_k400_16x8x3.yaml", entries=None, resume=None,
                     views_checked=None):
    """The video eval (jepa_tpu_torch.evals.video_classification_frozen.main)
    on configs/evals/<config> (default vitl16_k400_16x8x3.yaml) at its
    model's full width and depth. bf16: the config's batch 4, ``entries``
    (default EVAL_BF16_ENTRIES) synthetic videos, 1 epoch then (``resume``,
    default on) a resume to 2. fp32 (use_bfloat16: false): batch 1,
    EVAL_F32_ENTRIES, 1 epoch. Checks the launches and H3 rows of every
    step, the resume step, the CSV, the probe checkpoint and finite
    results, then the features of the first train and val batch against
    the plain versions (``views_checked``: of their first (segments, views),
    ``eval_features_vs_plain``)."""
    from jepa_tpu_torch.evals import video_classification_frozen as vcf
    from jepa_tpu_torch.models.factory import vit_cfg
    from jepa_tpu_torch.ops import flash_attention as fa
    from jepa_tpu_torch.ops import fused_mlp as fm

    batch = 4 if bf16 else 1
    n_train, n_val = entries or (EVAL_BF16_ENTRIES if bf16 else EVAL_F32_ENTRIES)
    resume = bf16 if resume is None else resume
    name = f"{config.split('_k400')[0]}_k400_{'bf16' if bf16 else 'fp32'}"
    cfg = eval_config(repo, workdir, name, enc_path, n_train, n_val, config=config,
                      batch_size=batch, num_epochs=1, use_bfloat16=bf16)
    d, p = cfg["data"], cfg["pretrain"]
    res = cfg["optimization"].get("resolution", d.get("resolution", 224))
    enc = vit_cfg(p["model_name"], img_size=res, patch_size=p["patch_size"],
                  num_frames=p["frames_per_clip"], tubelet_size=p["tubelet_size"])
    depth, c = enc.depth, enc.embed_dim // enc.num_heads
    s, v = d["num_segments"], d["num_views_per_segment"]
    n_tok = enc.num_patches
    keys = (f"h1_c{c}", "h3") if bf16 else ("h1_f32" if c == 64 else f"h1_f32_c{c}", "h3_f32")
    per_step = {k: depth for k in keys}
    if bf16:
        per_step["h1"] = depth  # the bf16 total counter moves with its instance's
        if (c, n_tok) == (K2_C, K2_N):
            per_step[K2_KEY] = depth
    want = {"train_step": (per_step, batch * s * n_tok),
            "val_step": (per_step, batch * s * v * n_tok)}
    log(f"eval {name}: {config} ({p['model_name']}, {res} px), batch {batch}, "
        f"{s} segments x {v} views, "
        f"{n_train} train / {n_val} val synthetic videos; expected per step {per_step}, "
        f"H3 rows train {want['train_step'][1]} / val {want['val_step'][1]}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(fa, fm)
    t0 = time.perf_counter()
    with spy_steps(torch, vcf, fa, fm) as rec:
        accs = vcf.main(cfg)  # device="cuda"
        if resume:  # to 2 epochs from the probe checkpoint
            cfg["optimization"]["num_epochs"] = 2
            cfg["resume_checkpoint"] = True
            rec["inputs"].clear()  # so the first run's probe and encoder can go
            accs += vcf.main(cfg)
    secs = time.perf_counter() - t0
    launches = _counts(fa, fm)
    peak = torch.cuda.max_memory_allocated() / 2**30
    cos = eval_features_vs_plain(torch, vcf, rec.pop("inputs"),
                                 FEAT_COS_MIN if bf16 else F32_FEAT_COS_MIN, name,
                                 views_checked)
    epochs = 2 if resume else 1
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
    if resume and rec["train_step"][ipe]["step_before"] != ipe:
        raise RuntimeError(f"eval {name}: the resumed run started at probe step "
                           f"{rec['train_step'][ipe]['step_before']}, not {ipe}")
    (tr_ms, tr_host, tr_aug), (va_ms, va_host, _) = times["train_step"], times["val_step"]
    log(f"eval {name}: {epochs} epoch(s) in {secs:.1f} s (loaders and checkpoints "
        f"included){'; resumed at probe step ' + str(ipe) if resume else ''}; train losses "
        f"{[round(x, 4) for x in losses]}, val accs {accs}; median train step {tr_ms:.1f} ms "
        f"(host share of the wall {_fmt_host(tr_host)}, augmentation on the card "
        f"{_fmt_host(tr_aug)}), median val step {va_ms:.1f} ms "
        f"(host share {_fmt_host(va_host)}); peak allocated {peak:.2f} GiB; launches "
        f"{ {k: x for k, x in launches.items() if x} }")
    return dict(launches=launches, train_ms=tr_ms, val_ms=va_ms, train_host=tr_host,
                train_aug=tr_aug, val_host=va_host, peak_gib=peak, feat_cos=cos,
                steps=len(rec["train_step"]) + len(rec["val_step"]))


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


IMAGE_EVAL_IMAGES = (48, 16)  # (train, val) seeded 320x240 JPEGs in 4 classes: 3 train
                              # steps and 1 val step at the config's batch 16
IMAGE_EVAL_WORKERS = 8
OFF_SIZE_CLIPS = ((16, 256), (8, 224))  # (frames, px) served by the 224 px, 16-frame
                                        # ViT-L: N = 2048 and N = 784 tokens
OFF_SIZE_REQUESTS = 4
INSTR_IPE = 2      # updates of the app run with logging.profile_steps and log_resources
PROFILE_STEPS = [1, 1]  # one traced update, after the first


def phase_image_eval(torch, repo, workdir, enc_path):
    """(b) The image eval through ``evals.main`` (the CLI a user runs) at
    configs/evals/vitl16_in1k.yaml's geometry on IMAGE_EVAL_IMAGES seeded
    320x240 JPEGs in 4 classes, written with PIL, with IMAGE_EVAL_WORKERS
    loader workers: first the default process pool, which forks after
    CUDA is up (the train and the val loader), then the same run with
    ``use_processes=False`` (threads). Each run: every step's launches and
    H3 rows checked, finite losses, the probe checkpoint and the host share
    of the wall between back-to-back train steps; the process pool's run
    also the features of its first train and val batch against the plain
    versions."""
    import yaml
    from PIL import Image

    from jepa_tpu_torch.data import image_dataset
    from jepa_tpu_torch.evals import image_classification_frozen as icf
    from jepa_tpu_torch.evals.main import main as eval_cli
    from jepa_tpu_torch.models.factory import vit_cfg
    from jepa_tpu_torch.ops import flash_attention as fa
    from jepa_tpu_torch.ops import fused_mlp as fm

    root = os.path.join(workdir, "images")
    rng = np.random.default_rng(SEED)
    y, x = np.mgrid[0:240, 0:320]
    for split, n in zip(("train", "val"), IMAGE_EVAL_IMAGES):
        for i in range(n):
            d = os.path.join(root, "imgs", split, f"class{i % 4}")
            os.makedirs(d, exist_ok=True)
            f = rng.uniform(0.01, 0.1, 3)  # a smooth pattern plus noise: JPEG-like content
            img = 127.5 * (1 + np.sin(f[:, None, None] * (x + y * (i % 4)) + rng.uniform(0, 6)))
            img = img.transpose(1, 2, 0) + rng.normal(0, 8, (240, 320, 3))
            Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
                os.path.join(d, f"{i}.jpg"), quality=90)
    with open(os.path.join(repo, "configs", "evals", "vitl16_in1k.yaml")) as f:
        cfg = yaml.safe_load(f)
    p, o = cfg["pretrain"], cfg["optimization"]
    cfg["data"].update(root_path=root, image_folder="imgs", num_workers=IMAGE_EVAL_WORKERS)
    o["num_epochs"] = 1
    enc_cfg = vit_cfg(p["model_name"], img_size=cfg["data"]["resolution"],
                      patch_size=p["patch_size"], num_frames=p["frames_per_clip"],
                      tubelet_size=p["tubelet_size"])
    b = o["batch_size"]
    per_step = {"h1": enc_cfg.depth, "h1_c64": enc_cfg.depth, "h3": enc_cfg.depth}
    want = {"train_step": (per_step, b * enc_cfg.num_patches),
            "val_step": (per_step, b * enc_cfg.num_patches)}
    real_loader = image_dataset.make_image_loader
    out = {"launches": {}}
    for procs in (True, False):
        mode = "processes" if procs else "threads"
        p.update(folder=os.path.join(workdir, f"image_eval_{mode}"), checkpoint=enc_path)
        path = os.path.join(workdir, f"image_eval_{mode}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
        pools = []

        def recording_loader(**kw):
            ds, loader, sampler = real_loader(**kw, **({} if procs else {"use_processes": False}))
            pools.append(loader.use_processes)
            return ds, loader, sampler

        torch.cuda.empty_cache()
        _reset_counts(fa, fm)
        t0 = time.perf_counter()
        with spy_steps(torch, icf, fa, fm) as rec, \
                mock.patch.object(icf, "make_image_loader", recording_loader):
            accs = eval_cli(["--fname", path])  # the card
        secs = time.perf_counter() - t0
        launches = _counts(fa, fm)
        if pools != [procs, procs]:
            raise RuntimeError(f"image eval ({mode}): loaders use_processes {pools}")
        n_train = IMAGE_EVAL_IMAGES[0] // b
        if len(rec["train_step"]) != n_train or len(rec["val_step"]) != 1:
            raise RuntimeError(f"image eval ({mode}): {len(rec['train_step'])} train and "
                               f"{len(rec['val_step'])} val steps")
        times = _check_steps(rec, want, f"image eval ({mode})")
        losses = [float(s["out"]["loss"]) for s in rec["train_step"]]
        if not (all(np.isfinite(losses)) and len(accs) == 1 and 0.0 <= accs[0] <= 100.0):
            raise RuntimeError(f"image eval ({mode}): losses {losses}, val accs {accs}")
        folder = os.path.join(p["folder"], "image_classification_frozen", cfg["tag"])
        saved = torch.load(os.path.join(folder, f"{p['write_tag']}-latest.pth.tar"),
                           weights_only=True)
        if saved["opt"]["step"] != n_train or saved["epoch"] != 1:
            raise RuntimeError(f"image eval ({mode}): checkpoint step {saved['opt']['step']}")
        cos = {}  # the threads run's batches are the process pool's (tests/test_torch_host.py)
        with torch.no_grad():
            for kind, (probe, imgs, _) in (rec.pop("inputs").items() if procs else ()):
                feats = icf.encode_images(probe, imgs.cuda())
                with plain_versions():
                    ref = icf.encode_images(probe, imgs.cuda())
                cos[kind] = torch.nn.functional.cosine_similarity(feats, ref, dim=-1).min().item()
                if not (torch.isfinite(feats).all() and cos[kind] >= FEAT_COS_MIN):
                    raise RuntimeError(f"image eval ({mode}) {kind} features disagree with "
                                       f"the plain versions: min cosine {cos[kind]}")
        (tr_ms, tr_host, tr_aug), (va_ms, _, _) = times["train_step"], times["val_step"]
        log(f"image eval ({mode}, {IMAGE_EVAL_WORKERS} workers, nproc {os.cpu_count()}): "
            f"{secs:.1f} s through evals.main; train losses {[round(v, 4) for v in losses]}, "
            f"val acc {accs}; median train step {tr_ms:.1f} ms (host share of the wall "
            f"{_fmt_host(tr_host)}, augmentation on the card {_fmt_host(tr_aug)}), val step "
            f"{va_ms:.1f} ms" + (f"; features vs plain min cosine train "
                                 f"{cos['train_step']:.7f} / val {cos['val_step']:.7f}"
                                 if cos else ""))
        out[mode] = dict(train_ms=tr_ms, val_ms=va_ms, host=tr_host, aug=tr_aug, secs=secs,
                         feat_cos=cos)
        out["launches"] = _sum_launches(out["launches"], launches)
        del rec
    return out


def phase_serve_off_size(torch, enc_path):
    """(d) The seeded ViT-L/16 (224 px, 16 frames) serving clips off its
    grid through ``api.Encoder.encode`` (the pos-embed table resized as
    ``jax.image.resize`` does): OFF_SIZE_REQUESTS requests of 2 clips at
    each OFF_SIZE_CLIPS geometry, every request's launches checked whole
    and H1 c=64's counted at its N, the features against the plain
    versions."""
    import dataclasses

    from jepa_tpu_torch import api
    from jepa_tpu_torch.ops import flash_attention as fa
    from jepa_tpu_torch.ops import fused_mlp as fm

    enc = api.load_encoder(enc_path, "vit_large", **VITL16_GEO)
    rng = np.random.default_rng(SEED + 1)
    out = {"launches": {}}
    for frames, px in OFF_SIZE_CLIPS:
        cfg = dataclasses.replace(enc.cfg, img_size=px, num_frames=frames)
        n_tok = cfg.num_patches
        want = expected_launches(cfg)
        requests = [rng.integers(0, 256, size=(2, frames, px, px, 3), dtype=np.uint8)
                    for _ in range(OFF_SIZE_REQUESTS)]
        _reset_counts(fa, fm)
        times, deltas = [], []
        for clips in requests:
            c0 = _counts(fa, fm)
            t0 = time.perf_counter()
            feats = enc.encode(clips)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            deltas.append(_launch_diff(c0, _counts(fa, fm)))
        at_n = fa.launches_by_tokens[64, n_tok]
        if any(d != want for d in deltas) or at_n != enc.cfg.depth * len(requests):
            raise RuntimeError(f"serve off-size {frames}x{px}: launches {deltas} != {want}, "
                               f"H1 c=64 at N={n_tok}: {at_n}")
        with plain_versions():
            ref = enc.encode(clips)
        torch.cuda.synchronize()
        cos = torch.nn.functional.cosine_similarity(feats, ref, dim=-1).min().item()
        if (tuple(feats.shape) != (2, n_tok, enc.cfg.embed_dim)
                or not torch.isfinite(feats).all() or cos < FEAT_COS_MIN):
            raise RuntimeError(f"serve off-size {frames}x{px}: features {tuple(feats.shape)}, "
                               f"min cosine vs plain {cos}")
        med = statistics.median(times[1:])
        log(f"serve off-size {frames} frames x {px} px (N={n_tok}, B=2): ms/request "
            f"{[round(t, 3) for t in times]}, median after warm-up {med:.3f} ms; launches per "
            f"request {deltas[0]}, H1 c=64 at N={n_tok} {at_n}; features vs plain min cosine "
            f"{cos:.6f} (min {FEAT_COS_MIN})")
        out[frames, px] = dict(median_ms=med, n=n_tok, feat_cos=cos)
        out["launches"] = _sum_launches(out["launches"], _counts(fa, fm))
    del enc
    torch.cuda.empty_cache()
    return out


def phase_app_instruments(torch, repo, setup, workdir):
    """The pretrain app on vitl16.yaml (synthetic data, fixed masks, 1 epoch
    of INSTR_IPE updates) with ``logging.log_resources`` and
    ``logging.profile_steps: PROFILE_STEPS``: launches per update checked
    whole, the resource CSV and the Chrome trace written to the run's
    folder; from the trace, the window's span and the device's busy and
    idle share (kernels summed: one stream) with the loader running."""
    import yaml

    from jepa_tpu_torch.apps.vjepa.train import main as train_main
    from jepa_tpu_torch.ops import flash_attention as fa
    from jepa_tpu_torch.ops import fused_mlp as fm
    from jepa_tpu_torch.utils.monitoring import CSV_HEADER

    with open(os.path.join(repo, "configs", "pretrain", setup["config"])) as f:
        cfg = yaml.safe_load(f)
    folder = os.path.join(workdir, "instruments")
    cfg["data"]["dataset_type"] = "synthetic"
    cfg["optimization"].update(ipe=INSTR_IPE, epochs=1)
    cfg["logging"].update(folder=folder, log_resources=True, profile_steps=PROFILE_STEPS)
    want = expected_launches(setup["enc_cfg"], setup["pred_cfg"], setup["keep"])
    torch.cuda.empty_cache()
    _reset_counts(fa, fm)
    t0 = time.perf_counter()
    state = train_main(cfg)  # the card
    secs = time.perf_counter() - t0
    got = _counts(fa, fm)
    if state.step != INSTR_IPE or _launch_diff({}, got, INSTR_IPE) != want:
        raise RuntimeError(f"app instruments: step {state.step}, launches {got}")
    del state
    resources = os.path.join(folder, "resources_r0.csv")
    trace = os.path.join(folder, "trace_r0.json")
    if not (os.path.exists(resources) and open(resources).read().startswith(CSV_HEADER)):
        raise RuntimeError(f"app instruments: no resource CSV at {resources}")
    if not os.path.exists(trace):
        raise RuntimeError(f"app instruments: no trace at {trace}")
    with open(trace) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    span = max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)
    busy = sum(e["dur"] for e in kernels)
    step_ms, wall_ms, host, n_rows = _csv_times(
        os.path.join(folder, f"{cfg['logging']['write_tag']}_r0.csv"))
    log(f"app instruments: {INSTR_IPE} updates in {secs:.1f} s; trace {trace} "
        f"({os.path.getsize(trace) / 2**20:.1f} MiB, {len(events)} events, {len(kernels)} "
        f"kernels) over steps {PROFILE_STEPS}: span {span / 1e3:.1f} ms, device busy "
        f"{busy / 1e3:.1f} ms, idle share {100 * (1 - busy / span):.1f} %; resource CSV "
        f"{len(open(resources).read().splitlines())} lines; CSV median step {step_ms:.0f} ms, "
        f"wall {wall_ms:.0f} ms, host share {100 * host:.1f} %")
    import shutil

    shutil.rmtree(folder)
    torch.cuda.empty_cache()
    return dict(launches=got, span_ms=span / 1e3, busy_ms=busy / 1e3, step_ms=step_ms,
                wall_ms=wall_ms, host=host, secs=secs)


def phase_diffusion(torch, repo):
    """(c) vitl16.yaml with ``model.use_mask_tokens: false`` (the
    diffusion-mode predictor: the targets noised by one forward-diffusion
    step in place of the mask tokens) at B=TRAIN_BATCH: 3 updates with
    their launches checked whole (the predictor's sequences are as long
    as with mask tokens: H1 72, H2 48 + 48, H3 24 per update), one
    profiled, and the B=2 update against the plain versions from the
    seeded and the trained state (``check_b2``'s limits)."""
    setup = train_setup(repo, use_mask_tokens=False)
    out = phase_train(torch, setup, steps=3)
    del setup
    torch.cuda.empty_cache()
    return out


def timed(label, fn, *args, **kw):
    """fn(*args, **kw), logging how long the phase took."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    log(f"phase {label}: {time.perf_counter() - t0:.1f} s")
    return out


PLAIN_BATCH_BYTES = 4 * 2**30  # a batch's fp32 scores past this: plain versions by sample


def phase_vith_kernels(torch, setups):
    """The instances ViT-H's paths launch, at their shapes, against their
    plain versions on the card (each called a second time, bit-equal;
    the plain versions one sample at a time where a batch's fp32 scores
    pass PLAIN_BATCH_BYTES), timed beside a library call and their bound:
    H1 c=80 at the vith16 target (B=24, N=1568) and the vith16_384 target
    (B=10, N=4608), both H2 kernels at c=80 at the vith16 context (B=24),
    H3 at ViT-H's fc1 (M=24*1568, K=1280, F=5120). Then, checked only:
    every other token-major call of one update of each of ``setups``
    (vith16, vith16_384: H1 and, under a gradient, both H2 kernels at the
    contexts (c=80) and the predictors (c=24->32)), and the fp32 eval of
    vith16_384 at its train step's 8 clips (H1-fp32 c=80 at N=4608, H3-fp32
    at M=8*4608); ``held`` gives each instance's max|d| there."""
    from jepa_tpu_torch.ops import flash_attention as fa
    from jepa_tpu_torch.ops import fused_mlp as fm

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    rep = {}
    h, c = 16, 80
    scale = c**-0.5
    by_sample = lambda b, heads, n: b * heads * n * n * 4 > PLAIN_BATCH_BYTES
    for key, b, n in (("h1_c80", TRAIN_BATCH, 1568), ("h1_c80_n4608", 10, 4608)):
        qkv = torch.randn((b, n, 3 * h * c), generator=gen, device="cuda").to(torch.bfloat16)
        label = f"H1 ViT-H B={b} N={n} H={h} c={c}"
        split = by_sample(b, h, n)
        o, lse, err = _check_h1(torch, label, qkv, h, scale, by_sample=split)
        plain = lambda: _by_sample(torch, split, fa.flash_self_attention_ref, qkv, h, scale)
        r = rep[key] = dict(
            max_abs_err=err, shape=(b, n, h, c),
            ms=time_ms(torch, lambda: fa.flash_self_attention_cuda(qkv, h, scale)),
            plain_ms=time_ms(torch, plain, iters=3, warmup=1),
            library_ms=_sdpa_fwd_ms(torch, qkv, h, scale),
            bound=attn_bound_ms(b, n, h, c, 2, qkv.numel() * 2,
                                b * n * h * c * 2 + b * h * n * 4))
        log(f"{label} time: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
            f"(SDPA forward) {r['library_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms "
            f"({r['bound'][2]})")
        del qkv, o, lse

    ctx = setups[0]["keep"][0][0]  # vith16's first context
    b, n = TRAIN_BATCH, ctx
    qkv, do = _attn_inputs(torch, gen, b, n, h, c)
    o, lse, _ = _check_h1(torch, f"H1 ViT-H context B={b} N={n}", qkv, h, scale)
    delta, errs = _check_h2(torch, f"H2 ViT-H context B={b} N={n} H={h}", qkv, do, o, lse, h,
                            scale, c)
    qkv_b, o_b, vec_b = qkv.numel() * 2, o.numel() * 2, b * h * n * 4
    lib = _sdpa_bwd_ms(torch, qkv, do, h, scale)
    out = torch.empty_like(qkv)
    for key, fn, ref, products, outs, names in (
            ("dkv_c80", fa.flash_bwd_dkv_cuda, fa.flash_bwd_dkv_ref, 4, 2, ("dk", "dv")),
            ("dq_c80", fa.flash_bwd_dq_cuda, fa.flash_bwd_dq_ref, 3, 1, ("dq",))):
        r = rep[key] = dict(
            max_abs_err=max(errs[k] for k in names), shape=(b, n, h, c), library_ms=lib,
            ms=time_ms(torch, lambda: fn(qkv, do, lse, delta, out, h, scale)),
            plain_ms=time_ms(torch, lambda: ref(qkv, do, lse, delta, h, scale)),
            bound=attn_bound_ms(b, n, h, c, products, qkv_b + o_b + 2 * vec_b, outs * o_b))
        log(f"{key} ViT-H context B={b} N={n} H={h} c={c} time: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library (SDPA's whole backward) {lib:.4f} ms, bound "
            f"{r['bound'][0]:.4f} ms ({r['bound'][2]})")
    del qkv, do, o, lse, delta, out

    m, k, f = TRAIN_BATCH * 1568, 1280, 5120
    x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn((f, k), generator=gen, device="cuda") / 32).to(torch.bfloat16)
    bias = torch.randn((f,), generator=gen, device="cuda") * 0.1
    err = _check_h3(torch, f"H3 ViT-H fc1 M={m} K={k} F={f}", x, w, bias)
    bias_lp = bias.to(x.dtype)
    r = rep["h3_k1280"] = dict(
        max_abs_err=err, shape=(m, k, f),
        ms=time_ms(torch, lambda: fm.linear_gelu_cuda(x, w, bias)),
        plain_ms=time_ms(torch, lambda: fm.linear_gelu_ref(x, w, bias)),
        library_ms=time_ms(torch, lambda: torch._addmm_activation(bias_lp, x, w.t(),
                                                                  use_gelu=True)),
        bound=fc1_bound_ms(m, k, f, outputs=1))
    log(f"H3 ViT-H fc1 M={m} K={k} F={f} time: kernel {r['ms']:.4f} ms, plain "
        f"{r['plain_ms']:.4f} ms, library (_addmm_activation) {r['library_ms']:.4f} ms, bound "
        f"{r['bound'][0]:.4f} ms ({r['bound'][2]})")
    del x, w, bias, bias_lp

    held = collections.defaultdict(float)
    done = {(TRAIN_BATCH, 1568, h, c), (10, 4608, h, c), (TRAIN_BATCH, ctx, h, c)}
    for setup in setups:
        b = setup["yaml_batch"]
        for n, heads, c_real, _, grad, _ in attention_calls(setup["enc_cfg"], setup["pred_cfg"],
                                                            setup["keep"]):
            cp = fa.padded_head_dim(c_real)
            if (n < 128 or fa.self_attention_route(heads, c_real, n) != "tm"
                    or (b, n, heads, cp) in done):
                continue
            done.add((b, n, heads, cp))
            split = by_sample(b, heads, n)
            label = (f"{setup['config']} B={b} N={n} H={heads}"
                     + (" (plain versions by sample)" if split else ""))
            qkv, do = _attn_inputs(torch, gen, b, n, heads, cp, c_real)
            sc = c_real**-0.5
            o, lse, err = _check_h1(torch, f"H1 {label} c={c_real}->{cp}", qkv, heads, sc,
                                    by_sample=split)
            held[f"h1_c{cp}"] = max(held[f"h1_c{cp}"], err)
            if grad:
                _, errs = _check_h2(torch, f"H2 {label}", qkv, do, o, lse, heads, sc, c_real,
                                    by_sample=split)
                held[f"dq_c{cp}"] = max(held[f"dq_c{cp}"], errs["dq"])
                held[f"dkv_c{cp}"] = max(held[f"dkv_c{cp}"], errs["dk"], errs["dv"])
            del qkv, do, o, lse
            torch.cuda.empty_cache()
    # the vith16_384 fp32 eval's train step: 8 clips of N=4608
    b, n = 8, setups[-1]["enc_cfg"].num_patches
    qkv = torch.randn((b, n, 3 * h * c), generator=gen, device="cuda")
    held["h1_f32_c80"] = _check_h1_f32(torch, f"H1-fp32 vith16_384 eval B={b} N={n} H={h} c={c}",
                                       qkv, h, scale, by_sample=True)
    del qkv
    m = b * n
    x = torch.randn((m, k), generator=gen, device="cuda")
    w = torch.randn((f, k), generator=gen, device="cuda") / 32
    bias = torch.randn((f,), generator=gen, device="cuda") * 0.1
    held["h3_f32_k1280"] = _check_f32_fc1(torch, f"H3-fp32 vith16_384 eval M={m} K={k} F={f}",
                                          x, w, bias)
    del x, w, bias
    rep["held"] = held
    log(f"ViT-H's other call shapes against the plain versions, max|d| by instance: "
        f"{dict(held)}")
    torch.cuda.empty_cache()
    return rep


def phase_remat(torch, repo):
    """Activation checkpointing at vitl16.yaml (ViT-L, B=TRAIN_BATCH): from
    one seeded state, updates with remat False, True and 'attn' (encoder and
    predictor), each from a copy of the state: one of each first, whose
    loss, metrics, parameters and AdamW moments must be bit-equal across
    the three (the recomputation repeats deterministic kernels), then two
    more of each in turns (F T A A T F), timed by the host clock to a
    synchronise with their peak of allocated memory (the seeded state's
    copy held beside: its GiB are logged), then one profiled each (device
    time). Every update's launches are checked whole: 'attn' those of
    False, True one more H1 per trainable attention block."""
    import copy

    from jepa_tpu_torch.ops import flash_attention as fa
    from jepa_tpu_torch.ops import fused_mlp as fm
    from jepa_tpu_torch.train.step import init_train_state

    setups = {r: train_setup(repo, remat=r) for r in (False, True, "attn")}
    base = setups[False]
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    state = init_train_state(base["enc_cfg"], base["pred_cfg"], gen)
    batch = {"clips": torch.randn((TRAIN_BATCH, *base["clip_shape"]), generator=gen,
                                  device="cuda")}
    torch.cuda.synchronize()
    state_gib = torch.cuda.memory_allocated() / 2**30 - batch["clips"].numel() * 4 / 2**30
    want = {r: expected_launches(s["enc_cfg"], s["pred_cfg"], s["keep"])
            for r, s in setups.items()}
    times = {r: [] for r in setups}
    seen = {r: [] for r in setups}  # each update's launches, as read
    peaks = dict.fromkeys(setups, 0.0)

    def update(remat):
        twin = copy.deepcopy(state)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts(fa, fm)
        t0 = time.perf_counter()
        twin, metrics = setups[remat]["step_fn"](twin, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = _launch_diff({}, _counts(fa, fm))
        if got != want[remat]:
            raise RuntimeError(f"remat {remat!r}: launches {got} != {want[remat]}")
        seen[remat].append(got)
        return twin, metrics, ms

    ref, ref_metrics, _ = update(False)
    for remat in (True, "attn"):
        twin, metrics, _ = update(remat)
        differ = [k for k, v in metrics.items()
                  if torch.is_tensor(v) and not v.equal(ref_metrics[k])]
        for m in ("encoder", "predictor", "target"):
            differ += [f"{m}.{n}" for (n, p), q in zip(
                getattr(twin, m).named_parameters(), getattr(ref, m).parameters())
                       if not p.equal(q)]
        differ += [f"moments of {n}" for n in twin.mu if not (
            twin.mu[n].equal(ref.mu[n]) and twin.nu[n].equal(ref.nu[n]))]
        log(f"remat {remat!r} (encoder and predictor), B={TRAIN_BATCH}: loss "
            f"{metrics['loss'].item():.9g} (remat False {ref_metrics['loss'].item():.9g}); "
            f"metrics, parameters and moments that differ from remat False: {len(differ)}")
        if differ:
            raise RuntimeError(f"remat {remat!r}: the update differs from remat False: "
                               f"{differ[:8]}")
        del twin
    del ref
    for remat in (False, True, "attn", "attn", True, False):
        twin, _, ms = update(remat)
        times[remat].append(ms)
        peaks[remat] = max(peaks[remat], torch.cuda.max_memory_allocated() / 2**30)
        del twin
    out = {}
    for remat, setup in setups.items():
        twin = copy.deepcopy(state)
        prof = profile_device(torch, lambda: setup["step_fn"](twin, batch), f"remat {remat!r}")
        del twin
        out[remat] = dict(median_ms=statistics.median(times[remat]), times=times[remat],
                          peak_gib=peaks[remat], per_update=want[remat], prof=prof,
                          state_gib=state_gib, launches=_sum_launches(*seen[remat]))
        log(f"remat {remat!r}, B={TRAIN_BATCH}, in turns: {[round(t, 1) for t in times[remat]]} "
            f"ms, median {out[remat]['median_ms']:.1f} ms/update, device "
            f"{prof['device_ms']:.1f} ms, peak allocated {peaks[remat]:.2f} GiB (the seeded "
            f"state's copy beside: {state_gib:.2f} GiB); launches/update {want[remat]}, in "
            f"{len(seen[remat])} checked updates {dict(out[remat]['launches'])}")
    del state, batch
    torch.cuda.empty_cache()
    return out


def phase_remat_peak(torch, repo, config, padded):
    """``--remat-peak``: one ViT-H config with meta.remat false, outside the
    smoke (an out-of-memory error ends the command and is the finding):
    TRAIN_STEPS updates through build_train_step (fixed masks), or with
    ``padded`` 1 epoch of 2 updates of the app in padded mode; prints ms per
    update and the peak of allocated memory."""
    import shutil

    import yaml

    from jepa_tpu_torch.apps.vjepa.train import main as train_main

    if not padded:
        setup = train_setup(repo, config=config)
        r = phase_train(torch, setup, b2=())
        log(f"remat-peak {config} fixed, remat False: median {r['median_ms']:.1f} ms/update, "
            f"peak allocated {r['peak_gib']:.2f} GiB")
        return
    with open(os.path.join(repo, "configs", "pretrain", config)) as f:
        cfg = yaml.safe_load(f)
    workdir = tempfile.mkdtemp(dir=repo, prefix=".chip_smoke_")
    cfg["data"]["dataset_type"] = "synthetic"
    cfg["meta"].update(mask_mode="padded", remat=False)
    cfg["optimization"].update(ipe=2, epochs=1)
    cfg["logging"]["folder"] = workdir
    try:
        torch.cuda.reset_peak_memory_stats()
        train_main(cfg)
        step_ms, wall_ms, _, _ = _csv_times(os.path.join(workdir, "jepa_r0.csv"))
    finally:
        shutil.rmtree(workdir)
    log(f"remat-peak {config} padded app, remat False: step {step_ms:.0f} ms, wall "
        f"{wall_ms:.0f} ms, peak allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


# ---- phase_dist: data parallelism ------------------------------------------------

DIST_BATCH = TRAIN_BATCH // 2  # (b): 2 ranks x 12 clips against 1 rank x 24
# (b): the kernels' 2 x 12 vs 1 x 24 spread may be this many times the plain
# versions' on the same inputs (each limit is printed before it is held)
DIST_LIMIT_FACTOR = 10.0
DIST_REL_FLOOR = 1e-6  # a limit never below this relative difference (nor cosine above 1 - it)
DIST_APP_IPE = 2  # (c): updates per epoch of the 2-rank app
DIST_EVAL_ENTRIES = (8, 10)  # (d): train / val videos; 10 is no multiple of 2 ranks x 4
DIST_MODULES = ("encoder", "predictor", "target")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_device(torch):
    """A spawned rank's card settings: cuda:0 (two ranks share the card),
    TF32 off as in the parent."""
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _deltas(torch, state, state0) -> dict:
    """Each module's parameter change, flat fp32."""
    return {m: torch.cat([(p.detach() - p0).flatten() for p, p0 in
                          zip(getattr(state, m).parameters(), getattr(state0, m).parameters())])
            for m in DIST_MODULES}


def _spread(torch, a, b) -> dict:
    """How far update b (metrics, deltas) lies from update a: the relative
    difference of the loss and both grad norms, and per module the cosine
    and |db - da| / |da| of the parameter changes."""
    out = {k: abs(b[0][k] - a[0][k]) / abs(a[0][k])
           for k in ("loss", "enc_grad_norm", "pred_grad_norm")}
    for m in DIST_MODULES:
        da, db = a[1][m], b[1][m]
        out[f"{m}_cos"] = torch.nn.functional.cosine_similarity(da, db, dim=0).item()
        out[f"{m}_rel"] = ((db - da).norm() / da.norm()).item()
    return out


def _dist_limits(plain: dict) -> dict:
    """The limits of the kernels' spread, from the plain versions'."""
    return {k: (1.0 - max(DIST_LIMIT_FACTOR * (1.0 - v), DIST_REL_FLOOR)) if k.endswith("_cos")
            else max(DIST_LIMIT_FACTOR * v, DIST_REL_FLOOR) for k, v in plain.items()}


def _dist_update_rank(rank, world, repo):
    """Phase (b) in one of 2 ranks on the one card (gloo): rank 0 first
    takes the 1-rank update of all TRAIN_BATCH clips (no layout: no
    collectives) through the plain versions and the kernels; then both
    ranks take the 2-rank update of DIST_BATCH clips each (the global
    masks sliced) the same two ways, counting the kernel run's launches;
    then fsdp=2 against fsdp=1, two updates each. Every update starts from
    the same seeded state, built in each rank from SEED."""
    import copy

    import torch

    from jepa_tpu_torch.ops import flash_attention as fa
    from jepa_tpu_torch.ops import fused_mlp as fm
    from jepa_tpu_torch.parallel import dist as pdist
    from jepa_tpu_torch.parallel.mesh import make_layout
    from jepa_tpu_torch.train.step import build_train_step, init_train_state, shard_state_
    from jepa_tpu_torch.utils.checkpoint import gather_moments

    _rank_device(torch)
    one = train_setup(repo, remat="attn")
    two = train_setup(repo, remat="attn", layout=make_layout(1))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    state0 = init_train_state(one["enc_cfg"], one["pred_cfg"], gen)
    clips = [torch.randn((TRAIN_BATCH, *one["clip_shape"]), generator=gen, device="cuda")
             for _ in range(2)]
    mine = [c[rank * DIST_BATCH:(rank + 1) * DIST_BATCH] for c in clips]
    keys = ("loss", "enc_grad_norm", "pred_grad_norm")

    def update(step_fn, batch, plain):
        state = copy.deepcopy(state0)
        with plain_versions() if plain else contextlib.nullcontext():
            state, m = step_fn(state, {"clips": batch})
        torch.cuda.synchronize()
        return {k: m[k].item() for k in keys}, _deltas(torch, state, state0), state

    out = {}
    ref = {}
    if rank == 0:
        for plain in (True, False):
            t0 = time.perf_counter()
            ref[plain] = update(one["step_fn"], clips[0], plain)[:2]
            out[f"one_ms_{'plain' if plain else 'kernels'}"] = (time.perf_counter() - t0) * 1e3
    pdist.barrier()
    torch.cuda.reset_peak_memory_stats()
    for plain in (True, False):
        _reset_counts(fa, fm)
        t0 = time.perf_counter()
        metrics, deltas, state = update(two["step_fn"], mine[0], plain)
        out[f"two_ms_{'plain' if plain else 'kernels'}"] = (time.perf_counter() - t0) * 1e3
        if not plain:
            out["launches"] = _counts(fa, fm)
            checksum = float(sum(p.detach().double().sum() for p in state.named_params().values()))
            pdist.check_same_across_ranks(checksum, "cuda", "parameters after the update")
        if rank == 0:
            out["plain" if plain else "kernels"] = _spread(torch, ref.pop(plain),
                                                           (metrics, deltas))
        out[f"metrics_{'plain' if plain else 'kernels'}"] = metrics
        del deltas, state
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30

    # ZeRO-1: fsdp 2 against fsdp 1, two updates from the seeded state
    layout2 = make_layout(2)
    zero1 = build_train_step(two["enc_cfg"], two["pred_cfg"], two["tc"], *two["scheds"],
                             two["specs"], two["grid"], two["keep"], layout=layout2)
    runs = {}
    for fsdp, step_fn in ((1, two["step_fn"]), (2, zero1)):
        state = shard_state_(copy.deepcopy(state0), layout2 if fsdp == 2 else make_layout(1))
        for batch in mine:
            state, _ = step_fn(state, {"clips": batch})
        mu, nu = gather_moments(state, layout2 if fsdp == 2 else make_layout(1))
        runs[fsdp] = dict(state=state, mu=mu, nu=nu,
                          local=sum(t.numel() for t in state.mu.values()))
    differ = [f"{m}.{n}" for m in DIST_MODULES
              for (n, p), q in zip(getattr(runs[1]["state"], m).named_parameters(),
                                   getattr(runs[2]["state"], m).parameters())
              if not torch.equal(p, q)]
    differ += [f"{k} of {n}" for k in ("mu", "nu") for n, t in runs[1][k].items()
               if not torch.equal(t, runs[2][k][n])]
    out["fsdp_differ"] = differ
    out["fsdp_moment_elems"] = (runs[1]["local"], runs[2]["local"])
    return out


def _dist_app_rank(rank, world, argv):
    """Phase (c) in one rank: the pretrain app through the launcher's
    in-cluster mode (the process group from the SLURM environment the
    parent set), with its launches counted and its checkpoint writes
    recorded."""
    import torch

    from jepa_tpu_torch.apps import main_distributed
    from jepa_tpu_torch.ops import flash_attention as fa
    from jepa_tpu_torch.ops import fused_mlp as fm
    from jepa_tpu_torch.utils import checkpoint as ckpt_lib

    _rank_device(torch)
    writes, save = [], ckpt_lib._save_atomic
    ckpt_lib._save_atomic = lambda obj, path: (writes.append(path), save(obj, path))
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(fa, fm)
    t0 = time.perf_counter()
    state = main_distributed.main(argv)
    torch.cuda.synchronize()
    return dict(step=state.step, writes=writes, launches=_counts(fa, fm),
                secs=time.perf_counter() - t0,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def _dist_eval_rank(rank, world, argv):
    """Phase (d) in one rank: the video eval through the eval launcher's
    in-cluster mode. Records the val pass's global (correct, total), and
    on rank 0 a 1-rank val pass of the same probe at the same point (the
    eval's own val loader rebuilt for rank 0 of 1, its val step, no
    collective; its launches left out of the count)."""
    import torch

    from jepa_tpu_torch.evals import main_distributed
    from jepa_tpu_torch.evals import video_classification_frozen as vcf
    from jepa_tpu_torch.ops import flash_attention as fa
    from jepa_tpu_torch.ops import fused_mlp as fm
    from jepa_tpu_torch.utils import checkpoint as ckpt_lib

    _rank_device(torch)
    rec = {"counts": [], "one_rank": [], "extra": {}}
    loaders, make_loader, val_counts = [], vcf.make_video_loader, vcf.val_counts

    def recording_loader(**kw):
        if not kw.get("training", True):
            loaders.append(kw)
        return make_loader(**kw)

    def recording_counts(loader, n_items, batch_size, step, r, ws):
        rec["counts"].append(val_counts(loader, n_items, batch_size, step, r, ws))
        if rank == 0:
            before = _counts(fa, fm)
            _, one_loader, _ = make_loader(**dict(loaders[-1], rank=0, world_size=1))
            rec["one_rank"].append(val_counts(one_loader, n_items, batch_size, step, 0, 1))
            extra = _launch_diff(before, _counts(fa, fm))
            rec["extra"] = {k: rec["extra"].get(k, 0) + v for k, v in extra.items()}
        return rec["counts"][-1]

    vcf.make_video_loader, vcf.val_counts = recording_loader, recording_counts
    writes, save = [], ckpt_lib._save_atomic
    ckpt_lib._save_atomic = lambda obj, path: (writes.append(path), save(obj, path))
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(fa, fm)
    t0 = time.perf_counter()
    accs = main_distributed.main(argv)
    torch.cuda.synchronize()
    launches = {k: v - rec["extra"].get(k, 0) for k, v in _counts(fa, fm).items()}
    return dict(accs=accs, writes=writes, launches=launches, counts=rec["counts"],
                one_rank=rec["one_rank"], secs=time.perf_counter() - t0,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def _slurm_env(world: int) -> list:
    """Two one-GPU nodes that share this card: SLURM's variables per rank,
    the master on 127.0.0.1."""
    port = _free_port()
    return [dict(SLURM_NTASKS=world, SLURM_PROCID=r, SLURM_LOCALID=0, MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=port) for r in range(world)]


def _run_ranks(fn, args, init_group=True, env=None):
    from jepa_tpu_torch.parallel import dist as pdist

    out = pdist.run_local_ranks(fn, 2, args, init_group=init_group, env=env, timeout=600)
    if any(r["jax_imported"] for r in out):
        raise RuntimeError("a spawned rank imported jax")
    return [r["result"] for r in out]


UPDATE_AB_CHILD = r"""
import json, statistics, sys, time
sys.path.insert(0, ".")
import chip_smoke as cs
import torch
cs.phase_device(torch)
cs.phase_build()
from jepa_tpu_torch.train.step import init_train_state
out = {}
for name, setup in (("vit_tiny", cs.tiny_setup(".")[0]), ("vit_large", cs.train_setup("."))):
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    state = init_train_state(setup["enc_cfg"], setup["pred_cfg"], gen)
    clips = torch.randn((cs.TRAIN_BATCH, *setup["clip_shape"]), generator=gen, device="cuda")
    times = []
    for _ in range(9):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = setup["step_fn"](state, {"clips": clips})
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out[name] = {"median_ms": statistics.median(times[1:]), "loss": m["loss"].item()}
    del state, clips
    torch.cuda.empty_cache()
print("RESULT " + json.dumps(out), flush=True)
"""


def phase_update_ab(repo, others):
    """The 1-rank updates (vit_tiny and vitl16.yaml at TRAIN_BATCH, remat
    False, 1 warm-up + 8 timed from a seeded state) of this checkout and
    each ``--other`` checkout in turns (other, this, this, other), each
    side in its own process with its own build; the losses must agree."""
    sides = [("this", repo)] + [(os.path.basename(d), d) for d in others]
    order = [sides[1], sides[0], sides[0], sides[1]] if len(sides) == 2 else sides
    runs = []
    for name, root in order:
        p = subprocess.run([sys.executable, "-c", UPDATE_AB_CHILD], cwd=root,
                           capture_output=True, text=True, timeout=600)
        line = [x for x in p.stdout.splitlines() if x.startswith("RESULT ")]
        if p.returncode or not line:
            raise RuntimeError(f"update A/B, {name}: {p.stdout[-2000:]} {p.stderr[-2000:]}")
        runs.append((name, json.loads(line[0][len("RESULT "):])))
        log(f"update A/B {name}: {runs[-1][1]}")
    for model in ("vit_tiny", "vit_large"):
        log(f"update A/B {model}: median ms " + ", ".join(
            f"{n} {[round(r[model]['median_ms'], 1) for m, r in runs if m == n]}"
            for n in dict(order)))
        if len({r[model]["loss"] for _, r in runs}) != 1:
            raise RuntimeError(f"update A/B {model}: the losses differ")


def phase_dist(torch, repo, setup, card):
    """Data parallelism on the one card:
    (a) a vitl16.yaml update at B=TRAIN_BATCH in a 1-rank NCCL group (its
        collectives run) against the same update with no group, bit for
        bit (loss, grad norms, every parameter and moment), and its
        launches those of the bare update;
    (b) 2 gloo ranks of DIST_BATCH clips against the 1-rank update of
        their TRAIN_BATCH (``_dist_update_rank``): the limits come from the
        plain versions' spread on the same inputs, measured first and
        printed; then fsdp=2 against fsdp=1 after 2 updates, bit-equal;
    (c) the 2-rank app on vitl16.yaml (per-rank batch 24, ipe
        DIST_APP_IPE), fixed then a resume, and padded, through
        apps/main_distributed.py's in-cluster mode: one checkpoint writer,
        the resume, equal CSV loss columns, each rank's launches those of
        the 1-rank app;
    (d) the 2-rank K400 16x8x3 bf16 eval (batch 4 per rank, one epoch):
        the val pass counts each of an uneven val set's clips once and
        matches a 1-rank val pass of the same probe.
    Spawned ranks fail the phase when they fail."""
    import copy
    import shutil

    import yaml

    from jepa_tpu_torch.masks.multiblock3d import calibrate_pad_ladders
    from jepa_tpu_torch.ops import flash_attention as fa
    from jepa_tpu_torch.ops import fused_mlp as fm
    from jepa_tpu_torch.parallel import dist as pdist
    from jepa_tpu_torch.parallel.mesh import make_layout
    from jepa_tpu_torch.train.step import build_train_step, init_train_state

    out = {}
    want = expected_launches(setup["enc_cfg"], setup["pred_cfg"], setup["keep"])
    # (a) 1 rank through NCCL against no group
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    state0 = init_train_state(setup["enc_cfg"], setup["pred_cfg"], gen)
    clips = torch.randn((TRAIN_BATCH, *setup["clip_shape"]), generator=gen, device="cuda")
    t0 = time.perf_counter()
    bare, mb = setup["step_fn"](copy.deepcopy(state0), {"clips": clips})
    torch.cuda.synchronize()
    bare_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory(dir=repo, prefix=".chip_smoke_") as rdv:
        pdist.initialize(backend="nccl", init_method=f"file://{rdv}/rendezvous", world_size=1,
                         rank=0)
        try:
            step_fn = build_train_step(setup["enc_cfg"], setup["pred_cfg"], setup["tc"],
                                       *setup["scheds"], setup["specs"], setup["grid"],
                                       setup["keep"], layout=make_layout(1))
            _reset_counts(fa, fm)
            t0 = time.perf_counter()
            grouped, mg = step_fn(copy.deepcopy(state0), {"clips": clips})
            torch.cuda.synchronize()
            grouped_ms = (time.perf_counter() - t0) * 1e3
            got = _launch_diff({}, _counts(fa, fm))
        finally:
            torch.distributed.destroy_process_group()
    differ = [k for k, v in mb.items() if torch.is_tensor(v) and not v.equal(mg[k])]
    for m in DIST_MODULES:
        differ += [f"{m}.{n}" for (n, p), q in zip(getattr(bare, m).named_parameters(),
                                                  getattr(grouped, m).parameters())
                   if not p.equal(q)]
    differ += [f"moments of {n}" for n in bare.mu
               if not (bare.mu[n].equal(grouped.mu[n]) and bare.nu[n].equal(grouped.nu[n]))]
    log(f"dist (a): card {card}; vitl16.yaml update B={TRAIN_BATCH} in a 1-rank NCCL group vs "
        f"no group: loss {mg['loss'].item():.9g} / {mb['loss'].item():.9g}, enc_grad_norm "
        f"{mg['enc_grad_norm'].item():.9g} / {mb['enc_grad_norm'].item():.9g}; metrics, "
        f"parameters and moments that differ: {len(differ)}; {grouped_ms:.0f} ms (no group "
        f"{bare_ms:.0f} ms, the first update of each, copy of the state included); launches "
        f"{got}")
    if differ or got != want:
        raise RuntimeError(f"dist (a): differ {differ[:8]}, launches {got} != {want}")
    out["a"] = got
    del state0, clips, bare, grouped, mb, mg
    torch.cuda.empty_cache()

    # (b) 2 ranks on the one card against 1 rank
    t0 = time.perf_counter()
    ranks = _run_ranks(_dist_update_rank, (repo,))
    secs = time.perf_counter() - t0
    r0 = ranks[0]
    limits = _dist_limits(r0["plain"])
    log(f"dist (b): card {card}; 2 gloo ranks x {DIST_BATCH} vs 1 rank x {TRAIN_BATCH}, seeded "
        f"state, remat 'attn': plain versions' spread {r0['plain']}; limits (x"
        f"{DIST_LIMIT_FACTOR:g}, floor {DIST_REL_FLOOR:g}) {limits}")
    log(f"dist (b): kernels' spread {r0['kernels']}; 1-rank update "
        f"{r0['one_ms_kernels']:.0f} ms (plain {r0['one_ms_plain']:.0f}), 2-rank update "
        f"{r0['two_ms_kernels']:.0f} ms (plain {r0['two_ms_plain']:.0f}); peak per rank "
        f"{[round(r['peak_gib'], 2) for r in ranks]} GiB; launches per rank "
        f"{[_launch_diff({}, r['launches']) for r in ranks]}; {secs:.0f} s")
    bad = [k for k, v in r0["kernels"].items()
           if (v < limits[k] if k.endswith("_cos") else v > limits[k])]
    for r in ranks:
        if _launch_diff({}, r["launches"]) != want:
            raise RuntimeError(f"dist (b): launches {r['launches']} != {want}")
    if bad:
        raise RuntimeError(f"dist (b): the kernels' 2-rank update is past its limits on {bad}")
    log(f"dist (b): fsdp=2 vs fsdp=1 after 2 updates: AdamW moment elements per rank "
        f"{r0['fsdp_moment_elems']}; parameters and moments that differ "
        f"{[len(r['fsdp_differ']) for r in ranks]}")
    if any(r["fsdp_differ"] for r in ranks):
        raise RuntimeError(f"dist (b): fsdp=2 differs from fsdp=1: {r0['fsdp_differ'][:8]}")
    out["b"] = _sum_launches(*(r["launches"] for r in ranks))

    with tempfile.TemporaryDirectory(dir=repo, prefix=".chip_smoke_") as workdir:
        # (c) the 2-rank app through the launcher's in-cluster mode
        with open(os.path.join(repo, "configs", "pretrain", "vitl16.yaml")) as f:
            cfg = yaml.safe_load(f)
        cfg["data"]["dataset_type"] = "synthetic"
        cfg["data"]["num_workers"] = 4  # per rank: two ranks share the host's cores
        cfg["optimization"].update(ipe=DIST_APP_IPE, epochs=1)
        cfg_path = os.path.join(workdir, "dist_app.yaml")
        argv = ["--fname", cfg_path, "--backend", "gloo"]
        tag = cfg["logging"]["write_tag"]
        ladders = calibrate_pad_ladders(setup["specs"], setup["grid"], cfg["data"]["batch_size"],
                                        n_chunks=2)
        runs = (("fixed", 1, want), ("resume", 2, want),
                ("padded", 1, expected_launches(setup["enc_cfg"], setup["pred_cfg"],
                                                [rungs[0] for rungs in ladders], masked=True)))
        out["c"] = {}
        for mode, epochs, want_mode in runs:
            cfg["optimization"]["epochs"] = epochs
            cfg["meta"]["mask_mode"] = "padded" if mode == "padded" else "fixed"
            cfg["logging"]["folder"] = os.path.join(workdir, "padded" if mode == "padded"
                                                    else "fixed")
            with open(cfg_path, "w") as f:
                yaml.safe_dump(cfg, f)
            torch.cuda.empty_cache()
            ranks = _run_ranks(_dist_app_rank, (argv,), init_group=False, env=_slurm_env(2))
            steps = epochs * DIST_APP_IPE
            new = DIST_APP_IPE  # updates this run took (the resume: the second epoch's)
            csvs = [os.path.join(cfg["logging"]["folder"], f"{tag}_r{r}.csv") for r in range(2)]
            losses = [_csv_losses(c) for c in csvs]
            times = [_csv_times(c)[:3] for c in csvs]
            log(f"dist (c): card {card}; 2-rank app {mode} (vitl16.yaml, batch "
                f"{cfg['data']['batch_size']} per rank): steps {[r['step'] for r in ranks]}, "
                f"checkpoint writes per rank {[len(r['writes']) for r in ranks]}, "
                f"{[round(r['secs'], 1) for r in ranks]} s, CSV median step / wall ms and host "
                f"share per rank {[(round(a), round(b), round(c, 3)) for a, b, c in times]}, "
                f"peak {[round(r['peak_gib'], 2) for r in ranks]} GiB; CSV losses {losses}")
            for r in ranks:
                if _launch_diff({}, r["launches"], new) != want_mode:
                    raise RuntimeError(f"dist (c) {mode}: launches {r['launches']} != {new} x "
                                       f"{want_mode}")
            if ([r["step"] for r in ranks] != [steps, steps]
                    or len(ranks[0]["writes"]) != 1 or ranks[1]["writes"]
                    or losses[0] != losses[1] or len(losses[0]) != steps):
                raise RuntimeError(f"dist (c) {mode}: steps {[r['step'] for r in ranks]}, "
                                   f"writes {[r['writes'] for r in ranks]}, losses {losses}")
            out["c"][mode] = _sum_launches(*(r["launches"] for r in ranks))
            if mode != "fixed":
                shutil.rmtree(cfg["logging"]["folder"])

        # (d) the 2-rank K400 16x8x3 bf16 eval
        enc_path = write_seeded_encoder(torch, workdir)
        n_train, n_val = DIST_EVAL_ENTRIES
        ecfg = eval_config(repo, workdir, "dist_k400", enc_path, n_train, n_val, batch_size=4,
                           num_epochs=1, use_bfloat16=True)
        for split, n in (("train", n_train), ("val", n_val)):  # labels 0 / 1: the probe's
            with open(ecfg["data"][f"dataset_{split}"], "w") as f:  # val hits are not all 0
                f.writelines(f"synthetic://dist-{split}{i} {i % 2}\n" for i in range(n))
        ecfg["data"]["num_workers"] = 4
        epath = os.path.join(workdir, "dist_eval.yaml")
        with open(epath, "w") as f:
            yaml.safe_dump(ecfg, f)
        torch.cuda.empty_cache()
        ranks = _run_ranks(_dist_eval_rank, (["--fname", epath, "--backend", "gloo"],),
                           init_group=False, env=_slurm_env(2))
        steps = n_train // (2 * 4) + -(-n_val // (2 * 4))
        per_step = {"h1": DEPTH, "h1_c64": DEPTH, "h3": DEPTH}
        r0 = ranks[0]
        log(f"dist (d): card {card}; 2-rank K400 16x8x3 bf16 eval (batch 4 per rank, {n_train} "
            f"train / {n_val} val videos): val (correct, total) 2 ranks {r0['counts']}, 1 rank "
            f"{r0['one_rank']}; val accs {[r['accs'] for r in ranks]}; probe checkpoint writes "
            f"{[len(r['writes']) for r in ranks]}; {[round(r['secs'], 1) for r in ranks]} s, "
            f"peak {[round(r['peak_gib'], 2) for r in ranks]} GiB; launches per step "
            f"{[_launch_diff({}, r['launches'], steps) for r in ranks]}")
        if (r0["counts"] != r0["one_rank"] or r0["counts"][0][1] != n_val
                or ranks[1]["counts"] != r0["counts"] or ranks[0]["accs"] != ranks[1]["accs"]
                or len(r0["writes"]) != 1 or ranks[1]["writes"]):
            raise RuntimeError(f"dist (d): counts {r0['counts']} vs 1 rank {r0['one_rank']}, "
                               f"writes {[r['writes'] for r in ranks]}")
        for r in ranks:
            if _launch_diff({}, r["launches"], steps) != per_step:
                raise RuntimeError(f"dist (d): launches {r['launches']} != {steps} x {per_step}")
        out["d"] = _sum_launches(*(r["launches"] for r in ranks))
    return out


def _csv_losses(path) -> list:
    rows = open(path).read().strip().splitlines()
    return [r.split(",")[2] for r in rows if r[:1].isdigit()]


def tiny_setup(repo):
    """vitl16.yaml with model_name vit_tiny (``train_setup``) and the padded
    mode's cap ladders of its mask configs at TRAIN_BATCH."""
    from jepa_tpu_torch.masks.multiblock3d import calibrate_pad_ladders

    setup = train_setup(repo, "vit_tiny")
    return setup, calibrate_pad_ladders(setup["specs"], setup["grid"], TRAIN_BATCH)


def _b2_metrics(torch, step_fn, state, batch, ctx=None) -> dict:
    """Loss and grad norms of one update from a copy of ``state`` (inside
    the context ``ctx``, if any)."""
    import copy

    twin = copy.deepcopy(state)
    with ctx if ctx is not None else contextlib.nullcontext():
        _, m = step_fn(twin, batch)
    torch.cuda.synchronize()
    del twin
    return {k: m[k].item() for k in ("loss", "enc_grad_norm", "pred_grad_norm")}


def reversed_plain_versions():
    """plain_versions() with the sums taken in another order: every
    attention on its keys reversed (token-major: all its tokens, with o, lse
    and dqkv reversed back; head-major: k, v and the key mask, with dk and
    dv reversed back; attention is equivariant under the permutation) and
    every fc1 on its contraction dim reversed. The same functions, other
    fp32 sum orders."""
    import torch

    from jepa_tpu_torch.ops import flash_attention as fa
    from jepa_tpu_torch.ops import fused_mlp as fm

    flip = lambda t: None if t is None else t.flip(1)  # noqa: E731
    keys = lambda t: None if t is None else t.flip(-1)  # noqa: E731

    def fwd(qkv, h, scale, kv_mask=None):
        o, lse = fa.flash_self_attention_ref(qkv.flip(1), h, scale, flip(kv_mask))
        return o.flip(1), lse.flip(2)

    def bwd(qkv, do, lse, delta, h, scale, kv_mask=None):
        return fa.flash_self_attention_bwd_ref(qkv.flip(1), do.flip(1), lse.flip(2),
                                               delta.flip(2), h, scale, flip(kv_mask)).flip(1)

    def hm(kind, back):
        ref = getattr(fa, f"flash_{kind}_hm_ref")
        n = 1 if kind == "fwd" else 4  # (scale) or (do, lse, delta, scale) before the mask

        def call(q, k, v, *args, kv_mask=None, out=None):
            args, kv_mask = args[:n], args[n] if len(args) > n else kv_mask
            got = ref(q, k.flip(2), v.flip(2), *args, keys(kv_mask))
            got = (got,) if isinstance(got, torch.Tensor) else tuple(got)
            got = tuple(t.flip(2) if i in back else t for i, t in enumerate(got))
            if out is not None:
                got = fa._into(out if isinstance(out, tuple) else (out,), got)
            return got[0] if len(got) == 1 else got
        return call

    stack = plain_versions()
    stack.enter_context(mock.patch.object(fa, "flash_self_attention_cuda", fwd))
    stack.enter_context(mock.patch.object(fa, "flash_self_attention_bwd_cuda", bwd))
    for kind, back in (("fwd", ()), ("bwd_dq", ()), ("bwd_dkv", (0, 1)), ("bwd_dqkv", (1, 2))):
        stack.enter_context(mock.patch.object(fa, f"flash_{kind}_hm_cuda", hm(kind, back)))
    stack.enter_context(mock.patch.object(
        fm, "linear_gelu_cuda", lambda x, w, b: fm.linear_gelu_ref(x.flip(-1), w.flip(-1), b)))
    stack.enter_context(mock.patch.object(
        fm, "linear_gelu_z_cuda", lambda x, w, b: fm.linear_gelu_z_ref(x.flip(-1), w.flip(-1), b)))
    return stack


def other_library(root):
    """Another checkout's kernel library (the same C entry points), built
    from its own sources by its own ``_build``."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        f"jt_other_build_{abs(hash(str(root)))}",
        Path(root).resolve() / "jepa_tpu_torch" / "ops" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.load_library()


@contextlib.contextmanager
def other_kernels(lib):
    """The kernel wrappers launch another build's C entry points (the same
    names and signatures) instead of this checkout's."""
    from jepa_tpu_torch.ops import _build

    saved, _build._lib = _build._lib, lib
    try:
        yield
    finally:
        _build._lib = saved


def _others() -> dict:
    """{name: library} of every ``--other DIR`` on the command line."""
    from pathlib import Path

    dirs = [sys.argv[i + 1] for i, a in enumerate(sys.argv) if a == "--other"]
    return {Path(d).resolve().name: other_library(d) for d in dirs}


def phase_b2_spread(torch, repo, others, seeds):
    """The spread of phase 6's B=2 check (``python3 chip_smoke.py
    --b2-spread [--seeds 0,1,2] [--other DIR]...``, not part of the smoke
    run). For ViT-L (each seed; ``fused_mlp='force'``, the first seed) and
    vit_tiny (each seed): the seeded state and the state phase 6 checks
    from (TRAIN_STEPS + 1 updates at TRAIN_BATCH through the kernels), then
    one B=2 update from copies of each through the plain versions (the
    reference) and through: the kernels; the kernels with H1 alone plain;
    the plain versions with their sums in another order
    (``reversed_plain_versions``); each other checkout's kernels (its
    library, built from its sources, in this one's place). From the seeded
    state on the first 2 training clips, and from the trained state on
    those clips (phase 6's check) and on 2 fresh seeded clips. Prints each
    signed (x - ref) / |ref|, a table of |rel| per variant over the seeds,
    and a JSON line of every row."""
    from jepa_tpu_torch.ops import flash_attention as fa
    from jepa_tpu_torch.train.step import init_train_state

    variants = {
        "kernels": lambda: None,
        "kernels, H1 plain": lambda: mock.patch.object(
            fa, "flash_self_attention_cuda", fa.flash_self_attention_ref),
        "plain, sums reversed": reversed_plain_versions,
    }
    for name, lib in others.items():
        variants[f"{name}'s kernels"] = lambda lib=lib: other_kernels(lib)
    rows = []

    def spread(step_fn, state, batch, case, seed, batch_name):
        ref = _b2_metrics(torch, step_fn, state, batch, plain_versions())
        for name, ctx in variants.items():
            got = _b2_metrics(torch, step_fn, state, batch, ctx())
            rel = {k: (got[k] - ref[k]) / abs(ref[k]) for k in got}
            log(f"B=2 spread, {case}, seed {seed}, {batch_name}, {name} vs plain: "
                f"enc_grad_norm {got['enc_grad_norm']:.6g} vs {ref['enc_grad_norm']:.6g} "
                f"(rel {rel['enc_grad_norm']:+.2e}), pred_grad_norm rel "
                f"{rel['pred_grad_norm']:+.2e}, loss rel {rel['loss']:+.2e}")
            rows.append(dict(case=case, seed=seed, batch=batch_name, variant=name, **rel))

    for model, fused, case_seeds in (("vit_large", False, seeds), ("vit_large", "force", seeds[:1]),
                                     ("vit_tiny", False, seeds)):
        case = f"{model}, fused_mlp {fused!r}"
        setup = train_setup(repo, model, fused_mlp=fused)
        step_fn = setup["step_fn"]
        for seed in case_seeds:
            t0 = time.perf_counter()
            gen = torch.Generator(device="cuda").manual_seed(seed)
            state = init_train_state(setup["enc_cfg"], setup["pred_cfg"], gen)
            clips = torch.randn((TRAIN_BATCH, *setup["clip_shape"]), generator=gen, device="cuda")
            spread(step_fn, state, {"clips": clips[:2].contiguous()}, case, seed, "seeded state")
            for _ in range(TRAIN_STEPS + 1):
                state, _ = step_fn(state, {"clips": clips})
            fresh = torch.randn((2, *setup["clip_shape"]), generator=gen, device="cuda")
            spread(step_fn, state, {"clips": clips[:2].contiguous()}, case, seed, "trained clips")
            spread(step_fn, state, {"clips": fresh}, case, seed, "fresh clips")
            del state, clips, fresh
            log(f"B=2 spread, {case}, seed {seed}: {time.perf_counter() - t0:.1f} s")
    for case in dict.fromkeys(r["case"] for r in rows):
        for batch_name in ("seeded state", "trained clips", "fresh clips"):
            for name in variants:
                vals = [r["enc_grad_norm"] for r in rows if (r["case"], r["batch"], r["variant"])
                        == (case, batch_name, name)]
                log(f"B=2 spread table, {case}, {batch_name}, {name}: enc_grad_norm rel "
                    f"{' / '.join(f'{v:+.2e}' for v in vals)}; max |rel| "
                    f"{max(abs(v) for v in vals):.2e} (limit {TRAIN_GNORM_REL})")
    print(json.dumps({"b2_spread": rows}))
    return rows


# (label, B, N, H, c, c_real, mid) of the A/B mode's H1 rows: mid None = no
# key mask, else the start of a run of pads (0: a random start) besides a
# ragged tail of pads; then (label, M, K, F, outputs) of its fc1 rows
AB_H1_ROWS = (
    ("H1 c=64 B=2 N=1568 H=16 (ViT-L serving)", 2, 1568, 16, 64, 64, None),
    ("H1 c=64 B=24 N=1568 H=16 (ViT-L target)", 24, 1568, 16, 64, 64, None),
    ("H1 c=64 B=24 N=376 H=16 (ViT-L context)", 24, 376, 16, 64, 64, None),
    ("H1 c=24->32 B=24 N=1109 H=16 (ViT-L predictor)", 24, 1109, 16, 32, 24, None),
    ("H1 c=64 masked B=24 N=384 H=16", 24, 384, 16, 64, 64, 0),
    ("H1 c=24->32 masked B=24 N=1152 H=16", 24, 1152, 16, 32, 24, 384),
    ("H1 c=128 B=24 N=1109 H=3 (vit_tiny predictor)", 24, 1109, 3, 128, 128, None),
    ("H1 c=128 masked B=24 N=1664 H=3", 24, 1664, 3, 128, 128, 256),
    ("H1 c=80 B=1 N=4608 H=16 (K2 geometry)", 1, 4608, 16, 80, 80, None),
)
AB_FC1_ROWS = (
    ("H3 M=3136 (ViT-L serving fc1)", 3136, 1024, 4096, 1),
    ("H3 M=37632 (ViT-L target fc1)", 37632, 1024, 4096, 1),
    ("H8 M=9024 (force, long context)", 9024, 1024, 4096, 2),
    ("H8 M=2304 (force, short context)", 2304, 1024, 4096, 2),
)
# (label, B, H, Nq, Nk, c, masked) of the A/B mode's H4 rows (vit_tiny's
# encoder: 3 heads of 64; self-attention on permuted views of the projection)
AB_HM_ROWS = (
    ("H4 B=2 N=1568 (vit_tiny serving)", 2, 3, 1568, 1568, 64, False),
    ("H4 B=24 N=1568 (vit_tiny target)", 24, 3, 1568, 1568, 64, False),
    ("H4 B=24 N=376 (vit_tiny fixed context)", 24, 3, 376, 376, 64, False),
    ("H4 masked B=24 N=640 (vit_tiny top context rung)", 24, 3, 640, 640, 64, True),
    ("H4 masked B=2 Nq=1 Nk=1568 (probe geometry)", 2, 3, 1, 1568, 64, True),
)
# (label, B, H, Nq, Nk, c, masked) of the A/B mode's H6 rows (vit_tiny's split
# backward, N >= 1300; self-attention on permuted views of the projection)
AB_H6_ROWS = (
    ("H6 B=24 N=1568 H=3 c=64 (vit_tiny split backward)", 24, 3, 1568, 1568, 64, False),
    ("H6 masked B=24 N=1568 H=3 c=64", 24, 3, 1568, 1568, 64, True),
    ("H6 B=24 N=1568 H=6 c=32", 24, 6, 1568, 1568, 32, False),
    ("H6 B=24 H=3 Nq=376 Nk=1568 c=64 (cross lengths)", 24, 3, 376, 1568, 64, False),
)
# (label, entry kind, B, H, Nq, Nk, c, masked) of the A/B mode's H7 (merged,
# "dqkv") rows, vit_tiny's fixed context and padded rungs, and its H5 (split
# dq) rows, every instance (c = 64 and 32, masked or not) and cross lengths;
# self-attention on permuted views of the projection
AB_HM_BWD_ROWS = (
    ("H7 B=24 N=376 H=3 c=64 (vit_tiny fixed context)", "dqkv", 24, 3, 376, 376, 64, False),
    ("H7 masked B=24 N=640 H=3 c=64 (vit_tiny top context rung)", "dqkv", 24, 3, 640, 640, 64,
     True),
    ("H7 masked B=24 N=128 H=3 c=64 (vit_tiny bottom context rung)", "dqkv", 24, 3, 128, 128, 64,
     True),
    ("H7 B=24 N=376 H=6 c=32", "dqkv", 24, 6, 376, 376, 32, False),
    ("H5 B=24 N=1568 H=3 c=64 (vit_tiny split backward)", "dq", 24, 3, 1568, 1568, 64, False),
    ("H5 masked B=24 N=1568 H=3 c=64", "dq", 24, 3, 1568, 1568, 64, True),
    ("H5 B=24 N=1568 H=6 c=32", "dq", 24, 6, 1568, 1568, 32, False),
    ("H5 masked B=24 N=1568 H=6 c=32", "dq", 24, 6, 1568, 1568, 32, True),
    ("H5 B=24 H=3 Nq=376 Nk=1568 c=64 (cross lengths)", "dq", 24, 3, 376, 1568, 64, False),
)
# (label, B, N, H, c, c_real, mid) of the A/B mode's H2 rows, as AB_H1_ROWS
AB_H2_ROWS = (
    ("H2 c=24->32 B=24 N=1109 H=16 (ViT-L predictor)", 24, 1109, 16, 32, 24, None),
    ("H2 c=24->32 B=24 N=1191 H=16 (ViT-L predictor, mask 2)", 24, 1191, 16, 32, 24, None),
    ("H2 c=64 B=24 N=376 H=16 (ViT-L context)", 24, 376, 16, 64, 64, None),
    ("H2 c=64 masked B=24 N=128 H=16 (context rung)", 24, 128, 16, 64, 64, 0),
    ("H2 c=64 masked B=24 N=384 H=16 (context rung)", 24, 384, 16, 64, 64, 0),
    ("H2 c=64 masked B=24 N=640 H=16 (context rung)", 24, 640, 16, 64, 64, 0),
    ("H2 c=24->32 masked B=24 N=1152 H=16 (predictor rung)", 24, 1152, 16, 32, 24, 384),
    ("H2 c=24->32 masked B=24 N=1664 H=16 (predictor rung)", 24, 1664, 16, 32, 24, 256),
    ("H2 c=128 B=24 N=1109 H=3 (vit_tiny predictor)", 24, 1109, 3, 128, 128, None),
    ("H2 c=128 masked B=24 N=1664 H=3 (vit_tiny predictor rung)", 24, 1664, 3, 128, 128, 256),
    ("H2 c=80 B=1 N=4608 H=16 (K3 geometry)", 1, 4608, 16, 80, 80, None),
    ("H2 c=80 B=1 N=333 H=16 (ragged)", 1, 333, 16, 80, 80, None),
)


def queued_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """time_ms with the launches queued behind a ~1 ms spin kernel, so the
    card runs them back to back even where one call's host time exceeds
    its kernel's (rows near 0.02 ms, where time_ms would time the host)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(2_000_000)  # cycles; longer than enqueuing `iters` calls
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _host_us(torch, fn, n=48) -> float:
    """Host time of one call of fn, in us: n calls enqueued back to back
    (the card still busy with them), the wait for them excluded."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def phase_kernel_ab(torch, others):
    """The bf16 H1, H3, H8, H4 and H2, H6, H7 and H5, and H1-fp32, H3-fp32
    and H8-fp32, of this checkout against each other checkout's (``python3
    chip_smoke.py --kernel-ab --other DIR...``, not part of the smoke run),
    at the shapes of PERF.md's kernel tables, both called through the C
    entry points (shared names and signatures). Per
    row: device times in turns (other, this, this, other), each with
    ``queued_ms``; the bound (``attn_bound_ms`` / ``fc1_bound_ms``) and its
    share; the library call; max|this - other|; the host time of one call
    (``_host_us``); for H1 the mean of lse - the plain version's lse over
    every row (a bias in the denominators shows there; rounding alone
    averages out). H2's rows time the dk/dv and dq kernels each (both
    write one dqkv; each row compares its own columns), then their sum
    against SDPA's whole backward and the 5-product bound. H7's and H5's
    bounds count the bytes of their inputs and gradients, not H7's dq
    slabs; the fp32 fc1 rows' library is cuBLASLt's fp32 GEMM with its GELU
    epilogue. Prints a line per row and a JSON line of every row."""
    import torch.nn.functional as F

    from jepa_tpu_torch.ops import _build
    from jepa_tpu_torch.ops import flash_attention as fa

    libs = {"this": _build.load_library(), **others}
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    rows = []

    def ab(row, entry, args, outs, after=None):
        calls = {name: (lambda lib=lib: _build.check(getattr(lib, entry)(*args()), entry))
                 for name, lib in libs.items()}
        got = {}
        for name, call in calls.items():
            call()
            torch.cuda.synchronize()
            got[name] = [o.clone() for o in outs]
            if after:
                row[f"{name} extra"] = after()
        for name in others:
            o1, t1, t2, o2 = (queued_ms(torch, calls[k]) for k in (name, "this", "this", name))
            row[f"{name} ms"], row[f"{name} this ms"] = (o1 + o2) / 2, (t1 + t2) / 2
            row[f"{name} speedup"] = row[f"{name} ms"] / row[f"{name} this ms"]
            row[f"{name} max|this - other|"] = max(
                (a.float() - b.float()).abs().max().item()
                for a, b in zip(got["this"], got[name]))
        row["ms"] = min(row[f"{name} this ms"] for name in others) if others else queued_ms(
            torch, calls["this"])
        row["host_us"] = {name: _host_us(torch, call) for name, call in calls.items()}
        row["bound_share"] = row["bound"][0] / row["ms"]
        rows.append(row)
        log(f"A/B {row['row']}: this {row['ms']:.4f} ms, " + ", ".join(
            f"{n} {row[f'{n} ms']:.4f} ms (x{row[f'{n} speedup']:.2f}, max|d| "
            f"{row[f'{n} max|this - other|']:.2e})" for n in others)
            + f"; bound {row['bound'][0]:.4f} ms ({row['bound'][2]}, share "
            f"{100 * row['bound_share']:.1f} %), library {row['library_ms']:.4f} ms; host us/call "
            + ", ".join(f"{n} {v:.1f}" for n, v in row["host_us"].items())
            + ("; mean lse - plain " + ", ".join(f"{n} {row[f'{n} extra']:+.3e}" for n in libs)
               if after else ""))

    for label, b, n, h, c, c_real, mid in AB_H1_ROWS:
        x = torch.randn((b, n, 3, h, c), generator=gen, device="cuda")
        x[..., c_real:] = 0
        qkv = x.reshape(b, n, 3 * h * c).to(torch.bfloat16)
        del x
        mask = None if mid is None else padded_key_mask(torch, rng, b, n, mid)
        m8 = None if mask is None else mask.to(torch.uint8).contiguous()
        o = torch.empty((b, n, h * c), dtype=torch.bfloat16, device="cuda")
        lse = torch.empty((b, h, n), dtype=torch.float32, device="cuda")
        scale = c_real**-0.5
        _, lse_ref = fa.flash_self_attention_ref(qkv, h, scale, mask)
        entry = f"jt_flash_fwd_c{c}"
        args = lambda: (qkv.data_ptr(), None if m8 is None else m8.data_ptr(),  # noqa: E731
                        o.data_ptr(), lse.data_ptr(), b, n, h, scale * fa._LOG2E, stream())
        q, k, v = (t.transpose(1, 2).contiguous() for t in qkv.reshape(b, n, 3, h, c).unbind(2))
        am = None if mask is None else mask[:, None, None, :]
        pairs = b * n * n if mask is None else int(mask.sum().item()) * n
        row = dict(row=label, library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                       q, k, v, attn_mask=am, scale=scale)),
                   bound=attn_bound_ms(b, n, h, c_real, 2, qkv.numel() * 2 + (0 if m8 is None else
                                                                            b * n),
                                       o.numel() * 2 + lse.numel() * 4, pairs))
        del q, k, v
        ab(row, entry, args, (o, lse), after=lambda: (lse - lse_ref).double().mean().item())
        del qkv, o, lse, lse_ref
    k, f = 1024, 4096
    w = (torch.randn((f, k), generator=gen, device="cuda") / 32).to(torch.bfloat16)
    bias = torch.randn((f,), generator=gen, device="cuda") * 0.1
    bias_lp = bias.to(torch.bfloat16)
    for label, m, k, f, outputs in AB_FC1_ROWS:
        x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        outs = [torch.empty((m, f), dtype=torch.bfloat16, device="cuda") for _ in range(outputs)]
        entry = "jt_linear_gelu_z_bf16" if outputs == 2 else "jt_linear_gelu_bf16"
        args = lambda: (x.data_ptr(), w.data_ptr(), bias.data_ptr(),  # noqa: E731
                        *(t.data_ptr() for t in outs), m, k, f, stream())
        row = dict(row=label, bound=fc1_bound_ms(m, k, f, outputs),
                   library_ms=time_ms(torch, lambda: torch._addmm_activation(
                       bias_lp, x, w.t(), use_gelu=True)))
        ab(row, entry, args, outs)
        del x, outs
    for label, b, h, nq, nk, c, masked in AB_HM_ROWS:
        q, k, v, do = _hm_inputs(torch, gen, b, h, nq, nk, c)
        mask = padded_key_mask(torch, rng, b, nk, 0) if masked else None
        o, lse = fa._alloc_like(q), torch.empty((b, h, nq), dtype=torch.float32, device="cuda")
        scale = c**-0.5
        hm = _hm_args(fa, q, k, v, scale, mask, o=o, lse=lse)
        args = lambda hm=hm: (ctypes.addressof(hm), stream())  # noqa: E731
        pairs = b * nq * nk if mask is None else int(mask.sum().item()) * nq
        row = dict(row=label, library_ms=_sdpa_hm_ms(torch, q, k, v, do, scale, mask)[0],
                   bound=attn_bound_ms(b, nq, h, c, 2, b * h * c * 2 * (nq + 2 * nk)
                                       + (0 if mask is None else b * nk),
                                       o.numel() * 2 + lse.numel() * 4, pairs))
        ab(row, f"jt_flash_hm_fwd_c{c}", args, (o, lse))
        del q, k, v, do, o, lse
    for label, b, n, h, c, c_real, mid in AB_H2_ROWS:
        qkv, do = _attn_inputs(torch, gen, b, n, h, c, c_real)
        mask = None if mid is None else padded_key_mask(torch, rng, b, n, mid)
        m8 = None if mask is None else mask.to(torch.uint8).contiguous()
        scale = c_real**-0.5
        o, lse = fa.flash_self_attention_cuda(qkv, h, scale, mask)
        delta = fa.attention_delta(do, o, h)
        dqkv = torch.zeros_like(qkv)
        hc = h * c
        qkv_b, o_b, vec_b, m_b = qkv.numel() * 2, o.numel() * 2, lse.numel() * 4, (
            0 if m8 is None else b * n)
        pairs = b * n * n if mask is None else int(mask.sum().item()) * n
        lib = (_sdpa_bwd_ms(torch, qkv, do, h, scale) if mask is None
               else _sdpa_masked_ms(torch, qkv, do, h, scale, mask)[1])
        pair = []
        for kind, products, outs, cols in (("dkv", 4, 2, slice(hc, 3 * hc)),
                                           ("dq", 3, 1, slice(0, hc))):
            extra = (scale,) if kind == "dq" else ()
            args = lambda extra=extra: (  # noqa: E731
                qkv.data_ptr(), None if m8 is None else m8.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dqkv.data_ptr(), b, n, h, scale * fa._LOG2E,
                *extra, stream())
            row = dict(row=f"{label} {kind}", library_ms=lib,
                       bound=attn_bound_ms(b, n, h, c_real, products,
                                           qkv_b + o_b + 2 * vec_b + m_b, outs * o_b, pairs))
            ab(row, f"jt_flash_bwd_{kind}_c{c}", args, (dqkv[..., cols],))
            pair.append(row)
        whole = attn_bound_ms(b, n, h, c_real, 5, qkv_b + o_b + 2 * vec_b + m_b, qkv_b, pairs)
        row = dict(row=f"{label} dkv + dq", library_ms=lib, bound=whole,
                   ms=pair[0]["ms"] + pair[1]["ms"])
        for name in others:
            row[f"{name} ms"] = pair[0][f"{name} ms"] + pair[1][f"{name} ms"]
            row[f"{name} speedup"] = row[f"{name} ms"] / row["ms"]
        row["bound_share"] = whole[0] / row["ms"]
        rows.append(row)
        log(f"A/B {row['row']}: this {row['ms']:.4f} ms, " + ", ".join(
            f"{n} {row[f'{n} ms']:.4f} ms (x{row[f'{n} speedup']:.2f})" for n in others)
            + f"; bound {whole[0]:.4f} ms ({whole[2]}, share {100 * row['bound_share']:.1f} %), "
            f"library (SDPA backward) {lib:.4f} ms (x{lib / row['ms']:.2f} of this)")
        del qkv, do, o, lse, delta, dqkv
    for label, b, h, nq, nk, c, masked in AB_H6_ROWS:
        q, k, v, do = _hm_inputs(torch, gen, b, h, nq, nk, c)
        mask = padded_key_mask(torch, rng, b, nk, 0) if masked else None
        scale = c**-0.5
        o, lse = fa.flash_fwd_hm_cuda(q, k, v, scale, mask)
        delta = fa.hm_delta(do, o)
        dk, dv = fa._alloc_like(k), fa._alloc_like(v)
        hm = _hm_args(fa, q, k, v, scale, mask, do=do, lse=lse, delta=delta, dk=dk, dv=dv)
        args = lambda hm=hm: (ctypes.addressof(hm), stream())  # noqa: E731
        pairs = b * nq * nk if mask is None else int(mask.sum().item()) * nq
        row = dict(row=label, library_ms=_sdpa_hm_ms(torch, q, k, v, do, scale, mask)[1],
                   bound=attn_bound_ms(b, nq, h, c, 4, b * h * c * 2 * (2 * nq + 2 * nk)
                                       + 2 * lse.numel() * 4 + (0 if mask is None else b * nk),
                                       b * h * c * 2 * 2 * nk, pairs))
        ab(row, f"jt_flash_hm_dkv_c{c}", args, (dk, dv))
        del q, k, v, do, o, lse, delta, dk, dv
    # H7 (merged) and H5 (split dq): the bound counts the bytes the
    # function needs (q, k, v, do, lse, delta in; its gradients out), not
    # H7's dq slabs
    for label, kind, b, h, nq, nk, c, masked in AB_HM_BWD_ROWS:
        q, k, v, do = _hm_inputs(torch, gen, b, h, nq, nk, c)
        mask = padded_key_mask(torch, rng, b, nk, 0) if masked else None
        scale = c**-0.5
        o, lse = fa.flash_fwd_hm_cuda(q, k, v, scale, mask)
        delta = fa.hm_delta(do, o)
        grads = dict(dq=fa._alloc_like(q))
        work = {}
        if kind == "dqkv":  # and the dq slabs
            grads.update(dk=fa._alloc_like(k), dv=fa._alloc_like(v))
            work = dict(ws=torch.empty((-(-nk // 64), *q.shape), device="cuda"))
        hm = _hm_args(fa, q, k, v, scale, mask, do=do, lse=lse, delta=delta, **grads, **work)
        args = lambda hm=hm: (ctypes.addressof(hm), stream())  # noqa: E731
        pairs = b * nq * nk if mask is None else int(mask.sum().item()) * nq
        row = dict(row=label, library_ms=_sdpa_hm_ms(torch, q, k, v, do, scale, mask)[1],
                   bound=attn_bound_ms(b, nq, h, c, 5 if kind == "dqkv" else 3,
                                       b * h * c * 2 * 2 * (nq + nk) + 2 * lse.numel() * 4
                                       + (0 if mask is None else b * nk),
                                       sum(t.numel() for t in grads.values()) * 2, pairs))
        ab(row, f"jt_flash_hm_{kind}_c{c}", args, tuple(grads.values()))
        del q, k, v, do, o, lse, delta, grads, work, hm
    # H3-fp32 at the fp32 evals' fc1 shapes, then H8-fp32 (o and z) at the
    # force update's long context
    for m, k, f, outputs in F32_H3_SHAPES_AB:
        x = torch.randn((m, k), generator=gen, device="cuda")
        w = torch.randn((f, k), generator=gen, device="cuda") / 32
        bias = torch.randn((f,), generator=gen, device="cuda") * 0.1
        outs = [torch.empty((m, f), device="cuda") for _ in range(outputs)]
        entry = "jt_linear_gelu_z_f32" if outputs == 2 else "jt_linear_gelu_f32"
        args = lambda: (x.data_ptr(), w.data_ptr(), bias.data_ptr(),  # noqa: E731
                        *(t.data_ptr() for t in outs), m, k, f, stream())
        row = dict(row=f"{'H8' if outputs == 2 else 'H3'}-fp32 M={m} K={k} F={f}",
                   bound=f32_bound_ms(2.0 * m * k * f, 0, 4 * (m * k + f * k + f
                                                               + outputs * m * f)),
                   library_ms=time_ms(torch, lambda: torch._addmm_activation(
                       bias, x, w.t(), use_gelu=True)))
        ab(row, entry, args, outs)
        del x, w, bias, outs
    for b, n, h, c in F32_H1_SHAPES:
        qkv = torch.randn((b, n, 3 * h * c), generator=gen, device="cuda")
        o = torch.empty((b, n, h * c), device="cuda")
        lse = torch.empty((b, h, n), device="cuda")
        scale = c**-0.5
        args = lambda: (qkv.data_ptr(), o.data_ptr(), lse.data_ptr(), b, n, h,  # noqa: E731
                        scale * fa._LOG2E, stream())
        row = dict(row=f"H1-fp32 B={b} N={n} H={h} c={c}",
                   library_ms=_sdpa_fwd_ms(torch, qkv, h, scale),
                   bound=f32_bound_ms(4.0 * b * h * n * n * c, b * h * n * n,
                                      4 * (qkv.numel() + o.numel() + lse.numel())))
        ab(row, f"jt_flash_fwd_f32_c{c}", args, (o, lse))
        del qkv, o, lse
    print(json.dumps({"kernel_ab": rows}))
    return rows


def _sum_launches(*runs) -> dict:
    """Launch counters summed over runs (``_counts`` / ``_launch_diff``
    dicts; a counter missing from one counts 0 there)."""
    out = {}
    for run in runs:
        for k, v in run.items():
            out[k] = out.get(k, 0) + v
    return collections.defaultdict(int, out)


def kernel_entry(name, source, replaces, launches, rep) -> dict:
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": int(launches), "max_abs_err": rep["max_abs_err"], "ms": rep["ms"],
            "plain_ms": rep["plain_ms"], "bound_ms": rep["bound"][0],
            "bound_by": rep["bound"][1], "bound_share": rep["bound"][0] / rep["ms"],
            "library_ms": rep.get("library_ms")}


def main() -> int:
    import torch

    card = phase_device(torch)
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    phase_build()
    if "--remat-peak" in sys.argv:
        phase_remat_peak(torch, repo, sys.argv[sys.argv.index("--remat-peak") + 1],
                         "--padded" in sys.argv)
        return 0
    if "--update-ab" in sys.argv:
        phase_update_ab(repo, [sys.argv[i + 1] for i, a in enumerate(sys.argv)
                               if a == "--other"])
        return 0
    if "--kernel-ab" in sys.argv or "--b2-spread" in sys.argv:
        others = _others()
        if "--kernel-ab" in sys.argv:
            phase_kernel_ab(torch, others)
        if "--b2-spread" in sys.argv:
            seeds = sys.argv[sys.argv.index("--seeds") + 1] if "--seeds" in sys.argv else "0,1,2"
            phase_b2_spread(torch, repo, others, tuple(int(x) for x in seeds.split(",")))
        return 0
    timed("autograd", phase_autograd, torch)
    setup = train_setup(repo)
    kern = timed("kern", phase_kernels, torch, setup["enc_cfg"].num_patches)
    timed("edges", phase_edges, torch)
    f32 = timed("f32", phase_f32_kernels, torch)
    (ke0, kp0), (ke1, kp1) = setup["keep"]
    k11 = timed("k11", phase_k11, torch, [TRAIN_BATCH * ke0, TRAIN_BATCH * ke1])
    bwd = timed("bwd", phase_bwd_kernels, torch, [
        ("predictor, mask 1", TRAIN_BATCH, ke0 + kp0, 16, 32, 24),
        ("predictor, mask 2", TRAIN_BATCH, ke1 + kp1, 16, 32, 24),
        ("encoder context", TRAIN_BATCH, ke0, 16, 64, 64),
        ("ragged c=80", 1, 333, 16, 80, 80),
        ("vith16_384 encoder geometry", 1, 4608, 16, 80, 80),
        ("384px predictor geometry", 1, 4608, 16, 32, 24),
    ])
    kern["h1"]["max_abs_err"] = max(kern["h1"]["max_abs_err"], bwd["h1"]["max_abs_err"])
    masked = timed("masked", phase_masked_kernels, torch, [
        ("context, short-range rung", TRAIN_BATCH, 384, 16, 64, 64, 0),
        ("context, long-range rung", TRAIN_BATCH, 128, 16, 64, 64, 0),
        ("context, top rung", TRAIN_BATCH, 640, 16, 64, 64, 0),
        ("predictor, short-range", TRAIN_BATCH, 384 + 768, 16, 32, 24, 384),
        ("predictor, top rungs", TRAIN_BATCH, 256 + 1408, 16, 32, 24, 256),
        ("ViT-H context rung", TRAIN_BATCH, 384, 16, 80, 80, 0),
    ])
    tiny, ladders = tiny_setup(repo)
    hm = timed("hm", phase_hm_kernels, torch, tiny,
               sorted({ce for rungs in ladders for ce, _ in rungs if ce >= 128},
                      reverse=True))
    c128 = timed("c128", phase_c128_kernels, torch, tiny,
                 sorted({r for rungs in ladders for r in rungs}, reverse=True))
    with tempfile.TemporaryDirectory(dir=repo, prefix=".chip_smoke_") as workdir:
        serve = timed("serve", phase_serve, torch, workdir)
        enc_path = serve["enc_path"]
        off = timed("(d) off-size serving", phase_serve_off_size, torch, enc_path)
        ev16 = timed("ev16", phase_eval_video, torch, repo, workdir, enc_path, bf16=True)
        ev32 = timed("ev32", phase_eval_video, torch, repo, workdir, enc_path, bf16=False)
        img = timed("img", phase_image_probe, torch, repo, enc_path)
        img_eval = timed("(b) image eval through evals.main", phase_image_eval, torch, repo,
                         workdir, enc_path)
    train = timed("train", phase_train, torch, setup)
    # the context encoder's fc1 fused and differentiated: H8 + LinearGelu
    force = train_setup(repo, fused_mlp="force")
    train_force = timed("train_force", phase_train, torch, force)
    ab = timed("ab", phase_force_ab, torch, setup, force)
    diff = timed("(c) diffusion-mode update", phase_diffusion, torch, repo)
    with tempfile.TemporaryDirectory(dir=repo, prefix=".chip_smoke_") as workdir:
        app = timed("app", phase_app, torch, repo, setup, workdir)
        instr = timed("app with profile_steps and log_resources", phase_app_instruments,
                      torch, repo, setup, workdir)
    dist = timed("dist", phase_dist, torch, repo, setup, card)
    # vit_tiny: its serving, updates and app, through the head-major kernels
    with tempfile.TemporaryDirectory(dir=repo, prefix=".chip_smoke_") as workdir:
        tiny_serve = timed("tiny_serve", phase_serve, torch, workdir, "vit_tiny")
        tiny_train = timed("tiny_train", phase_train, torch, tiny, determinism=True)
        tiny_app = timed("tiny_app", phase_app, torch, repo, tiny, workdir)
    # the tube mask mode at vitl16.yaml: updates (one B=2 update against the
    # plain versions), the app fixed and padded; then remat at ViT-L
    tube = train_setup(repo, tube=TUBE_MASKS)
    tube_train = timed("tube_train", phase_train, torch, tube, steps=3, b2=(False,))
    with tempfile.TemporaryDirectory(dir=repo, prefix=".chip_smoke_") as workdir:
        tube_app = timed("tube_app", phase_app, torch, repo, tube, workdir, epochs=1, resume=False)
    remat = timed("remat", phase_remat, torch, repo)
    # ViT-H: its kernel instances, vith16.yaml and vith16_384.yaml with the
    # app's default remat ('attn') through build_train_step and the app, and
    # the K400 16x8x3 evals of both in bf16 and fp32
    vith = train_setup(repo, config="vith16.yaml", remat="attn")
    vith384 = train_setup(repo, config="vith16_384.yaml", remat="attn")
    vk = timed("vk", phase_vith_kernels, torch, (vith, vith384))
    for key, row in (("h1_c32", bwd["h1_c32"]), ("dkv_c32", bwd["dkv"]), ("dq_c32", bwd["dq"]),
                     ("h1_c80", vk["h1_c80"]), ("dkv_c80", vk["dkv_c80"]),
                     ("dq_c80", vk["dq_c80"]),
                     ("h1_f32_c80", f32["by_shape"][F32_H1_SHAPES[1]]),
                     ("h3_f32_k1280", f32["by_shape"][F32_H3_SHAPES[1]])):
        row["max_abs_err"] = max(row["max_abs_err"], vk["held"][key])
    vith_train = timed("vith_train", phase_train, torch, vith, b2=())
    vith384_train = timed("vith384_train", phase_train, torch, vith384, b2=())
    evh = {}
    with tempfile.TemporaryDirectory(dir=repo, prefix=".chip_smoke_") as workdir:
        vith_app = timed("vith_app", phase_app, torch, repo, vith, workdir, ipe=2, epochs=1)
        vith384_app = timed("vith384_app", phase_app, torch, repo, vith384, workdir, ipe=2,
                            epochs=1, resume=False, padded=False)
        enc_h = write_seeded_encoder(torch, workdir, "vit_huge")
        for config in VITH_EVALS:
            for bf16 in (True, False):
                evh[config, bf16] = phase_eval_video(
                    torch, repo, workdir, enc_h, bf16, config=config,
                    entries=VITH_EVAL_ENTRIES if bf16 else EVAL_F32_ENTRIES, resume=False,
                    views_checked=VITH_VIEWS_CHECKED)
        os.remove(enc_h)
    sl = _sum_launches(serve["launches"], off["launches"])
    al = app["padded"]["launches"]
    el, fl = ev16["launches"], ev32["launches"]
    il = _sum_launches(img["launches"], img_eval["launches"])
    # ViT-L's updates: the timed default ones, the tube mode's (updates, fixed
    # app), the remat phase's (its checked updates), the diffusion mode's and
    # the instrumented app's
    tl = _sum_launches(train["launches"], tube_train["launches"],
                       tube_app["fixed"]["launches"], *(r["launches"] for r in remat.values()),
                       dist["a"], dist["b"], dist["c"]["fixed"], dist["c"]["resume"],
                       diff["launches"], instr["launches"])
    al = _sum_launches(al, tube_app["padded"]["launches"], dist["c"]["padded"])
    el = _sum_launches(el, dist["d"])
    # ViT-H: its updates, apps and evals; K2's launches are H1's at (K2_C,
    # K2_N), the vith16_384 target's and eval encoder's, K1's the rest of H1
    # c=80, both as counted at the launch
    vith_runs = [vith_train["launches"], vith384_train["launches"],
                 vith_app["fixed"]["launches"], vith384_app["fixed"]["launches"]]
    vl = _sum_launches(*vith_runs, *(e["launches"] for e in evh.values()))
    vp = vith_app["padded"]["launches"]  # every attention call key-masked but the target's
    k2 = vl[K2_KEY] + vp[K2_KEY]
    fa_src, bwd_src = "jepa_tpu_torch/csrc/flash_attention.cu", "jepa_tpu_torch/csrc/flash_attention_bwd.cu"
    fa_py = "jepa_tpu/ops/flash_attention.py"
    kernels = [
        # the padded apps' unmasked launches: their target forwards (H1, H3)
        kernel_entry("flash_self_attention_fwd", fa_src, f"{fa_py}:955",
                     sl["h1"] + tl["h1_c64"] + el["h1_c64"] + il["h1_c64"] + al["h1_c64"],
                     kern["h1"]),
        # ViT-L's updates and ViT-H's predictors (c=32)
        kernel_entry("flash_self_attention_fwd_c32", fa_src, f"{fa_py}:955",
                     tl["h1_c32"] + vl["h1_c32"], bwd["h1_c32"]),
        kernel_entry("flash_bwd_dkv", bwd_src, f"{fa_py}:1452", tl["dkv"] + vl["dkv_c32"],
                     bwd["dkv"]),
        kernel_entry("flash_bwd_dq", bwd_src, f"{fa_py}:1400", tl["dq"] + vl["dq_c32"],
                     bwd["dq"]),
        kernel_entry("linear_gelu_fwd", "jepa_tpu_torch/csrc/fused_mlp.cu",
                     "jepa_tpu/ops/fused_mlp.py:92",
                     sl["h3"] + tl["h3"] + el["h3"] + il["h3"] + al["h3"], kern["h3"]),
        # the fp32 instances: the fp32 video eval's launches
        kernel_entry("flash_self_attention_fwd_f32", fa_src, f"{fa_py}:955", fl["h1_f32"],
                     f32["h1"]),
        kernel_entry("linear_gelu_fwd_f32", "jepa_tpu_torch/csrc/fused_mlp.cu",
                     "jepa_tpu/ops/fused_mlp.py:92", fl["h3_f32"], f32["h3"]),
        # the key-masked instances: the padded-mode apps' launches (ViT-L;
        # ViT-H's predictors at c=32)
        kernel_entry("flash_self_attention_fwd_masked", fa_src, f"{fa_py}:955",
                     al["h1_c64_masked"], masked["h1_c64"]),
        kernel_entry("flash_self_attention_fwd_masked_c32", fa_src, f"{fa_py}:955",
                     al["h1_c32_masked"] + vp["h1_c32_masked"], masked["h1_c32"]),
        kernel_entry("flash_bwd_dkv_masked", bwd_src, f"{fa_py}:1452",
                     al["dkv_masked"] + vp["dkv_c32"], masked["dkv"]),
        kernel_entry("flash_bwd_dq_masked", bwd_src, f"{fa_py}:1400",
                     al["dq_masked"] + vp["dq_c32"], masked["dq"]),
        # K11: the force update's context encoder; fp32: linear_gelu under autograd
        kernel_entry("linear_gelu_fwd_z", "jepa_tpu_torch/csrc/fused_mlp.cu",
                     "jepa_tpu/ops/fused_mlp.py:112", train_force["launches"]["h8"], k11["z"]),
        kernel_entry("linear_gelu_fwd_z_f32", "jepa_tpu_torch/csrc/fused_mlp.cu",
                     "jepa_tpu/ops/fused_mlp.py:112", k11["f32_launches"]["h8_f32"],
                     k11["z_f32"]),
    ]
    # the head-major kernels and the c=128 instances: vit_tiny's serving, its
    # timed updates, its app (fixed + resume, padded), and H5 + H6 through
    # flash_attention_packed under autograd
    hm_src = "jepa_tpu_torch/csrc/flash_attention_hm.cu"
    ts, tt = tiny_serve["launches"], tiny_train["launches"]
    tf, tp = tiny_app["fixed"]["launches"], tiny_app["padded"]["launches"]
    tiny_runs = lambda k: ts[k] + tt[k] + tf[k] + tp[k]
    kernels += [
        kernel_entry("flash_attention_hm_fwd", hm_src, f"{fa_py}:122",
                     tiny_runs("hm_fwd") - tp["hm_fwd_masked"], hm["fwd"]),
        kernel_entry("flash_attention_hm_fwd_masked", hm_src, f"{fa_py}:122",
                     tp["hm_fwd_masked"], hm["fwd_masked"]),
        kernel_entry("flash_attention_hm_bwd_dq", hm_src, f"{fa_py}:225",
                     hm["split_launches"]["dq"], hm["dq"]),
        kernel_entry("flash_attention_hm_bwd_dq_masked", hm_src, f"{fa_py}:225",
                     hm["split_masked_launches"]["dq"], hm["dq_masked"]),
        kernel_entry("flash_attention_hm_bwd_dkv", hm_src, f"{fa_py}:254",
                     hm["split_launches"]["dkv"], hm["dkv"]),
        kernel_entry("flash_attention_hm_bwd_merged", hm_src, f"{fa_py}:318",
                     tiny_runs("hm_dqkv") - tp["hm_dqkv_masked"], hm["dqkv"]),
        kernel_entry("flash_attention_hm_bwd_merged_masked", hm_src, f"{fa_py}:318",
                     tp["hm_dqkv_masked"], hm["dqkv_masked"]),
        kernel_entry("flash_self_attention_fwd_c128", fa_src, f"{fa_py}:955",
                     tiny_runs("h1_c128"), c128["fwd"]),
        kernel_entry("flash_self_attention_fwd_masked_c128", fa_src, f"{fa_py}:955",
                     tp["h1_c128_masked"], c128["fwd_masked"]),
        kernel_entry("flash_bwd_dkv_c128", bwd_src, f"{fa_py}:1452",
                     tiny_runs("dkv_c128") - tp["dkv_masked"], c128["dkv"]),
        kernel_entry("flash_bwd_dq_c128", bwd_src, f"{fa_py}:1400",
                     tiny_runs("dq_c128") - tp["dq_masked"], c128["dq"]),
        kernel_entry("flash_bwd_dkv_masked_c128", bwd_src, f"{fa_py}:1452",
                     tp["dkv_masked"], c128["dkv_masked"]),
        kernel_entry("flash_bwd_dq_masked_c128", bwd_src, f"{fa_py}:1400",
                     tp["dq_masked"], c128["dq_masked"]),
    ]
    fc1_src = "jepa_tpu_torch/csrc/fused_mlp.cu"
    kernels += [
        kernel_entry("flash_self_attention_fwd_c80", fa_src, f"{fa_py}:955",
                     vl["h1_c80"] + vp["h1_c80"] - k2, vk["h1_c80"]),
        kernel_entry("flash_self_attention_fwd_c80_n4608", fa_src, f"{fa_py}:1081", k2,
                     vk["h1_c80_n4608"]),
        kernel_entry("flash_self_attention_fwd_masked_c80", fa_src, f"{fa_py}:955",
                     vp["h1_c80_masked"], dict(masked["h1_c80"])),
        kernel_entry("flash_bwd_dkv_c80", bwd_src, f"{fa_py}:1452", vl["dkv_c80"], vk["dkv_c80"]),
        kernel_entry("flash_bwd_dq_c80", bwd_src, f"{fa_py}:1400", vl["dq_c80"], vk["dq_c80"]),
        kernel_entry("flash_bwd_dkv_masked_c80", bwd_src, f"{fa_py}:1452", vp["dkv_c80"],
                     dict(masked["dkv_c80"], max_abs_err=masked["dkv"]["max_abs_err"])),
        kernel_entry("flash_bwd_dq_masked_c80", bwd_src, f"{fa_py}:1400", vp["dq_c80"],
                     dict(masked["dq_c80"], max_abs_err=masked["dq"]["max_abs_err"])),
        kernel_entry("linear_gelu_fwd_k1280", fc1_src, "jepa_tpu/ops/fused_mlp.py:92",
                     vl["h3"] + vp["h3"], vk["h3_k1280"]),
        kernel_entry("flash_self_attention_fwd_f32_c80", fa_src, f"{fa_py}:955",
                     vl["h1_f32_c80"], f32["by_shape"][F32_H1_SHAPES[1]]),
        kernel_entry("linear_gelu_fwd_f32_k1280", fc1_src, "jepa_tpu/ops/fused_mlp.py:92",
                     sum(e["launches"]["h3_f32"] for e in evh.values()),
                     f32["by_shape"][F32_H3_SHAPES[1]]),
    ]
    for name, r in (("tube (vitl16.yaml, ratio 0.9)", tube_train),
                    ("vith16.yaml, remat 'attn'", vith_train),
                    ("vith16_384.yaml, remat 'attn'", vith384_train)):
        g = r["prof"]["groups"]
        log(f"card: {card}; {name} update: median {r['median_ms']:.1f} ms/update, peak "
            f"{r['peak_gib']:.2f} GiB, device {r['prof']['device_ms']:.1f} ms (" + ", ".join(
                f"{k} {v:.1f}" for k, v in g.items()) + f"); launches/update {r['per_step']}")
    for name, a in (("tube", tube_app), ("vith16", vith_app), ("vith16_384", vith384_app)):
        for mode, m in a.items():
            log(f"card: {card}; {name} app {mode}: median step {m['step_ms']:.0f} ms, wall "
                f"{m['wall_ms']:.0f} ms, host share {100 * m['host']:.1f} %, peak "
                f"{m['peak_gib']:.2f} GiB")
    for r, m in remat.items():
        log(f"card: {card}; ViT-L update remat {r!r} (B={TRAIN_BATCH}, in turns): median "
            f"{m['median_ms']:.1f} ms, device {m['prof']['device_ms']:.1f} ms, peak "
            f"{m['peak_gib']:.2f} GiB, bit-equal to remat False")
    for (config, bf16), e in evh.items():
        log(f"card: {card}; {config} eval {'bf16, batch 4' if bf16 else 'fp32, batch 1'}: "
            f"median train step {e['train_ms']:.1f} ms, val step {e['val_ms']:.1f} ms, peak "
            f"{e['peak_gib']:.2f} GiB; features vs plain min cosine "
            f"{min(e['feat_cos'].values()):.7f}")
    log(f"card: {card}; vit_tiny serve median {tiny_serve['median_ms']:.3f} ms/request (B=2), "
        f"peak {tiny_serve['peak_gib']:.3f} GiB; train median {tiny_train['median_ms']:.1f} "
        f"ms/step (B={TRAIN_BATCH}), peak {tiny_train['peak_gib']:.2f} GiB")
    for mode in ("fixed", "padded"):
        a = tiny_app[mode]
        log(f"card: {card}; vit_tiny app {mode} (B={TRAIN_BATCH}): median step "
            f"{a['step_ms']:.0f} ms, wall {a['wall_ms']:.0f} ms, host share "
            f"{100 * a['host']:.1f} %, peak {a['peak_gib']:.2f} GiB")
    log(f"card: {card}; serve median {serve['median_ms']:.3f} ms/request (B=2), "
        f"peak {serve['peak_gib']:.3f} GiB, device {serve['prof']['device_ms']:.2f} ms/request "
        f"(H1 {serve['prof']['groups']['H1 flash_fwd']:.2f}, H3 "
        f"{serve['prof']['groups']['H3/H8 linear_gelu']:.2f}); train median "
        f"{train['median_ms']:.1f} ms/step (B={TRAIN_BATCH}), peak {train['peak_gib']:.2f} GiB, "
        f"device {train['prof']['device_ms']:.1f} ms/step (H1 "
        f"{train['prof']['groups']['H1 flash_fwd']:.1f}, H3 "
        f"{train['prof']['groups']['H3/H8 linear_gelu']:.1f}); force device "
        f"{train_force['prof']['device_ms']:.1f} ms/step (H1 "
        f"{train_force['prof']['groups']['H1 flash_fwd']:.1f}, H3 + H8 "
        f"{train_force['prof']['groups']['H3/H8 linear_gelu']:.1f})")
    log(f"card: {card}; force update (fused trainable fc1, H8) median "
        f"{train_force['median_ms']:.1f} ms/step, peak {train_force['peak_gib']:.2f} GiB; A/B in "
        f"turns: default {ab['default']['median_ms']:.1f} ms / {ab['default']['peak_gib']:.2f} "
        f"GiB, force {ab['force']['median_ms']:.1f} ms / {ab['force']['peak_gib']:.2f} GiB")
    for m, r in k11["rows"].items():
        log(f"card: {card}; H8 M={m}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms ({r['bound'][2]})")
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
    log(f"card: {card}; app with profile_steps {PROFILE_STEPS} and log_resources "
        f"(B={TRAIN_BATCH}, synthetic): median step {instr['step_ms']:.0f} ms, wall "
        f"{instr['wall_ms']:.0f} ms, host share {100 * instr['host']:.1f} % (app fixed in the "
        f"same run: {app['fixed']['step_ms']:.0f} / {app['fixed']['wall_ms']:.0f} ms, "
        f"{100 * app['fixed']['host']:.1f} %); traced window {instr['span_ms']:.1f} ms, "
        f"device busy {instr['busy_ms']:.1f} ms")
    log(f"card: {card}; diffusion-mode update (vitl16.yaml, use_mask_tokens false, "
        f"B={TRAIN_BATCH}): {diff['median_ms']:.1f} ms (the default update "
        f"{train['median_ms']:.1f} ms), peak {diff['peak_gib']:.2f} GiB, device "
        f"{diff['prof']['device_ms']:.1f} ms; launches/update {diff['per_step']}")
    for (frames, px), r in ((k, v) for k, v in off.items() if k != "launches"):
        log(f"card: {card}; serve off-size {frames} frames x {px} px (N={r['n']}, B=2): "
            f"median {r['median_ms']:.3f} ms/request (on-size {serve['median_ms']:.3f})")
    for mode in ("processes", "threads"):
        r = img_eval[mode]
        log(f"card: {card}; image eval through evals.main with {IMAGE_EVAL_WORKERS} {mode} "
            f"(nproc {os.cpu_count()}): median train step {r['train_ms']:.1f} ms, host share "
            f"{_fmt_host(r['host'])}, val step {r['val_ms']:.1f} ms, {r['secs']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
