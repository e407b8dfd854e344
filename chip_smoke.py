#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (jepa_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                   # the smoke run below
    python3 chip_smoke.py --b2-spread [--seeds 0,1,2] [--other DIR]...
                                            # only the spread of phase 6's B=2
                                            # check (phase_b2_spread)
    python3 chip_smoke.py --kernel-ab --other DIR...
                                            # only H1-H8, H1-fp32, H2-fp32,
                                            # H5-H7-fp32, H3-fp32 and
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
    python3 chip_smoke.py --f32-peak vitl16.yaml:vit_giant [--padded]
                                            # only a pretrain config (and
                                            # model) in fp32 at full depth:
                                            # its ms and peak memory, or the
                                            # OOM and the largest batch that
                                            # fits (phase_f32_peak)

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
     the B=2 check; H8 24 per context forward, H3 24 for the
     target) and the A/B against the default update in turns, with each
     variant's peak memory.
 17. at VITL_CUT_DEPTH (2) of ViT-L's 24 blocks (``cut_depth``), the tube
     mask mode (data.mask_type random_tube, one mask of ratio
     0.9, the reference's default) at vitl16.yaml: 3 updates at B=24
     (context 152 tokens, predictor 1568), one B=2 update against the
     plain versions from the seeded state, then the app fixed 1 epoch and
     padded 1 epoch (one tier of static caps, 256 and 1536: the masked
     H1/H2);
 18. at VITL_CUT_DEPTH blocks, activation checkpointing at vitl16.yaml,
     B=24: from one seeded
     state, one update with remat False, True and 'attn' (encoder and
     predictor) each, whose loss, metrics, parameters and AdamW moments
     must be bit-equal, then two more of each in turns (ms, peak
     memory); the launches per update those of False
     ('attn') or one more H1 per trainable attention block (True);
 19. ViT-H: H1 c=80 at the vith16 target (B=24, N=1568) and the
     vith16_384 target (B=10, N=4608), both H2 kernels at c=80 at the
     vith16 context and H3 at ViT-H's fc1, against their plain versions
     and timed; every other token-major call shape of both configs'
     updates (the vith16_384 contexts, c=80, and predictors, c=24->32, at
     B=10: H1 and both H2 kernels) and the vith16_384 fp32 eval's train
     step (H1-fp32 c=80 at B=8, N=4608; H3-fp32 at M=8*4608) against their
     plain versions (one sample at a time where a batch's fp32 scores pass
     PLAIN_BATCH_BYTES); then, at VITH_CUT_DEPTH (2) of ViT-H's 32 blocks
     (``cut_depth``), vith16.yaml (B=24) and vith16_384.yaml (B=10) with the
     app's default remat ('attn'): TRAIN_STEPS updates each through
     build_train_step and the app (vith16: fixed 1 epoch of 2 updates,
     padded 1 epoch; vith16_384: fixed 1 epoch), each checkpoint written in
     the temporary folder and removed; runs at a cut depth are not profiled;
 20. at VITH_CUT_DEPTH blocks, the K400 16x8x3 evals of ViT-H (vith16_k400_16x8x3.yaml,
     vith16_384_k400_16x8x3.yaml) in bf16 (batch 4: 1 train step, 1 val
     step) and fp32 (batch 1: 2 and 1) on a seeded ViT-H .pth.tar, the
     features of each first train and val batch's first VITH_VIEWS_CHECKED
     (segments, views) through the kernels against the plain versions.
 21. data parallelism (``phase_dist``), after phase 8, ViT-L at DIST_DEPTH
     (2) of its 24 blocks in every run (``cut_depth``): a vitl16.yaml
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
     false), after phase 16: 3 vitl16.yaml updates at B=24 and the B=2
     checks from the seeded and the trained state;
 25. the app with logging.profile_steps [1, 1] and log_resources
     (``phase_app_instruments``), after phase 8: vitl16.yaml, synthetic,
     2 updates; the Chrome trace of the second and the resource CSV
     written, the device's busy share of the traced window.
 26. vit_giant (1408 wide, 40 blocks, 16 heads of 88 padded to 96) and
     vit_gigantic (1664 wide, 48 blocks, 16 heads of 104 padded to 128, its
     factory's patch 14: N = 2048), after phase 20: their kernel instances
     (``phase_giant_kernels``: H1 and H2 at c=96, masked and not, H1-fp32
     at c=96 and 128, H1 / H2 c=128 at N = 2048, H3 and H3-fp32 at K=1408
     F=6144 and K=1664 F=6656, at the models' shapes and the tiles' edges),
     then for each model at GIANT_CUT_DEPTH (2) blocks serving (4 seeded
     requests of 2 clips), TRAIN_STEPS updates of vitl16.yaml at B=24 with
     remat 'attn' (vit_giant also the B=2 check from the
     seeded state), the K400 16x8x3 eval in bf16 (batch 4) and fp32 (batch
     1) with the features of each first batch against the plain versions,
     and vit_giant's app (fixed, padded; checkpoints in the
     temporary folder, removed).
 27. fp32 pretraining (``phase_f32_pretrain``), after phase 25: vitl16.yaml
     with meta.dtype float32, ViT-L/16 + the 12 x 384 predictor at full
     width and depth, remat 'attn': H1-fp32 (c=64 and c=24->32) and both
     H2-fp32 kernels against their plain versions in fp32 (TF32 off) at
     the encoder context, both predictors (B=24) and a ragged N=333, each
     unmasked and with a mid-row run of pads and a ragged tail (masked
     keys' dk and dv exactly 0, pad lanes exactly 0, second calls
     bit-equal), timed beside SDPA fp32 and their FFMA / exp2 / bytes
     bounds; TRAIN_STEPS updates at B=24 in the fixed and the padded mode
     with their launches whole (H1-fp32, H2-fp32, H3-fp32; no bf16 entry),
     a seeded B=2 update in each mode against the plain versions (limits
     from their own re-ordered spread), and the app in fp32 at
     VITL_CUT_DEPTH blocks, fixed and padded, 1 epoch each.
 28. vit_tiny in fp32 (``phase_tiny_f32``), after phase 27: H4-H7-fp32
     (c=64, and c=32 for the 96-wide predictor) and H1-fp32 / H2-fp32 at
     c=128 (the 384-wide predictor) against their plain versions in fp32
     at the target, the contexts and every padded rung (key mask), both
     predictors, the split geometry (N=1568) and N=333, timed beside SDPA
     fp32 and their bounds; the split backward through
     flash_attention_packed under autograd; serving with compute_dtype
     float32, the fp32 K400 16x8x3 eval, TRAIN_STEPS updates of vitl16.yaml
     with meta.dtype float32 at B=24 'attn' fixed and padded (seeded B=2
     checks) and 2 in each mode with the 96-wide predictor, and the app
     fixed and padded.
 29. ViT-H and the giants in fp32 (``phase_f32_giants``), after phase 28:
     H1-fp32 and both H2-fp32 kernels against their plain versions in fp32
     at the vith16 context (c=80), the vit_giant (c=88->96) and
     vit_gigantic (c=104->128) contexts (B=24), vith16_384's first padded
     context rung (B=10) and N=333 at c=80 and 88->96, masked or not,
     timed beside SDPA fp32 and their bounds, and every H2-fp32 instance
     with its last 16 columns of dq, dk and dv nonzero; vith16.yaml whole
     (32 blocks, B=24) with meta.dtype float32, TRAIN_STEPS updates in the
     fixed and the padded mode and a seeded B=2 check in each;
     vith16_384.yaml, vit_giant and vit_gigantic at 2 blocks, full width,
     F32_CUT_STEPS updates in each mode; the app on vith16.yaml in fp32 at
     VITH_CUT_DEPTH blocks, fixed and padded.
 30. vit_small and vit_base (``small_base_paths``), after phase 26: H4-H7
     and H4-H7-fp32 at c=16 (vit_small's 96-wide predictor, 6 heads of 16)
     against their plain versions at its fixed sequences, every padded rung
     (key mask), the top rung's split backward and N=333, timed beside SDPA
     and their bounds; H1 + H2 at 6 x 64, 12 x 64 and 12 x 32, H3 at K=384
     and 768, H1-fp32 + H2-fp32 at 6 x 64 and H3-fp32 at K=384; serving both
     models; TRAIN_STEPS updates fixed and padded with a seeded B=2 check
     each for vit_small (12 x 384 predictor; 2 x 96 in bf16 and fp32, the
     padded mode's last update at the top rungs) and vit_base (12 x 384);
     the app with no model.model_name (its default, vit_base) fixed, a
     resume and padded.
The native decoder has no phase: the card's machine has no FFmpeg
libraries (PERF.md §6), so it is held against the JAX package's on the
CPU only (tests/test_torch_native.py).
Phases 12-13 run after phase 7, phases 14-15 after phase 8, phase 16's
kernel checks after phase 9, phases 17-20 after phase 15, phases 26 and 30 last.
Every fp32 attention kernel (H1-fp32, H2-fp32, H4-H7-fp32) is one body in
jepa_tpu_torch/csrc/flash_f32.cuh, the JSON line's source for them.
Launch counts are checked as whole dicts of every counter (``_counts``): a
kernel that should not run must count 0.
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
T0 = 0.0  # main's start (time.perf_counter)
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
# the A/B mode's further H1-fp32 rows: vit_giant's and vit_gigantic's (padded)
# head dims
F32_H1_SHAPES_AB = ((2, 1568, 16, 96), (2, 2048, 16, 128))
# (M, K, F, outputs) of the A/B mode's fp32 fc1 rows: H3-fp32 at every
# F32_H3_SHAPES row, H8-fp32 at the force update's long context
F32_H3_SHAPES_AB = tuple(s + (1,) for s in F32_H3_SHAPES) + ((9024, 1024, 4096, 2),)
F32_FEAT_COS_MIN = 0.99999  # fp32 eval features, kernels vs plain: only the order
                            # of fp32 sums differs
PROB_TOL = 1e-3
# fp32 pretraining (phase_f32_pretrain): vitl16.yaml with meta.dtype float32
F32_B2_FACTOR = 10.0  # the fp32 B=2 check: |kernels - plain| / |plain| of the loss and
F32_B2_FLOOR = 1e-5   # both grad norms <= max(10 x the plain versions' own spread with
                      # their sums re-ordered (reversed_plain_versions), 1e-5); fixed
                      # before the first run: only the order of fp32 sums differs
F32_APP_IPE = 2       # the fp32 app's updates per epoch, fixed and padded
EVAL_BF16_ENTRIES = (8, 6)  # (train, val) synthetic videos of the bf16 video eval at
                            # batch 4: 2 train steps, 2 val steps (the last one padded)
EVAL_F32_ENTRIES = (2, 1)   # the fp32 video eval at batch 1: 2 train, 1 val step
IMAGE_TRAIN_STEPS = 2
APP_IPE = 2        # app updates per epoch (the config's ipe is 300)
TUBE_MASKS = [{"ratio": 0.9}]  # data.mask_type random_tube at the reference's default ratio
VITH_EVALS = ("vith16_k400_16x8x3.yaml", "vith16_384_k400_16x8x3.yaml")
VITH_EVAL_ENTRIES = (4, 4)  # the ViT-H bf16 evals at batch 4: 1 train step, 1 val step
VITH_VIEWS_CHECKED = (2, 1)  # (segments, views) of each ViT-H eval sample whose features
                             # are held against the plain versions
# depth cuts of earlier paths, each model's width kept (cut_depth, PERF.md §4)
VITH_CUT_DEPTH = 2  # ViT-H's blocks in its updates, apps and evals (of 32)
VITL_CUT_DEPTH = 2  # ViT-L's blocks in the tube mode's and the remat phase's runs (of 24)
GIANT_CUT_DEPTH = 2  # vit_giant's and vit_gigantic's blocks in their serving, updates,
                     # K400 evals and vit_giant's app (of 40, 48)
# fp32 pretraining of ViT-H and the giants (phase_f32_giants): vith16.yaml whole;
# (config, model_name, patch_size, depth) of the runs at full width and cut depth
# (each instance they launch is held at its full shape in the phase's kernel rows)
F32_GIANT_RUNS = (("vith16_384.yaml", None, None, VITH_CUT_DEPTH),
                  ("vitl16.yaml", "vit_giant", None, GIANT_CUT_DEPTH),
                  ("vitl16.yaml", "vit_gigantic", 14, GIANT_CUT_DEPTH))
F32_CUT_STEPS = 2  # their updates in each mask mode: a warm-up and a timed one
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
    """H4 (H4-fp32 for fp32 operands) on head-major q, k, v (with a key mask
    or none) against its plain version on the card (finite, |do| <=
    HM_O_TOL, |dlse| <= HM_LSE_TOL; fp32: F32_TOL each), then a second call
    on the same inputs, which must be bit-equal. Returns (o, lse, max|do|)."""
    from jepa_tpu_torch.ops import flash_attention as fa

    o_tol, lse_tol = (F32_TOL, F32_TOL) if q.dtype == torch.float32 else (HM_O_TOL, HM_LSE_TOL)
    o, lse = fa.flash_fwd_hm_cuda(q, k, v, scale, mask)
    o_ref, lse_ref = fa.flash_fwd_hm_ref(q, k, v, scale, mask)
    torch.cuda.synchronize()
    err_o = (o.float() - o_ref.float()).abs().max().item()
    err_l = (lse - lse_ref).abs().max().item()
    log(f"{label}: max|do| {err_o:.3e} (tol {o_tol}) max|dlse| {err_l:.3e} (tol {lse_tol})")
    if not (_finite(o) and _finite(lse) and err_o <= o_tol and err_l <= lse_tol):
        raise RuntimeError(f"{label} disagrees with its plain version")
    _same_bits(label, (o, lse), fa.flash_fwd_hm_cuda(q, k, v, scale, mask))
    return o, lse, err_o


def _check_h1_f32(torch, label, qkv, h, scale, by_sample=False, mask=None):
    """H1-fp32 on fp32 qkv (with a key mask or none) against its plain
    version on the card (finite, |do| and |dlse| <= F32_TOL; ``by_sample``:
    the plain version one sample at a time), then a second call on the same
    inputs, which must be bit-equal. Returns max(|do|, |dlse|)."""
    from jepa_tpu_torch.ops import flash_attention as fa

    o, lse = fa.flash_self_attention_cuda(qkv, h, scale, mask)
    o_ref, lse_ref = _by_sample(torch, by_sample, fa.flash_self_attention_ref, qkv, h, scale,
                                mask)
    torch.cuda.synchronize()
    if not (_finite(o) and _finite(lse)):
        raise RuntimeError(f"{label}: non-finite output")
    err_o = (o - o_ref).abs().max().item()
    err_l = (lse - lse_ref).abs().max().item()
    del o_ref, lse_ref
    log(f"{label}: max|do| {err_o:.3e} max|dlse| {err_l:.3e} (tol {F32_TOL} each)")
    if not (err_o <= F32_TOL and err_l <= F32_TOL):
        raise RuntimeError(f"{label} disagrees with its plain version")
    _same_bits(label, (o, lse), fa.flash_self_attention_cuda(qkv, h, scale, mask))
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
    the split dk/dv) or H7 ("dqkv", merged), or its fp32 instance for fp32
    operands, on q, k, v and do, its lse and delta from H4, against its
    plain version on the card: each gradient within H2_REL * max|ref|
    (fp32: F32_TOL * max(|ref|, 1) element by element) and, with a key
    mask, the masked keys' dk and dv exactly 0 (``_check_grads``); written
    into ``out`` when given; then a second call on the same inputs, which
    must be bit-equal. Returns (lse, delta, max|d|)."""
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
    return lse, delta, _check_grads(label, got, want, HM_BWD_GRADS[kind], mask,
                                    f32=q.dtype == torch.float32)


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


def _sdpa_fwd_ms(torch, qkv, h, scale, mask=None):
    """Library yardstick: torch's scaled_dot_product_attention forward on the
    same q/k/v (a boolean key mask as its attn_mask; timed only)."""
    b, n, w3 = qkv.shape
    c = w3 // (3 * h)
    q, k, v = (t.transpose(1, 2).contiguous()
               for t in qkv.reshape(b, n, 3, h, c).unbind(2))
    am = None if mask is None else mask[:, None, None, :]
    f = torch.nn.functional.scaled_dot_product_attention
    return time_ms(torch, lambda: f(q, k, v, attn_mask=am, scale=scale))


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


def _hm_inputs(torch, gen, b, h, nq, nk, c, dtype=None):
    """Seeded operands (bf16, or ``dtype``) as the head-major path sees them:
    for self-attention the q, k, v planes of a token-major [B, N, 3, H, c]
    projection (strided views), else separate [B, H, N, c] tensors; do [B,
    H, Nq, c] token-major (as o's gradient arrives through the transpose
    back)."""
    dt = dtype or torch.bfloat16
    if nq == nk:
        qkv = torch.randn((b, nq, 3, h, c), generator=gen, device="cuda").to(dt)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    else:
        q, k, v = (torch.randn((b, h, n, c), generator=gen, device="cuda").to(dt)
                   for n in (nq, nk, nk))
    do = torch.randn((b, nq, h, c), generator=gen, device="cuda").to(dt)
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


def _check_grads(label, got, want, names, mask=None, f32=False):
    """Each gradient within H2_REL * max|ref| of its plain version (``f32``:
    |d| <= F32_TOL * max(|ref|, 1) element by element); with a key mask the
    masked keys' dk and dv exactly 0. Returns the max |d|."""
    worst = 0.0
    for name, g, w in zip(names, got, want):
        d = (g.float() - w.float()).abs()
        err = d.max().item()
        if f32:
            excess = (d - F32_TOL * w.float().abs().clamp(min=1)).max().item()
            rule = f"worst margin {excess:.3e} (tol |d| <= {F32_TOL} * max(|ref|, 1))"
        else:
            excess = err - H2_REL * w.float().abs().max().item()
            rule = f"(tol {err - excess:.3e} = 2^-6 * max|ref|)"
        masked = 0.0
        if mask is not None and name in ("dk", "dv"):
            masked = g.transpose(1, 2)[~mask].abs().max().item()
        log(f"{label}: {name} max|d| {err:.3e} {rule}"
            + ("" if mask is None or name == "dq" else f", masked keys max|{name}| {masked:.1e}"))
        if not (_finite(g) and excess <= 0 and masked == 0.0):
            raise RuntimeError(f"{label} {name} disagrees with its plain version")
        worst = max(worst, err)
    return worst


def _finite(t) -> bool:
    return bool(t.float().isfinite().all().item())


def _check_packed_split(torch, q, k, v, do, mask, scale):
    """The split backward (H5 + H6; H5-fp32 + H6-fp32 for fp32 operands)
    driven through flash_attention_packed under autograd on the token-major
    projection of q, k, v, every counter set to 0 just before and read just
    after (one forward, one dq and one dk/dv launch, masked where the key
    mask is given, and nothing else); its grads against the same op through
    the plain versions. Returns {kind: launches} and {kind: masked launches}
    over HM_KINDS."""
    from jepa_tpu_torch.ops import flash_attention as fa
    from jepa_tpu_torch.ops import fused_mlp as fm

    f32 = q.dtype == torch.float32
    key = lambda kind: f"hm{'_f32' if f32 else ''}_{kind}_c{q.shape[-1]}"  # noqa: E731
    grads = []
    for plain in (False, True):
        # the token-major projection [B, N, 3, H, c] and its [3, B, H, N, c] view
        tok = torch.stack((q, k, v)).permute(1, 3, 0, 2, 4).contiguous().requires_grad_(True)
        with plain_versions() if plain else contextlib.nullcontext():
            _reset_counts(fa, fm)
            o = fa.flash_attention_packed(tok.permute(2, 0, 3, 1, 4), kv_mask=mask, scale=scale)
            o.backward(do)
            torch.cuda.synchronize()
            if not plain:
                got = _launch_diff({}, _counts(fa, fm))
        grads.append(tok.grad.permute(2, 0, 3, 1, 4))
    want = {key(kind) + sfx: 1 for kind in ("fwd", "dq", "dkv")
            for sfx in ("", "_masked")[:1 + (mask is not None)]}
    tag = (f"flash_attention_packed {tuple(q.shape)} {str(q.dtype)[6:]}"
           f"{' with a key mask' if mask is not None else ''}")
    if got != want:
        raise RuntimeError(f"{tag}: the split backward launched {got}, not {want}")
    _check_grads(f"{tag} under autograd, kernels vs plain", grads[0].unbind(0),
                 grads[1].unbind(0), ("dq", "dk", "dv"), mask, f32=f32)
    log(f"{tag}: launches {got}")
    return ({kind: got.get(key(kind), 0) for kind in fa.HM_KINDS},
            {kind: got.get(key(kind) + "_masked", 0) for kind in fa.HM_KINDS})


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
    # and without the c=64 key mask (``_check_packed_split``)
    rep["split_launches"] = _check_packed_split(torch, q, k, v, do, masks[False], scale)[0]
    rep["split_masked_launches"] = _check_packed_split(torch, q, k, v, do, masks[True],
                                                       scale)[1]
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


@contextlib.contextmanager
def cut_depth(model_name: str, depth: int):
    """The factory's ``model_name`` at ``depth`` blocks, its width, heads,
    MLP and patch kept, for every config, checkpoint, app and eval built
    inside: a smoke-time cut of an earlier path's depth (PERF.md §4); each
    instance it launches is held at its full shape elsewhere."""
    from jepa_tpu_torch.models import factory

    dim, _, heads, ratio, patch = factory._SPECS[model_name]
    with mock.patch.dict(factory._SPECS, {model_name: (dim, depth, heads, ratio, patch)}):
        yield


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


def phase_serve(torch, workdir: str, model_name: str = "vit_large", dtype=None):
    """Serving through jepa_tpu_torch.api on a seeded encoder .pth.tar (at
    vitl16_k400_16x8x3.yaml's geometry), which it writes to workdir and
    returns (``enc_path``) for the evals: 4 requests of 2 clips, each
    launching exactly the kernels the routes give (``expected_launches``);
    ``dtype`` the compute dtype (default bf16; fp32: the features held at
    F32_FEAT_COS_MIN)."""
    from jepa_tpu_torch import api
    from jepa_tpu_torch.models.attentive import AttentiveCfg, init_attentive_classifier
    from jepa_tpu_torch.models.factory import vit_cfg
    from jepa_tpu_torch.ops import flash_attention as fa
    from jepa_tpu_torch.ops import fused_mlp as fm

    geo = VITL16_GEO
    dtype = dtype or torch.bfloat16
    cfg = vit_cfg(model_name, compute_dtype=dtype, **geo)
    cos_min = F32_FEAT_COS_MIN if dtype == torch.float32 else FEAT_COS_MIN
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    enc_path = write_seeded_encoder(torch, workdir, model_name)
    acfg = AttentiveCfg(embed_dim=cfg.embed_dim, num_heads=cfg.num_heads, num_classes=400)
    probe = init_attentive_classifier(acfg, gen, device="cuda")
    probe_path = os.path.join(workdir, f"{model_name}_probe.pth.tar")
    torch.save({"classifier": {k: v.cpu() for k, v in probe.state_dict().items()}},
               probe_path)
    del probe
    enc = api.load_encoder(enc_path, model_name, compute_dtype=dtype, **geo)  # device="cuda"
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
    log(f"serve {model_name} ({dtype}): kernel vs plain path, features min cosine {cos:.7f} "
        f"(min {cos_min}), max|d| {f_err:.3e}; probabilities max|d| {p_err:.3e} "
        f"(tol {PROB_TOL})")
    if cos < cos_min or p_err > PROB_TOL:
        raise RuntimeError("serving path disagrees with its plain version")
    return {"launches": launches, "median_ms": med, "peak_gib": peak_gib, "enc_path": enc_path,
            "feat_cos": cos, "prof": prof}


def train_setup(repo: str, model_name: str = None, fused_mlp=False, config="vitl16.yaml",
                tube=None, remat=False, layout=None, use_mask_tokens=None, patch_size=None,
                pred_depth=None, dtype=None, mask_mode=None, pred_embed_dim=None):
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
    predictor); ``patch_size``: the config's ``data.patch_size`` overridden
    (vit_gigantic's factory patch, 14); ``pred_depth``: the config's
    ``model.pred_depth`` overridden (a depth cut, PERF.md §4);
    ``pred_embed_dim``: the config's ``model.pred_embed_dim`` overridden (the
    CPU fixture's 96-wide predictor at vit_tiny); ``dtype``: the
    compute dtype (the app's ``meta.dtype``; default the config's, bf16);
    ``mask_mode``: the config's ``meta.mask_mode`` overridden ('padded': the
    step takes the host collator's padded masks, ``padded_batch``)."""
    import torch
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
    d["patch_size"] = patch_size or d["patch_size"]
    m["pred_depth"] = pred_depth or m["pred_depth"]
    m["pred_embed_dim"] = pred_embed_dim or m["pred_embed_dim"]
    if use_mask_tokens is not None:
        m["use_mask_tokens"] = use_mask_tokens
    dtype = dtype or {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        str(cfg["meta"].get("dtype", "bfloat16"))]
    enc_cfg = vit_cfg(m["model_name"], img_size=d["crop_size"], patch_size=d["patch_size"],
                      num_frames=d["num_frames"], tubelet_size=d["tubelet_size"],
                      uniform_power=m["uniform_power"], fused_mlp=fused_mlp, remat=remat,
                      compute_dtype=dtype)
    if tube is not None:
        cfg["mask"] = tube
    if mask_mode is not None:
        cfg["meta"]["mask_mode"] = mask_mode
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
                config=config, tube=tube, remat=remat, use_mask_tokens=m["use_mask_tokens"],
                patch_size=d["patch_size"])


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
    'attn' keeps the forward's (o, lse) and launches no more than False.
    H4-H7 count by kind and head dim. An fp32 config (``compute_dtype``
    float32) counts H1-fp32 (the unmasked c=64 instance as "h1_f32", the
    evals' key), H2-fp32, H4-H7-fp32 (by kind and head dim) and H3-fp32 /
    H8-fp32 in place of the bf16 instances."""
    import torch

    from jepa_tpu_torch.ops import flash_attention as fa
    from jepa_tpu_torch.ops.fused_mlp import fused_tiling

    f32 = enc_cfg.compute_dtype == torch.float32
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
        if route == "tm" and f32:  # H1-fp32, then H2-fp32 under a gradient
            cp = fa.padded_head_dim(c)
            add("h1_f32" if (cp, mask) == (64, False) else f"h1_f32_c{cp}{sfx}", fwd)
            for k in ("dkv", "dq") if grad else ():
                add(f"{k}_f32_c{cp}{sfx}", depth)
            return
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
            key = f"hm{'_f32' if f32 else ''}_{k}_c{c}"  # H4-H7(-fp32) by head dim
            add(key, fwd if k == "fwd" else depth)
            if mask:
                add(f"{key}_masked", fwd if k == "fwd" else depth)

    for n, heads, c, depth, grad, cfg in attention_calls(enc_cfg, pred_cfg, pairs):
        attn(n, heads, c, depth, grad, masked and grad, full(cfg))
    if fused_tiling(8, enc_cfg.embed_dim, enc_cfg.mlp_hidden):
        add("h3_f32" if f32 else "h3", enc_cfg.depth)
        if pairs and enc_cfg.fused_mlp == "force":
            add("h8_f32" if f32 else "h8",
                enc_cfg.depth * len(pairs) * (2 if full(enc_cfg) else 1))
    return want


def _counts(fa, fm) -> dict:
    """Every wrapper's launch counter, by kernel, instance and mask."""
    c = {"h1": fa.launches, "dkv": fa.dkv_launches, "dq": fa.dq_launches,
         "dkv_masked": fa.dkv_masked_launches, "dq_masked": fa.dq_masked_launches,
         "h3": fm.launches, "h3_f32": fm.f32_launches,
         "h8": fm.z_launches, "h8_f32": fm.z_f32_launches,
         "h1_f32": fa.f32_launches_by_head_dim[64],
         **{f"h1_f32_c{hd}": fa.f32_launches_by_head_dim[hd] for hd in fa.F32_HEAD_DIMS
            if hd != 64},
         **{f"h1_f32_c{hd}_masked": fa.f32_masked_launches_by_head_dim[hd]
            for hd in fa.F32_HEAD_DIMS},
         **{f"{k}_f32_c{hd}{'_masked' if m else ''}": v
            for (k, hd, m), v in fa.f32_bwd_launches.items()},
         K2_KEY: fa.launches_by_tokens[K2_C, K2_N]}
    for hd in fa.KERNEL_HEAD_DIMS:
        c.update({f"h1_c{hd}": fa.launches_by_head_dim[hd],
                  f"h1_c{hd}_masked": fa.masked_launches_by_head_dim[hd],
                  f"dkv_c{hd}": fa.dkv_launches_by_head_dim[hd],
                  f"dq_c{hd}": fa.dq_launches_by_head_dim[hd]})
    for (k, hd), v in fa.hm_launches.items():
        c.update({f"hm_{k}_c{hd}": v, f"hm_{k}_c{hd}_masked": fa.hm_masked_launches[k, hd]})
    for (k, hd), v in fa.hm_f32_launches.items():
        c.update({f"hm_f32_{k}_c{hd}": v,
                  f"hm_f32_{k}_c{hd}_masked": fa.hm_f32_masked_launches[k, hd]})
    return c


def _launch_diff(before: dict, after: dict, steps: int = 1) -> dict:
    """The counters that moved between two ``_counts`` (``before`` {}: since
    zero), per step."""
    return {k: (v - before.get(k, 0)) / steps for k, v in after.items()
            if v != before.get(k, 0)}


def _reset_counts(fa, fm) -> None:
    fa.reset_launch_counts()
    fm.reset_launch_counts()


def phase_train(torch, setup, determinism=False, steps=TRAIN_STEPS, b2=(False, True),
                top_last=False, profile=True):
    """``steps`` pretraining updates of the config of ``train_setup`` at its
    batch (vitl16.yaml: TRAIN_BATCH clips per card), with the launches of
    every update checked whole, one more update (profiled), and held against
    the plain versions by one update at B=2 through both, from the seeded
    state and from the state the timed updates leave (``check_b2``; ``b2``
    holds the ``trained`` flags of those it takes); with ``determinism``, first
    two B=2 updates through the kernels from copies of the trained state,
    which must agree to the bit. A padded-mode setup takes each update's
    masks from the host collator, padded as the app pads them
    (``padded_batch``), and expects the masked kernels' launches at the
    caps each update picks (``top_last``: the last update's masks padded to
    the top rung of each ladder); its B=2 checks are left to the caller.
    ``profile`` False runs that update unprofiled (the smoke profiles only
    the main cells: host time, 4-18 s a profile, PERF.md §4)."""
    from jepa_tpu_torch.masks.multiblock3d import MaskCollator, calibrate_pad_ladders
    from jepa_tpu_torch.ops import flash_attention as fa
    from jepa_tpu_torch.ops import fused_mlp as fm
    from jepa_tpu_torch.train.step import init_train_state

    batch = setup["yaml_batch"]
    padded = setup["tc"].mask_mode == "padded"
    pairs = setup["keep"]
    if padded:
        if b2:
            raise ValueError("phase_train: the padded mode takes no B=2 check here")
        collator = MaskCollator(setup["specs"], setup["grid"], seed=setup["tc"].seed)
        ladders = calibrate_pad_ladders(setup["specs"], setup["grid"], batch)
        pairs = [rungs[0] for rungs in ladders]
    want = expected_launches(setup["enc_cfg"], setup["pred_cfg"], pairs, masked=padded)
    log(f"train: {setup['config']}{' (tube masks)' if setup['tube'] else ''}"
        f"{'' if setup['use_mask_tokens'] else ' (diffusion-mode predictor)'}, "
        f"{setup['model_name']} (fused_mlp {setup['enc_cfg'].fused_mlp!r}, remat "
        f"{setup['remat']!r}) + predictor {setup['pred_cfg'].depth}x"
        f"{setup['pred_cfg'].predictor_embed_dim}, {setup['enc_cfg'].compute_dtype}, "
        f"{setup['tc'].mask_mode} masks, batch {batch}, keep counts "
        f"{setup['keep']}, expected launches/step {want}"
        + (f" at the first caps of {ladders}" if padded else ""))
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

    def next_batch(top=False):  # (the update's batch, the launches it implies)
        if not padded:
            return {"clips": clips}, want
        b, tier = padded_batch(torch, collator, ladders, clips, top)
        return b, expected_launches(setup["enc_cfg"], setup["pred_cfg"], tier, masked=True)

    torch.cuda.reset_peak_memory_stats()
    _reset_counts(fa, fm)
    times, per_step, wants = [], [], []
    for i in range(steps):
        upd, want_i = next_batch(top_last and i == steps - 1)
        wants.append(want_i)
        before = _counts(fa, fm)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, upd)
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
    if per_step != wants:
        raise RuntimeError(f"launches per step {per_step} != expected {wants}")
    med = statistics.median(times[1:])
    log(f"train: ms/step {[round(t, 1) for t in times]}; median after warm-up "
        f"{med:.1f} ms ({batch / med * 1e3:.2f} clips/s); peak allocated "
        f"{peak_gib:.2f} GiB; launches {launches}")
    upd = next_batch()[0]
    # one more update, profiled with ``profile``: the checks below start from
    # the state it leaves either way
    if profile:
        prof = profile_device(torch, lambda: step_fn(state, upd), "train")
    else:
        step_fn(state, upd)
        torch.cuda.synchronize()
        prof = None
    del clips, upd
    if determinism:
        check_update_determinism(torch, step_fn, state, small)
    if True in b2:
        check_b2(torch, step_fn, state, small, trained=True)
    del state, small
    torch.cuda.empty_cache()
    return {"launches": launches, "median_ms": med, "peak_gib": peak_gib, "prof": prof,
            "keep": setup["keep"], "per_step": want, "steps": steps, "batch": batch,
            "mode": setup["tc"].mask_mode, "depth": setup["enc_cfg"].depth}


def padded_batch(torch, collator, ladders, clips, top=False):
    """One padded-mode batch as the app assembles it (apps/vjepa/train.py):
    the host collator's masks for the clips, each spec's padded to the
    smallest rung of its cap ladder that covers them (``pad_masks``), with
    validity weights; ``top``: to the top rung of each ladder instead (it
    covers every batch's masks: the caps a batch of the largest masks
    picks). Returns (batch, the (context, target) caps)."""
    from jepa_tpu_torch.masks.multiblock3d import select_pad_rungs
    from jepa_tpu_torch.masks.padding import pad_masks

    me_list, mp_list = collator.collate_chunks(clips.shape[0], 1)
    rungs = ([len(rungs) - 1 for rungs in ladders] if top
             else select_pad_rungs(ladders, me_list, mp_list))
    tier = [ladders[s][r] for s, r in enumerate(rungs)]
    batch = {"clips": clips, "masks_enc": [], "enc_weights": [], "masks_pred": [],
             "pred_weights": []}
    for (mes, mps), (ce, cp) in zip(zip(me_list, mp_list), tier):
        for masks, cap, (k_idx, k_w) in ((mes, ce, ("masks_enc", "enc_weights")),
                                         (mps, cp, ("masks_pred", "pred_weights"))):
            idx, w = pad_masks(masks[0], cap)
            batch[k_idx].append(torch.from_numpy(idx).to(clips.device))
            batch[k_w].append(torch.from_numpy(w).to(clips.device))
    return batch, tier


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


def profile_device(torch, fn, label):
    """fn() once under torch.profiler: device self time by kernel group, the
    top kernels and the aten ops that launched the most device time."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
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
        elif "flash_fwd_kernel" in name or "flash_fwd_f32_kernel" in name:
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
    log(f"{label} profile ({time.perf_counter() - t0:.1f} s with the aggregation): device self "
        f"time {total:.2f} ms in one call; " + "; ".join(
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


def device_split(t) -> str:
    """A phase_train report's profiled device time and its split, for a log
    line ("not profiled": ``phase_train(profile=False)``)."""
    if t["prof"] is None:
        return "device not profiled"
    return (f"device {t['prof']['device_ms']:.1f} ms ("
            + ", ".join(f"{k} {v:.1f}" for k, v in t["prof"]["groups"].items()) + ")")


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


def phase_app(torch, repo, setup, workdir, ipe=APP_IPE, epochs=1, resume=True, padded=True,
              default_model=False):
    """The pretrain app on ``setup``'s config (``train_setup``: its model,
    its tube masks if any) on synthetic data, ``ipe`` updates per epoch:
    fixed mode ``epochs`` epochs, a resume to one more, then padded mode 1
    epoch, each with the launch counts set to 0 just before and read just
    after; api.load_encoder reads the fixed run's checkpoint. The app runs
    its default activation checkpointing (meta.remat absent: 'attn');
    ``default_model``: the YAML's model.model_name deleted, so the app
    takes its default model, which must be ``setup``'s."""
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
    cfg["data"]["patch_size"] = setup["patch_size"]
    cfg["model"]["model_name"] = setup["model_name"]
    if default_model:
        del cfg["model"]["model_name"]
    if setup["tube"]:
        cfg["data"]["mask_type"] = "random_tube"
        cfg["mask"] = setup["tube"]
    cfg["meta"]["dtype"] = str(setup["enc_cfg"].compute_dtype).replace("torch.", "")
    cfg["optimization"]["ipe"] = ipe
    cfg["optimization"]["epochs"] = epochs
    cfg["logging"]["folder"] = os.path.join(workdir, "fixed")
    d = cfg["data"]
    label = (f"{setup['config']}{' (tube masks)' if setup['tube'] else ''} with "
             f"{setup['model_name']}{' (no model_name: the default)' if default_model else ''}"
             f", meta.dtype {cfg['meta']['dtype']}")
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
    shape = lambda cfg: (cfg.embed_dim, cfg.depth, cfg.num_heads)  # noqa: E731
    if shape(state.encoder.cfg) != shape(setup["enc_cfg"]):
        raise RuntimeError(f"app: an encoder of (width, depth, heads) "
                           f"{shape(state.encoder.cfg)}, not {setup['model_name']}'s")

    # the app's checkpoint through the serving API: the EMA target's features
    geo = dict(VITL16_GEO, img_size=d["crop_size"], patch_size=d["patch_size"])
    clips = np.random.default_rng(SEED).integers(
        0, 256, size=(2, 16, d["crop_size"], d["crop_size"], 3), dtype=np.uint8)
    feats = api.load_encoder(ckpt, setup["model_name"],
                             compute_dtype=setup["enc_cfg"].compute_dtype, **geo).encode(clips)
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
    if n_rows != steps or not all(np.isfinite(float(x)) for x in _csv_losses(csv)):
        raise RuntimeError(f"app: {n_rows} CSV rows != {steps}, or a loss not finite")
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
    csv = os.path.join(cfg["logging"]["folder"], f"{tag}_r0.csv")
    step_ms, wall_ms, host, n_rows = _csv_times(csv)
    if n_rows != ipe or not all(np.isfinite(float(x)) for x in _csv_losses(csv)):
        raise RuntimeError(f"app padded: {n_rows} CSV rows != {ipe}, or a loss not finite")
    out["padded"] = dict(step_ms=step_ms, wall_ms=wall_ms, host=host, peak_gib=peak,
                         launches=got, ladders=specs_caps, updates=ipe)
    log(f"app padded: step {state.step}, caps {specs_caps}; launches per update "
        f"{_launch_diff({}, got, ipe)}; median step {step_ms:.0f} ms, wall "
        f"{wall_ms:.0f} ms, host share {100 * host:.1f} %, peak allocated {peak:.2f} GiB")
    del state
    shutil.rmtree(cfg["logging"]["folder"])
    torch.cuda.empty_cache()
    return out


def _check_h2_f32(torch, label, qkv, do, h, scale, c_real, mask=None):
    """H1-fp32 (checked by ``_check_h1_f32``) then both H2-fp32 kernels on
    fp32 qkv (with a key mask or none) against their plain versions on the
    card, on the kernel's own lse: finite, each gradient |d| <= F32_TOL *
    max(|ref|, 1) element by element (fp32 everywhere, only the order of
    the sums differs), the pad lanes past c_real exactly 0 and, with a mask,
    the masked keys' dk and dv exactly 0, and each head's last 16 real
    columns [c_real - 16, c_real) of each gradient nonzero (a geometry that
    drops a thread's tail columns leaves them 0); then a second call on the
    same inputs, which must be bit-equal. Returns (lse, delta, max|do - ref|
    of H1-fp32, {gradient: max|d|})."""
    from jepa_tpu_torch.ops import flash_attention as fa

    err_h1 = _check_h1_f32(torch, f"H1-fp32 {label}", qkv, h, scale, mask=mask)
    o, lse = fa.flash_self_attention_cuda(qkv, h, scale, mask)
    delta = fa.attention_delta(do, o, h)
    dqkv = fa.flash_self_attention_bwd_cuda(qkv, do, lse, delta, h, scale, mask)
    ref = fa.flash_self_attention_bwd_ref(qkv, do, lse, delta, h, scale, mask)
    torch.cuda.synchronize()
    if not _finite(dqkv):
        raise RuntimeError(f"H2-fp32 {label}: non-finite output")
    _same_bits(f"H2-fp32 {label} dq/dk/dv", (dqkv,),
               (fa.flash_self_attention_bwd_cuda(qkv, do, lse, delta, h, scale, mask),))
    b, n, w3 = qkv.shape
    hc = w3 // 3
    c = hc // h
    errs = {}
    for i, name in enumerate(("dq", "dk", "dv")):
        got, want = dqkv[..., i * hc:(i + 1) * hc], ref[..., i * hc:(i + 1) * hc]
        d = (got - want).abs()
        err = d.max().item()
        excess = (d - F32_TOL * want.abs().clamp(min=1)).max().item()
        pad = got.reshape(b, n, h, c)[..., c_real:].abs().max().item() if c_real < c else 0.0
        keys = mask is not None and name != "dq"
        masked = got[~mask].abs().max().item() if keys else 0.0
        tail = got.reshape(b, n, h, c)[..., c_real - 16:c_real].abs().amax(dim=(0, 1, 3))
        log(f"H2-fp32 {label} c={c_real}->{c}: {name} max|d| {err:.3e}, worst margin "
            f"{excess:.3e} (tol |d| <= {F32_TOL} * max(|ref|, 1)), pad lanes max {pad:.1e}"
            + (f", masked keys max|{name}| {masked:.1e} (must be 0)" if keys else "")
            + f", least head max|{name}| over columns [{c_real - 16}, {c_real}) "
            f"{tail.min().item():.3e} (must be > 0)")
        if not (excess <= 0 and pad == 0.0 and masked == 0.0 and tail.min().item() > 0):
            raise RuntimeError(f"H2-fp32 {label} {name} disagrees with its plain version")
        errs[name] = err
    del o, dqkv, ref
    return lse, delta, err_h1, errs


def _tm_f32_times(torch, qkv, do, lse, delta, h, scale, c_real, mask):
    """H1-fp32 and both H2-fp32 kernels on fp32 qkv (with a key mask or
    none), each timed beside its plain version, SDPA fp32 (forward; whole
    backward) and its FFMA / exp2 / bytes bound at the real head dim c_real
    over the valid pairs. Returns {"h1" | "dkv" | "dq": times}."""
    from jepa_tpu_torch.ops import flash_attention as fa

    b, n, w3 = qkv.shape
    c = w3 // (3 * h)
    pairs = b * n * n if mask is None else int(mask.sum().item()) * n
    io = dict(qkv=4 * qkv.numel(), o=4 * b * n * h * c, vec=4 * b * h * n,
              mask=0 if mask is None else b * n)
    ins = io["qkv"] + io["o"] + 2 * io["vec"] + io["mask"]  # qkv, do, lse, delta
    if mask is None:
        lib_fwd, lib_bwd = _sdpa_fwd_ms(torch, qkv, h, scale), _sdpa_bwd_ms(torch, qkv, do, h,
                                                                             scale)
    else:
        lib_fwd, lib_bwd = _sdpa_masked_ms(torch, qkv, do, h, scale, mask)
    out = torch.empty_like(qkv)
    rows = {}
    for kind, fn, plain, flops, io_b, lib in (
            ("h1", lambda: fa.flash_self_attention_cuda(qkv, h, scale, mask),
             lambda: fa.flash_self_attention_ref(qkv, h, scale, mask), 4,
             io["qkv"] + io["mask"] + io["o"] + io["vec"], lib_fwd),
            ("dkv", lambda: fa.flash_bwd_dkv_cuda(qkv, do, lse, delta, out, h, scale, mask),
             lambda: fa.flash_bwd_dkv_ref(qkv, do, lse, delta, h, scale, mask), 8,
             ins + 2 * io["o"], lib_bwd),
            ("dq", lambda: fa.flash_bwd_dq_cuda(qkv, do, lse, delta, out, h, scale, mask),
             lambda: fa.flash_bwd_dq_ref(qkv, do, lse, delta, h, scale, mask), 6,
             ins + io["o"], lib_bwd)):
        rows[kind] = dict(ms=time_ms(torch, fn), plain_ms=time_ms(torch, plain), library_ms=lib,
                          bound=f32_bound_ms(flops * h * pairs * c_real, h * pairs, io_b))
    return rows


def check_b2_f32(torch, step_fn, state, batch, label):
    """One B=2 update from ``state`` through the kernels, the plain versions
    and the plain versions with their sums re-ordered
    (``reversed_plain_versions``): the loss and both grad norms of the
    kernels must lie within F32_B2_FACTOR times the plain versions' own
    spread of the plain update (at least F32_B2_FLOOR, relative)."""
    k = _b2_metrics(torch, step_fn, state, batch)
    p = _b2_metrics(torch, step_fn, state, batch, plain_versions())
    r = _b2_metrics(torch, step_fn, state, batch, reversed_plain_versions())
    out = {}
    for key in ("loss", "enc_grad_norm", "pred_grad_norm"):
        got, spread = (abs(x[key] - p[key]) / abs(p[key]) for x in (k, r))
        lim = max(F32_B2_FACTOR * spread, F32_B2_FLOOR)
        out[key] = dict(kernels=k[key], plain=p[key], rel=got, spread=spread, limit=lim)
        log(f"fp32 B=2 {label}: {key} kernels {k[key]:.9g} plain {p[key]:.9g} re-ordered "
            f"{r[key]:.9g}: |kernels - plain| rel {got:.3e}, plain spread {spread:.3e}, "
            f"limit {lim:.3e}")
        if not (np.isfinite(k[key]) and got <= lim):
            raise RuntimeError(f"the fp32 B=2 update ({label}) through the kernels disagrees "
                               f"with the plain versions: {key}")
    return out


def phase_f32_pretrain(torch, repo, workdir):
    """fp32 pretraining at vitl16.yaml (meta.dtype float32), ViT-L/16 + the
    12 x 384 predictor at full width and depth, remat 'attn' (the app's
    default):

      * H1-fp32 (c=64 and c=24->32) and both H2-fp32 kernels against their
        plain versions in fp32 (TF32 off) at the encoder context (B=24,
        N=ke0, c=64), both predictors (B=24, N=ke+kp, c=24->32) and a
        ragged N=333 (B=2, both head dims), each unmasked and with a key
        mask of a mid-row run of pads and a ragged tail (``_check_h2_f32``);
        each row timed (kernel, plain version, SDPA fp32 forward and whole
        backward, the FFMA / exp2 / bytes bound);
      * TRAIN_STEPS updates at TRAIN_BATCH through build_train_step in the
        fixed and in the padded mode (``phase_train``: launches whole, ms,
        peak, the profile's split), and a seeded B=2 update in each mode
        against the plain versions (``check_b2_f32``);
      * the pretrain app with meta.dtype float32 at VITL_CUT_DEPTH blocks,
        fixed 1 epoch and padded 1 epoch of F32_APP_IPE updates
        (``phase_app``: launches per update, finite CSV losses, a
        checkpoint read back by api.load_encoder)."""
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError("TF32 is on: the fp32 plain versions would not be fp32")
    fixed = train_setup(repo, dtype=torch.float32, remat="attn")
    padded = train_setup(repo, dtype=torch.float32, remat="attn", mask_mode="padded")
    (ke0, kp0), (ke1, kp1) = fixed["keep"]
    enc_d, pred_d = fixed["enc_cfg"].depth, fixed["pred_cfg"].depth
    # (label, B, N, H, c, c_real, mid-row pad start (0: random), launches per fixed update)
    shapes = (("encoder context", TRAIN_BATCH, ke0, 16, 64, 64, 0, enc_d),
              ("predictor, mask 1", TRAIN_BATCH, ke0 + kp0, 16, 32, 24, ke0, pred_d),
              ("predictor, mask 2", TRAIN_BATCH, ke1 + kp1, 16, 32, 24, ke1, pred_d),
              ("ragged c=64", 2, 333, 16, 64, 64, 0, 0),
              ("ragged c=24", 2, 333, 16, 32, 24, 0, 0))
    rows = f32_attn_rows(torch, shapes, SEED + 5)
    runs = mode_updates(torch, fixed, padded)
    with cut_depth("vit_large", VITL_CUT_DEPTH):
        app = phase_app(torch, repo, train_setup(repo, dtype=torch.float32, remat="attn"),
                        workdir, ipe=F32_APP_IPE, epochs=1, resume=False)
    return {"rows": rows, "runs": runs, "app": app}


def f32_attn_rows(torch, shapes, seed):
    """H1-fp32 and both H2-fp32 kernels at each (label, B, N, H, c, c_real,
    mid-row pad start (0: random), launches per fixed-mode update) of
    ``shapes``, unmasked and with a key mask of a mid-row run of pads and a
    ragged tail: held against their plain versions (``_check_h2_f32``) and
    timed (``_tm_f32_times``). Returns {row label: {"h1" | "dkv" | "dq":
    times, max_abs_err, shape (B, N, H, c_real), masked, per_update}}."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rng = np.random.default_rng(seed)
    rows = {}
    for label, b, n, h, c, c_real, mid, per_update in shapes:
        qkv = _f32_attn_inputs(torch, gen, b, n, h, c, c_real)
        do = torch.randn((b, n, h, c), generator=gen, device="cuda")
        do[..., c_real:] = 0
        do = do.reshape(b, n, h * c)
        scale = c_real**-0.5
        for mask in (None, padded_key_mask(torch, rng, b, n, mid)):
            tag = f"{label}{'' if mask is None else ', masked'} B={b} N={n}"
            lse, delta, err_h1, errs = _check_h2_f32(torch, tag, qkv, do, h, scale, c_real, mask)
            r = _tm_f32_times(torch, qkv, do, lse, delta, h, scale, c_real, mask)
            r["h1"]["max_abs_err"] = err_h1
            r["dkv"]["max_abs_err"] = max(errs["dk"], errs["dv"])
            r["dq"]["max_abs_err"] = errs["dq"]
            for k, x in r.items():
                x.update(shape=(b, n, h, c_real), masked=mask is not None,
                         per_update=per_update)
                log(f"{'H1-fp32' if k == 'h1' else 'H2-fp32 ' + k} {tag} c={c_real}->{c} time: "
                    f"kernel {x['ms']:.4f} ms, plain {x['plain_ms']:.4f} ms, library (SDPA fp32 "
                    f"{'forward' if k == 'h1' else 'whole backward'}) {x['library_ms']:.4f} ms, "
                    f"bound {x['bound'][0]:.4f} ms ({x['bound'][2]}), "
                    f"{x['bound'][0] / x['ms']:.3f} of it; launches per fixed-mode update "
                    f"{per_update}")
            rows[tag] = r
            del lse, delta
        del qkv, do
    return rows


def mode_updates(torch, fixed, padded, steps=TRAIN_STEPS, b2=True, top_last=False,
                 profile=("fixed",)):
    """``steps`` updates of the setups ``fixed`` and ``padded``
    (``phase_train``: launches whole, ms, peak, the profile's split in the
    modes named in ``profile``; ``top_last``: the padded mode's last update
    at the top rungs) and, with
    ``b2``, a seeded B=2 update in each mode against the plain versions
    (``check_b2_f32`` in fp32, else ``check_b2`` from the seeded state).
    Returns {mode: phase_train's dict, with "b2" in fp32}."""
    from jepa_tpu_torch.masks.multiblock3d import MaskCollator, calibrate_pad_ladders
    from jepa_tpu_torch.train.step import init_train_state

    runs = {}
    for mode, setup in (("fixed", fixed), ("padded", padded)):
        runs[mode] = phase_train(torch, setup, steps=steps, b2=(), profile=mode in profile,
                                 top_last=top_last and mode == "padded")
        if not b2:
            continue
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        state = init_train_state(setup["enc_cfg"], setup["pred_cfg"], gen)
        clips = torch.randn((2, *setup["clip_shape"]), generator=gen, device="cuda")
        batch = {"clips": clips}
        if mode == "padded":
            batch, _ = padded_batch(
                torch, MaskCollator(setup["specs"], setup["grid"], seed=setup["tc"].seed),
                calibrate_pad_ladders(setup["specs"], setup["grid"], setup["yaml_batch"]),
                clips)
        if setup["enc_cfg"].compute_dtype == torch.float32:
            runs[mode]["b2"] = check_b2_f32(torch, setup["step_fn"], state, batch,
                                            f"{setup['config']} {setup['model_name']} {mode}, "
                                            "seeded state")
        else:
            check_b2(torch, setup["step_fn"], state, batch, trained=False)
        del state, clips, batch
        torch.cuda.empty_cache()
    return runs


def phase_f32_giants(torch, repo, workdir):
    """fp32 pretraining (meta.dtype float32, remat 'attn') of ViT-H and the
    giants, whose encoders run H1-fp32 and H2-fp32 at c=80 (ViT-H), 88->96
    (vit_giant) and 104->128 (vit_gigantic), their predictors at c=24->32:

      * H1-fp32 and both H2-fp32 kernels against their plain versions in
        fp32 (TF32 off) at the vith16 context (B=24, N=376, c=80), the
        vit_giant and vit_gigantic contexts (B=24), vith16_384's first
        padded context rung (B=10) and a ragged N=333 at c=80 and 88->96,
        each unmasked and with a mid-row run of pads and a ragged tail
        (``f32_attn_rows``: second calls bit-equal, timed beside SDPA fp32
        and the FFMA bound); then every H2-fp32 instance at c_real = c
        (B=2, N=333, 4 heads), masked or not, whose last 16 columns of
        dq, dk and dv must be nonzero and match (``_check_h2_f32``);
      * vith16.yaml whole (32 blocks, B=24): TRAIN_STEPS updates in the
        fixed and the padded mode and a seeded B=2 update in each against
        the plain versions (``mode_updates``);
      * vith16_384.yaml (B=10), vit_giant and vit_gigantic (patch 14) at
        vitl16.yaml (B=24) at VITH_CUT_DEPTH / GIANT_CUT_DEPTH blocks, full
        width: F32_CUT_STEPS updates in each mode, launches whole;
      * the pretrain app on vith16.yaml in fp32 at VITH_CUT_DEPTH blocks,
        fixed and padded, F32_APP_IPE updates each, a checkpoint read back
        by api.load_encoder."""
    from jepa_tpu_torch.masks.multiblock3d import calibrate_pad_ladders
    from jepa_tpu_torch.ops import flash_attention as fa

    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError("TF32 is on: the fp32 plain versions would not be fp32")
    f32 = dict(dtype=torch.float32, remat="attn")
    vith = train_setup(repo, config="vith16.yaml", **f32)
    vith_padded = train_setup(repo, config="vith16.yaml", mask_mode="padded", **f32)
    cut = {}  # (config, model): (fixed setup, padded setup), at their cut depth
    for config, model, patch, depth in F32_GIANT_RUNS:
        with cut_depth(model or "vit_huge", depth):
            cut[config, model or "vit_huge"] = tuple(
                train_setup(repo, model_name=model, config=config, patch_size=patch,
                            mask_mode=mode, **f32) for mode in (None, "padded"))
    h384 = cut["vith16_384.yaml", "vit_huge"][0]
    rung = calibrate_pad_ladders(h384["specs"], h384["grid"], h384["yaml_batch"])[0][0][0]
    ctx = {m: cut["vitl16.yaml", m][0]["keep"][0][0] for m in ("vit_giant", "vit_gigantic")}
    # (label, B, N, H, c, c_real, mid-row pad start (0: random), launches per fixed update
    # at full depth)
    shapes = (("vith16 context", TRAIN_BATCH, vith["keep"][0][0], 16, 80, 80, 0, 32),
              ("vit_giant context", TRAIN_BATCH, ctx["vit_giant"], 16, 96, 88, 0, 40),
              ("vit_gigantic context", TRAIN_BATCH, ctx["vit_gigantic"], 16, 128, 104, 0, 48),
              ("vith16_384 context rung", h384["yaml_batch"], rung, 16, 80, 80, 0, 32),
              ("ragged c=80", 2, RAGGED_N, 16, 80, 80, 0, 0),
              ("ragged c=88", 2, RAGGED_N, 16, 96, 88, 0, 0))
    rows = f32_attn_rows(torch, shapes, SEED + 21)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    rng = np.random.default_rng(SEED + 22)
    for c in fa.F32_BWD_HEAD_DIMS:  # each instance's own columns, c_real = c
        qkv = _f32_attn_inputs(torch, gen, 2, RAGGED_N, 4, c, c)
        do = torch.randn((2, RAGGED_N, 4 * c), generator=gen, device="cuda")
        for mask in (None, padded_key_mask(torch, rng, 2, RAGGED_N, 0)):
            tag = f"instance c={c}{'' if mask is None else ', masked'} B=2 N={RAGGED_N} H=4"
            _check_h2_f32(torch, tag, qkv, do, 4, c**-0.5, c, mask)
        del qkv, do

    runs = {("vith16.yaml", "vit_huge"): mode_updates(torch, vith, vith_padded, profile=())}
    for key, (fixed, padded) in cut.items():
        runs[key] = mode_updates(torch, fixed, padded, steps=F32_CUT_STEPS, b2=False,
                                 profile=())
    with cut_depth("vit_huge", VITH_CUT_DEPTH):
        app = phase_app(torch, repo, train_setup(repo, config="vith16.yaml", **f32), workdir,
                        ipe=F32_APP_IPE, epochs=1, resume=False)
    return {"rows": rows, "runs": runs, "app": app}


TINY_F32_PRED96 = dict(pred_embed_dim=96, pred_depth=2)  # the CPU fixture's predictor
TINY_F32_PRED96_STEPS = 2  # its updates at B=24 in each mask mode
RAGGED_N = 333  # a ragged sequence: two 128-row blocks and 77 rows


def _hm_times(torch, kind, q, k, v, do, scale, mask, lib):
    """One head-major kernel (``kind`` fwd: H4, dq: H5, dkv: H6, dqkv: H7;
    their fp32 instances for fp32 operands) timed beside its plain version,
    ``lib`` (SDPA forward ms, whole backward ms) and its bound (each input
    read once, each output written once; the valid pairs only): fp32 the
    FFMA / exp2 / bytes bound, bf16 the tensor-core / exp2 / bytes one."""
    from jepa_tpu_torch.ops import flash_attention as fa

    b, h, nq, c = q.shape
    nk = k.shape[2]
    el = q.element_size()
    pairs = int(mask.sum().item()) * nq if mask is not None else b * nq * nk
    qb, kb, vec, mb = el * b * h * nq * c, el * b * h * nk * c, 4 * b * h * nq, (
        0 if mask is None else b * nk)
    if kind == "fwd":
        fn = lambda: fa.flash_fwd_hm_cuda(q, k, v, scale, mask)  # noqa: E731
        plain = lambda: fa.flash_fwd_hm_ref(q, k, v, scale, mask)  # noqa: E731
        flops, io, lib_ms = 4, 2 * qb + 2 * kb + vec + mb, lib[0]
    else:
        o, lse = fa.flash_fwd_hm_cuda(q, k, v, scale, mask)
        delta = fa.hm_delta(do, o)
        cuda, ref = (getattr(fa, f"flash_bwd_{kind}_hm_{x}") for x in ("cuda", "ref"))
        fn = lambda: cuda(q, k, v, do, lse, delta, scale, mask)  # noqa: E731
        plain = lambda: ref(q, k, v, do, lse, delta, scale, mask)  # noqa: E731
        flops, outs = {"dq": (6, qb), "dkv": (8, 2 * kb), "dqkv": (10, qb + 2 * kb)}[kind]
        io, lib_ms = 2 * qb + 2 * kb + 2 * vec + mb + outs, lib[1]
    bound = (f32_bound_ms(flops * h * pairs * c, h * pairs, io) if el == 4
             else attn_bound_ms(b, nq, h, c, flops // 2, io, 0, pairs))
    return dict(ms=time_ms(torch, fn), plain_ms=time_ms(torch, plain, iters=5, warmup=1),
                library_ms=lib_ms, bound=bound, shape=(b, h, nq, nk, c), masked=mask is not None,
                f32=el == 4)


def _note(rows, key, err, times=None, per_update=None):
    """Keep row ``key``'s largest max|d| in ``rows``, and its first timed
    shape's times (``_hm_times`` / ``_tm_f32_times``), logged."""
    r = rows.setdefault(key, {"max_abs_err": 0.0})
    r["max_abs_err"] = max(r["max_abs_err"], err)
    if times is not None and "ms" not in r:
        r.update(times, per_update=per_update)
        log(f"{key} {times['shape']}{' masked' if times['masked'] else ''} time: kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library (SDPA "
            f"{'fp32 ' if times.get('f32', True) else ''}"
            f"{'forward' if key.startswith(('hm_fwd', 'h1')) else 'whole backward'}) "
            f"{r['library_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms ({r['bound'][2]}), "
            f"{r['bound'][0] / r['ms']:.3f} of it; launches per update {per_update}")


def phase_tiny_f32(torch, repo, workdir):
    """vit_tiny in fp32 on the card (serving with compute_dtype float32, the
    K400 probe with use_bfloat16: false, vitl16.yaml with meta.dtype
    float32), TF32 off:

      * the kernels against their plain versions in fp32: H4-fp32 at the
        serving (B=2) and target (B=24) shapes, N=1568, c=64; H4-fp32 +
        H7-fp32 at the fixed context and every padded context rung (key
        mask), and at c=32 (the 96-wide predictor, 3 heads) at its fixed
        sequences and merged padded rungs; H5-fp32 and H6-fp32 at N=1568
        (and the 96-wide predictor's top rung, 1664) at c=64 and 32, masked
        or not, then through flash_attention_packed under autograd (the
        launches the JSON line reports); H1-fp32 + H2-fp32 at c=128 (the
        384-wide predictor) at its fixed sequences and padded rungs; a
        ragged N=333 of each. |d| <= F32_TOL * max(|ref|, 1), masked keys'
        dk and dv exactly 0, second calls bit-equal; the first row of each
        instance timed (kernel, plain version, SDPA fp32, bound);
      * serving (``phase_serve``, 4 requests of 2 clips) and the fp32 K400
        16x8x3 eval (``phase_eval_video``, batch 1) with vit_tiny;
      * TRAIN_STEPS updates at B=24, remat 'attn', in the fixed and the
        padded mode with the 384-wide predictor, and TINY_F32_PRED96_STEPS
        in each mode with the 96-wide one (``phase_train``: launches whole,
        ms, peak), a seeded B=2 update in each mode
        against the plain versions (``check_b2_f32``);
      * the pretrain app in fp32, fixed and padded, 1 epoch of F32_APP_IPE
        updates each (``phase_app``)."""
    from jepa_tpu_torch.masks.multiblock3d import (
        MaskCollator,
        calibrate_pad_ladders,
    )
    from jepa_tpu_torch.ops import flash_attention as fa
    from jepa_tpu_torch.train.step import init_train_state

    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError("TF32 is on: the fp32 plain versions would not be fp32")
    f32 = torch.float32
    fixed = train_setup(repo, "vit_tiny", dtype=f32, remat="attn")
    padded = train_setup(repo, "vit_tiny", dtype=f32, remat="attn", mask_mode="padded")
    narrow = train_setup(repo, "vit_tiny", dtype=f32, remat="attn", **TINY_F32_PRED96)
    narrow_padded = train_setup(repo, "vit_tiny", dtype=f32, remat="attn", mask_mode="padded",
                                **TINY_F32_PRED96)
    ladders = calibrate_pad_ladders(fixed["specs"], fixed["grid"], TRAIN_BATCH)
    enc = fixed["enc_cfg"]
    h, n_full = enc.num_heads, enc.num_patches
    c = enc.embed_dim // h
    hp = fixed["pred_cfg"].num_heads
    cp = fixed["pred_cfg"].predictor_embed_dim // hp
    hn = narrow["pred_cfg"].num_heads
    cn = narrow["pred_cfg"].predictor_embed_dim // hn
    if (h, c, hp, cp, hn, cn) != (3, 64, 3, 128, 3, 32):
        raise RuntimeError(f"vit_tiny's heads {(h, c, hp, cp, hn, cn)}")
    enc_d, pred_d, nar_d = enc.depth, fixed["pred_cfg"].depth, narrow["pred_cfg"].depth
    keep = fixed["keep"]
    ctx_rungs = sorted({ce for rungs in ladders for ce, _ in rungs if ce >= 128}, reverse=True)
    pred_rungs = sorted({r for rungs in ladders for r in rungs}, key=sum, reverse=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    rng = np.random.default_rng(SEED + 6)
    rows = {}
    note = lambda *a, **kw: _note(rows, *a, **kw)  # noqa: E731

    # H4-fp32 alone: serving and the target
    for label, b, timed_row in (("serving", 2, False), ("target", TRAIN_BATCH, True)):
        q, k, v, do = _hm_inputs(torch, gen, b, h, n_full, n_full, c, f32)
        _, _, err = _check_h4(torch, f"H4-fp32 {label} B={b} N={n_full} c={c}", q, k, v, c**-0.5)
        note("hm_fwd_c64", err, _hm_times(
            torch, "fwd", q, k, v, do, c**-0.5, None, _sdpa_hm_ms(torch, q, k, v, do, c**-0.5))
            if timed_row else None, enc_d)
        del q, k, v, do
    # H4-fp32 + H7-fp32 (merged): the contexts (c=64), the 96-wide predictor
    # (c=32), ragged; (label, B, N, H, c, mid-row pad start or None, per update)
    merged = ([(f"context {ke}", TRAIN_BATCH, ke, h, c, None, enc_d) for ke, _ in keep
               if ke >= 128]
              + [(f"context rung {n}", TRAIN_BATCH, n, h, c, 0, enc_d) for n in ctx_rungs]
              + [(f"96-wide predictor {ke}+{kp}", TRAIN_BATCH, ke + kp, hn, cn, None, nar_d)
                 for ke, kp in keep]
              + [(f"96-wide predictor rung {ce}+{cq}", TRAIN_BATCH, ce + cq, hn, cn, ce, nar_d)
                 for ce, cq in pred_rungs if fa.merged_bwd(ce + cq, ce + cq, cn)]
              + [(f"ragged c={cc}", 2, RAGGED_N, 3, cc, mid, 0) for cc in (c, cn)
                 for mid in (None, 0)])
    for label, b, n, hh, cc, mid, per_update in merged:
        if not fa.merged_bwd(n, n, cc):
            raise RuntimeError(f"H7-fp32 {label}: N={n} does not take the merged backward")
        q, k, v, do = _hm_inputs(torch, gen, b, hh, n, n, cc, f32)
        mask = None if mid is None else padded_key_mask(torch, rng, b, n, mid)
        sfx = f"_c{cc}" + ("" if mask is None else "_masked")
        tag = f"{label} B={b} N={n} H={hh} c={cc}{'' if mask is None else ' masked'}"
        scale = cc**-0.5
        _, _, err_f = _check_h4(torch, f"H4-fp32 {tag}", q, k, v, scale, mask)
        _, _, err_b = _check_hm_bwd(torch, "dqkv", f"H7-fp32 {tag}", q, k, v, do, scale, mask)
        first = f"hm_dqkv{sfx}" not in rows and per_update
        lib = _sdpa_hm_ms(torch, q, k, v, do, scale, mask) if first else None
        note(f"hm_fwd{sfx}", err_f, _hm_times(torch, "fwd", q, k, v, do, scale, mask, lib)
             if first and f"hm_fwd{sfx}" not in rows else None, per_update)
        note(f"hm_dqkv{sfx}", err_b, _hm_times(torch, "dqkv", q, k, v, do, scale, mask, lib)
             if first else None, per_update)
        del q, k, v, do, mask
    # H5-fp32 + H6-fp32 (the split backward past the merged rule's reach)
    split = ([(f"N={n_full}", n_full, cc, masked, None) for cc in (c, cn)
              for masked in (False, True)]
             + [(f"96-wide predictor rung {ce}+{cq}", ce + cq, cn, True, ce)
                for ce, cq in pred_rungs if not fa.merged_bwd(ce + cq, ce + cq, cn)][:1]
             + [(f"ragged N={RAGGED_N}", RAGGED_N, c, True, None)])
    packed_masks = {}
    for label, n, cc, masked, mid in split:
        b = 2 if n == RAGGED_N else TRAIN_BATCH
        q, k, v, do = _hm_inputs(torch, gen, b, 3, n, n, cc, f32)
        mask = padded_key_mask(torch, rng, b, n, mid or 0) if masked else None
        sfx = f"_c{cc}" + ("_masked" if masked else "")
        tag = f"{label} B={b} H=3 c={cc}{' masked' if masked else ''}"
        scale = cc**-0.5
        errs = {kind: _check_hm_bwd(torch, kind, f"H{5 if kind == 'dq' else 6}-fp32 {tag}", q,
                                    k, v, do, scale, mask)[2] for kind in ("dq", "dkv")}
        first = f"hm_dq{sfx}" not in rows and n == n_full
        lib = _sdpa_hm_ms(torch, q, k, v, do, scale, mask) if first else None
        for kind in ("dq", "dkv"):
            note(f"hm_{kind}{sfx}", errs[kind], _hm_times(
                torch, kind, q, k, v, do, scale, mask, lib) if first else None, 0)
        if n == n_full and cc == c:
            packed_masks[masked] = (q, k, v, do, mask)
        else:
            del q, k, v, do, mask
    # the split backward through the public op under autograd
    # (``_check_packed_split``), the launches the JSON line reports
    split_launches = {masked: _check_packed_split(torch, *packed, c**-0.5)[masked]
                      for masked, packed in packed_masks.items()}
    del packed_masks
    # H1-fp32 + H2-fp32 at c=128: the 384-wide predictor, ragged
    tm = ([(f"predictor {ke}+{kp}", TRAIN_BATCH, ke + kp, None, pred_d) for ke, kp in keep]
          + [(f"predictor rung {ce}+{cq}", TRAIN_BATCH, ce + cq, ce, pred_d)
             for ce, cq in pred_rungs]
          + [("ragged", 2, RAGGED_N, None, 0), ("ragged", 2, RAGGED_N, 0, 0)])
    for label, b, n, mid, per_update in tm:
        qkv = _f32_attn_inputs(torch, gen, b, n, hp, cp, cp)
        do = torch.randn((b, n, hp * cp), generator=gen, device="cuda")
        mask = None if mid is None else padded_key_mask(torch, rng, b, n, mid)
        sfx = "_c128" + ("" if mask is None else "_masked")
        tag = f"c=128 {label}{'' if mask is None else ', masked'} B={b} N={n}"
        scale = cp**-0.5
        lse, delta, err_h1, errs = _check_h2_f32(torch, tag, qkv, do, hp, scale, cp, mask)
        times = {}
        if f"h1{sfx}" not in rows and per_update:  # the instance's first row: timed
            times = _tm_f32_times(torch, qkv, do, lse, delta, hp, scale, cp, mask)
            for t in times.values():
                t.update(shape=(b, hp, n, n, cp), masked=mask is not None)
        note(f"h1{sfx}", err_h1, times.get("h1"), per_update)
        note(f"dkv{sfx}", max(errs["dk"], errs["dv"]), times.get("dkv"), per_update)
        note(f"dq{sfx}", errs["dq"], times.get("dq"), per_update)
        del qkv, do, lse, delta, mask
    torch.cuda.empty_cache()

    serve = phase_serve(torch, workdir, "vit_tiny", dtype=f32)
    ev = phase_eval_video(torch, repo, workdir, serve["enc_path"], bf16=False, resume=False,
                          model_name="vit_tiny")
    os.remove(serve["enc_path"])
    runs = {}
    for mode, setup in (("fixed", fixed), ("padded", padded)):
        runs[mode] = phase_train(torch, setup, b2=(), profile=False)
        g = torch.Generator(device="cuda").manual_seed(SEED)
        state = init_train_state(setup["enc_cfg"], setup["pred_cfg"], g)
        clips = torch.randn((2, *setup["clip_shape"]), generator=g, device="cuda")
        batch = {"clips": clips}
        if mode == "padded":
            batch, _ = padded_batch(
                torch, MaskCollator(setup["specs"], setup["grid"], seed=setup["tc"].seed),
                calibrate_pad_ladders(setup["specs"], setup["grid"], TRAIN_BATCH), clips)
        runs[mode]["b2"] = check_b2_f32(torch, setup["step_fn"], state, batch,
                                        f"vit_tiny {mode}, seeded state")
        del state, clips, batch
        torch.cuda.empty_cache()
    for mode, setup in (("narrow", narrow), ("narrow_padded", narrow_padded)):
        runs[mode] = phase_train(torch, setup, steps=TINY_F32_PRED96_STEPS, b2=(),
                                 profile=False)
    app = phase_app(torch, repo, fixed, workdir, ipe=F32_APP_IPE, epochs=1, resume=False)
    return {"rows": rows, "split": split_launches, "serve": serve, "eval": ev, "runs": runs,
            "app": app}


# vit_small and vit_base: the 96-wide predictor at vit_small (6 heads of 16,
# the head-major route at c=16) and the models' paths
SMALL_PRED96 = dict(pred_embed_dim=96, pred_depth=2)  # the CPU fixture's predictor
SMALL_TM_SHAPES = (("vit_small context", 6, 64), ("vit_small 384-wide predictor", 6, 64),
                   ("vit_base context", 12, 64), ("vit_base 384-wide predictor", 12, 32))
SMALL_FC1 = {"vit_small": (384, 1536), "vit_base": (768, 3072)}  # (K, F) of the fc1


def phase_c16_kernels(torch, narrow, ladders):
    """H4-H7 and H4-H7-fp32 at head dim 16 (``narrow``: the train setup of
    vit_small with the 96-wide predictor, 6 heads of 16; ``ladders``: the
    padded mode's cap ladders) against their plain versions on the card, in
    bf16 and in fp32 (TF32 off): H4 + H7 at the predictor's fixed sequences
    (B=24), at every padded rung with a key mask (pads from the context's
    cap, and a ragged tail), H4 + H5 + H6 at the rungs past the merged
    rule's reach (the top rung, N=1664) masked and also unmasked, and H4 +
    H7 at a ragged N=RAGGED_N (B=2) masked or not. bf16 is held under
    phase_hm_kernels' rule (HM_O_TOL / HM_LSE_TOL, H2_REL), fp32 under
    F32_TOL; masked keys' dk and dv exactly 0 and second calls bit-equal
    (``_check_h4``, ``_check_hm_bwd``). The first row of each instance is
    timed (``_hm_times``: kernel, plain version, SDPA, bound). Returns
    {"bfloat16" | "float32": {row key: max_abs_err and times}}."""
    from jepa_tpu_torch.ops import flash_attention as fa

    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError("TF32 is on: the fp32 plain versions would not be fp32")
    h = narrow["pred_cfg"].num_heads
    c = narrow["pred_cfg"].predictor_embed_dim // h
    if (h, c) != (6, 16):
        raise RuntimeError(f"vit_small's 96-wide predictor has {h} heads of {c}, not 6 of 16")
    depth, scale = narrow["pred_cfg"].depth, c**-0.5
    rungs = sorted({r for rs in ladders for r in rs}, key=sum, reverse=True)
    split = [(ce, cq) for ce, cq in rungs if not fa.merged_bwd(ce + cq, ce + cq, c)]
    if not split:
        raise RuntimeError(f"no padded rung of {rungs} takes the split backward at c={c}")
    # (label, B, N, mid-row pad start or None (unmasked), launches per update)
    shapes = ([(f"fixed {ke}+{kp}", TRAIN_BATCH, ke + kp, None, depth)
               for ke, kp in narrow["keep"]]
              + [(f"rung {ce}+{cq}", TRAIN_BATCH, ce + cq, ce, depth) for ce, cq in rungs]
              + [(f"rung {ce}+{cq} unmasked", TRAIN_BATCH, ce + cq, None, 0)
                 for ce, cq in split]
              + [("ragged", 2, RAGGED_N, mid, 0) for mid in (None, 0)])
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
        rng = np.random.default_rng(SEED + 23)
        rows = out[str(dt)[6:]] = {}
        f32 = "-fp32" if dt == torch.float32 else ""
        for label, b, n, mid, per_update in shapes:
            q, k, v, do = _hm_inputs(torch, gen, b, h, n, n, c, dt)
            mask = None if mid is None else padded_key_mask(torch, rng, b, n, mid)
            sfx = "_c16" + ("" if mask is None else "_masked")
            tag = f"{label} B={b} N={n} H={h} c={c}{'' if mask is None else ' masked'}"
            kinds = ["dqkv"] if fa.merged_bwd(n, n, c) else ["dq", "dkv"]
            _, _, err = _check_h4(torch, f"H4{f32} {tag}", q, k, v, scale, mask)
            errs = {"fwd": err}
            for kind in kinds:
                name = {"dq": "H5", "dkv": "H6", "dqkv": "H7"}[kind]
                errs[kind] = _check_hm_bwd(torch, kind, f"{name}{f32} {tag}", q, k, v, do, scale,
                                           mask)[2]
            untimed = [kind for kind in errs if f"hm_{kind}{sfx}" not in rows]
            lib = _sdpa_hm_ms(torch, q, k, v, do, scale, mask) if untimed else None
            for kind, e in errs.items():
                _note(rows, f"hm_{kind}{sfx}", e, _hm_times(torch, kind, q, k, v, do, scale,
                                                            mask, lib)
                      if kind in untimed else None, per_update)
            del q, k, v, do, mask
        torch.cuda.empty_cache()
    return out


def phase_small_base_tm_kernels(torch, depth):
    """The token-major instances at the head counts vit_small and vit_base
    bring (``depth``: their encoders' blocks, the launches per update),
    against their plain versions on the card (second calls bit-equal),
    timed beside SDPA and their bounds: H1 + both H2 kernels
    (``_check_h1``, ``_check_h2``) at 6 heads of 64 (vit_small's context,
    N=376, and its 384-wide predictor, N=1109), 12 heads of 64 (vit_base's
    context) and 12 of 32 (vit_base's 384-wide predictor), B=24; H3 at both
    models' target fc1 (M=24*1568; K=384, F=1536 and K=768, F=3072); in
    fp32 (vit_small's fp32 updates) H1-fp32 + H2-fp32 at the 6 x 64 context
    masked or not (``f32_attn_rows``) and H3-fp32 at K=384. Returns {row
    label: times and max_abs_err}."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 24)
    ctx, pred = 376, 376 + 733  # vitl16.yaml's first mask config at B=24 (train_setup's keep)
    rows = {}
    for label, h, c in SMALL_TM_SHAPES:
        n = pred if "predictor" in label else ctx
        qkv, do = _attn_inputs(torch, gen, TRAIN_BATCH, n, h, c)
        tag = f"{label} B={TRAIN_BATCH} N={n} H={h} c={c}"
        o, lse, err = _check_h1(torch, f"H1 {tag}", qkv, h, c**-0.5)
        delta, errs = _check_h2(torch, f"H2 {tag}", qkv, do, o, lse, h, c**-0.5, c)
        rows[label, "h1"] = dict(_time_h1(torch, f"H1 {tag}", qkv, h, c**-0.5, c),
                                 max_abs_err=err)
        for kind, r in _time_h2(torch, tag, qkv, do, lse, delta, h, c**-0.5, c, errs).items():
            rows[label, kind] = r
        del qkv, do, o, lse, delta
    for model, (k, f) in SMALL_FC1.items():
        rows[model, "h3"] = _time_fc1(torch, f"H3 {model} target fc1", gen,
                                      TRAIN_BATCH * 1568, k, f, torch.bfloat16)
    rows["vit_small", "h3_f32"] = _time_fc1(torch, "H3-fp32 vit_small target fc1", gen,
                                            TRAIN_BATCH * 1568, *SMALL_FC1["vit_small"],
                                            torch.float32)
    for tag, r in f32_attn_rows(torch, (("vit_small context", TRAIN_BATCH, ctx, 6, 64, 64, 0,
                                         depth),), SEED + 25).items():
        for kind, x in r.items():
            rows[tag, f"{kind}_f32"] = x
    torch.cuda.empty_cache()
    return rows


def small_base_paths(torch, repo):
    """vit_small and vit_base on the card (``train_setup`` at vitl16.yaml,
    B=24, full width and depth): the c=16 head-major instances
    (``phase_c16_kernels``) and the token-major ones at the models' head
    counts (``phase_small_base_tm_kernels``); serving both models
    (``phase_serve``, 4 requests of 2 clips, features against the plain
    path); TRAIN_STEPS updates in the fixed and the padded mode (the fixed
    mode's profiled) with a seeded B=2 update in each against the plain
    versions (``mode_updates``)
    of vit_small with its 12 x 384 predictor, vit_small with the 2 x 96 one
    (6 heads of 16: H4 + H7 at the fixed sequences; the padded mode's last
    update at the top rungs, N=1664: H4 + H5 + H6) in bf16 and in fp32
    (meta.dtype float32, remat 'attn', TF32 off), and vit_base with its
    12 x 384 predictor; then the pretrain app with no model.model_name, so
    it takes its default, vit_base (``phase_app``: fixed, a resume,
    padded). Returns each part's report."""
    from jepa_tpu_torch.masks.multiblock3d import calibrate_pad_ladders

    f32 = dict(dtype=torch.float32, remat="attn")
    setups = {}
    for label, model, kw in (("vit_small", "vit_small", {}),
                             ("vit_small 96", "vit_small", SMALL_PRED96),
                             ("vit_small 96 fp32", "vit_small", dict(SMALL_PRED96, **f32)),
                             ("vit_base", "vit_base", {})):
        setups[label] = tuple(train_setup(repo, model, mask_mode=mode, **kw)
                              for mode in (None, "padded"))
    narrow = setups["vit_small 96"][0]
    ladders = calibrate_pad_ladders(narrow["specs"], narrow["grid"], TRAIN_BATCH)
    out = {"c16": timed("c16 kernels", phase_c16_kernels, torch, narrow, ladders),
           "tm": timed("vit_small / vit_base tm kernels", phase_small_base_tm_kernels, torch,
                       narrow["enc_cfg"].depth)}
    with tempfile.TemporaryDirectory(dir=repo, prefix=".chip_smoke_") as workdir:
        for model in ("vit_small", "vit_base"):
            out[model, "serve"] = timed(f"{model} serve", phase_serve, torch, workdir, model)
            os.remove(out[model, "serve"]["enc_path"])
    out["runs"] = {label: timed(f"{label} updates", mode_updates, torch, fixed, padded,
                                top_last="96" in label)
                   for label, (fixed, padded) in setups.items()}
    with tempfile.TemporaryDirectory(dir=repo, prefix=".chip_smoke_") as workdir:
        out["app"] = timed("vit_base app (the default model)", phase_app, torch, repo,
                           setups["vit_base"][0], workdir, ipe=2, default_model=True)
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
            if got != launches or s["h3_rows"] != ([rows] if rows else []):
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
                     views_checked=None, model_name=None, patch_size=None):
    """The video eval (jepa_tpu_torch.evals.video_classification_frozen.main)
    on configs/evals/<config> (default vitl16_k400_16x8x3.yaml) at its
    model's full width and depth. bf16: the config's batch 4, ``entries``
    (default EVAL_BF16_ENTRIES) synthetic videos, 1 epoch then (``resume``,
    default on) a resume to 2. fp32 (use_bfloat16: false): batch 1,
    EVAL_F32_ENTRIES, 1 epoch. Checks the launches and H3 rows of every
    step, the resume step, the CSV, the probe checkpoint and finite
    results, then the features of the first train and val batch against
    the plain versions (``views_checked``: of their first (segments, views),
    ``eval_features_vs_plain``); ``model_name`` and ``patch_size`` override
    the config's ``pretrain`` section (vit_giant, vit_gigantic at patch 14)."""
    from jepa_tpu_torch.evals import video_classification_frozen as vcf
    from jepa_tpu_torch.models.factory import vit_cfg
    from jepa_tpu_torch.ops import flash_attention as fa
    from jepa_tpu_torch.ops import fused_mlp as fm

    batch = 4 if bf16 else 1
    n_train, n_val = entries or (EVAL_BF16_ENTRIES if bf16 else EVAL_F32_ENTRIES)
    resume = bf16 if resume is None else resume
    name = (f"{config.split('_k400')[0]}{'_' + model_name if model_name else ''}_k400_"
            f"{'bf16' if bf16 else 'fp32'}")
    cfg = eval_config(repo, workdir, name, enc_path, n_train, n_val, config=config,
                      batch_size=batch, num_epochs=1, use_bfloat16=bf16)
    d, p = cfg["data"], cfg["pretrain"]
    p["model_name"] = model_name or p["model_name"]
    p["patch_size"] = patch_size or p["patch_size"]
    res = cfg["optimization"].get("resolution", d.get("resolution", 224))
    enc = vit_cfg(p["model_name"], img_size=res, patch_size=p["patch_size"],
                  num_frames=p["frames_per_clip"], tubelet_size=p["tubelet_size"],
                  compute_dtype=torch.bfloat16 if bf16 else torch.float32)
    s, v = d["num_segments"], d["num_views_per_segment"]
    n_tok = enc.num_patches
    # one encoder pass over every clip of the step: the grad-free routes'
    # launches (H1 or H4 by route and dtype; H3 where its tiling takes the fc1)
    per_step = expected_launches(enc)
    fc1 = any(k.startswith("h3") for k in per_step)  # H3 rows: the step's tokens
    want = {"train_step": (per_step, batch * s * n_tok if fc1 else None),
            "val_step": (per_step, batch * s * v * n_tok if fc1 else None)}
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
    as with mask tokens: H1 72, H2 48 + 48, H3 24 per update) and the
    B=2 update against the plain versions from the seeded and the trained
    state (``check_b2``'s limits)."""
    setup = train_setup(repo, use_mask_tokens=False)
    out = phase_train(torch, setup, steps=3, profile=False)
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


def _time_h1(torch, label, qkv, h, scale, c_real, mask=None, by_sample=False, f32=False):
    """H1 (or H1-fp32) timed beside its plain version (``by_sample``: one
    sample at a time), SDPA's forward on the same q/k/v (with the key mask
    where there is one) and its bound at the real head dim c_real."""
    from jepa_tpu_torch.ops import flash_attention as fa

    b, n, w3 = qkv.shape
    el = qkv.element_size()
    pairs = None if mask is None else int(mask.sum().item()) * n
    io = (qkv.numel() + w3 // 3 * b * n) * el + b * h * n * 4 + (0 if mask is None else b * n)
    bound = (f32_bound_ms(4.0 * b * h * n * n * c_real, b * h * n * n, io) if f32 else
             attn_bound_ms(b, n, h, c_real, 2, qkv.numel() * el + (0 if mask is None else b * n),
                           w3 // 3 * b * n * el + b * h * n * 4, pairs))
    lib = _sdpa_fwd_ms(torch, qkv, h, scale, mask)
    r = dict(ms=time_ms(torch, lambda: fa.flash_self_attention_cuda(qkv, h, scale, mask)),
             plain_ms=time_ms(torch, lambda: _by_sample(torch, by_sample,
                                                        fa.flash_self_attention_ref, qkv, h,
                                                        scale, mask), iters=3, warmup=1),
             library_ms=lib, bound=bound, shape=(b, n, h, c_real))
    log(f"{label} time: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library (SDPA "
        f"forward{', bool mask' if mask is not None else ''}{', fp32' if f32 else ''}) "
        f"{lib:.4f} ms, bound {bound[0]:.4f} ms ({bound[2]})")
    return r


def _time_h2(torch, label, qkv, do, lse, delta, h, scale, c_real, errs, mask=None):
    """Both H2 kernels timed beside their plain versions, SDPA's whole
    backward (with the key mask where there is one) and their bounds at the
    real head dim c_real; returns {"dkv": ..., "dq": ...}."""
    from jepa_tpu_torch.ops import flash_attention as fa

    b, n, w3 = qkv.shape
    qkv_b, o_b, vec_b = qkv.numel() * 2, w3 // 3 * b * n * 2, b * h * n * 4
    m_b = 0 if mask is None else b * n
    pairs = None if mask is None else int(mask.sum().item()) * n
    lib = (_sdpa_masked_ms(torch, qkv, do, h, scale, mask)[1] if mask is not None
           else _sdpa_bwd_ms(torch, qkv, do, h, scale))
    out = torch.empty_like(qkv)
    rep = {}
    for key, fn, ref, products, outs, names in (
            ("dkv", fa.flash_bwd_dkv_cuda, fa.flash_bwd_dkv_ref, 4, 2, ("dk", "dv")),
            ("dq", fa.flash_bwd_dq_cuda, fa.flash_bwd_dq_ref, 3, 1, ("dq",))):
        r = rep[key] = dict(
            max_abs_err=max(errs[k] for k in names), shape=(b, n, h, c_real), library_ms=lib,
            ms=time_ms(torch, lambda: fn(qkv, do, lse, delta, out, h, scale, mask)),
            plain_ms=time_ms(torch, lambda: ref(qkv, do, lse, delta, h, scale, mask)),
            bound=attn_bound_ms(b, n, h, c_real, products, qkv_b + o_b + 2 * vec_b + m_b,
                                outs * o_b, pairs))
        log(f"{key} {label} time: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library (SDPA's whole backward{', bool mask' if mask is not None else ''}) "
            f"{lib:.4f} ms, bound {r['bound'][0]:.4f} ms ({r['bound'][2]})")
    return rep


def _time_fc1(torch, label, gen, m, k, f, dt):
    """H3 (bf16 ``dt``) or H3-fp32 on seeded x [m, k], w [f, k], b [f]:
    held against its plain version (``_check_h3`` / ``_check_f32_fc1``),
    then timed beside it, ``torch._addmm_activation`` and its bound."""
    from jepa_tpu_torch.ops import fused_mlp as fm

    x = torch.randn((m, k), generator=gen, device="cuda").to(dt)
    w = (torch.randn((f, k), generator=gen, device="cuda") / 32).to(dt)
    bias = torch.randn((f,), generator=gen, device="cuda") * 0.1
    label = f"{label} M={m} K={k} F={f}"
    err = (_check_h3 if dt == torch.bfloat16 else _check_f32_fc1)(torch, label, x, w, bias)
    bias_lp = bias.to(dt)
    bound = (fc1_bound_ms(m, k, f, outputs=1) if dt == torch.bfloat16 else
             f32_bound_ms(2.0 * m * k * f, 0, 4 * (m * k + f * k + f + m * f)))
    r = dict(max_abs_err=err, shape=(m, k, f), bound=bound,
             ms=time_ms(torch, lambda: fm.linear_gelu_cuda(x, w, bias)),
             plain_ms=time_ms(torch, lambda: fm.linear_gelu_ref(x, w, bias)),
             library_ms=time_ms(torch, lambda: torch._addmm_activation(bias_lp, x, w.t(),
                                                                       use_gelu=True)))
    log(f"{label} time: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
        f"(_addmm_activation) {r['library_ms']:.4f} ms, bound {bound[0]:.4f} ms ({bound[2]})")
    return r


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

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    rep = {}
    h, c = 16, 80
    scale = c**-0.5
    by_sample = lambda b, heads, n: b * heads * n * n * 4 > PLAIN_BATCH_BYTES
    for key, b, n in (("h1_c80", TRAIN_BATCH, 1568), ("h1_c80_n4608", 10, 4608)):
        qkv = torch.randn((b, n, 3 * h * c), generator=gen, device="cuda").to(torch.bfloat16)
        label = f"H1 ViT-H B={b} N={n} H={h} c={c}"
        split = by_sample(b, h, n)
        _, _, err = _check_h1(torch, label, qkv, h, scale, by_sample=split)
        rep[key] = dict(_time_h1(torch, label, qkv, h, scale, c, by_sample=split),
                        max_abs_err=err)
        del qkv

    ctx = setups[0]["keep"][0][0]  # vith16's first context
    b, n = TRAIN_BATCH, ctx
    qkv, do = _attn_inputs(torch, gen, b, n, h, c)
    o, lse, _ = _check_h1(torch, f"H1 ViT-H context B={b} N={n}", qkv, h, scale)
    delta, errs = _check_h2(torch, f"H2 ViT-H context B={b} N={n} H={h}", qkv, do, o, lse, h,
                            scale, c)
    for key, r in _time_h2(torch, f"ViT-H context B={b} N={n} H={h} c={c}", qkv, do, lse, delta,
                           h, scale, c, errs).items():
        rep[f"{key}_c80"] = r
    del qkv, do, o, lse, delta

    m, k, f = TRAIN_BATCH * 1568, 1280, 5120
    rep["h3_k1280"] = _time_fc1(torch, "H3 ViT-H fc1", gen, m, k, f, torch.bfloat16)

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


# vit_giant and vit_gigantic: (model, data.patch_size in the pretrain YAML and
# pretrain.patch_size in the eval YAML; None keeps the config's 16), each at
# vitl16.yaml / vitl16_k400_16x8x3.yaml's geometry; gigantic at its factory's
# patch 14 (N = 2048). Both update at B=24 with the app's default remat,
# 'attn' (PERF.md §4: both fit).
GIANTS = (("vit_giant", None), ("vit_gigantic", 14))


def _f32_attn_inputs(torch, gen, b, n, h, c, c_real):
    """Seeded fp32 qkv [B, N, 3*H*c] with the pad lanes past c_real zero."""
    qkv = torch.randn((b, n, 3, h, c), generator=gen, device="cuda")
    qkv[..., c_real:] = 0
    return qkv.reshape(b, n, 3 * h * c)


def phase_giant_kernels(torch, setups):
    """The instances vit_giant's and vit_gigantic's paths launch, against
    their plain versions on the card, each called a second time (bit-equal;
    the plain versions one sample at a time where a batch's fp32 scores pass
    PLAIN_BATCH_BYTES), timed beside a library call and their bound:
    H1 c=88->96 at the vit_giant target (B=24, N=1568), both H2 kernels at
    c=96 at its first context (B=24), H1 and both H2 kernels at c=96 with a
    key mask at its padded mode's first context rung (B=24), H1 and both H2
    kernels at c=104->128 at the vit_gigantic target (B=24, N=2048) and
    first context, H1-fp32 at c=96 and c=128 at the fp32 evals' train step
    (B=8, N=1568 and 2048), H3 and H3-fp32 at both fc1 (K=1408, F=6144;
    K=1664, F=6656; M = 24 N and 8 N). Then, checked only: H1-fp32 at the
    fp32 evals' val step (B=24), H1 and H2 at c=96 at the tile edges (N =
    40 and 129; keys [128, 384) all pads at N = 640), H1-fp32 at c=96 and
    128 at N = 40, 129 and 333, H3 and H3-fp32 at M = 2305, every other
    padded-mode context rung and every other token-major call of one
    update of each of ``setups`` (vit_giant, vit_gigantic: the contexts
    under grad and the predictors, c=24->32); ``held`` gives each
    instance's max|d| there."""
    from jepa_tpu_torch.masks.multiblock3d import calibrate_pad_ladders
    from jepa_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    rng = np.random.default_rng(SEED + 15)
    by_sample = lambda b, heads, n: b * heads * n * n * 4 > PLAIN_BATCH_BYTES
    rep, held, done = {}, collections.defaultdict(float), set()
    for setup in setups:
        enc = setup["enc_cfg"]
        h, c_real, n = enc.num_heads, enc.embed_dim // enc.num_heads, enc.num_patches
        c, scale, b = fa.padded_head_dim(c_real), c_real**-0.5, setup["yaml_batch"]
        sfx = "" if c == 96 else f"_{setup['model_name']}"
        name = f"{setup['model_name']} B={b} H={h} c={c_real}->{c}"
        # the target (grad-free) and the first context (under grad)
        qkv, _ = _attn_inputs(torch, gen, b, n, h, c, c_real)
        split = by_sample(b, h, n)
        label = f"H1 {name} target N={n}"
        _, _, err = _check_h1(torch, label, qkv, h, scale, by_sample=split)
        rep[f"h1_c{c}{sfx}"] = dict(_time_h1(torch, label, qkv, h, scale, c_real,
                                             by_sample=split), max_abs_err=err)
        del qkv
        ctx = setup["keep"][0][0]
        qkv, do = _attn_inputs(torch, gen, b, ctx, h, c, c_real)
        label = f"H1 {name} context N={ctx}"
        o, lse, err = _check_h1(torch, label, qkv, h, scale)
        held[f"h1_c{c}"] = max(held[f"h1_c{c}"], err)
        rep[f"h1_ctx_c{c}{sfx}"] = dict(_time_h1(torch, label, qkv, h, scale, c_real),
                                        max_abs_err=err)
        delta, errs = _check_h2(torch, f"H2 {name} context N={ctx}", qkv, do, o, lse, h, scale,
                                c_real)
        for key, r in _time_h2(torch, f"{name} context N={ctx}", qkv, do, lse, delta, h, scale,
                               c_real, errs).items():
            rep[f"{key}_c{c}{sfx}"] = r
        done |= {(b, n, h, c), (b, ctx, h, c)}
        del qkv, do, o, lse, delta
        # the padded mode's context rungs, with the key mask (vit_giant's app)
        if c == 96:
            ladders = calibrate_pad_ladders(setup["specs"], setup["grid"], b)
            first = ladders[0][0][0]  # the app's first padded context (expected_launches)
            rungs = [first] + sorted({ce for ladder in ladders for ce, _ in ladder} - {first})
            for i, ce in enumerate(rungs):
                qkv, do = _attn_inputs(torch, gen, b, ce, h, c, c_real)
                mask = padded_key_mask(torch, rng, b, ce, 0)
                label = f"masked H1 {name} context rung N={ce}"
                o, lse, err = _check_h1(torch, label, qkv, h, scale, mask)
                delta, errs = _check_h2(torch, f"masked H2 {name} context rung N={ce}", qkv, do,
                                        o, lse, h, scale, c_real, mask)
                if i == 0:
                    rep["h1_c96_masked"] = dict(_time_h1(torch, label, qkv, h, scale, c_real,
                                                         mask), max_abs_err=err)
                    for key, r in _time_h2(torch, f"masked {name} context rung N={ce}", qkv, do,
                                           lse, delta, h, scale, c_real, errs, mask).items():
                        rep[f"{key}_c96_masked"] = r
                else:
                    held["h1_c96_masked"] = max(held["h1_c96_masked"], err)
                    held["dkv_c96_masked"] = max(held["dkv_c96_masked"], errs["dk"], errs["dv"])
                    held["dq_c96_masked"] = max(held["dq_c96_masked"], errs["dq"])
                del qkv, do, o, lse, delta, mask
        # H1-fp32 at the fp32 eval's train step (batch 1: 8 clips)
        qkv = _f32_attn_inputs(torch, gen, 8, n, h, c, c_real)
        label = f"H1-fp32 {setup['model_name']} eval B=8 N={n} H={h} c={c_real}->{c}"
        err = _check_h1_f32(torch, label, qkv, h, scale)
        rep[f"h1_f32_c{c}"] = dict(_time_h1(torch, label, qkv, h, scale, c_real, f32=True),
                                   max_abs_err=err)
        qkv = _f32_attn_inputs(torch, gen, b, n, h, c, c_real)  # the val step's clips
        held[f"h1_f32_c{c}"] = max(held[f"h1_f32_c{c}"], _check_h1_f32(
            torch, f"H1-fp32 {setup['model_name']} eval B={b} N={n} H={h} c={c_real}->{c}", qkv,
            h, scale, by_sample=by_sample(b, h, n)))
        del qkv
        # H3 and H3-fp32 at the encoder's fc1: the target's rows, the fp32 eval's;
        # then at a ragged M
        k, f = enc.embed_dim, enc.mlp_hidden
        for dt, m, key, kind in ((torch.bfloat16, b * n, f"h3_k{k}", "H3"),
                                 (torch.float32, 8 * n, f"h3_f32_k{k}", "H3-fp32")):
            rep[key] = _time_fc1(torch, f"{kind} {setup['model_name']} fc1", gen, m, k, f, dt)
            x = torch.randn((2305, k), generator=gen, device="cuda").to(dt)
            w = (torch.randn((f, k), generator=gen, device="cuda") / 32).to(dt)
            bias = torch.randn((f,), generator=gen, device="cuda") * 0.1
            held[key] = max(held[key], (_check_h3 if dt == torch.bfloat16 else _check_f32_fc1)(
                torch, f"{kind} {setup['model_name']} fc1 edge M=2305 K={k} F={f}", x, w, bias))
            del x, w, bias

    # tile edges: H1 and H2 at c=96, H1-fp32 at c=96 and c=128
    for b, n in ((2, 40), (2, 129)):
        qkv, do = _attn_inputs(torch, gen, b, n, 16, 96, 88)
        o, lse, err = _check_h1(torch, f"H1 edge B={b} N={n} H=16 c=88->96", qkv, 16, 88**-0.5)
        held["h1_c96"] = max(held["h1_c96"], err)
        _, errs = _check_h2(torch, f"H2 edge B={b} N={n} H=16", qkv, do, o, lse, 16, 88**-0.5,
                            88)
        held["dq_c96"] = max(held["dq_c96"], errs["dq"])
        held["dkv_c96"] = max(held["dkv_c96"], errs["dk"], errs["dv"])
    qkv, do = _attn_inputs(torch, gen, 4, 640, 16, 96, 88)
    mask = padded_key_mask(torch, rng, 4, 640, 0)
    mask[:, 128:384] = False
    label = "B=4 N=640 H=16, keys [128, 384) all pads"
    o, lse, err = _check_h1(torch, f"masked H1 edge {label}, c=88->96", qkv, 16, 88**-0.5, mask)
    held["h1_c96_masked"] = max(held["h1_c96_masked"], err)
    _, errs = _check_h2(torch, f"masked H2 edge {label},", qkv, do, o, lse, 16, 88**-0.5, 88, mask)
    held["dq_c96_masked"] = max(held["dq_c96_masked"], errs["dq"])
    held["dkv_c96_masked"] = max(held["dkv_c96_masked"], errs["dk"], errs["dv"])
    for c, c_real in ((96, 88), (128, 104)):
        for n in (40, 129, 333):
            qkv = _f32_attn_inputs(torch, gen, 2, n, 16, c, c_real)
            err = _check_h1_f32(torch, f"H1-fp32 edge B=2 N={n} H=16 c={c_real}->{c}", qkv, 16,
                                c_real**-0.5)
            held[f"h1_f32_c{c}"] = max(held[f"h1_f32_c{c}"], err)
    del qkv, do, o, lse, mask

    # every other token-major call of one update of each setup
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
            label = (f"{setup['model_name']} B={b} N={n} H={heads}"
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
    for key, r in rep.items():  # vit_gigantic's c=128 rows take c=128's other calls
        r["max_abs_err"] = max(r["max_abs_err"], held.get(key.removesuffix("_vit_gigantic"), 0.0))
    rep["held"] = held
    log(f"vit_giant's and vit_gigantic's other call shapes against the plain versions, max|d| "
        f"by instance: {dict(held)}")
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
    copy held beside: its GiB are logged). Every update's launches are
    checked whole: 'attn' those of
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
    for remat in setups:
        out[remat] = dict(median_ms=statistics.median(times[remat]), times=times[remat],
                          peak_gib=peaks[remat], per_update=want[remat],
                          state_gib=state_gib, launches=_sum_launches(*seen[remat]))
        log(f"remat {remat!r}, B={TRAIN_BATCH}, in turns: {[round(t, 1) for t in times[remat]]} "
            f"ms, median {out[remat]['median_ms']:.1f} ms/update, peak allocated "
            f"{peaks[remat]:.2f} GiB (the seeded "
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


def phase_f32_peak(torch, repo, spec, padded):
    """``--f32-peak CONFIG[:MODEL] [--padded]``: one pretrain config in fp32
    (meta.dtype float32, remat 'attn', the app's default) at full depth,
    outside the smoke: TRAIN_STEPS updates through build_train_step at the
    config's batch (fixed masks, or with ``padded`` the collator's padded
    masks), with their launches checked whole; prints ms per update and the
    peak of allocated memory. MODEL overrides the config's model_name
    (vit_gigantic takes its factory patch, 14). Where the batch does not
    fit, the out-of-memory error is printed and the next smaller batch of
    ``f32_peak_batches`` is tried, until one fits."""
    import gc

    config, _, model = spec.partition(":")
    kw = dict(config=config, model_name=model or None, patch_size=dict(GIANTS).get(model),
              dtype=torch.float32, remat="attn", mask_mode="padded" if padded else None)
    yaml_batch = train_setup(repo, **kw)["yaml_batch"]
    label = f"f32-peak {spec} {'padded' if padded else 'fixed'}"
    for batch in f32_peak_batches(yaml_batch):
        setup = dict(train_setup(repo, **kw), yaml_batch=batch)
        try:
            r = phase_train(torch, setup, b2=())
        except torch.cuda.OutOfMemoryError as e:
            log(f"{label} B={batch}: out of memory ({str(e).splitlines()[0]}); peak allocated "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB of "
                f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f} GiB")
            r = None
        if r is None:  # past the handler, whose traceback held the update's tensors
            gc.collect()
            torch.cuda.empty_cache()
            continue
        log(f"{label} B={batch} (the config's {yaml_batch}), {setup['model_name']} "
            f"{setup['enc_cfg'].depth} blocks: median {r['median_ms']:.1f} ms/update, peak "
            f"allocated {r['peak_gib']:.2f} GiB, device {r['prof']['device_ms']:.1f} ms/update")
        return
    raise RuntimeError(f"{label}: no batch of {f32_peak_batches(yaml_batch)} fits")


def f32_peak_batches(batch):
    """The batches ``--f32-peak`` tries, the config's first, then smaller."""
    return sorted({max(1, batch * k // 6) for k in (6, 5, 4, 3, 2, 1)}, reverse=True)


# ---- phase_dist: data parallelism ------------------------------------------------

DIST_BATCH = TRAIN_BATCH // 2  # (b): 2 ranks x 12 clips against 1 rank x 24
# (b): the kernels' 2 x 12 vs 1 x 24 spread may be this many times the plain
# versions' on the same inputs (each limit is printed before it is held)
DIST_LIMIT_FACTOR = 10.0
DIST_REL_FLOOR = 1e-6  # a limit never below this relative difference (nor cosine above 1 - it)
DIST_APP_IPE = 2  # (c): updates per epoch of the 2-rank app
DIST_EVAL_ENTRIES = (8, 10)  # (d): train / val videos; 10 is no multiple of 2 ranks x 4
DIST_DEPTH = 2  # ViT-L's depth in every run of phase_dist, its width kept (cut_depth)
DIST_PRED_DEPTH = 2  # the predictor's depth there (model.pred_depth; 12 in vitl16.yaml)
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
    with cut_depth("vit_large", DIST_DEPTH):
        one = train_setup(repo, remat="attn", pred_depth=DIST_PRED_DEPTH)
        two = train_setup(repo, remat="attn", layout=make_layout(1), pred_depth=DIST_PRED_DEPTH)
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
    with cut_depth("vit_large", DIST_DEPTH):
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
    with cut_depth("vit_large", DIST_DEPTH):
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
    ``setup`` and every run here are ViT-L at DIST_DEPTH blocks
    (``cut_depth``, entered by the caller and by each spawned rank).
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
        cfg["model"]["pred_depth"] = DIST_PRED_DEPTH
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
        depth = setup["enc_cfg"].depth
        per_step = {"h1": depth, "h1_c64": depth, "h3": depth}
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
# (label, B, N, H, c, c_real, mid) of the A/B mode's fp32 token-major rows:
# H1-fp32 (masked where mid is not None) and both H2-fp32 kernels, then their
# sum, at every fp32 pretraining instance: c=64, c=24->32, c=80, c=88->96,
# c=104->128 and c=128, masked or not, vit_small's 6 heads of 64, and a ragged N
AB_F32_TM_ROWS = (
    ("c=64 B=24 N=376 H=16 (ViT-L fp32 context)", 24, 376, 16, 64, 64, None),
    ("c=64 masked B=24 N=384 H=16 (context rung)", 24, 384, 16, 64, 64, 0),
    ("c=24->32 B=24 N=1109 H=16 (ViT-L fp32 predictor)", 24, 1109, 16, 32, 24, None),
    ("c=24->32 masked B=24 N=1152 H=16 (predictor rung)", 24, 1152, 16, 32, 24, 384),
    ("c=64 masked B=2 N=333 H=16 (ragged)", 2, 333, 16, 64, 64, 0),
    ("c=104->128 B=24 N=513 H=16 (vit_gigantic fp32 context)", 24, 513, 16, 128, 104, None),
    ("c=104->128 masked B=24 N=513 H=16", 24, 513, 16, 128, 104, 0),
    ("c=80 B=24 N=376 H=16 (vith16 fp32 context)", 24, 376, 16, 80, 80, None),
    ("c=88->96 B=24 N=376 H=16 (vit_giant fp32 context)", 24, 376, 16, 96, 88, None),
    ("c=128 B=24 N=1109 H=3 (vit_tiny fp32 predictor)", 24, 1109, 3, 128, 128, None),
    ("c=128 masked B=24 N=1664 H=3 (vit_tiny fp32 predictor rung)", 24, 1664, 3, 128, 128, 256),
    ("c=64 B=24 N=376 H=6 (vit_small fp32 context)", 24, 376, 6, 64, 64, None),
)
# (label, entry kind, B, H, Nq, Nk, c, masked) of the A/B mode's head-major
# fp32 rows: H7-fp32 ("dqkv") at vit_tiny's fp32 context and top rung, its 2 x
# 96 predictor (c=32) and vit_small's (c=16), fixed and a padded rung; H5-fp32
# ("dq") and H6-fp32 ("dkv") at the split backward's geometry (N >= ~1300)
AB_HM_F32_ROWS = (
    ("H7-fp32 B=24 N=376 H=3 c=64 (vit_tiny fp32 context)", "dqkv", 24, 3, 376, 376, 64, False),
    ("H7-fp32 masked B=24 N=640 H=3 c=64 (top context rung)", "dqkv", 24, 3, 640, 640, 64, True),
    ("H7-fp32 B=24 N=1109 H=3 c=32 (vit_tiny 2 x 96 predictor)", "dqkv", 24, 3, 1109, 1109, 32,
     False),
    ("H7-fp32 masked B=24 N=1408 H=3 c=32", "dqkv", 24, 3, 1408, 1408, 32, True),
    ("H7-fp32 B=24 N=1109 H=6 c=16 (vit_small 2 x 96 predictor)", "dqkv", 24, 6, 1109, 1109, 16,
     False),
    ("H7-fp32 masked B=24 N=1408 H=6 c=16", "dqkv", 24, 6, 1408, 1408, 16, True),
    ("H5-fp32 B=24 N=1568 H=3 c=64 (split backward)", "dq", 24, 3, 1568, 1568, 64, False),
    ("H6-fp32 B=24 N=1568 H=3 c=64 (split backward)", "dkv", 24, 3, 1568, 1568, 64, False),
    ("H5-fp32 masked B=24 N=1664 H=6 c=16 (top rung)", "dq", 24, 6, 1664, 1664, 16, True),
    ("H6-fp32 masked B=24 N=1664 H=6 c=16 (top rung)", "dkv", 24, 6, 1664, 1664, 16, True),
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
    """The bf16 H1, H3, H8, H4 and H2, H6, H7 and H5, and H1-fp32 (masked or
    not), H2-fp32 (each kernel and their sum), H5-H7-fp32, H3-fp32 and
    H8-fp32, of this checkout against each other checkout's (``python3
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

    def ab(row, entry, args, outs, after=None, per_lib=False):
        """``args()`` the entry's arguments; with ``per_lib`` ``args(lib)``,
        where they depend on the library (the key-mask argument H1-fp32
        gained)."""
        argv = lambda lib: args(lib) if per_lib else args()  # noqa: E731
        calls = {name: (lambda lib=lib: _build.check(getattr(lib, entry)(*argv(lib)), entry))
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

    def ab_sum(label, pair, lib, whole):
        """The dk/dv and dq rows ``pair`` summed, beside the bound ``whole``
        and SDPA's whole backward ``lib``."""
        row = dict(row=label, library_ms=lib, bound=whole, ms=pair[0]["ms"] + pair[1]["ms"])
        for name in others:
            row[f"{name} ms"] = pair[0][f"{name} ms"] + pair[1][f"{name} ms"]
            row[f"{name} speedup"] = row[f"{name} ms"] / row["ms"]
            row[f"{name} max|this - other|"] = max(
                p[f"{name} max|this - other|"] for p in pair)
        row["bound_share"] = whole[0] / row["ms"]
        rows.append(row)
        log(f"A/B {row['row']}: this {row['ms']:.4f} ms, " + ", ".join(
            f"{n} {row[f'{n} ms']:.4f} ms (x{row[f'{n} speedup']:.2f}, max|d| "
            f"{row[f'{n} max|this - other|']:.2e})" for n in others)
            + f"; bound {whole[0]:.4f} ms ({whole[2]}, share {100 * row['bound_share']:.1f} %), "
            f"library (SDPA backward) {lib:.4f} ms (x{lib / row['ms']:.2f} of this)")

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
        ab_sum(f"{label} dkv + dq", pair, lib, attn_bound_ms(
            b, n, h, c_real, 5, qkv_b + o_b + 2 * vec_b + m_b, qkv_b, pairs))
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
    # fp32 pretraining's token-major instances: H1-fp32 masked or not, then
    # both H2-fp32 kernels on its lse (each row compares its own columns)
    for label, b, n, h, c, c_real, mid in AB_F32_TM_ROWS:
        qkv = _f32_attn_inputs(torch, gen, b, n, h, c, c_real)
        do = torch.randn((b, n, h, c), generator=gen, device="cuda")
        do[..., c_real:] = 0
        do = do.reshape(b, n, h * c)
        mask = None if mid is None else padded_key_mask(torch, rng, b, n, mid)
        m8 = None if mask is None else mask.to(torch.uint8).contiguous()
        scale = c_real**-0.5
        o = torch.empty((b, n, h * c), device="cuda")
        lse = torch.empty((b, h, n), device="cuda")
        pairs = b * n * n if mask is None else int(mask.sum().item()) * n
        io = 4 * (qkv.numel() + o.numel() + lse.numel()) + (0 if m8 is None else b * n)
        args = lambda: (qkv.data_ptr(), None if m8 is None else m8.data_ptr(),  # noqa: E731
                        o.data_ptr(), lse.data_ptr(), b, n, h, scale * fa._LOG2E, stream())
        lib_fwd, lib_bwd = (_sdpa_masked_ms(torch, qkv, do, h, scale, mask) if mask is not None
                            else (_sdpa_fwd_ms(torch, qkv, h, scale),
                                  _sdpa_bwd_ms(torch, qkv, do, h, scale)))
        ab(dict(row=f"H1-fp32 {label}", library_ms=lib_fwd,
                bound=f32_bound_ms(4.0 * h * pairs * c_real, h * pairs, io)),
           f"jt_flash_fwd_f32_c{c}", args, (o, lse))
        o, lse = fa.flash_self_attention_cuda(qkv, h, scale, mask)
        delta = fa.attention_delta(do, o, h)
        dqkv = torch.zeros_like(qkv)
        hc = h * c
        ins = io + 4 * (do.numel() + lse.numel())
        pair = []
        for kind, products, cols in (("dkv", 8, slice(hc, 3 * hc)), ("dq", 6, slice(0, hc))):
            extra = (scale,) if kind == "dq" else ()
            args = lambda extra=extra: (  # noqa: E731
                qkv.data_ptr(), None if m8 is None else m8.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dqkv.data_ptr(), b, n, h, scale * fa._LOG2E,
                *extra, stream())
            row = dict(row=f"H2-fp32 {label} {kind}", library_ms=lib_bwd,
                       bound=f32_bound_ms(products * h * pairs * c_real, h * pairs,
                                          ins + 4 * do.numel() * (2 if kind == "dkv" else 1)))
            ab(row, f"jt_flash_bwd_{kind}_f32_c{c}", args, (dqkv[..., cols],))
            pair.append(row)
        ab_sum(f"H2-fp32 {label} dkv + dq", pair, lib_bwd,
               f32_bound_ms(14 * h * pairs * c_real, 2 * h * pairs, ins + 4 * qkv.numel()))
        del qkv, do, o, lse, delta, dqkv
    # H5-H7-fp32 through their head-major entries; H7-fp32's bound counts the
    # bytes of its inputs and gradients, not its dq slabs
    for label, kind, b, h, nq, nk, c, masked in AB_HM_F32_ROWS:
        q, k, v, do = _hm_inputs(torch, gen, b, h, nq, nk, c, torch.float32)
        mask = padded_key_mask(torch, rng, b, nk, 0) if masked else None
        scale = c**-0.5
        o, lse = fa.flash_fwd_hm_cuda(q, k, v, scale, mask)
        delta = fa.hm_delta(do, o)
        grads = dict(dq=fa._alloc_like(q)) if kind != "dkv" else {}
        work = {}
        if kind != "dq":
            grads.update(dk=fa._alloc_like(k), dv=fa._alloc_like(v))
        if kind == "dqkv":
            work = dict(ws=torch.empty((-(-nk // fa.hm_slab_keys(torch.float32)), *q.shape),
                                       device="cuda"))
        hm = _hm_args(fa, q, k, v, scale, mask, do=do, lse=lse, delta=delta, **grads, **work)
        args = lambda hm=hm: (ctypes.addressof(hm), stream())  # noqa: E731
        pairs = b * nq * nk if mask is None else int(mask.sum().item()) * nq
        io = (4 * (b * h * c * 2 * (nq + nk) + 2 * lse.numel()) + (0 if mask is None else b * nk)
              + 4 * sum(t.numel() for t in grads.values()))
        flops = {"dq": 6, "dkv": 8, "dqkv": 10}[kind] * h * pairs * c
        row = dict(row=label, library_ms=_sdpa_hm_ms(torch, q, k, v, do, scale, mask)[1],
                   bound=f32_bound_ms(flops, h * pairs, io))
        ab(row, f"jt_flash_hm_{kind}_f32_c{c}", args, tuple(grads.values()))
        del q, k, v, do, o, lse, delta, grads, work, hm
    for b, n, h, c in F32_H1_SHAPES + F32_H1_SHAPES_AB:
        qkv = torch.randn((b, n, 3 * h * c), generator=gen, device="cuda")
        o = torch.empty((b, n, h * c), device="cuda")
        lse = torch.empty((b, h, n), device="cuda")
        scale = c**-0.5
        entry = f"jt_flash_fwd_f32_c{c}"
        # unmasked; a library built before the key-mask argument takes no None
        args = lambda lib: (  # noqa: E731
            qkv.data_ptr(), *((None,) if len(getattr(lib, entry).argtypes) == 9 else ()),
            o.data_ptr(), lse.data_ptr(), b, n, h, scale * fa._LOG2E, stream())
        row = dict(row=f"H1-fp32 B={b} N={n} H={h} c={c}",
                   library_ms=_sdpa_fwd_ms(torch, qkv, h, scale),
                   bound=f32_bound_ms(4.0 * b * h * n * n * c, b * h * n * n,
                                      4 * (qkv.numel() + o.numel() + lse.numel())))
        ab(row, entry, args, (o, lse), per_lib=True)
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

    global T0
    T0 = time.perf_counter()
    card = phase_device(torch)
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    phase_build()
    if "--remat-peak" in sys.argv:
        phase_remat_peak(torch, repo, sys.argv[sys.argv.index("--remat-peak") + 1],
                         "--padded" in sys.argv)
        return 0
    if "--f32-peak" in sys.argv:
        phase_f32_peak(torch, repo, sys.argv[sys.argv.index("--f32-peak") + 1],
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
    train_force = timed("train_force", phase_train, torch, force, profile=False)
    ab = timed("ab", phase_force_ab, torch, setup, force)
    diff = timed("(c) diffusion-mode update", phase_diffusion, torch, repo)
    with tempfile.TemporaryDirectory(dir=repo, prefix=".chip_smoke_") as workdir:
        app = timed("app", phase_app, torch, repo, setup, workdir)
        instr = timed("app with profile_steps and log_resources", phase_app_instruments,
                      torch, repo, setup, workdir)
    with tempfile.TemporaryDirectory(dir=repo, prefix=".chip_smoke_") as workdir:
        f32pre = timed("f32_pretrain", phase_f32_pretrain, torch, repo, workdir)
    with tempfile.TemporaryDirectory(dir=repo, prefix=".chip_smoke_") as workdir:
        tiny32 = timed("tiny_f32", phase_tiny_f32, torch, repo, workdir)
    with tempfile.TemporaryDirectory(dir=repo, prefix=".chip_smoke_") as workdir:
        giants32 = timed("f32_giants", phase_f32_giants, torch, repo, workdir)
    with cut_depth("vit_large", DIST_DEPTH):
        dist_setup = train_setup(repo, pred_depth=DIST_PRED_DEPTH)
        dist = timed("dist", phase_dist, torch, repo, dist_setup, card)
    # vit_tiny: its serving, updates and app, through the head-major kernels
    with tempfile.TemporaryDirectory(dir=repo, prefix=".chip_smoke_") as workdir:
        tiny_serve = timed("tiny_serve", phase_serve, torch, workdir, "vit_tiny")
        tiny_train = timed("tiny_train", phase_train, torch, tiny, determinism=True)
        tiny_app = timed("tiny_app", phase_app, torch, repo, tiny, workdir)
    # at VITL_CUT_DEPTH of ViT-L's blocks: the tube mask mode at vitl16.yaml
    # (updates, one B=2 update against the plain versions, the app fixed and
    # padded), then remat
    with cut_depth("vit_large", VITL_CUT_DEPTH):
        tube = train_setup(repo, tube=TUBE_MASKS)
        tube_train = timed("tube_train", phase_train, torch, tube, steps=3, b2=(False,),
                           profile=False)
        with tempfile.TemporaryDirectory(dir=repo, prefix=".chip_smoke_") as workdir:
            tube_app = timed("tube_app", phase_app, torch, repo, tube, workdir, epochs=1,
                             resume=False)
        remat = timed("remat", phase_remat, torch, repo)
    # ViT-H: its kernel instances at their full shapes, then at VITH_CUT_DEPTH
    # blocks vith16.yaml and vith16_384.yaml with the app's default remat
    # ('attn') through build_train_step and the app, and the K400 16x8x3
    # evals of both in bf16 and fp32
    with cut_depth("vit_huge", VITH_CUT_DEPTH):
        vith = train_setup(repo, config="vith16.yaml", remat="attn")
        vith384 = train_setup(repo, config="vith16_384.yaml", remat="attn")
        vk = timed("vk", phase_vith_kernels, torch, (vith, vith384))
        for key, row in (("h1_c32", bwd["h1_c32"]), ("dkv_c32", bwd["dkv"]), ("dq_c32", bwd["dq"]),
                         ("h1_c80", vk["h1_c80"]), ("dkv_c80", vk["dkv_c80"]),
                         ("dq_c80", vk["dq_c80"]),
                         ("h1_f32_c80", f32["by_shape"][F32_H1_SHAPES[1]]),
                         ("h3_f32_k1280", f32["by_shape"][F32_H3_SHAPES[1]])):
            row["max_abs_err"] = max(row["max_abs_err"], vk["held"][key])
        vith_train = timed("vith_train", phase_train, torch, vith, b2=(), profile=False)
        vith384_train = timed("vith384_train", phase_train, torch, vith384, b2=(),
                              profile=False)
        evh = {}
        with tempfile.TemporaryDirectory(dir=repo, prefix=".chip_smoke_") as workdir:
            vith_app = timed("vith_app", phase_app, torch, repo, vith, workdir, ipe=2, epochs=1,
                             resume=False)
            vith384_app = timed("vith384_app", phase_app, torch, repo, vith384, workdir, ipe=2,
                                epochs=1, resume=False, padded=False)
            enc_h = write_seeded_encoder(torch, workdir, "vit_huge")
            for config in VITH_EVALS:
                for bf16 in (True, False):
                    evh[config, bf16] = timed(
                        f"{config} {'bf16' if bf16 else 'fp32'}", phase_eval_video,
                        torch, repo, workdir, enc_h, bf16, config=config,
                        entries=VITH_EVAL_ENTRIES if bf16 else EVAL_F32_ENTRIES, resume=False,
                        views_checked=VITH_VIEWS_CHECKED)
            os.remove(enc_h)
    # vit_giant and vit_gigantic: their kernel instances at full shapes; at
    # GIANT_CUT_DEPTH blocks serving, updates at the config's batch, the K400
    # 16x8x3 evals in bf16 and fp32 and vit_giant's app (fixed, padded)
    gsetups = {}
    for m, p in GIANTS:
        with cut_depth(m, GIANT_CUT_DEPTH):
            gsetups[m] = train_setup(repo, model_name=m, remat="attn", patch_size=p)
    gk = timed("giant kernels", phase_giant_kernels, torch, tuple(gsetups.values()))
    for key in ("h1_c32", "dkv_c32", "dq_c32"):  # the predictors' c=24->32
        row = {"h1_c32": bwd["h1_c32"], "dkv_c32": bwd["dkv"], "dq_c32": bwd["dq"]}[key]
        row["max_abs_err"] = max(row["max_abs_err"], gk["held"][key])
    gruns = {}
    for m, p in GIANTS:
        r = gruns[m] = {}
        with (tempfile.TemporaryDirectory(dir=repo, prefix=".chip_smoke_") as workdir,
              cut_depth(m, GIANT_CUT_DEPTH)):
            r["serve"] = timed(f"{m} serve", phase_serve, torch, workdir, m)
            r["train"] = timed(f"{m} train", phase_train, torch, gsetups[m],
                               b2=(False,) if m == "vit_giant" else (), profile=False)
            os.remove(r["serve"]["enc_path"])
            enc_path = write_seeded_encoder(torch, workdir, m)
            for bf16 in (True, False):
                r[bf16] = timed(f"{m} eval {'bf16' if bf16 else 'fp32'}", phase_eval_video,
                                torch, repo, workdir, enc_path, bf16,
                                entries=VITH_EVAL_ENTRIES if bf16 else EVAL_F32_ENTRIES,
                                resume=False, views_checked=VITH_VIEWS_CHECKED,
                                model_name=m, patch_size=p)
            os.remove(enc_path)
            if m == "vit_giant":
                r["app"] = timed(f"{m} app", phase_app, torch, repo,
                                 train_setup(repo, model_name=m, remat="attn"), workdir,
                                 ipe=2, epochs=1, resume=False)
    # vit_small and vit_base: the c=16 instances, serving, updates, the app
    small = small_base_paths(torch, repo)
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
    # vit_giant (gl; its padded app gp, every trainable call key-masked) and
    # vit_gigantic (gg): serving, updates, evals and vit_giant's app
    runs = lambda m: [gruns[m][k]["launches"] for k in ("serve", "train", True, False)]
    gl = _sum_launches(*runs("vit_giant"), gruns["vit_giant"]["app"]["fixed"]["launches"])
    gp = gruns["vit_giant"]["app"]["padded"]["launches"]
    gg = _sum_launches(*runs("vit_gigantic"))
    fa_src, bwd_src = "jepa_tpu_torch/csrc/flash_attention.cu", "jepa_tpu_torch/csrc/flash_attention_bwd.cu"
    # the fp32 attention kernels (H1-fp32, H2-fp32, H4-H7-fp32), whose C
    # entries live in flash_attention.cu, flash_attention_bwd_f32.cu and
    # flash_attention_hm_f32.cu
    f32_attn_src = "jepa_tpu_torch/csrc/flash_f32.cuh"
    fa_py = "jepa_tpu/ops/flash_attention.py"
    # fp32 pretraining of ViT-H (vith16 whole, vith16_384 cut, vith16's app),
    # vit_giant and vit_gigantic (cut): by model, fixed (gx) and padded (gp32)
    g32runs, g32app = giants32["runs"], giants32["app"]
    gx, gp32 = {}, {}
    for name in ("vit_huge", "vit_giant", "vit_gigantic"):
        runs = [r for (_, n), r in g32runs.items() if n == name] + (
            [g32app] if name == "vit_huge" else [])
        for out, mode in ((gx, "fixed"), (gp32, "padded")):
            out[name] = _sum_launches(*(r[mode]["launches"] for r in runs))
    g32 = {name: _sum_launches(gx[name], gp32[name]) for name in gx}  # both modes
    g32x, g32p = _sum_launches(*gx.values()), _sum_launches(*gp32.values())
    # ViT-L's fp32 pretraining: the fixed mode's updates and app (fx), the
    # padded mode's (fp; every trainable call key-masked); the predictors'
    # c=24->32 instances also in every fp32 run of ViT-H and the giants
    f32runs, f32app = f32pre["runs"], f32pre["app"]
    c32 = lambda d: {k: v for k, v in d.items() if "_c32" in k}  # noqa: E731
    fx = _sum_launches(f32runs["fixed"]["launches"], f32app["fixed"]["launches"], c32(g32x))
    fp = _sum_launches(f32runs["padded"]["launches"], f32app["padded"]["launches"], c32(g32p))
    kernels = [
        # the padded apps' unmasked launches: their target forwards (H1, H3)
        kernel_entry("flash_self_attention_fwd", fa_src, f"{fa_py}:955",
                     sl["h1"] + tl["h1_c64"] + el["h1_c64"] + il["h1_c64"] + al["h1_c64"],
                     kern["h1"]),
        # ViT-L's updates and ViT-H's predictors (c=32)
        kernel_entry("flash_self_attention_fwd_c32", fa_src, f"{fa_py}:955",
                     tl["h1_c32"] + vl["h1_c32"] + gl["h1_c32"] + gg["h1_c32"], bwd["h1_c32"]),
        kernel_entry("flash_bwd_dkv", bwd_src, f"{fa_py}:1452",
                     tl["dkv"] + vl["dkv_c32"] + gl["dkv_c32"] + gg["dkv_c32"], bwd["dkv"]),
        kernel_entry("flash_bwd_dq", bwd_src, f"{fa_py}:1400",
                     tl["dq"] + vl["dq_c32"] + gl["dq_c32"] + gg["dq_c32"], bwd["dq"]),
        kernel_entry("linear_gelu_fwd", "jepa_tpu_torch/csrc/fused_mlp.cu",
                     "jepa_tpu/ops/fused_mlp.py:92",
                     sl["h3"] + tl["h3"] + el["h3"] + il["h3"] + al["h3"], kern["h3"]),
        # the fp32 instances: the fp32 video eval's launches
        kernel_entry("flash_self_attention_fwd_f32", f32_attn_src, f"{fa_py}:955",
                     fl["h1_f32"] + fx["h1_f32"] + fp["h1_f32"], f32["h1"]),
        kernel_entry("linear_gelu_fwd_f32", "jepa_tpu_torch/csrc/fused_mlp.cu",
                     "jepa_tpu/ops/fused_mlp.py:92", fl["h3_f32"] + fx["h3_f32"] + fp["h3_f32"],
                     f32["h3"]),
        # the key-masked instances: the padded-mode apps' launches (ViT-L;
        # ViT-H's predictors at c=32)
        kernel_entry("flash_self_attention_fwd_masked", fa_src, f"{fa_py}:955",
                     al["h1_c64_masked"], masked["h1_c64"]),
        kernel_entry("flash_self_attention_fwd_masked_c32", fa_src, f"{fa_py}:955",
                     al["h1_c32_masked"] + vp["h1_c32_masked"] + gp["h1_c32_masked"],
                     masked["h1_c32"]),
        kernel_entry("flash_bwd_dkv_masked", bwd_src, f"{fa_py}:1452",
                     al["dkv_masked"] + vp["dkv_c32"] + gp["dkv_c32"], masked["dkv"]),
        kernel_entry("flash_bwd_dq_masked", bwd_src, f"{fa_py}:1400",
                     al["dq_masked"] + vp["dq_c32"] + gp["dq_c32"], masked["dq"]),
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
                     tiny_runs("hm_fwd_c64") - tp["hm_fwd_c64_masked"], hm["fwd"]),
        kernel_entry("flash_attention_hm_fwd_masked", hm_src, f"{fa_py}:122",
                     tp["hm_fwd_c64_masked"], hm["fwd_masked"]),
        kernel_entry("flash_attention_hm_bwd_dq", hm_src, f"{fa_py}:225",
                     hm["split_launches"]["dq"], hm["dq"]),
        kernel_entry("flash_attention_hm_bwd_dq_masked", hm_src, f"{fa_py}:225",
                     hm["split_masked_launches"]["dq"], hm["dq_masked"]),
        kernel_entry("flash_attention_hm_bwd_dkv", hm_src, f"{fa_py}:254",
                     hm["split_launches"]["dkv"], hm["dkv"]),
        kernel_entry("flash_attention_hm_bwd_merged", hm_src, f"{fa_py}:318",
                     tiny_runs("hm_dqkv_c64") - tp["hm_dqkv_c64_masked"], hm["dqkv"]),
        kernel_entry("flash_attention_hm_bwd_merged_masked", hm_src, f"{fa_py}:318",
                     tp["hm_dqkv_c64_masked"], hm["dqkv_masked"]),
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
        kernel_entry("flash_self_attention_fwd_f32_c80", f32_attn_src, f"{fa_py}:955",
                     vl["h1_f32_c80"] + g32x["h1_f32_c80"], f32["by_shape"][F32_H1_SHAPES[1]]),
        kernel_entry("linear_gelu_fwd_f32_k1280", fc1_src, "jepa_tpu/ops/fused_mlp.py:92",
                     sum(e["launches"]["h3_f32"] for e in evh.values())
                     + g32["vit_huge"]["h3_f32"], f32["by_shape"][F32_H3_SHAPES[1]]),
    ]
    # vit_giant's instances (c=88->96, K=1408) and vit_gigantic's (c=104->128,
    # K=1664): by the JAX pickers K1 for every forward (N = 1568, 2048) and K3
    # for every trainable call, whose H2 pair is listed under K5 / K4 as above
    kernels += [
        kernel_entry("flash_self_attention_fwd_c96", fa_src, f"{fa_py}:955",
                     gl["h1_c96"] + gp["h1_c96"], gk["h1_c96"]),
        kernel_entry("flash_self_attention_fwd_masked_c96", fa_src, f"{fa_py}:955",
                     gp["h1_c96_masked"], gk["h1_c96_masked"]),
        kernel_entry("flash_bwd_dkv_c96", bwd_src, f"{fa_py}:1452", gl["dkv_c96"],
                     gk["dkv_c96"]),
        kernel_entry("flash_bwd_dq_c96", bwd_src, f"{fa_py}:1400", gl["dq_c96"], gk["dq_c96"]),
        kernel_entry("flash_bwd_dkv_masked_c96", bwd_src, f"{fa_py}:1452", gp["dkv_c96"],
                     gk["dkv_c96_masked"]),
        kernel_entry("flash_bwd_dq_masked_c96", bwd_src, f"{fa_py}:1400", gp["dq_c96"],
                     gk["dq_c96_masked"]),
        kernel_entry("flash_self_attention_fwd_f32_c96", f32_attn_src, f"{fa_py}:955",
                     gl["h1_f32_c96"] + g32x["h1_f32_c96"], gk["h1_f32_c96"]),
        kernel_entry("flash_self_attention_fwd_f32_c128", f32_attn_src, f"{fa_py}:955",
                     gg["h1_f32_c128"] + gx["vit_gigantic"]["h1_f32_c128"], gk["h1_f32_c128"]),
        kernel_entry("flash_self_attention_fwd_c128_n2048", fa_src, f"{fa_py}:955",
                     gg["h1_c128"], gk["h1_c128_vit_gigantic"]),
        kernel_entry("flash_bwd_dkv_c128_gigantic", bwd_src, f"{fa_py}:1452", gg["dkv_c128"],
                     gk["dkv_c128_vit_gigantic"]),
        kernel_entry("flash_bwd_dq_c128_gigantic", bwd_src, f"{fa_py}:1400", gg["dq_c128"],
                     gk["dq_c128_vit_gigantic"]),
        kernel_entry("linear_gelu_fwd_k1408", fc1_src, "jepa_tpu/ops/fused_mlp.py:92",
                     gl["h3"] + gp["h3"], gk["h3_k1408"]),
        kernel_entry("linear_gelu_fwd_k1664", fc1_src, "jepa_tpu/ops/fused_mlp.py:92", gg["h3"],
                     gk["h3_k1664"]),
        kernel_entry("linear_gelu_fwd_f32_k1408", fc1_src, "jepa_tpu/ops/fused_mlp.py:92",
                     gl["h3_f32"] + g32["vit_giant"]["h3_f32"], gk["h3_f32_k1408"]),
        kernel_entry("linear_gelu_fwd_f32_k1664", fc1_src, "jepa_tpu/ops/fused_mlp.py:92",
                     gg["h3_f32"] + g32["vit_gigantic"]["h3_f32"], gk["h3_f32_k1664"]),
    ]
    # H1-fp32 at c=32 and masked, H2-fp32 (fp32 pretraining): each entry
    # reports its first row (the fixed-mode update's shape; masked: the same
    # shape with pads), max_abs_err over every row of its instance
    def f32_entry(name, src, replaces, launches, kind, c_real, masked, rows=f32pre["rows"]):
        rs = [r[kind] for r in rows.values()
              if r[kind]["shape"][3] == c_real and r[kind]["masked"] == masked]
        return kernel_entry(name, src, replaces, launches,
                            dict(rs[0], max_abs_err=max(x["max_abs_err"] for x in rs)))

    kernels += [
        f32_entry("flash_self_attention_fwd_f32_c32", f32_attn_src, f"{fa_py}:955",
                  fx["h1_f32_c32"], "h1", 24, False),
        f32_entry("flash_self_attention_fwd_f32_masked", f32_attn_src, f"{fa_py}:955",
                  fp["h1_f32_c64_masked"], "h1", 64, True),
        f32_entry("flash_self_attention_fwd_f32_masked_c32", f32_attn_src, f"{fa_py}:955",
                  fp["h1_f32_c32_masked"], "h1", 24, True),
    ]
    for c, c_real in ((32, 24), (64, 64)):  # ViT-L's instances; c=128 below (vit_tiny's)
        sfx = "" if c == 64 else f"_c{c}"
        for kind, line in (("dkv", 1452), ("dq", 1400)):
            kernels += [
                f32_entry(f"flash_bwd_{kind}_f32{sfx}", f32_attn_src, f"{fa_py}:{line}",
                          fx[f"{kind}_f32_c{c}"], kind, c_real, False),
                f32_entry(f"flash_bwd_{kind}_f32_masked{sfx}", f32_attn_src, f"{fa_py}:{line}",
                          fp[f"{kind}_f32_c{c}_masked"], kind, c_real, True)]
    # ViT-H's (c=80) and vit_giant's (c=88->96) fp32 instances: H2-fp32, and
    # H1-fp32 with a key mask (its unmasked instances are listed above)
    g32rows = giants32["rows"]
    for c, c_real in ((80, 80), (96, 88)):
        kernels.append(f32_entry(f"flash_self_attention_fwd_f32_masked_c{c}", f32_attn_src,
                                 f"{fa_py}:955", g32p[f"h1_f32_c{c}_masked"], "h1", c_real, True,
                                 g32rows))
        for kind, line in (("dkv", 1452), ("dq", 1400)):
            for masked, runs in ((False, g32x), (True, g32p)):
                sfx = "_masked" if masked else ""
                kernels.append(f32_entry(
                    f"flash_bwd_{kind}_f32{sfx}_c{c}", f32_attn_src, f"{fa_py}:{line}",
                    runs[f"{kind}_f32_c{c}{sfx}"], kind, c_real, masked, g32rows))
    # vit_tiny in fp32: H4-H7-fp32 (c=64 encoder, c=32 the 96-wide
    # predictor) and H1-fp32 / H2-fp32 at c=128 (the 384-wide predictor):
    # serving, the fp32 eval, the updates (fixed, padded, 96-wide) and the
    # app; H5-fp32 / H6-fp32 through flash_attention_packed under autograd
    tr, ta = tiny32["rows"], tiny32["app"]
    t32 = _sum_launches(tiny32["serve"]["launches"], tiny32["eval"]["launches"],
                        *(r["launches"] for r in tiny32["runs"].values()),
                        ta["fixed"]["launches"], ta["padded"]["launches"],
                        {k: v for k, v in g32["vit_gigantic"].items()
                         if k.startswith(("dkv_f32_c128", "dq_f32_c128", "h1_f32_c128_masked"))})
    sp, spm = tiny32["split"][False], tiny32["split"][True]
    tiny_f32 = [
        ("flash_attention_hm_fwd_f32", 122,
         t32["hm_f32_fwd_c64"] - t32["hm_f32_fwd_c64_masked"], "hm_fwd_c64"),
        ("flash_attention_hm_fwd_f32_masked", 122, t32["hm_f32_fwd_c64_masked"],
         "hm_fwd_c64_masked"),
        ("flash_attention_hm_fwd_f32_c32", 122,
         t32["hm_f32_fwd_c32"] - t32["hm_f32_fwd_c32_masked"], "hm_fwd_c32"),
        ("flash_attention_hm_bwd_merged_f32", 318,
         t32["hm_f32_dqkv_c64"] - t32["hm_f32_dqkv_c64_masked"], "hm_dqkv_c64"),
        ("flash_attention_hm_bwd_merged_f32_masked", 318,
         t32["hm_f32_dqkv_c64_masked"], "hm_dqkv_c64_masked"),
        ("flash_attention_hm_bwd_merged_f32_c32", 318,
         t32["hm_f32_dqkv_c32"] - t32["hm_f32_dqkv_c32_masked"], "hm_dqkv_c32"),
        ("flash_attention_hm_bwd_dq_f32", 225, sp["dq"], "hm_dq_c64"),
        ("flash_attention_hm_bwd_dq_f32_masked", 225, spm["dq"], "hm_dq_c64_masked"),
        ("flash_attention_hm_bwd_dkv_f32", 254, sp["dkv"], "hm_dkv_c64"),
        ("flash_attention_hm_bwd_dkv_f32_masked", 254, spm["dkv"],
         "hm_dkv_c64_masked"),
        ("flash_self_attention_fwd_f32_c128_predictor", 955, t32["h1_f32_c128"],
         "h1_c128"),
        ("flash_self_attention_fwd_f32_masked_c128", 955, t32["h1_f32_c128_masked"],
         "h1_c128_masked"),
        ("flash_bwd_dkv_f32_c128", 1452, t32["dkv_f32_c128"], "dkv_c128"),
        ("flash_bwd_dq_f32_c128", 1400, t32["dq_f32_c128"], "dq_c128"),
        ("flash_bwd_dkv_f32_masked_c128", 1452, t32["dkv_f32_c128_masked"],
         "dkv_c128_masked"),
        ("flash_bwd_dq_f32_masked_c128", 1400, t32["dq_f32_c128_masked"],
         "dq_c128_masked"),
    ]
    for name, line, launches, key in tiny_f32:
        if launches < 1:
            raise RuntimeError(f"{name}: no launch on vit_tiny's fp32 path")
        kernels.append(kernel_entry(name, f32_attn_src, f"{fa_py}:{line}", launches, tr[key]))
    # the 96-wide predictor's masked instances, launched as the padded mode's
    # seeded masks pick its rungs (merged up to 1300 tokens, split past)
    for name, line, kind in (("flash_attention_hm_fwd_f32_masked_c32", 122, "fwd"),
                             ("flash_attention_hm_bwd_merged_f32_masked_c32", 318, "dqkv"),
                             ("flash_attention_hm_bwd_dq_f32_masked_c32", 225, "dq"),
                             ("flash_attention_hm_bwd_dkv_f32_masked_c32", 254, "dkv")):
        launches = t32[f"hm_f32_{kind}_c32_masked"]
        if launches:
            kernels.append(kernel_entry(name, f32_attn_src, f"{fa_py}:{line}", launches,
                                        tr[f"hm_{kind}_c32_masked"]))
    for key, r in tr.items():
        if "ms" not in r:
            log(f"{key}: held against its plain version, max|d| {r['max_abs_err']:.3e} "
                "(no launch on the driven path: not in the JSON line)")
    # vit_small's 96-wide predictor (6 heads of 16): H4-H7 and H4-H7-fp32 at
    # c=16, launched by its updates (fixed: H4 + H7; padded: masked, the last
    # update's top rung H5 + H6)
    for dt, src in (("bfloat16", hm_src), ("float32", f32_attn_src)):
        sf = "_f32" if dt == "float32" else ""
        runs = small["runs"]["vit_small 96" + (" fp32" if sf else "")]
        x, p = runs["fixed"]["launches"], runs["padded"]["launches"]
        rows = small["c16"][dt]
        for name, line, kind, masked in (("fwd", 122, "fwd", False), ("fwd", 122, "fwd", True),
                                         ("bwd_merged", 318, "dqkv", False),
                                         ("bwd_merged", 318, "dqkv", True),
                                         ("bwd_dq", 225, "dq", True),
                                         ("bwd_dkv", 254, "dkv", True)):
            key = f"hm{sf}_{kind}_c16"
            n = p[key + "_masked"] if masked else x[key] + p[key] - p[key + "_masked"]
            entry = f"flash_attention_hm_{name}{sf}{'_masked' if masked else ''}_c16"
            if n < 1:
                raise RuntimeError(f"{entry}: no launch on vit_small's path")
            kernels.append(kernel_entry(entry, src, f"{fa_py}:{line}", n,
                                        rows[f"hm_{kind}_c16{'_masked' if masked else ''}"]))
        for key, r in rows.items():
            if "ms" in r and not r["per_update"]:
                log(f"{key} ({dt}): held and timed, no launch on the driven path (not in the "
                    f"JSON line): max|d| {r['max_abs_err']:.3e}")
    for label, modes in small["runs"].items():
        for mode, t in modes.items():
            log(f"card: {card}; {label} update (vitl16.yaml, {mode} masks, B={t['batch']}): "
                f"median {t['median_ms']:.1f} ms/update, peak {t['peak_gib']:.2f} GiB, "
                f"{device_split(t)}; launches/update {t['per_step']}"
                + (f"; B=2 seeded loss rel {t['b2']['loss']['rel']:.2e}" if "b2" in t else ""))
    for model in ("vit_small", "vit_base"):
        r = small[model, "serve"]
        log(f"card: {card}; {model} serve median {r['median_ms']:.3f} ms/request (B=2), peak "
            f"{r['peak_gib']:.3f} GiB, features vs plain min cosine {r['feat_cos']:.7f}")
    for mode, a in small["app"].items():
        log(f"card: {card}; vit_base app (no model_name) {mode} (B={TRAIN_BATCH}): median step "
            f"{a['step_ms']:.0f} ms, wall {a['wall_ms']:.0f} ms, host share "
            f"{100 * a['host']:.1f} %, peak {a['peak_gib']:.2f} GiB")
    for mode, t in tiny32["runs"].items():
        pred = "the 2 x 96 predictor" if mode.startswith("narrow") else "the 12 x 384 predictor"
        log(f"card: {card}; vit_tiny fp32 update (vitl16.yaml, meta.dtype float32, "
            f"{t['mode']} masks, {pred}, "
            f"B={t['batch']}, remat 'attn'): median {t['median_ms']:.1f} ms/update, peak "
            f"{t['peak_gib']:.2f} GiB, {device_split(t)}; launches/update {t['per_step']}"
            + (f"; B=2 seeded loss rel {t['b2']['loss']['rel']:.2e}" if "b2" in t else ""))
    for mode in ("fixed", "padded"):
        a = ta[mode]
        log(f"card: {card}; vit_tiny fp32 app {mode}: median step {a['step_ms']:.0f} ms, wall "
            f"{a['wall_ms']:.0f} ms, host share {100 * a['host']:.1f} %, peak "
            f"{a['peak_gib']:.2f} GiB")
    e = tiny32["eval"]
    log(f"card: {card}; vit_tiny fp32 serve median {tiny32['serve']['median_ms']:.3f} ms/request "
        f"(B=2), peak {tiny32['serve']['peak_gib']:.3f} GiB; K400 16x8x3 eval fp32, batch 1: "
        f"median train step {e['train_ms']:.1f} ms, val step {e['val_ms']:.1f} ms, peak "
        f"{e['peak_gib']:.2f} GiB; features vs plain min cosine {min(e['feat_cos'].values()):.7f}")
    for mode in ("fixed", "padded"):
        t, a = f32runs[mode], f32app[mode]
        log(f"card: {card}; fp32 update (vitl16.yaml, meta.dtype float32, {mode} masks, "
            f"B={t['batch']}, remat 'attn'): median {t['median_ms']:.1f} ms/update, peak "
            f"{t['peak_gib']:.2f} GiB, {device_split(t)}; launches/update {t['per_step']}; "
            f"B=2 seeded loss rel {t['b2']['loss']['rel']:.2e}; app ({VITL_CUT_DEPTH} blocks) "
            f"{mode}: median step "
            f"{a['step_ms']:.0f} ms, wall {a['wall_ms']:.0f} ms, host share "
            f"{100 * a['host']:.1f} %, peak {a['peak_gib']:.2f} GiB")
    for (config, name), modes in g32runs.items():
        for mode, t in modes.items():
            depth = "" if config == "vith16.yaml" else f", {t['depth']} blocks"
            log(f"card: {card}; fp32 update ({config}, {name}{depth}, meta.dtype float32, "
                f"{mode} masks, B={t['batch']}, remat 'attn'): median {t['median_ms']:.1f} "
                f"ms/update, peak {t['peak_gib']:.2f} GiB, {device_split(t)}; "
                f"launches/update {t['per_step']}"
                + (f"; B=2 seeded loss rel {t['b2']['loss']['rel']:.2e}" if "b2" in t else ""))
    for mode, a in g32app.items():
        log(f"card: {card}; vith16 fp32 app ({VITH_CUT_DEPTH} blocks) {mode}: median step "
            f"{a['step_ms']:.0f} ms, wall {a['wall_ms']:.0f} ms, host share "
            f"{100 * a['host']:.1f} %, peak {a['peak_gib']:.2f} GiB")
    for m, _ in GIANTS:
        r = gruns[m]
        t = r["train"]
        log(f"card: {card}; {m} ({GIANT_CUT_DEPTH} blocks) serve median "
            f"{r['serve']['median_ms']:.3f} ms/request (B=2), "
            f"peak {r['serve']['peak_gib']:.3f} GiB; update (vitl16.yaml, B={t['batch']}, remat "
            f"'attn'): median {t['median_ms']:.1f} ms/update, peak "
            f"{t['peak_gib']:.2f} GiB, {device_split(t)}; launches/update {t['per_step']}")
        for bf16 in (True, False):
            e = r[bf16]
            log(f"card: {card}; {m} ({GIANT_CUT_DEPTH} blocks) K400 16x8x3 eval "
                f"{'bf16, batch 4' if bf16 else 'fp32, batch 1'}"
                f": median train step {e['train_ms']:.1f} ms, val step {e['val_ms']:.1f} ms, peak "
                f"{e['peak_gib']:.2f} GiB; features vs plain min cosine "
                f"{min(e['feat_cos'].values()):.7f}")
        for mode, a in r.get("app", {}).items():
            log(f"card: {card}; {m} ({GIANT_CUT_DEPTH} blocks) app {mode}: median step "
                f"{a['step_ms']:.0f} ms, wall "
                f"{a['wall_ms']:.0f} ms, host share {100 * a['host']:.1f} %, peak "
                f"{a['peak_gib']:.2f} GiB")
    for name, r in ((f"tube (vitl16.yaml, ratio 0.9, {VITL_CUT_DEPTH} blocks)", tube_train),
                    (f"vith16.yaml ({VITH_CUT_DEPTH} blocks), remat 'attn'", vith_train),
                    (f"vith16_384.yaml ({VITH_CUT_DEPTH} blocks), remat 'attn'", vith384_train)):
        log(f"card: {card}; {name} update: median {r['median_ms']:.1f} ms/update, peak "
            f"{r['peak_gib']:.2f} GiB, {device_split(r)}; launches/update {r['per_step']}")
    for name, a in ((f"tube ({VITL_CUT_DEPTH} blocks)", tube_app),
                    (f"vith16 ({VITH_CUT_DEPTH} blocks)", vith_app),
                    (f"vith16_384 ({VITH_CUT_DEPTH} blocks)", vith384_app)):
        for mode, m in a.items():
            log(f"card: {card}; {name} app {mode}: median step {m['step_ms']:.0f} ms, wall "
                f"{m['wall_ms']:.0f} ms, host share {100 * m['host']:.1f} %, peak "
                f"{m['peak_gib']:.2f} GiB")
    for r, m in remat.items():
        log(f"card: {card}; ViT-L update ({VITL_CUT_DEPTH} blocks) remat {r!r} "
            f"(B={TRAIN_BATCH}, in turns): median "
            f"{m['median_ms']:.1f} ms, peak {m['peak_gib']:.2f} GiB, bit-equal to remat False")
    for (config, bf16), e in evh.items():
        log(f"card: {card}; {config} eval ({VITH_CUT_DEPTH} blocks) "
            f"{'bf16, batch 4' if bf16 else 'fp32, batch 1'}: "
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
        f"{train['prof']['groups']['H3/H8 linear_gelu']:.1f}); force {device_split(train_force)}")
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
        f"{train['median_ms']:.1f} ms), peak {diff['peak_gib']:.2f} GiB, {device_split(diff)}; "
        f"launches/update {diff['per_step']}")
    for (frames, px), r in ((k, v) for k, v in off.items() if k != "launches"):
        log(f"card: {card}; serve off-size {frames} frames x {px} px (N={r['n']}, B=2): "
            f"median {r['median_ms']:.3f} ms/request (on-size {serve['median_ms']:.3f})")
    for mode in ("processes", "threads"):
        r = img_eval[mode]
        log(f"card: {card}; image eval through evals.main with {IMAGE_EVAL_WORKERS} {mode} "
            f"(nproc {os.cpu_count()}): median train step {r['train_ms']:.1f} ms, host share "
            f"{_fmt_host(r['host'])}, val step {r['val_ms']:.1f} ms, {r['secs']:.1f} s")
    log(f"smoke: {time.perf_counter() - T0:.1f} s from the start of main")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
