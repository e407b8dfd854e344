"""V-JEPA pretraining application (counterpart of
jepa_tpu/apps/vjepa/train.py; reference app/vjepa/train.py:66-586).

    from jepa_tpu_torch.apps.vjepa.train import main
    state = main(load_config("configs/pretrain/vitl16.yaml"))   # device="cuda"

It reads the reference's YAML schema key by key, as the JAX app does, and
runs single-process (rank 0 of 1) on one device: the card unless the caller
asks for the CPU; a missing GPU raises. Per step: the host loader's uint8
clips go to the device, are augmented there (``data.transforms``) with a
generator seeded from (seed + 11, step), and feed one
``train.step.build_train_step`` update; in padded mode the host
``MaskCollator`` draws the reference-distribution masks, padded to the
per-spec cap ladders. ``data.mask_type: random_tube`` takes tube masks
(``mask`` entries ``{ratio: ...}``): the fixed mode becomes the step's
``tube`` mode, and the padded mode pads ``TubeMaskCollator``'s masks to
one tier of ``static_cap`` caps. Every epoch writes
``<tag>-latest.pth.tar`` in the reference's layout and a restart resumes
from it (the collator continues at ``start_epoch * ipe``). The CSV has
the JAX app's columns.

Activation checkpointing, as the JAX app reads it: ``meta.remat`` sets
the encoder's (default ``'attn'``: the flash forward's (o, lse), the qkv
projection and the fc1 pre-activation are kept, the rest of each block
is recomputed in the backward; ``true``/``'full'``: every block is
recomputed; ``false``: none), ``meta.pred_remat`` the predictor's
(default ``'attn'`` when ``meta.remat`` is truthy, else off).

Accepted and logged, with no effect here: ``meta.unroll_blocks`` (torch
modules are per-layer). Logged as not ported: ``logging.profile_steps``,
``log_resources``, and ``meta.export_torch_checkpoint`` (the checkpoint
already is a .pth.tar).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from jepa_tpu_torch.api import _resolve_device
from jepa_tpu_torch.configs import dump_config
from jepa_tpu_torch.data.loader import make_video_loader
from jepa_tpu_torch.data.transforms import AugmentCfg, pretrain_augment
from jepa_tpu_torch.masks.multiblock3d import (
    MaskCollator,
    MaskGrid,
    MaskSpec,
    calibrate_keep_counts,
    calibrate_pad_ladders,
    calibrate_pad_tiers,
    select_pad_rungs,
    select_pad_tier,
)
from jepa_tpu_torch.masks.padding import pad_masks, static_cap
from jepa_tpu_torch.masks.random_tube import TubeMaskCollator, TubeSpec
from jepa_tpu_torch.masks.random_tube import keep_counts as tube_keep_counts
from jepa_tpu_torch.models.factory import predictor_cfg_for, vit_cfg
from jepa_tpu_torch.train.step import (
    TrainCfg,
    build_train_step,
    init_train_state,
    step_generator,
)
from jepa_tpu_torch.utils import checkpoint as ckpt_lib
from jepa_tpu_torch.utils.logging import AverageMeter, CSVLogger, get_logger, train_step_flops
from jepa_tpu_torch.utils.schedulers import build_schedules

LOG_FREQ = 10
CHECKPOINT_FREQ = 1
_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.bfloat16, "float32": torch.float32}


def main(args: dict, resume_preempt: bool = False, device="cuda"):
    # ---- config unpack (same keys as the reference) --------------------
    cfgs_meta = args.get("meta", {})
    load_model = bool(cfgs_meta.get("load_checkpoint")) or resume_preempt
    r_file = cfgs_meta.get("read_checkpoint", None)
    seed = int(cfgs_meta.get("seed", 0))
    save_every_freq = int(cfgs_meta.get("save_every_freq", -1))
    export_torch = bool(cfgs_meta.get("export_torch_checkpoint", False))
    compute_dtype = _DTYPES[str(cfgs_meta.get("dtype", "bfloat16")).lower()]
    mask_mode = cfgs_meta.get("mask_mode", "fixed")
    # encoder remat default 'attn'; the predictor's follows meta.remat
    # (jepa_tpu/apps/vjepa/train.py:147-165)
    remat = cfgs_meta.get("remat", "attn")
    pred_remat = cfgs_meta.get("pred_remat", "attn" if cfgs_meta.get("remat", True) else False)

    cfgs_mask = args.get("mask", [])

    cfgs_model = args.get("model", {})
    model_name = cfgs_model.get("model_name", "vit_base")
    pred_depth = int(cfgs_model.get("pred_depth", 6))
    pred_embed_dim = int(cfgs_model.get("pred_embed_dim", 384))
    uniform_power = bool(cfgs_model.get("uniform_power", True))
    use_mask_tokens = bool(cfgs_model.get("use_mask_tokens", True))
    zero_init_mask_tokens = bool(cfgs_model.get("zero_init_mask_tokens", True))

    cfgs_data = args.get("data", {})
    dataset_type = str(cfgs_data.get("dataset_type", "videodataset")).lower()
    dataset_paths = cfgs_data.get("datasets", [])
    datasets_weights = cfgs_data.get("datasets_weights", None)
    batch_size = int(cfgs_data.get("batch_size"))
    num_clips = int(cfgs_data.get("num_clips", 1))
    num_frames = int(cfgs_data.get("num_frames", 16))
    tubelet_size = int(cfgs_data.get("tubelet_size", 2))
    sampling_rate = int(cfgs_data.get("sampling_rate", 4))
    duration = cfgs_data.get("clip_duration", None)
    crop_size = int(cfgs_data.get("crop_size", 224))
    patch_size = int(cfgs_data.get("patch_size", 16))
    num_workers = int(cfgs_data.get("num_workers", 8))
    filter_short_videos = bool(cfgs_data.get("filter_short_videos", False))
    decode_backend = cfgs_data.get("decode_backend", "auto")

    cfgs_aug = args.get("data_aug", {})
    aug_cfg = AugmentCfg(
        crop_size=crop_size,
        random_resize_scale=tuple(cfgs_aug.get("random_resize_scale", (0.3, 1.0))),
        random_resize_aspect_ratio=tuple(cfgs_aug.get("random_resize_aspect_ratio", (0.75, 1.35))),
        motion_shift=bool(cfgs_aug.get("motion_shift", False)),
        reprob=float(cfgs_aug.get("reprob", 0.0)),
        auto_augment=(
            "rand-m7-n4-mstd0.5-inc1" if cfgs_aug.get("auto_augment", False) else None
        ),
    )

    cfgs_loss = args.get("loss", {})
    loss_exp = float(cfgs_loss.get("loss_exp", 1.0))
    reg_coeff = float(cfgs_loss.get("reg_coeff", 0.0))

    cfgs_opt = args.get("optimization", {})
    ipe = cfgs_opt.get("ipe", None)
    ipe_scale = float(cfgs_opt.get("ipe_scale", 1.0))
    clip_grad = cfgs_opt.get("clip_grad", None)
    wd = float(cfgs_opt.get("weight_decay"))
    final_wd = float(cfgs_opt.get("final_weight_decay"))
    num_epochs = int(cfgs_opt.get("epochs"))
    warmup = float(cfgs_opt.get("warmup"))
    start_lr = float(cfgs_opt.get("start_lr"))
    lr = float(cfgs_opt.get("lr"))
    final_lr = float(cfgs_opt.get("final_lr"))
    ema = cfgs_opt.get("ema", (0.998, 1.0))
    betas = tuple(cfgs_opt.get("betas", (0.9, 0.999)))
    eps = float(cfgs_opt.get("eps", 1e-8))

    cfgs_logging = args.get("logging", {})
    folder = cfgs_logging.get("folder", "./runs")
    tag = cfgs_logging.get("write_tag", "jepa")
    profile_steps = cfgs_logging.get("profile_steps", None)
    log_resources = bool(cfgs_data.get("log_resource_utilization", False)
                         or cfgs_logging.get("log_resources", False))

    # ---- runtime --------------------------------------------------------
    dev = _resolve_device(device)
    world_size, rank = 1, 0
    logger = get_logger(__name__, rank=rank)
    logger.info("initialized rank/world: %d/%d on %s", rank, world_size, dev)
    os.makedirs(folder, exist_ok=True)
    dump_config(args, os.path.join(folder, "params-pretrain.yaml"))
    if cfgs_meta.get("unroll_blocks") is not None:
        logger.info("meta.unroll_blocks=%s accepted: torch modules are per-layer",
                    cfgs_meta["unroll_blocks"])
    for key, on in (("logging.profile_steps", bool(profile_steps)),
                    ("log_resources", log_resources),
                    ("meta.export_torch_checkpoint", export_torch)):
        if on:
            logger.info("%s is not ported to jepa_tpu_torch; ignored", key)

    # ---- model ----------------------------------------------------------
    enc_cfg = vit_cfg(model_name, img_size=crop_size, patch_size=patch_size,
                      num_frames=num_frames, tubelet_size=tubelet_size,
                      uniform_power=uniform_power, compute_dtype=compute_dtype,
                      remat=remat)
    pred_cfg = predictor_cfg_for(enc_cfg, predictor_embed_dim=pred_embed_dim,
                                 depth=pred_depth, use_mask_tokens=use_mask_tokens,
                                 num_mask_tokens=len(cfgs_mask),
                                 zero_init_mask_tokens=zero_init_mask_tokens,
                                 remat=pred_remat)
    logger.info("activation checkpointing: encoder %r, predictor %r", remat, pred_remat)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = init_train_state(enc_cfg, pred_cfg, gen, device=dev)
    logger.info("encoder parameters: %d", sum(p.numel() for p in state.encoder.parameters()))
    logger.info("predictor parameters: %d", sum(p.numel() for p in state.predictor.parameters()))

    # ---- masks ----------------------------------------------------------
    grid = MaskGrid.from_data_cfg(crop_size, patch_size, num_frames, tubelet_size)
    mask_type = cfgs_data.get("mask_type", "multiblock3d")
    host_collator = pad_tiers = pad_ladders = None
    n_chunks = world_size  # one collate chunk per device
    if mask_type == "multiblock3d":
        specs = [MaskSpec.from_cfg(m) for m in cfgs_mask]
        # fixed-mode K at the reference's per-rank collator batch (its
        # batch-min truncation acts on the per-GPU batch)
        kc = [calibrate_keep_counts(s, grid, batch_size) for s in specs]
        if mask_mode == "padded":
            host_collator = MaskCollator(specs, grid, seed=seed)
            if cfgs_meta.get("pad_tier_scope", "spec") == "spec":
                pad_ladders = calibrate_pad_ladders(specs, grid, batch_size, n_chunks=n_chunks)
            else:
                pad_tiers = calibrate_pad_tiers(specs, grid, batch_size, n_chunks=n_chunks)
    elif mask_type == "random_tube":
        specs = [TubeSpec.from_cfg(m) for m in cfgs_mask]
        kc = [tube_keep_counts(s, grid) for s in specs]
        if mask_mode == "fixed":
            mask_mode = "tube"
        if mask_mode == "padded":
            host_collator = TubeMaskCollator(specs, grid, seed=seed)
            # exact-K masks: one tier, the caps rounded up to 128
            pad_tiers = [[(static_cap(grid.n, ke / grid.n), static_cap(grid.n, kp / grid.n))
                          for ke, kp in kc]]
    else:
        raise ValueError(f"unknown data.mask_type {mask_type!r}: 'multiblock3d' or "
                         "'random_tube'")
    logger.info("mask grid %s keep counts %s mode %s", (grid.t, grid.h, grid.w), kc, mask_mode)
    if mask_mode == "padded":
        logger.info("padded-mode cap %s: %s",
                    "ladders" if pad_ladders is not None else "tiers",
                    pad_ladders if pad_ladders is not None else pad_tiers)

    # ---- data -----------------------------------------------------------
    if dataset_type == "synthetic":
        # manifest-free mode: synthetic clip ids, rendered by the synthetic
        # decode backend
        n_fake = int(cfgs_data.get("num_synthetic_videos", 512))
        manifest = os.path.join(folder, f"synthetic_r{rank}.csv")
        with open(manifest, "w") as f:
            for i in range(n_fake):
                f.write(f"synthetic://video{i} 0\n")
        _, loader, sampler = make_video_loader(
            data_paths=[manifest], batch_size=batch_size, frames_per_clip=num_frames,
            frame_step=sampling_rate, num_clips=num_clips, decode_backend="synthetic",
            rank=rank, world_size=world_size, num_workers=num_workers, seed=seed)
    else:
        # one static frame shape for the batched augmentation: aspect-
        # preserving decode onto a letterbox canvas with a valid-size
        # sidecar, or a fixed (distorting) data.decode_size
        decode_short = int(cfgs_data.get("decode_short_side", int(crop_size * 256 / 224)))
        if cfgs_data.get("decode_size") is not None:
            geom = dict(decode_size=tuple(cfgs_data["decode_size"]))
        else:
            canvas = tuple(cfgs_data.get("decode_canvas", (2 * decode_short, 2 * decode_short)))
            geom = dict(decode_short_side=decode_short, decode_canvas=canvas)
        _, loader, sampler = make_video_loader(
            data_paths=dataset_paths, datasets_weights=datasets_weights,
            batch_size=batch_size, frames_per_clip=num_frames, frame_step=sampling_rate,
            num_clips=num_clips, duration=duration, filter_short_videos=filter_short_videos,
            filter_long_videos=int(cfgs_data.get("filter_long_videos", 1e9)),
            decode_backend=decode_backend, rank=rank, world_size=world_size,
            num_workers=num_workers, seed=seed, **geom)
    ipe = len(loader) if ipe is None else int(ipe)
    logger.info("iterations per epoch: %d (loader length %d)", ipe, len(loader))

    # ---- schedules + step -----------------------------------------------
    lr_sched, wd_sched, mom_sched = build_schedules(
        ipe=ipe, num_epochs=num_epochs, warmup_epochs=warmup, start_lr=start_lr,
        ref_lr=lr, final_lr=final_lr, wd=wd, final_wd=final_wd, ema=tuple(ema),
        ipe_scale=ipe_scale)
    train_cfg = TrainCfg(
        loss_exp=loss_exp, reg_coeff=reg_coeff,
        clip_grad=None if clip_grad is None else float(clip_grad),
        clip_after_step=int((warmup + 1) * ipe),  # reference: epoch > warmup
        betas=betas, eps=eps, num_clips=num_clips, mask_mode=mask_mode, seed=seed)
    step_fn = build_train_step(enc_cfg, pred_cfg, train_cfg, lr_sched, wd_sched,
                               mom_sched, specs, grid, kc)

    # ---- resume ----------------------------------------------------------
    start_epoch = 0
    if load_model or os.path.exists(ckpt_lib.checkpoint_path(folder, tag)):
        state, start_epoch = ckpt_lib.load_checkpoint(folder, tag, state, read_path=r_file)
        if host_collator is not None:
            host_collator.set_step(start_epoch * ipe)

    # ---- logging ---------------------------------------------------------
    csv_logger = CSVLogger(
        os.path.join(folder, f"{tag}_r{rank}.csv"),
        ("%d", "epoch"), ("%d", "itr"), ("%.5f", "loss"),
        ("%.5f", "loss-jepa"), ("%.5f", "reg-loss"),
        ("%.5f", "enc-grad-norm"), ("%.5f", "pred-grad-norm"),
        ("%d", "step-time(ms)"), ("%d", "wall-time(ms)"),
    )
    step_flops = train_step_flops(
        enc_dim=enc_cfg.embed_dim, enc_depth=enc_cfg.depth, enc_mlp=enc_cfg.mlp_ratio,
        pred_dim=pred_cfg.predictor_embed_dim, pred_depth=pred_cfg.depth,
        n_full=grid.n, ctx_lens=[k[0] for k in kc], tgt_lens=[k[1] for k in kc],
        batch=batch_size * num_clips, patch_dim=enc_cfg.patch_dim)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def device_batch(np_batch, step):
        clips = torch.from_numpy(np_batch["clips"]).to(dev)  # [nc*B, T, H, W, 3] uint8
        vhw = torch.from_numpy(np_batch["valid_hw"]).to(dev) if "valid_hw" in np_batch else None
        clips = pretrain_augment(step_generator(seed + 11, step, dev), clips, aug_cfg,
                                 valid_hw=vhw)
        batch = {"clips": clips.to(compute_dtype)}
        if mask_mode == "padded":
            me_list, mp_list = host_collator.collate_chunks(batch_size, n_chunks)
            if pad_ladders is not None:
                rungs = select_pad_rungs(pad_ladders, me_list, mp_list)
                tier = [pad_ladders[s][r] for s, r in enumerate(rungs)]
            else:
                tier = pad_tiers[select_pad_tier(pad_tiers, me_list, mp_list)]
            for key in ("masks_enc", "enc_weights", "masks_pred", "pred_weights"):
                batch[key] = []
            for (mes, mps), (ce, cp) in zip(zip(me_list, mp_list), tier):
                for masks, cap, (k_idx, k_w) in ((mes, ce, ("masks_enc", "enc_weights")),
                                                 (mps, cp, ("masks_pred", "pred_weights"))):
                    pads = [pad_masks(m, cap) for m in masks]
                    batch[k_idx].append(torch.from_numpy(np.concatenate([p[0] for p in pads])).to(dev))
                    batch[k_w].append(torch.from_numpy(np.concatenate([p[1] for p in pads])).to(dev))
        return batch

    # ---- loop ------------------------------------------------------------
    loader_iter = iter(loader)
    skip_batches = int(cfgs_meta.get("skip_batches", -1))
    if skip_batches > 0:
        logger.info("Skip %d batches", skip_batches)
        sampler.set_epoch(start_epoch)
        for itr in range(skip_batches):
            if itr % 10 == 0:
                logger.info("Skip %d/%d batches", itr, skip_batches)
            try:
                next(loader_iter)
            except StopIteration:
                loader_iter = iter(loader)
                next(loader_iter)
    for epoch in range(start_epoch, num_epochs):
        logger.info("Epoch %d", epoch + 1)
        sampler.set_epoch(epoch)
        meters = {k: AverageMeter() for k in ("loss", "jepa", "reg", "step_ms", "wall_ms",
                                              "ivar", "ivar_min")}
        for itr in range(ipe):
            t0 = time.time()
            try:
                np_batch = next(loader_iter)
            except StopIteration:
                logger.info("Exhausted data loaders. Refreshing...")
                loader_iter = iter(loader)
                np_batch = next(loader_iter)

            global_step = epoch * ipe + itr
            batch = device_batch(np_batch, global_step)
            sync()
            t1 = time.time()
            state, metrics = step_fn(state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            step_ms = (time.time() - t1) * 1000
            wall_ms = (time.time() - t0) * 1000

            loss = metrics["loss"]
            meters["loss"].update(loss)
            meters["jepa"].update(metrics["loss_jepa"])
            meters["reg"].update(metrics["loss_reg"])
            meters["step_ms"].update(step_ms)
            meters["wall_ms"].update(wall_ms)
            meters["ivar"].update(metrics["input_var"])
            meters["ivar_min"].update(metrics["input_var_min"])
            csv_logger.log(epoch + 1, itr, loss, metrics["loss_jepa"], metrics["loss_reg"],
                           metrics["enc_grad_norm"], metrics["pred_grad_norm"],
                           step_ms, wall_ms)
            if itr % LOG_FREQ == 0 or not np.isfinite(loss):
                flops_s = step_flops / max(1e-9, meters["step_ms"].avg / 1000.0)
                logger.info(
                    "[%d, %5d] loss: %.3f | p%.3f r%.3f | input_var: %.3f %.3f "
                    "[wd: %.2e] [lr: %.2e] [step: %.1f ms] [wall: %.1f ms] "
                    "[tflops: %.1f] [m1: %.2e m2: %.2e] [g: %.2e %.2e]",
                    epoch + 1, itr, meters["loss"].avg, meters["jepa"].avg,
                    meters["reg"].avg, meters["ivar"].avg, meters["ivar_min"].avg,
                    metrics["wd"], metrics["lr"], meters["step_ms"].avg,
                    meters["wall_ms"].avg, flops_s / 1e12,
                    metrics["exp_avg_abs_mean"], metrics["exp_avg_sq_mean"],
                    metrics["enc_grad_norm"], metrics["pred_grad_norm"])
                logger.info(
                    "[%d, %5d] enc_qkv_grads: f/l[%.2e %.2e] mn/mx(%.2e, %.2e) | "
                    "pred_qkv_grads: f/l[%.2e %.2e] mn/mx(%.2e, %.2e)",
                    epoch + 1, itr, metrics["enc_qkv_first"], metrics["enc_qkv_last"],
                    metrics["enc_qkv_min"], metrics["enc_qkv_max"],
                    metrics["pred_qkv_first"], metrics["pred_qkv_last"],
                    metrics["pred_qkv_min"], metrics["pred_qkv_max"])
            if not np.isfinite(loss):
                raise FloatingPointError(f"loss is {loss} at step {global_step}")

        logger.info("avg. loss %.3f", meters["loss"].avg)
        if epoch % CHECKPOINT_FREQ == 0 or epoch == num_epochs - 1:
            ckpt_lib.save_checkpoint(folder, tag, state, epoch + 1, save_every_freq,
                                     batch_size=batch_size, world_size=world_size, lr=lr)
    return state
