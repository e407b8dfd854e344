"""Frozen-encoder attentive-probe image classification, IN1K / Places /
iNat (counterpart of jepa_tpu/evals/image_classification_frozen.py;
reference evals/image_classification_frozen/eval.py:63-503).

    from jepa_tpu_torch.evals.image_classification_frozen import main
    val_accs = main(load_config("configs/evals/vitl16_in1k.yaml"))  # device="cuda"

The video encoder sees each image replicated ``frames_per_clip`` times on
the time axis (the reference's forward-pre-hook, eval.py:452-457, written
out). ``train_step``: random-resized crop, horizontal flip, AutoAugment
'original' (``data.auto_augment``: true / 'original' by default, a
'rand-...' string for RandAugment, false for none), normalize and random
erase on the device with a generator seeded from (4321, step * N + rank) on
each of N ranks, then the
frozen encoder under ``no_grad`` and one probe update (the video eval's
``probe_update``). ``val_step``: host short-side resize (256/224 of the
resolution) and centre crop, normalize on the device, (correct, total)
with zero weight on the padding of the last partial batch. The CSV,
checkpoints, resume, device and data-parallel rules are the video eval's.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from jepa_tpu_torch.data.image_dataset import make_image_loader
from jepa_tpu_torch.data.transforms import AugmentCfg, normalize, pretrain_augment
from jepa_tpu_torch.evals.video_classification_frozen import (
    Probe,
    load_frozen_encoder,
    make_probe,
    probe_correct,
    probe_schedules,
    probe_update,
    run_epochs,
    val_accuracy,
)
from jepa_tpu_torch.models.factory import vit_cfg
from jepa_tpu_torch.parallel import dist as pdist
from jepa_tpu_torch.parallel.mesh import eval_batch_geometry
from jepa_tpu_torch.models.vit import vit_forward
from jepa_tpu_torch.train.step import step_generator
from jepa_tpu_torch.utils.logging import AverageMeter, get_logger

AUG_SEED = 4321  # the JAX eval's augmentation key


def _resolve_aa(val):
    """Config value -> AugmentCfg.auto_augment string (or None)."""
    if val is True:
        return "original"
    if not val:
        return None
    return str(val)


def encode_images(probe: Probe, images: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> frozen features; a video encoder sees each image
    repeated over its frames."""
    cfg = probe.enc_cfg
    if cfg.is_video:
        b = images.shape[0]
        images = images[:, None].expand(b, cfg.num_frames, *images.shape[1:])
    return vit_forward(probe.encoder, images, cfg)


def train_step(probe: Probe, images: torch.Tensor, labels: torch.Tensor) -> dict:
    """Frozen encoder over post-augmentation images [B, H, W, C], then one
    probe update."""
    with torch.no_grad():
        feats = encode_images(probe, images)
    return probe_update(probe, [feats], labels)


@torch.no_grad()
def val_step(probe: Probe, images: torch.Tensor, labels: torch.Tensor,
             weights: torch.Tensor):
    """(correct, total) over normalized images [B, H, W, C]."""
    return probe_correct(probe, [encode_images(probe, images)], labels, weights)


def train_augment_cfg(resolution: int, auto_augment=True) -> AugmentCfg:
    """The probe's training augmentation (reference eval.py:394-403):
    random-resized crop, flip, ``auto_augment`` (a config value, see
    ``_resolve_aa``), random erase with probability 0.25."""
    return AugmentCfg(crop_size=resolution, random_resize_scale=(0.08, 1.0),
                      random_resize_aspect_ratio=(3 / 4, 4 / 3), random_horizontal_flip=True,
                      reprob=0.25, auto_augment=_resolve_aa(auto_augment))


def augment_images(gen: torch.Generator, images_uint8: torch.Tensor, cfg: AugmentCfg,
                   dtype: torch.dtype) -> torch.Tensor:
    """[B, H, W, C] uint8 -> augmented, normalized [B, crop, crop, C] in
    ``dtype``: the video augmentation on one-frame clips."""
    return pretrain_augment(gen, images_uint8[:, None], cfg)[:, 0].to(dtype)


def main(args_eval: dict, resume_preempt: bool = False, device="cuda"):
    args_pretrain = args_eval.get("pretrain", {})
    checkpoint_key = args_pretrain.get("checkpoint_key", "target_encoder")
    model_name = args_pretrain.get("model_name")
    patch_size = int(args_pretrain.get("patch_size", 16))
    pretrain_folder = args_pretrain.get("folder", ".")
    ckp_fname = args_pretrain.get("checkpoint", "")
    tag = args_pretrain.get("write_tag", "jepa")
    uniform_power = bool(args_pretrain.get("uniform_power", False))
    tubelet_size = int(args_pretrain.get("tubelet_size", 2))
    frames_per_clip = int(args_pretrain.get("frames_per_clip", 1))
    pretrained_path = os.path.join(pretrain_folder, ckp_fname)

    args_data = args_eval.get("data", {})
    num_classes = int(args_data.get("num_classes"))
    root_path = args_data.get("root_path")
    image_folder = args_data.get("image_folder", "")
    resolution = int(args_data.get("resolution", 224))
    num_workers = int(args_data.get("num_workers", 8))

    args_opt = args_eval.get("optimization", {})
    batch_size = int(args_opt.get("batch_size"))
    num_epochs = int(args_opt.get("num_epochs"))
    wd = float(args_opt.get("weight_decay", 0.01))
    start_lr = float(args_opt.get("start_lr"))
    lr = float(args_opt.get("lr"))
    final_lr = float(args_opt.get("final_lr"))
    warmup = float(args_opt.get("warmup", 0.0))
    use_bfloat16 = bool(args_opt.get("use_bfloat16", True))

    resume_checkpoint = bool(args_eval.get("resume_checkpoint", False)) or resume_preempt
    eval_tag = args_eval.get("tag", None)

    world_size, rank, dev = pdist.init_rank(device)
    logger = get_logger(__name__, rank=rank, force=world_size > 1)  # a rank > 0 logs errors only
    compute_dtype = torch.bfloat16 if use_bfloat16 else torch.float32
    folder = os.path.join(pretrain_folder, "image_classification_frozen/")
    if eval_tag is not None:
        folder = os.path.join(folder, eval_tag)
    os.makedirs(folder, exist_ok=True)

    enc_cfg = vit_cfg(model_name, img_size=resolution, patch_size=patch_size,
                      num_frames=frames_per_clip, tubelet_size=tubelet_size,
                      uniform_power=uniform_power, compute_dtype=compute_dtype,
                      fused_mlp=True)  # the encoder is frozen: grad-free forwards
    encoder = load_frozen_encoder(pretrained_path, enc_cfg, checkpoint_key, dev)

    _, train_loader, train_sampler = make_image_loader(
        root_path=root_path, image_folder=image_folder, batch_size=batch_size,
        training=True, output_size=int(resolution * 256 / 224), rank=rank,
        world_size=world_size, num_workers=num_workers)
    val_ds, val_loader, _ = make_image_loader(
        root_path=root_path, image_folder=image_folder, batch_size=batch_size,
        training=False, output_size=resolution, resize_short=int(resolution * 256 / 224),
        rank=rank, world_size=world_size, num_workers=num_workers)
    ipe = len(train_loader)
    logger.info("train iterations per epoch: %d; batch %d per rank, %d global", ipe,
                *eval_batch_geometry(batch_size, world_size))

    probe = make_probe(encoder, enc_cfg, num_classes,
                       *probe_schedules(ipe, num_epochs, warmup, start_lr, lr, final_lr, wd), dev)
    aug_cfg = train_augment_cfg(resolution, args_data.get("auto_augment", True))

    def train_epoch(epoch):
        train_sampler.set_epoch(epoch)
        meter = AverageMeter()
        for itr, np_batch in enumerate(train_loader):
            gen = step_generator(AUG_SEED, (epoch * ipe + itr) * world_size + rank, dev)
            images = augment_images(gen, torch.from_numpy(np_batch["images"]).to(dev), aug_cfg,
                                    compute_dtype)
            metrics = train_step(probe, images, torch.from_numpy(np_batch["labels"]).to(dev))
            meter.update(float(metrics["acc"]))
            if itr % 20 == 0:
                logger.info("[%5d] train acc %.3f%% (loss %.3f)", itr, meter.avg,
                            float(metrics["loss"]))
        return meter.avg

    def val_batch(np_batch, w, pad):
        images, labels = np.asarray(np_batch["images"]), np.asarray(np_batch["labels"])
        if pad:
            images = np.concatenate([images, np.repeat(images[-1:], pad, 0)])
            labels = np.concatenate([labels, np.zeros(pad, labels.dtype)])
        imgs = normalize(torch.from_numpy(images).to(dev).float()).to(compute_dtype)
        return val_step(probe, imgs, torch.from_numpy(labels).to(dev),
                        torch.from_numpy(w).to(dev))

    return run_epochs(
        folder, tag, probe, num_epochs, resume_checkpoint, train_epoch,
        lambda: val_accuracy(val_loader, len(val_ds), batch_size, val_batch, rank, world_size),
        logger, rank)
