"""Frozen-encoder attentive-probe video classification, K400 / SSv2
(counterpart of jepa_tpu/evals/video_classification_frozen.py; reference
evals/video_classification_frozen/eval.py:67-561).

    from jepa_tpu_torch.evals.video_classification_frozen import main
    val_accs = main(load_config("configs/evals/vitl16_k400_16x8x3.yaml"))  # device="cuda"

A pretrained encoder (a ``.pth.tar``, or a JAX pretraining run's orbax
directory, read strictly as the JAX eval reads one) is frozen; an AttentiveClassifier trains with
cross-entropy on the aggregated clip features; validation is
multi-segment x multi-view with softmax-averaged top-1. It reads the
reference's YAML schema key by key, as the JAX eval does. One process
drives one device: the card unless the caller asks for the CPU; a missing
GPU raises. ``optimization.batch_size`` is per rank (per GPU, as in the
reference). Run as N ranks (``parallel.dist.initialize``) it keeps the
JAX eval's global-batch semantics: the probe's gradients are averaged
over the ranks before the clip, the logged loss and accuracy are global,
and the val pass sums (correct, total) over the ranks; rank 0 writes the
probe checkpoint and every rank its ``_r{rank}.csv``.

``train_step``: the loader's uint8 clips are augmented on the device
(RandAugment 'rand-m7-n4-mstd0.5-inc1' unless ``data.auto_augment`` is
false, random-resized crop, random erase) with a generator seeded from
(1234, step * N + rank); the frozen encoder runs ONCE over all B*S clips under
``no_grad`` (on the card every block launches H1 and H3, or their fp32
instances under ``use_bfloat16: false``); the probe takes the CE averaged
over views, global-norm clipping at 1.0 and AdamW with the decay mask, lr
warmup-cosine and wd cosine to 1e-6 (the reference's init_opt default).
``val_step``: the sliding multi-view crops of every segment, one encoder
call over B*S*V clips, softmax averaged over views, (correct, total) with
zero weight on the padding of the last partial batch. ``main`` calls both,
writes ``<tag>_r{rank}.csv`` (epoch, train acc under "loss", val acc under
"acc", as the JAX eval does) and a ``<tag>-latest.pth.tar`` probe
checkpoint per epoch, and resumes from it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from jepa_tpu_torch.api import checkpoint_format
from jepa_tpu_torch.data.loader import make_video_loader
from jepa_tpu_torch.data.transforms import AugmentCfg, multiview_crops, pretrain_augment
from jepa_tpu_torch.evals.aggregation import (
    clip_aggregation,
    frame_aggregation,
    temporal_pos_embed_table,
)
from jepa_tpu_torch.models.attentive import (
    AttentiveCfg,
    AttentiveClassifier,
    classifier_forward,
    init_attentive_classifier,
)
from jepa_tpu_torch.models.factory import vit_cfg
from jepa_tpu_torch.parallel import dist as pdist
from jepa_tpu_torch.parallel.mesh import eval_batch_geometry
from jepa_tpu_torch.models.transformer import cast_matmul_weights_
from jepa_tpu_torch.models.vit import ViTCfg, VisionTransformer
from jepa_tpu_torch.train.optimizer import adamw_update_, clip_by_global_norm, decay_mask
from jepa_tpu_torch.train.step import step_generator
from jepa_tpu_torch.utils import checkpoint as ckpt_lib
from jepa_tpu_torch.utils.checkpoint_port import load_orbax_encoder, load_pretrained_encoder
from jepa_tpu_torch.utils.logging import AverageMeter, CSVLogger, get_logger
from jepa_tpu_torch.utils.schedulers import CosineWD, WarmupCosine

AUG_SEED = 1234  # the JAX eval's augmentation key


def load_frozen_encoder(path: str, cfg: ViTCfg, checkpoint_key: str, device) -> VisionTransformer:
    """A zoo or app ``.pth.tar`` encoder, loaded tolerantly as the JAX eval
    loads one, or a JAX orbax run directory's ``target`` / ``params/encoder``,
    loaded strictly as the JAX eval loads one (a probe on a silently random
    encoder is worse than a crash); frozen, its matmul weights stored in the
    compute dtype."""
    if checkpoint_format(path) == "orbax":
        model = load_orbax_encoder(path, cfg, checkpoint_key, device=device)
    else:
        model = load_pretrained_encoder(path, cfg, checkpoint_key, tolerant=True,
                                        device=device)
    return cast_matmul_weights_(model, cfg.compute_dtype).requires_grad_(False).eval()


@dataclasses.dataclass
class Probe:
    """The frozen encoder and the trained attentive probe with its AdamW
    state: what ``probe_update`` and the evals' steps read and update."""

    encoder: VisionTransformer  # frozen
    enc_cfg: ViTCfg             # the encoder's run config (fused fc1 on)
    classifier: AttentiveClassifier
    acfg: AttentiveCfg
    lr_sched: WarmupCosine
    wd_sched: CosineWD
    step: int = 0

    def __post_init__(self):
        named = list(self.classifier.named_parameters())
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        mask = decay_mask(self.classifier)
        self.decay = [mask[n] for n in self.names]
        self.mu: Dict[str, torch.Tensor] = {n: torch.zeros_like(p) for n, p in named}
        self.nu: Dict[str, torch.Tensor] = {n: torch.zeros_like(p) for n, p in named}


def make_probe(encoder: VisionTransformer, enc_cfg: ViTCfg, num_classes: int,
               lr_sched: WarmupCosine, wd_sched: CosineWD, device) -> Probe:
    """A depth-1 attentive classifier on the encoder's width, fp32
    parameters from a seeded CPU generator, the compute dtype of the
    encoder."""
    acfg = AttentiveCfg(embed_dim=enc_cfg.embed_dim, num_heads=enc_cfg.num_heads, depth=1,
                        num_classes=num_classes, compute_dtype=enc_cfg.compute_dtype)
    clf = init_attentive_classifier(acfg, torch.Generator().manual_seed(0)).to(device)
    return Probe(encoder=encoder, enc_cfg=enc_cfg, classifier=clf, acfg=acfg,
                 lr_sched=lr_sched, wd_sched=wd_sched)


def probe_update(probe: Probe, feats: List[torch.Tensor], labels: torch.Tensor) -> dict:
    """One probe update on frozen features (a list over views of [B, N, D]):
    CE averaged over the views, clipping at 1.0, AdamW at the schedules'
    values of this step. Returns loss, acc (%, of the view-averaged
    softmax) and lr as 0-d tensors. In a data-parallel run the gradients,
    loss and acc are averaged over the ranks (equal local batches: the
    global batch's means)."""
    sched_step = probe.step + 1
    lr = float(probe.lr_sched(sched_step))
    wd = float(probe.wd_sched(sched_step))
    with torch.enable_grad():
        logits = [classifier_forward(probe.classifier, f, probe.acfg) for f in feats]
        loss = sum(F.cross_entropy(lg, labels) for lg in logits) / len(logits)
    # xattn.proj is never applied (the reference's quirk): its gradient is
    # zero, as in the JAX package, and AdamW still decays it
    grads = list(torch.autograd.grad(loss, probe.params, materialize_grads=True))
    with torch.no_grad():
        pdist.all_reduce_(grads, "mean")
        clip_by_global_norm(grads, 1.0, True)
        adamw_update_(probe.params, grads, [probe.mu[n] for n in probe.names],
                      [probe.nu[n] for n in probe.names], probe.decay, probe.names,
                      lr=lr, wd=wd, step=sched_step)
        probe.step = sched_step
        probs = sum(torch.softmax(lg.detach(), -1) for lg in logits) / len(logits)
        acc = (probs.argmax(-1) == labels).float().mean() * 100.0
        loss = loss.detach()
        pdist.all_reduce_([loss, acc], "mean")
    return {"loss": loss, "acc": acc, "lr": torch.tensor(lr)}


@torch.no_grad()
def probe_correct(probe: Probe, feats: List[torch.Tensor], labels: torch.Tensor,
                  weights: torch.Tensor):
    """(sum of weighted hits, sum of weights) of the view-averaged softmax."""
    logits = [classifier_forward(probe.classifier, f, probe.acfg) for f in feats]
    probs = sum(torch.softmax(lg, -1) for lg in logits) / len(logits)
    hit = (probs.argmax(-1) == labels).float()
    return (hit * weights).sum(), weights.sum()


def encode_views(probe: Probe, clips: torch.Tensor, attend_across_segments: bool,
                 pos_table: Optional[torch.Tensor] = None,
                 clip_indices: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """clips [B, S, V, T, H, W, C] -> the probe's inputs, a flat list of
    feature sequences (per view, or per view and segment)."""
    if not probe.enc_cfg.is_video:
        return frame_aggregation(probe.encoder, clips, probe.enc_cfg,
                                 pos_embed_table=pos_table, clip_indices=clip_indices)
    feats = clip_aggregation(probe.encoder, clips, probe.enc_cfg,
                             attend_across_segments=attend_across_segments,
                             pos_embed_table=pos_table, clip_indices=clip_indices)
    return feats if attend_across_segments else [o for views in feats for o in views]


def train_step(probe: Probe, clips: torch.Tensor, labels: torch.Tensor,
               attend_across_segments: bool, pos_table=None, clip_indices=None) -> dict:
    """Frozen encoder once over the post-augmentation clips [B, S, 1, T, H,
    W, C], then one probe update."""
    with torch.no_grad():
        feats = encode_views(probe, clips, attend_across_segments, pos_table, clip_indices)
    return probe_update(probe, feats, labels)


@torch.no_grad()
def val_step(probe: Probe, clips: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor,
             attend_across_segments: bool, pos_table=None, clip_indices=None):
    """(correct, total) over the multi-view clips [B, S, V, T, H, W, C]."""
    feats = encode_views(probe, clips, attend_across_segments, pos_table, clip_indices)
    return probe_correct(probe, feats, labels, weights)


def probe_schedules(ipe: int, num_epochs: int, warmup: float, start_lr: float, lr: float,
                    final_lr: float, wd: float):
    """The probe's lr (warmup-cosine) and wd (cosine to 1e-6, the
    reference's init_opt default) over num_epochs * ipe steps."""
    t_max = int(num_epochs * ipe)
    return (WarmupCosine(warmup_steps=int(warmup * ipe), start_lr=start_lr, ref_lr=lr,
                         final_lr=final_lr, t_max=t_max),
            CosineWD(ref_wd=wd, final_wd=1e-6, t_max=t_max))


def val_counts(val_loader, n_items: int, batch_size: int, step, rank: int = 0,
               world_size: int = 1) -> Tuple[float, float]:
    """(correct, total) over the validation set. ``step(np_batch, w, pad)``
    pads a partial last batch of b samples with pad = batch_size - b
    repeats, so every val step has the configured shape, and returns
    (correct, total) under the weights w [batch_size]: zero for the
    non-drop_last sampler's repeats (positions >= n_items) and for the
    padding. With more than one rank the sums run over every rank (each
    rank's loader yields equal counts)."""
    correct = total = 0.0
    k_item = 0
    dev = None
    for np_batch in val_loader:
        b = len(np_batch["labels"])
        pos = rank + (k_item + np.arange(b)) * world_size
        k_item += b
        w = np.zeros(batch_size, np.float32)
        w[:b] = pos < n_items
        c, t = step(np_batch, w, batch_size - b)
        correct += float(c)
        total += float(t)
        dev = c.device
    if world_size > 1 and dev is not None:
        correct, total = pdist.all_reduce_scalars([correct, total], dev)
    return correct, total


def val_accuracy(val_loader, n_items: int, batch_size: int, step, rank: int = 0,
                 world_size: int = 1) -> float:
    """Top-1 (%) over the validation set (``val_counts``)."""
    correct, total = val_counts(val_loader, n_items, batch_size, step, rank, world_size)
    return 100.0 * correct / max(1, total)


def run_epochs(folder: str, tag: str, probe: Probe, num_epochs: int, resume: bool,
               train_epoch, val_epoch, logger, rank: int = 0) -> List[float]:
    """The evals' epoch loop: resume from ``<tag>-latest.pth.tar`` when asked
    and present; per epoch ``train_epoch(epoch)`` (-> mean train acc) and
    ``val_epoch()`` (-> val acc), a CSV row (epoch, train acc under "loss",
    val acc under "acc", as the JAX eval writes them) and the probe
    checkpoint. Returns the val accuracies."""
    start_epoch = 0
    if resume and os.path.exists(ckpt_lib.checkpoint_path(folder, tag)):
        start_epoch = ckpt_lib.load_probe_checkpoint(folder, tag, probe)
    csv_logger = CSVLogger(os.path.join(folder, f"{tag}_r{rank}.csv"),
                           ("%d", "epoch"), ("%.5f", "loss"), ("%.5f", "acc"))
    val_accs = []
    for epoch in range(start_epoch, num_epochs):
        logger.info("Epoch %d", epoch + 1)
        train_acc = train_epoch(epoch)
        val_acc = val_epoch()
        val_accs.append(val_acc)
        logger.info("[%5d] train: %.3f%% test: %.3f%%", epoch + 1, train_acc, val_acc)
        csv_logger.log(epoch + 1, train_acc, val_acc)
        ckpt_lib.save_probe_checkpoint(folder, tag, probe, epoch + 1)
    return val_accs


def pad_clip_major(arr, segments: int, pad: int) -> np.ndarray:
    """Pad a clip-major [S*B, ...] batch to [S*(B+pad), ...] by repeating
    each segment's last sample (consumed with zero weight)."""
    arr = np.asarray(arr)
    b = arr.shape[0] // segments
    a = arr.reshape((segments, b) + arr.shape[1:])
    a = np.concatenate([a, np.repeat(a[:, -1:], pad, axis=1)], axis=1)
    return a.reshape((segments * (b + pad),) + arr.shape[1:])


def sample_major(arr, segments: int) -> np.ndarray:
    """Clip-major [S*B, ...] -> sample-major [B*S, ...]."""
    arr = np.asarray(arr)
    b = arr.shape[0] // segments
    arr = np.moveaxis(arr.reshape((segments, b) + arr.shape[1:]), 1, 0)
    return np.ascontiguousarray(arr).reshape((b * segments,) + arr.shape[2:])


def main(args_eval: dict, resume_preempt: bool = False, device="cuda"):
    # ---- config (reference schema) ----------------------------------------
    args_pretrain = args_eval.get("pretrain", {})
    checkpoint_key = args_pretrain.get("checkpoint_key", "target_encoder")
    model_name = args_pretrain.get("model_name")
    patch_size = int(args_pretrain.get("patch_size", 16))
    pretrain_folder = args_pretrain.get("folder", ".")
    ckp_fname = args_pretrain.get("checkpoint", "")
    tag = args_pretrain.get("write_tag", "jepa")
    uniform_power = bool(args_pretrain.get("uniform_power", False))
    tubelet_size = int(args_pretrain.get("tubelet_size", 2))
    pretrain_frames_per_clip = int(args_pretrain.get("frames_per_clip", 1))
    eval_frame_step = int(args_pretrain.get("frame_step", 4))
    eval_duration = args_pretrain.get("clip_duration", None)
    pretrained_path = os.path.join(pretrain_folder, ckp_fname)

    args_data = args_eval.get("data", {})
    train_data_path = [args_data.get("dataset_train")]
    val_data_path = [args_data.get("dataset_val")]
    num_classes = int(args_data.get("num_classes"))
    eval_num_segments = int(args_data.get("num_segments", 1))
    eval_frames_per_clip = int(args_data.get("frames_per_clip", 16))
    eval_num_views_per_segment = int(args_data.get("num_views_per_segment", 1))
    decode_backend = args_data.get("decode_backend", "auto")
    num_workers = int(args_data.get("num_workers", 8))

    args_opt = args_eval.get("optimization", {})
    resolution = int(args_opt.get("resolution", 224))
    batch_size = int(args_opt.get("batch_size"))
    attend_across_segments = bool(args_opt.get("attend_across_segments", False))
    use_pos_embed = bool(args_opt.get("use_pos_embed", False))
    num_epochs = int(args_opt.get("num_epochs"))
    wd = float(args_opt.get("weight_decay", 0.01))
    start_lr = float(args_opt.get("start_lr"))
    lr = float(args_opt.get("lr"))
    final_lr = float(args_opt.get("final_lr"))
    warmup = float(args_opt.get("warmup", 0.0))
    use_bfloat16 = bool(args_opt.get("use_bfloat16", True))

    resume_checkpoint = bool(args_eval.get("resume_checkpoint", False)) or resume_preempt
    eval_tag = args_eval.get("tag", None)

    # ---- runtime ------------------------------------------------------------
    world_size, rank, dev = pdist.init_rank(device)
    logger = get_logger(__name__, rank=rank, force=world_size > 1)  # a rank > 0 logs errors only
    compute_dtype = torch.bfloat16 if use_bfloat16 else torch.float32
    folder = os.path.join(pretrain_folder, "video_classification_frozen/")
    if eval_tag is not None:
        folder = os.path.join(folder, eval_tag)
    os.makedirs(folder, exist_ok=True)

    # ---- frozen encoder -------------------------------------------------------
    enc_cfg = vit_cfg(model_name, img_size=resolution, patch_size=patch_size,
                      num_frames=pretrain_frames_per_clip, tubelet_size=tubelet_size,
                      uniform_power=uniform_power, compute_dtype=compute_dtype,
                      fused_mlp=True)  # the encoder is frozen: grad-free forwards
    encoder = load_frozen_encoder(pretrained_path, enc_cfg, checkpoint_key, dev)
    is_video_encoder = pretrain_frames_per_clip > 1

    # ---- data -------------------------------------------------------------------
    # aspect-preserving decode (default): per-video short-side resize onto a
    # static letterbox canvas with a valid-region sidecar; aspect_preserving:
    # false reverts to a fixed (distorting) 4:3 canvas
    train_short = int(resolution * 256 / 224)
    if bool(args_data.get("aspect_preserving", True)):
        train_geom = dict(decode_short_side=train_short,
                          decode_canvas=(2 * train_short, 2 * train_short))
        val_geom = dict(decode_short_side=resolution,
                        decode_canvas=(2 * resolution, 2 * resolution))
    else:
        train_geom = dict(decode_size=(train_short, int(train_short * 4 / 3)))
        val_geom = dict(decode_size=(resolution, int(resolution * 4 / 3)))
    train_segments = eval_num_segments if attend_across_segments else 1
    loader_kw = dict(batch_size=batch_size, frames_per_clip=eval_frames_per_clip,
                     frame_step=eval_frame_step, duration=eval_duration,
                     allow_clip_overlap=True, decode_backend=decode_backend, rank=rank,
                     world_size=world_size, num_workers=num_workers)
    _, train_loader, train_sampler = make_video_loader(
        data_paths=train_data_path, num_clips=train_segments, training=True,
        **loader_kw, **train_geom)
    val_ds, val_loader, _ = make_video_loader(
        data_paths=val_data_path, num_clips=eval_num_segments, training=False,
        drop_last=False, **loader_kw, **val_geom)
    ipe = len(train_loader)
    logger.info("train iterations per epoch: %d; batch %d per rank, %d global", ipe,
                *eval_batch_geometry(batch_size, world_size))

    # ---- probe ------------------------------------------------------------------
    probe = make_probe(encoder, enc_cfg, num_classes,
                       *probe_schedules(ipe, num_epochs, warmup, start_lr, lr, final_lr, wd), dev)
    aug_cfg = AugmentCfg(
        crop_size=resolution, random_resize_scale=(0.08, 1.0),
        random_resize_aspect_ratio=(0.75, 4 / 3), random_horizontal_flip=False,
        reprob=0.25,
        # the reference hard-codes auto-augment for probe training
        # (utils.py:227-231); data.auto_augment: false opts out
        auto_augment="rand-m7-n4-mstd0.5-inc1" if args_data.get("auto_augment", True) else None)
    # ClipAggregation indexes temporal token slots (max_frames // tubelet
    # rows); FrameAggregation raw frame indices (an image encoder has no tubelets)
    pos_table = (temporal_pos_embed_table(enc_cfg.embed_dim,
                                          tubelet_size=tubelet_size if is_video_encoder else 1,
                                          device=dev)
                 if use_pos_embed else None)
    steps_kw = dict(attend_across_segments=attend_across_segments, pos_table=pos_table)

    def clip_indices(np_batch, pad: int = 0):
        """The collate's per-sample clip-index lists -> [B, S, T] int32 on
        the device (None unless the pos-embed opt-in is on)."""
        if not use_pos_embed:
            return None
        ci = np.stack([np.stack(s) for s in np_batch["clip_indices"]]).astype(np.int32)
        if pad:
            ci = np.concatenate([ci, np.repeat(ci[-1:], pad, 0)])
        return torch.from_numpy(ci).to(dev)

    def train_views(np_batch, gstep):
        # [S*B, T, H, W, 3] uint8 clip-major -> augmented [B, S, 1, T, r, r, 3]
        clips = torch.from_numpy(sample_major(np_batch["clips"], train_segments)).to(dev)
        vhw = torch.from_numpy(sample_major(np_batch["valid_hw"], train_segments)).to(dev)
        out = pretrain_augment(step_generator(AUG_SEED, gstep * world_size + rank, dev),
                               clips, aug_cfg, valid_hw=vhw)
        t, c = out.shape[1], out.shape[-1]
        return out.reshape(-1, train_segments, 1, t, resolution, resolution, c).to(compute_dtype)

    def val_views(np_batch):
        clips = np.asarray(np_batch["clips"])  # [S*B, T, H, W, 3]
        sb, t, h, w, c = clips.shape
        b = sb // eval_num_segments
        clips = sample_major(clips, eval_num_segments).reshape(b, eval_num_segments, t, h, w, c)
        # valid_hw rows are clip-major and the same for every segment of a
        # sample: the first B rows are segment 0's
        vhw = torch.from_numpy(np.asarray(np_batch["valid_hw"][:b])).to(dev)
        out = multiview_crops(torch.from_numpy(clips).to(dev), resolution,
                              eval_num_views_per_segment, valid_hw=vhw)
        return out.to(compute_dtype)

    def train_epoch(epoch):
        train_sampler.set_epoch(epoch)
        train_meter = AverageMeter()
        for itr, np_batch in enumerate(train_loader):
            clips = train_views(np_batch, epoch * ipe + itr)
            labels = torch.from_numpy(np_batch["labels"]).to(dev)
            metrics = train_step(probe, clips, labels, clip_indices=clip_indices(np_batch),
                                 **steps_kw)
            train_meter.update(float(metrics["acc"]))
            if itr % 20 == 0:
                logger.info("[%5d] train acc %.3f%% (loss %.3f, lr %.1e)", itr,
                            train_meter.avg, float(metrics["loss"]), float(metrics["lr"]))
        return train_meter.avg

    def val_batch(np_batch, w, pad):
        ci = clip_indices(np_batch, pad=pad)
        if pad:
            np_batch = dict(np_batch)
            for key in ("clips", "valid_hw"):
                np_batch[key] = pad_clip_major(np_batch[key], eval_num_segments, pad)
            np_batch["labels"] = np.concatenate(
                [np_batch["labels"], np.zeros(pad, np_batch["labels"].dtype)])
        return val_step(probe, val_views(np_batch), torch.from_numpy(np_batch["labels"]).to(dev),
                        torch.from_numpy(w).to(dev), clip_indices=ci, **steps_kw)

    return run_epochs(
        folder, tag, probe, num_epochs, resume_checkpoint, train_epoch,
        lambda: val_accuracy(val_loader, len(val_ds), batch_size, val_batch, rank, world_size),
        logger, rank)
