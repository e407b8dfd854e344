"""Rank functions of the data-parallel tests (tests/test_torch_dist*.py).

``jepa_tpu_torch.parallel.dist.run_local_ranks`` spawns them; a spawned
process imports this module by name, so it imports torch and the port
only, never JAX. Inputs arrive as numpy arrays and plain dicts, results
go back as tensors and floats.
"""

from __future__ import annotations

import numpy as np
import torch

from jepa_tpu_torch.masks import multiblock3d as masks
from jepa_tpu_torch.masks.random_tube import TubeSpec
from jepa_tpu_torch.models.factory import predictor_cfg_for
from jepa_tpu_torch.models.vit import ViTCfg
from jepa_tpu_torch.parallel.mesh import make_layout
from jepa_tpu_torch.train.step import (
    TrainCfg,
    build_train_step,
    init_train_state,
    shard_state_,
)
from jepa_tpu_torch.utils import checkpoint as ckpt_lib
from jepa_tpu_torch.utils import schedulers
from jepa_tpu_torch.utils.checkpoint_port import train_state_from_jax


def _cfgs(spec):
    enc = ViTCfg(**spec["enc"], compute_dtype=torch.float32)
    return enc, predictor_cfg_for(enc, **spec["pred"])


def _t(a):
    return torch.from_numpy(np.array(a))


def update_rank(rank, world, spec):
    """``len(spec['batches'])`` updates of this rank's part of each global
    batch; returns the metrics of each update, the modules' state_dicts and
    the whole AdamW moments (gathered under ZeRO-1).

    spec: ``enc`` / ``pred`` (config kwargs), ``train`` (TrainCfg kwargs),
    ``sched``, ``masks`` (mask configs; ``{"ratio": r}`` for tube masks),
    ``grid``, ``keep``; ``init``: a JAX train state and consts as numpy
    (``("jax", state, consts)``) or a seed (``("seed", s)``); ``batches``:
    per update, per rank, a dict of numpy arrays (``clips``, and the padded
    mode's lists); ``global_masks``: per update, the global (masks_enc,
    masks_pred) handed to the step's sampler, or None for its default;
    ``fsdp`` / ``min_shard``; ``resume`` / ``save``: a checkpoint folder
    read before / written after the updates."""
    torch.set_num_threads(1)
    enc, pred = _cfgs(spec)
    if spec["init"][0] == "jax":
        state = train_state_from_jax(spec["init"][1], spec["init"][2], enc, pred, device="cpu")
    else:
        state = init_train_state(enc, pred, torch.Generator().manual_seed(spec["init"][1]),
                                 device="cpu")
    layout = make_layout(spec.get("fsdp", 1), min_size_to_shard=spec.get("min_shard", 2**20))
    shard_state_(state, layout)
    if spec.get("resume"):
        state, _ = ckpt_lib.load_checkpoint(spec["resume"], "dp", state, layout=layout)
    grid = masks.MaskGrid(**spec["grid"])
    tube = spec["train"].get("mask_mode") == "tube"
    specs = [TubeSpec.from_cfg(m) if tube else masks.MaskSpec.from_cfg(m)
             for m in spec["masks"]]
    sampler = None
    if spec.get("global_masks"):
        gm, step0 = spec["global_masks"], state.step
        sampler = lambda step, bs, dev: tuple([_t(m).long() for m in ms]
                                              for ms in gm[step - step0])
    step_fn = build_train_step(enc, pred, TrainCfg(**spec["train"]),
                               *schedulers.build_schedules(**spec["sched"]), specs, grid,
                               spec["keep"], mask_sampler=sampler, layout=layout)
    metrics = []
    for per_rank in spec["batches"]:
        b = per_rank[rank]
        batch = {"clips": _t(b["clips"])}
        for k in ("masks_enc", "enc_weights", "masks_pred", "pred_weights"):
            if k in b:
                batch[k] = [_t(a) for a in b[k]]
        state, m = step_fn(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    if spec.get("save"):
        ckpt_lib.save_checkpoint(spec["save"], "dp", state, 1, world_size=world, layout=layout)
    mu, nu = ckpt_lib.gather_moments(state, layout)
    return dict(metrics=metrics, step=state.step,
                encoder=state.encoder.state_dict(), predictor=state.predictor.state_dict(),
                target=state.target.state_dict(), mu=mu, nu=nu,
                local_mu_shapes={n: tuple(t.shape) for n, t in state.mu.items()})


def run_specs(rank, world, specs):
    """``update_rank`` of each spec in turn (a later one may resume from
    the checkpoint an earlier one wrote)."""
    return [update_rank(rank, world, spec) for spec in specs]


def probe_rank(rank, world, spec):
    """Probe train steps of the video eval on this rank's rows of each
    global batch of post-augmentation clips (recording the gradients the
    clip receives), then the val pass over an
    uneven val set through ``val_counts`` (a non-drop_last
    ``ShardedSampler`` over ``spec['val_clips']``, batches of
    ``spec['val_batch']``, the last one padded)."""
    from jepa_tpu_torch.data.loader import ShardedSampler
    from jepa_tpu_torch.evals import video_classification_frozen as vcf
    from jepa_tpu_torch.models.attentive import AttentiveCfg, AttentiveClassifier
    from jepa_tpu_torch.models.vit import VisionTransformer
    from jepa_tpu_torch.parallel.mesh import rank_rows

    torch.set_num_threads(1)
    cfg = ViTCfg(**spec["enc"], compute_dtype=torch.float32, fused_mlp=True)
    model = VisionTransformer(cfg)
    model.load_state_dict(spec["encoder_sd"])
    acfg = AttentiveCfg(**spec["acfg"], compute_dtype=torch.float32)
    clf = AttentiveClassifier(acfg)
    clf.load_state_dict(spec["classifier_sd"])
    probe = vcf.Probe(encoder=model.requires_grad_(False), enc_cfg=cfg, classifier=clf,
                      acfg=acfg, lr_sched=schedulers.WarmupCosine(**spec["lr"]),
                      wd_sched=schedulers.CosineWD(**spec["wd"]))
    grads = []  # each update's gradients as the clip sees them (after the all-reduce)
    clip = vcf.clip_by_global_norm

    def recording_clip(gs, *a):
        grads.append(dict(zip(probe.names, [g.clone() for g in gs])))
        return clip(gs, *a)

    vcf.clip_by_global_norm = recording_clip
    losses, classifiers = [], []
    for clips, labels in spec["train"]:
        out = vcf.train_step(probe, _t(rank_rows(clips, rank, world)),
                             _t(rank_rows(labels, rank, world)), attend_across_segments=True)
        losses.append((float(out["loss"]), float(out["acc"])))
        classifiers.append({k: v.clone() for k, v in probe.classifier.state_dict().items()})

    val_clips, val_labels, vb = spec["val_clips"], spec["val_labels"], spec["val_batch"]
    sampler = ShardedSampler(len(val_labels), rank=rank, world_size=world, shuffle=False,
                             drop_last=False)
    idx = list(sampler)
    loader = [{"idx": np.array(idx[i:i + vb]), "labels": val_labels[idx[i:i + vb]]}
              for i in range(0, len(idx), vb)]

    def step(np_batch, w, pad):
        sel = np.concatenate([np_batch["idx"], np.repeat(np_batch["idx"][-1:], pad)])
        return vcf.val_step(probe, _t(val_clips[sel]), _t(val_labels[sel]), _t(w),
                            attend_across_segments=True)

    counts = vcf.val_counts(loader, len(val_labels), vb, step, rank, world)
    return dict(losses=losses, counts=counts, classifiers=classifiers, grads=grads,
                mu=probe.mu, step=probe.step, n_local=len(idx))


def _record_writes() -> list:
    """The paths of the checkpoint files this process writes from now on."""
    writes, save = [], ckpt_lib._save_atomic

    def recording_save(obj, path):
        writes.append(path)
        save(obj, path)

    ckpt_lib._save_atomic = recording_save
    return writes


def app_rank(rank, world, argv):
    """The pretrain app through the launcher's in-cluster mode (the process
    group from the SLURM environment the caller sets); returns the steps
    taken and the checkpoint files this rank wrote."""
    from jepa_tpu_torch.apps import main_distributed

    torch.set_num_threads(1)
    writes = _record_writes()
    state = main_distributed.main(argv)
    return dict(step=state.step, writes=writes,
                qkv=state.encoder.blocks[0].attn.qkv.weight.detach().clone())


def cli_rank(rank, world, argv):
    """The pretrain app through ``python -m jepa_tpu_torch.apps.main``'s
    entry (the process group from torchrun's environment the caller
    sets)."""
    import torch.distributed as dist

    from jepa_tpu_torch.apps import main as cli

    torch.set_num_threads(1)
    state = cli.main(argv)
    dist.destroy_process_group()
    return dict(step=state.step, qkv=state.encoder.blocks[0].attn.qkv.weight.detach().clone())


def eval_rank(rank, world, argv):
    """The video eval through the eval launcher's in-cluster mode; returns
    the val accuracies and how many checkpoint files this rank wrote."""
    from jepa_tpu_torch.evals import main_distributed

    torch.set_num_threads(1)
    writes = _record_writes()
    return dict(accs=main_distributed.main(argv), writes=writes)
