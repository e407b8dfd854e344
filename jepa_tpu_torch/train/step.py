"""One V-JEPA pretraining update (counterpart of
jepa_tpu/train/step.py::build_train_step; reference app/vjepa/train.py:414-498).

    state = init_train_state(enc_cfg, pred_cfg, generator)        # device="cuda"
    step_fn = build_train_step(enc_cfg, pred_cfg, train_cfg, lr_sched,
                               wd_sched, mom_sched, mask_specs, grid, keep_counts)
    state, metrics = step_fn(state, {"clips": clips})             # [B, T, H, W, C]

The update, in the JAX package's order: masks for this step; the target
forward without gradients (fused fc1 + GELU, H3, on the card) with the
feature LayerNorm and the gather at the target indices; for each mask
config the context encoder on the kept tokens (run with ``enc_cfg``, as
the JAX package runs it: ``fused_mlp='force'`` sends its fc1 through H8
and its plain backward; its ``remat`` checkpoints the blocks) and the
predictor over [context || mask tokens] (run with ``pred_cfg``; with
``use_mask_tokens=False`` over [context || the targets noised by one
diffusion step], its draws from a generator seeded with (seed + 2, step),
the same for every mask config, as the JAX step folds one key); the L1
loss (plus the variance regularizer when its coefficient is not 0); the
backward (H1's saved outputs feed H2 on the
card); per-module gradient clipping gated by ``clip_after_step``; AdamW
with the decay mask; the EMA of the target. lr and wd are read at
``step + 1``, the momentum at ``step``.

Mask modes: ``fixed`` samples exact-K multiblock masks from (seed, step)
on the clips' device; ``tube`` samples random-tube masks the same way
(``masks.random_tube.sample_tube_masks``, one generator per step, the
mask configs drawn in order; exact-K, so no key mask), as
jepa_tpu/train/step.py:189-197; ``padded`` takes the host collator's
padded masks and validity weights from the batch
(jepa_tpu/train/step.py:214-236): the key mask of the context encoder and
the predictor is w > 0.5, and the loss and the variance regularizer are
weighted.

The state holds fp32 master parameters in modules, the target as a copy
of the encoder, and the AdamW moments; the step updates it IN PLACE and
returns it.

Data parallelism (``layout``, a ``parallel.mesh.Layout`` made in an
initialised process group, of any size): each rank holds B of the global
batch's ``world * B`` samples and
the step keeps the JAX package's global-batch semantics. The default
sampler draws the global batch's masks from (seed, step) and keeps rows
``[rank * B, (rank + 1) * B)``, so the masks do not depend on the world
size; after the backward one bucketed all-reduce of every gradient (in
``named_params`` order, fp32; a parameter without a gradient contributes
zeros) gives each rank the global gradient before the qkv statistics,
the grad norms and the clipping. The loss is the mean over the global
batch: the gradients are averaged, except in the padded mode, where each
mask config's weighted mean divides this rank's sum by the global weight
sum (all-reduced), the variance regularizer's per-sample mean is scaled
by 1 / world, and the gradients are summed. Logged metrics are global.
With ``layout.fsdp`` > 1 the AdamW moments are this rank's ZeRO-1 slices
(``shard_state_``). Without a layout, or with one made with no group,
none of this runs.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from jepa_tpu_torch.masks.multiblock3d import MaskGrid, MaskSpec, sample_masks_for_specs
from jepa_tpu_torch.masks.random_tube import sample_tube_masks
from jepa_tpu_torch.models.predictor import (
    Predictor,
    PredictorCfg,
    diffusion_draws,
    init_predictor,
    predictor_forward,
)
from jepa_tpu_torch.models.vit import ViTCfg, VisionTransformer, init_vit, vit_forward
from jepa_tpu_torch.ops.masking import gather_tokens, repeat_interleave_batch
from jepa_tpu_torch.parallel import dist as pdist
from jepa_tpu_torch.parallel.mesh import Layout, rank_rows, shard, zero1_plan
from jepa_tpu_torch.train.losses import jepa_loss, layer_norm_targets, variance_reg
from jepa_tpu_torch.train.optimizer import (
    adamw_update_,
    clip_by_global_norm,
    decay_mask,
    ema_update_,
    global_norm,
)
from jepa_tpu_torch.utils.schedulers import CosineWD, LinearMomentum, WarmupCosine


@dataclasses.dataclass(frozen=True)
class TrainCfg:
    loss_exp: float = 1.0
    reg_coeff: float = 0.0
    clip_grad: Optional[float] = 10.0
    # clipping starts after the warmup epochs (the reference's
    # `epoch > warmup` gate, train.py:468)
    clip_after_step: int = 0
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    num_clips: int = 1
    mask_mode: str = "fixed"  # 'fixed' | 'padded' | 'tube'
    seed: int = 234


@dataclasses.dataclass
class TrainState:
    """fp32 master parameters (``encoder``, ``predictor``), the EMA
    ``target``, and the AdamW moments keyed like :meth:`named_params`."""

    step: int
    encoder: VisionTransformer
    predictor: Predictor
    target: VisionTransformer
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]

    def named_params(self) -> Dict[str, torch.nn.Parameter]:
        """"encoder.<name>" and "predictor.<name>" -> trainable parameter."""
        out = {f"encoder.{n}": p for n, p in self.encoder.named_parameters()}
        out.update({f"predictor.{n}": p for n, p in self.predictor.named_parameters()})
        return out


def init_train_state(enc_cfg: ViTCfg, pred_cfg: PredictorCfg,
                     generator: Optional[torch.Generator] = None,
                     device="cuda") -> TrainState:
    """A fresh state on ``device`` (default "cuda"; a missing GPU raises).
    The target starts as a copy of the encoder (reference train.py:222)."""
    from jepa_tpu_torch.api import _resolve_device

    dev = _resolve_device(device)
    encoder = init_vit(enc_cfg, generator, device=dev)
    predictor = init_predictor(pred_cfg, generator, device=dev)
    return state_from_modules(encoder, predictor)


def state_from_modules(encoder: VisionTransformer, predictor: Predictor,
                       target: Optional[VisionTransformer] = None, step: int = 0,
                       mu=None, nu=None) -> TrainState:
    """A TrainState around existing modules (target defaults to a copy of
    the encoder, moments to zeros)."""
    target = copy.deepcopy(encoder) if target is None else target
    target.requires_grad_(False)
    state = TrainState(step, encoder, predictor, target, {}, {})
    params = state.named_params()
    state.mu = mu if mu is not None else {n: torch.zeros_like(p) for n, p in params.items()}
    state.nu = nu if nu is not None else {n: torch.zeros_like(p) for n, p in params.items()}
    return state


def shard_state_(state: TrainState, layout: Layout) -> TrainState:
    """Keep only this rank's ZeRO-1 slices of the AdamW moments
    (``zero1_plan`` at ``layout.fsdp``), as contiguous tensors; a no-op
    at fsdp 1."""
    if layout.fsdp > 1:
        plan = zero1_plan(state.named_params(), layout.fsdp, layout.min_size_to_shard)
        for moments in (state.mu, state.nu):
            for n, ax in plan.items():
                moments[n] = shard(moments[n], ax, layout).contiguous()
    return state


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, step), so the draws of
    a step depend on no earlier step (resume replays nothing)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed * 1_000_003 + step)
    return gen


MaskSampler = Callable[[int, int, torch.device], Tuple[List[torch.Tensor], List[torch.Tensor]]]
NoiseSampler = Callable[[int, int, Tuple[int, int, int], torch.device],
                        Tuple[torch.Tensor, torch.Tensor]]


def build_train_step(
    enc_cfg: ViTCfg,
    pred_cfg: PredictorCfg,
    train_cfg: TrainCfg,
    lr_sched: WarmupCosine,
    wd_sched: CosineWD,
    mom_sched: LinearMomentum,
    mask_specs: Sequence[MaskSpec],
    grid: MaskGrid,
    keep_counts: Sequence[Tuple[int, int]],
    mask_sampler: Optional[MaskSampler] = None,
    layout: Optional[Layout] = None,
    noise_sampler: Optional[NoiseSampler] = None,
):
    """Returns step_fn(state, batch) -> (state, metrics).

    batch: {"clips": [B*num_clips, T, H, W, C] float, normalized}; in
    padded mode also "masks_enc" / "masks_pred" ([B, cap] int per mask
    config) and "enc_weights" / "pred_weights" ([B, cap] float validity).
    ``mask_specs`` are ``MaskSpec`` (fixed, padded) or ``TubeSpec``
    (tube). ``mask_sampler(step, batch_size, device) -> (masks_enc,
    masks_pred)`` replaces the default sampler of the fixed and tube modes
    (a test seam: parity tests hand in the JAX package's masks); the
    default draws from a generator seeded with (seed, step), so the masks
    of a step do not depend on earlier steps. ``noise_sampler(step, i,
    shape, device) -> (t, n)`` does the same for the diffusion-mode
    predictor's draws of mask config i (``diffusion_draws``; the default
    draws from a fresh generator seeded with (seed + 2, step) for each i).
    Under a distributed ``layout`` the samplers are asked for the global
    batch's draws and the step keeps this rank's rows.
    """
    if train_cfg.mask_mode not in ("fixed", "padded", "tube"):
        raise ValueError(f"unknown mask_mode {train_cfg.mask_mode!r}: "
                         "'fixed', 'padded' or 'tube'")

    def default_sampler(step, batch_size, device):
        gen = step_generator(train_cfg.seed, step, device)
        if train_cfg.mask_mode == "tube":
            masks = [sample_tube_masks(gen, batch_size, spec, grid) for spec in mask_specs]
            return [m[0] for m in masks], [m[1] for m in masks]
        return sample_masks_for_specs(gen, batch_size, mask_specs, grid, keep_counts)

    def default_noise(step, i, shape, device):
        return diffusion_draws(step_generator(train_cfg.seed + 2, step, device), shape, device)

    sampler = mask_sampler or default_sampler
    noise_sampler = noise_sampler or default_noise
    diffusion = not pred_cfg.use_mask_tokens
    layout = layout or Layout()
    world, rank, dp = layout.world, layout.rank, layout.distributed
    padded = train_cfg.mask_mode == "padded"
    zero1 = []  # [(layout, shard axes)] once the first step has seen the params
    tgt_cfg = dataclasses.replace(enc_cfg, fused_mlp=True)  # grad-free: H3
    b1, b2 = train_cfg.betas
    masks_of_decay = {}

    def qkv_grad_stats(blocks, prefix) -> Dict[str, torch.Tensor]:
        """Per-layer qkv grad norms (reference grad_logger): first, last,
        min, max."""
        norms = torch.stack([blk.attn.qkv.weight.grad.float().norm() for blk in blocks])
        return {f"{prefix}_qkv_first": norms[0], f"{prefix}_qkv_last": norms[-1],
                f"{prefix}_qkv_min": norms.min(), f"{prefix}_qkv_max": norms.max()}

    def step_fn(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        step = state.step
        lr = lr_sched(step + 1)
        wd = wd_sched(step + 1)
        momentum = mom_sched(step)
        clips = batch["clips"]
        total_b = clips.shape[0]
        sample_b = total_b // train_cfg.num_clips
        dev = clips.device
        if padded:
            masks_enc, masks_pred = batch["masks_enc"], batch["masks_pred"]
            enc_w = [torch.as_tensor(w, device=dev) for w in batch["enc_weights"]]
            pred_w = [torch.as_tensor(w, device=dev) for w in batch["pred_weights"]]
        elif dp:  # the global batch's masks, this rank's rows
            masks_enc, masks_pred = sampler(step, sample_b * world, dev)
            masks_enc = [rank_rows(m, rank, world) for m in masks_enc]
            masks_pred = [rank_rows(m, rank, world) for m in masks_pred]
            enc_w = [None] * len(masks_enc)
            pred_w = [None] * len(masks_pred)
        else:
            masks_enc, masks_pred = sampler(step, sample_b, dev)
            enc_w = [None] * len(masks_enc)
            pred_w = [None] * len(masks_pred)
        masks_enc = [torch.as_tensor(m, device=dev) for m in masks_enc]
        masks_pred = [torch.as_tensor(m, device=dev) for m in masks_pred]
        if train_cfg.num_clips > 1:
            rep = lambda m: (None if m is None else
                             repeat_interleave_batch(m, sample_b, train_cfg.num_clips))
            masks_enc = [rep(m) for m in masks_enc]
            masks_pred = [rep(m) for m in masks_pred]
            enc_w = [rep(w) for w in enc_w]
            pred_w = [rep(w) for w in pred_w]
        kv_enc = [None if w is None else w > 0.5 for w in enc_w]
        kv_pred = [None if w is None else w > 0.5 for w in pred_w]

        # target features, no gradients: full forward, feature LN, gather
        with torch.no_grad():
            h = layer_norm_targets(vit_forward(state.target, clips, cfg=tgt_cfg))
            targets = [gather_tokens(h, m) for m in masks_pred]
            del h

        params = state.named_params()
        for p in params.values():
            p.grad = None
        preds = []
        for i, (me, mp) in enumerate(zip(masks_enc, masks_pred)):
            z = vit_forward(state.encoder, clips, cfg=enc_cfg, masks=me, kv_mask=kv_enc[i])
            tgt = noise = None
            if diffusion:  # the global batch's draws, this rank's rows
                tgt = targets[i]
                b, k = tgt.shape[:2]
                shape = (b * world if dp else b, k, pred_cfg.predictor_embed_dim)
                noise = noise_sampler(step, i, shape, dev)
                if dp:
                    noise = tuple(rank_rows(a, rank, world) for a in noise)
            preds.append(predictor_forward(state.predictor, z, me, mp, mask_index=i,
                                           cfg=pred_cfg, kv_mask_ctxt=kv_enc[i],
                                           kv_mask_tgt=kv_pred[i], tgt=tgt, noise=noise))
        denoms = None
        if padded and dp:  # each config's weight sum over the global batch
            denoms = torch.stack([w.float().sum() * t.shape[-1]
                                  for w, t in zip(pred_w, targets)])
            pdist.all_reduce_([denoms])
            denoms = list(denoms.unbind())
        l_jepa = jepa_loss(preds, targets, train_cfg.loss_exp, pred_w, denoms)
        if train_cfg.reg_coeff != 0.0:
            l_reg = variance_reg(preds, pred_w)
        else:  # metric only: no gradient path through the regularizer
            with torch.no_grad():
                l_reg = variance_reg([p.detach() for p in preds], pred_w)
        if denoms is None:
            loss = l_jepa + train_cfg.reg_coeff * l_reg
        else:  # this rank's share of the global loss: the shares are summed
            loss = l_jepa + train_cfg.reg_coeff * (l_reg / world)
        loss.backward()
        del preds, targets

        names = list(params)
        grads = [params[n].grad if params[n].grad is not None
                 else torch.zeros_like(params[n]) for n in names]
        if dp:
            for n, g in zip(names, grads):
                params[n].grad = g  # the qkv statistics read the reduced .grad
            pdist.all_reduce_(grads, "sum" if padded else "mean")
        stats = {**qkv_grad_stats(state.encoder.blocks, "enc"),
                 **qkv_grad_stats(state.predictor.predictor_blocks, "pred")}
        enc_idx = [i for i, n in enumerate(names) if n.startswith("encoder.")]
        pred_idx = [i for i, n in enumerate(names) if n.startswith("predictor.")]
        g_enc = [grads[i] for i in enc_idx]
        g_pred = [grads[i] for i in pred_idx]
        if train_cfg.clip_grad is not None:
            clip_on = step >= train_cfg.clip_after_step
            enc_norm = clip_by_global_norm(g_enc, train_cfg.clip_grad, clip_on)
            pred_norm = clip_by_global_norm(g_pred, train_cfg.clip_grad, clip_on)
        else:
            enc_norm, pred_norm = global_norm(g_enc), global_norm(g_pred)

        if not masks_of_decay:
            masks_of_decay.update(decay_mask(state.encoder, "encoder."))
            masks_of_decay.update(decay_mask(state.predictor, "predictor."))
            if layout.fsdp > 1:
                plan = zero1_plan(params, layout.fsdp, layout.min_size_to_shard)
                for n, ax in plan.items():
                    if state.mu[n].shape != shard(params[n], ax, layout).shape:
                        raise ValueError(f"fsdp={layout.fsdp}: the moments of {n} are not "
                                         "this rank's ZeRO-1 slice (shard_state_)")
                zero1.append((layout, [plan[n] for n in names]))
        with torch.no_grad():
            opt_stats = adamw_update_(
                [params[n] for n in names], grads,
                [state.mu[n] for n in names], [state.nu[n] for n in names],
                [masks_of_decay[n] for n in names], names,
                lr=float(lr), wd=float(wd), step=step + 1,
                b1=b1, b2=b2, eps=train_cfg.eps, zero1=zero1[0] if zero1 else None)
            ema_update_(list(state.target.parameters()),
                        list(state.encoder.parameters()), float(momentum))
        for p in params.values():
            p.grad = None
        state.step = step + 1

        flat = clips.reshape(total_b, -1).float()
        input_var = flat.var(dim=1, unbiased=True)
        l_jepa, l_reg, loss = l_jepa.detach(), l_reg.detach(), loss.detach()
        ivar, ivar_min = input_var.mean(), input_var.min()
        if dp:  # the global batch's values on every rank
            pdist.all_reduce_([l_jepa], "sum" if padded else "mean")
            pdist.all_reduce_([l_reg, ivar], "mean")
            pdist.all_reduce_([ivar_min], "min")
            loss = l_jepa + train_cfg.reg_coeff * l_reg
        metrics = {
            "loss": loss,
            "loss_jepa": l_jepa,
            "loss_reg": l_reg,
            "lr": lr,
            "wd": wd,
            "ema_momentum": momentum,
            "enc_grad_norm": enc_norm,
            "pred_grad_norm": pred_norm,
            "input_var": ivar,
            "input_var_min": ivar_min,
            **opt_stats,
            **stats,
        }
        return state, metrics

    return step_fn
