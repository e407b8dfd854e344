"""One V-JEPA pretraining update (counterpart of
jepa_tpu/train/step.py::build_train_step; reference app/vjepa/train.py:414-498).

    state = init_train_state(enc_cfg, pred_cfg, generator)        # device="cuda"
    step_fn = build_train_step(enc_cfg, pred_cfg, train_cfg, lr_sched,
                               wd_sched, mom_sched, mask_specs, grid, keep_counts)
    state, metrics = step_fn(state, {"clips": clips})             # [B, T, H, W, C]

The update, in the JAX package's order: masks for this step; the target
forward without gradients (fused fc1 + GELU, H3, on the card) with the
feature LayerNorm and the gather at the target indices; for each mask
config the context encoder on the kept tokens and the predictor over
[context || mask tokens]; the L1 loss (plus the variance regularizer when
its coefficient is not 0); the backward (H1's saved outputs feed H2 on the
card); per-module gradient clipping gated by ``clip_after_step``; AdamW
with the decay mask; the EMA of the target. lr and wd are read at
``step + 1``, the momentum at ``step``.

Mask modes: ``fixed`` samples exact-K masks from (seed, step) on the
clips' device; ``padded`` takes the host collator's padded masks and
validity weights from the batch (jepa_tpu/train/step.py:214-236): the key
mask of the context encoder and the predictor is w > 0.5, and the loss
and the variance regularizer are weighted. The tube mode is not ported.

The state holds fp32 master parameters in modules, the target as a copy
of the encoder, and the AdamW moments; the step updates it IN PLACE and
returns it.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from jepa_tpu_torch.masks.multiblock3d import MaskGrid, MaskSpec, sample_masks_for_specs
from jepa_tpu_torch.models.predictor import Predictor, PredictorCfg, init_predictor, predictor_forward
from jepa_tpu_torch.models.vit import ViTCfg, VisionTransformer, init_vit, vit_forward
from jepa_tpu_torch.ops.masking import gather_tokens, repeat_interleave_batch
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
    mask_mode: str = "fixed"
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


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, step), so the draws of
    a step depend on no earlier step (resume replays nothing)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed * 1_000_003 + step)
    return gen


MaskSampler = Callable[[int, int, torch.device], Tuple[List[torch.Tensor], List[torch.Tensor]]]


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
):
    """Returns step_fn(state, batch) -> (state, metrics).

    batch: {"clips": [B*num_clips, T, H, W, C] float, normalized}; in
    padded mode also "masks_enc" / "masks_pred" ([B, cap] int per mask
    config) and "enc_weights" / "pred_weights" ([B, cap] float validity).
    ``mask_sampler(step, batch_size, device) -> (masks_enc, masks_pred)``
    replaces the default fixed-mode sampler (a test seam: parity tests
    hand in the JAX package's masks); the default draws from a generator
    seeded with (seed, step), so the masks of a step do not depend on
    earlier steps.
    """
    if train_cfg.mask_mode not in ("fixed", "padded"):
        raise NotImplementedError(f"mask_mode {train_cfg.mask_mode!r}: only "
                                  "'fixed' and 'padded' are ported (tube: ROADMAP "
                                  "Queue 1)")

    def default_sampler(step, batch_size, device):
        gen = step_generator(train_cfg.seed, step, device)
        return sample_masks_for_specs(gen, batch_size, mask_specs, grid, keep_counts)

    sampler = mask_sampler or default_sampler
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
        if train_cfg.mask_mode == "padded":
            masks_enc, masks_pred = batch["masks_enc"], batch["masks_pred"]
            enc_w = [torch.as_tensor(w, device=dev) for w in batch["enc_weights"]]
            pred_w = [torch.as_tensor(w, device=dev) for w in batch["pred_weights"]]
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
            z = vit_forward(state.encoder, clips, masks=me, kv_mask=kv_enc[i])
            preds.append(predictor_forward(state.predictor, z, me, mp, mask_index=i,
                                           kv_mask_ctxt=kv_enc[i], kv_mask_tgt=kv_pred[i]))
        l_jepa = jepa_loss(preds, targets, train_cfg.loss_exp, pred_w)
        if train_cfg.reg_coeff != 0.0:
            l_reg = variance_reg(preds, pred_w)
        else:  # metric only: no gradient path through the regularizer
            with torch.no_grad():
                l_reg = variance_reg([p.detach() for p in preds], pred_w)
        loss = l_jepa + train_cfg.reg_coeff * l_reg
        loss.backward()
        del preds, targets

        stats = {**qkv_grad_stats(state.encoder.blocks, "enc"),
                 **qkv_grad_stats(state.predictor.predictor_blocks, "pred")}
        names = list(params)
        grads = [params[n].grad if params[n].grad is not None
                 else torch.zeros_like(params[n]) for n in names]
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
        with torch.no_grad():
            opt_stats = adamw_update_(
                [params[n] for n in names], grads,
                [state.mu[n] for n in names], [state.nu[n] for n in names],
                [masks_of_decay[n] for n in names], names,
                lr=float(lr), wd=float(wd), step=step + 1,
                b1=b1, b2=b2, eps=train_cfg.eps)
            ema_update_(list(state.target.parameters()),
                        list(state.encoder.parameters()), float(momentum))
        for p in params.values():
            p.grad = None
        state.step = step + 1

        flat = clips.reshape(total_b, -1).float()
        input_var = flat.var(dim=1, unbiased=True)
        metrics = {
            "loss": loss.detach(),
            "loss_jepa": l_jepa.detach(),
            "loss_reg": l_reg.detach(),
            "lr": lr,
            "wd": wd,
            "ema_momentum": momentum,
            "enc_grad_norm": enc_norm,
            "pred_grad_norm": pred_norm,
            "input_var": input_var.mean(),
            "input_var_min": input_var.min(),
            **opt_stats,
            **stats,
        }
        return state, metrics

    return step_fn
