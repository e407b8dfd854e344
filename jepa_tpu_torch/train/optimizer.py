"""AdamW with the decay mask, global-norm clipping and the EMA of the
target (counterpart of jepa_tpu/train/optimizer.py).

Semantics of the reference (torch.optim.AdamW and app/vjepa/utils.py:173-191):
decoupled decay applied to the parameters before the Adam step (p *= 1 -
lr*wd), bias-corrected moments, all in fp32; biases and LayerNorm
parameters are never decayed, every other parameter (mask tokens
included) follows the scheduled wd; gradients are clipped per module
(encoder and predictor separately).

Unlike the JAX package's pure functions, these update the parameters,
moments and gradients IN PLACE, with ``torch._foreach_*`` over lists of
fp32 tensors (a few fused launches per list instead of several per
parameter).

The moment statistics follow the JAX package's canonical stacked layout,
in which one leaf holds a block parameter kind for every layer (and one
leaf all mask tokens): they average the per-kind means.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence

import torch
import torch.nn as nn


def decay_mask(module: nn.Module, prefix: str = "") -> Dict[str, float]:
    """{parameter name: 1.0 where weight decay applies, else 0.0}: biases
    and LayerNorm parameters get 0 (jepa_tpu/train/optimizer.py:25-33)."""
    no_decay = set()
    for mname, mod in module.named_modules():
        if isinstance(mod, nn.LayerNorm):
            no_decay.update(f"{mname}.{p}" if mname else p for p, _ in mod.named_parameters())
    return {prefix + name: 0.0 if (name in no_decay or name.endswith("bias")) else 1.0
            for name, _ in module.named_parameters()}


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, fp32."""
    norms = torch._foreach_norm([g.float() for g in grads], 2)
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        enabled: bool) -> torch.Tensor:
    """torch.nn.utils.clip_grad_norm_ semantics, in place, without a host
    sync; ``enabled`` gates it (the reference's ``epoch > warmup``).
    Returns the pre-clip norm."""
    norm = global_norm(grads)
    if enabled:
        scale = torch.where(norm > max_norm, max_norm / (norm + 1e-6),
                            torch.ones_like(norm))
        torch._foreach_mul_(grads, scale)
    return norm


def _leaf_kind(name: str) -> str:
    """The stacked-layout leaf a parameter belongs to: layer and token
    indices dropped ("encoder.blocks.3.attn.qkv.weight" -> "encoder.blocks.attn.qkv.weight")."""
    return re.sub(r"\.\d+(?=\.|$)", "", name)


def adamw_update_(
    params: Sequence[torch.Tensor],
    grads: Sequence[torch.Tensor],
    mu: Sequence[torch.Tensor],
    nu: Sequence[torch.Tensor],
    decay: Sequence[float],
    names: Sequence[str],
    *,
    lr: float,
    wd: float,
    step: int,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    zero1=None,
) -> Dict[str, torch.Tensor]:
    """One AdamW step in place; ``step`` is the 1-indexed update count.
    lr and wd are fp32 values. Returns the moment statistics
    (``exp_avg_abs_mean``, ``exp_avg_sq_mean``) as 0-d tensors.

    ``zero1``: (``parallel.mesh.Layout``, shard axis or None per
    parameter), the sharded form (ZeRO-1): ``mu`` / ``nu`` hold only this
    rank's slice of each sharded parameter (``mesh.shard``); the step
    updates that slice of the parameter and all-gathers the parameter over
    the fsdp group, and the statistics sum the slices over it. AdamW is
    elementwise, so the parameters come out with the bits of the
    replicated step."""
    params, grads, mu, nu = list(params), list(grads), list(mu), list(nu)
    if zero1 is None:
        _adamw_math_(params, grads, mu, nu, decay, lr=lr, wd=wd, step=step, b1=b1, b2=b2,
                     eps=eps)
        return _moment_stats(mu, nu, [p.numel() for p in params], names)

    from jepa_tpu_torch.parallel import dist as pdist
    from jepa_tpu_torch.parallel.mesh import shard

    layout, axes = zero1
    cut = lambda ts: [t if ax is None else shard(t, ax, layout).contiguous()
                      for t, ax in zip(ts, axes)]
    local = cut(params)
    _adamw_math_(local, cut(grads), mu, nu, decay, lr=lr, wd=wd, step=step, b1=b1, b2=b2,
                 eps=eps)
    sharded = [i for i, ax in enumerate(axes) if ax is not None]
    parts = pdist.all_gather([local[i] for i in sharded], group=layout.fsdp_group)
    for j, i in enumerate(sharded):
        params[i].copy_(torch.cat([part[j] for part in parts], dim=axes[i]))

    def reduce_shards(sums):
        if sharded:
            flat = torch.stack([sums[i] for i in sharded])
            pdist.all_reduce_([flat], group=layout.fsdp_group)
            for j, i in enumerate(sharded):
                sums[i] = flat[j]
        return sums

    return _moment_stats(mu, nu, [p.numel() for p in params], names, reduce_shards)


def _adamw_math_(params, grads, mu, nu, decay, *, lr, wd, step, b1, b2, eps) -> None:
    """The AdamW arithmetic on lists of fp32 tensors, in place."""
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    stepf = f32(step)
    bc1 = float(1.0 - f32(b1) ** stepf)
    bc2 = float(1.0 - f32(b2) ** stepf)
    keep = float(1.0 - f32(lr) * f32(wd))
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, grads, alpha=1.0 - b1)
    torch._foreach_mul_(nu, b2)
    torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
    decayed = [p for p, d in zip(params, decay) if d]
    if decayed:
        torch._foreach_mul_(decayed, keep)
    denom = torch._foreach_div(nu, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    upd = torch._foreach_div(mu, bc1)
    torch._foreach_div_(upd, denom)
    torch._foreach_add_(params, upd, alpha=-float(lr))


def _moment_stats(mu, nu, sizes, names, reduce=None) -> Dict[str, torch.Tensor]:
    """The moments' mean |mu| and mean nu over the stacked-layout leaves;
    ``reduce`` (a list of per-parameter sums -> the same, summed over the
    shards) completes the sums of sharded moments."""
    abs_sums = list(torch._foreach_norm(mu, 1))
    sq_sums = list(torch._foreach_norm(nu, 1))  # nu >= 0: its L1 norm is its sum
    if reduce is not None:
        abs_sums, sq_sums = reduce(abs_sums), reduce(sq_sums)
    kinds: Dict[str, List[int]] = {}
    for i, name in enumerate(names):
        kinds.setdefault(_leaf_kind(name), []).append(i)
    am, sv = [], []
    for idx in kinds.values():
        size = sum(sizes[i] for i in idx)
        am.append(torch.stack([abs_sums[i] for i in idx]).sum() / size)
        sv.append(torch.stack([sq_sums[i] for i in idx]).sum() / size)
    return {"exp_avg_abs_mean": torch.stack(am).mean(),
            "exp_avg_sq_mean": torch.stack(sv).mean()}


def ema_update_(target: Sequence[torch.Tensor], online: Sequence[torch.Tensor],
                momentum: float) -> None:
    """k <- m*k + (1-m)*q in place, fp32 (reference train.py:483-487)."""
    m = torch.tensor(momentum, dtype=torch.float32)
    target = list(target)
    torch._foreach_mul_(target, float(m))
    torch._foreach_add_(target, list(online), alpha=float(1.0 - m))

