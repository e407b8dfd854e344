"""Training schedules as pure functions of the update step (counterpart of
jepa_tpu/utils/schedulers.py; reference src/utils/schedulers.py:11-76).

Every schedule is evaluated in fp32, as the JAX versions are, and returns
a 0-d fp32 tensor on the CPU. Step convention: ``lr_sched(i + 1)`` and
``wd_sched(i + 1)`` give the values of update ``i``; the EMA momentum of
update ``i`` is ``mom_sched(i)``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

_F32 = torch.float32


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=_F32)


@dataclasses.dataclass(frozen=True)
class WarmupCosine:
    """Linear warmup ``start_lr -> ref_lr``, then cosine decay to
    ``final_lr``; ``t_max`` includes the warmup."""

    warmup_steps: int
    start_lr: float
    ref_lr: float
    t_max: int
    final_lr: float = 0.0

    def __call__(self, step) -> torch.Tensor:
        step = _f32(step)
        warm = _f32(max(1, self.warmup_steps))
        warm_lr = self.start_lr + (step / warm) * (self.ref_lr - self.start_lr)
        cos_span = _f32(max(1, self.t_max - self.warmup_steps))
        progress = (step - self.warmup_steps) / cos_span
        cos_lr = self.final_lr + (self.ref_lr - self.final_lr) * 0.5 * (
            1.0 + torch.cos(math.pi * progress))
        cos_lr = torch.clamp(cos_lr, min=self.final_lr)
        return torch.where(step < self.warmup_steps, warm_lr, cos_lr)


@dataclasses.dataclass(frozen=True)
class CosineWD:
    """Cosine weight decay ``ref_wd -> final_wd`` over ``t_max``, clamped
    toward ``final_wd`` from whichever side it starts."""

    ref_wd: float
    t_max: int
    final_wd: float = 0.0

    def __call__(self, step) -> torch.Tensor:
        progress = _f32(step) / _f32(self.t_max)
        wd = self.final_wd + (self.ref_wd - self.final_wd) * 0.5 * (
            1.0 + torch.cos(math.pi * progress))
        if self.final_wd <= self.ref_wd:
            return torch.clamp(wd, min=self.final_wd)
        return torch.clamp(wd, max=self.final_wd)


@dataclasses.dataclass(frozen=True)
class LinearMomentum:
    """EMA momentum ramp ``ema0 -> ema1`` over ``total`` steps (0-indexed)."""

    ema0: float
    ema1: float
    total: int

    def __call__(self, step) -> torch.Tensor:
        return self.ema0 + _f32(step) * (self.ema1 - self.ema0) / _f32(self.total)


def build_schedules(
    *,
    ipe: int,
    num_epochs: int,
    warmup_epochs: float,
    start_lr: float,
    ref_lr: float,
    final_lr: float,
    wd: float,
    final_wd: float,
    ema: Tuple[float, float],
    ipe_scale: float = 1.0,
) -> Tuple[WarmupCosine, CosineWD, LinearMomentum]:
    """The three pretrain schedules from config values (reference
    app/vjepa/utils.py:init_opt and the momentum generator of
    app/vjepa/train.py)."""
    t_max = int(ipe_scale * num_epochs * ipe)
    lr_sched = WarmupCosine(warmup_steps=int(warmup_epochs * ipe), start_lr=start_lr,
                            ref_lr=ref_lr, final_lr=final_lr, t_max=t_max)
    wd_sched = CosineWD(ref_wd=wd, final_wd=final_wd, t_max=t_max)
    mom_sched = LinearMomentum(ema0=ema[0], ema1=ema[1], total=t_max)
    return lr_sched, wd_sched, mom_sched
