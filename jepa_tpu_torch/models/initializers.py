"""Weight initialization (counterpart of jepa_tpu/models/initializers.py).

The reference recipe: trunc-normal(std=0.02) weights clipped to [-2, 2],
zero biases, LayerNorm scale 1 and bias 0, and the residual-branch output
projections (attn.proj, mlp.fc2) of layer i (1-indexed) divided by
sqrt(2 * i). Draws come from an explicit ``torch.Generator``; they are not
the JAX package's draws (different generators), only the same
distribution.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def trunc_normal(
    shape: Sequence[int],
    generator: Optional[torch.Generator] = None,
    std: float = 0.02,
    mean: float = 0.0,
    a: float = -2.0,
    b: float = 2.0,
) -> torch.Tensor:
    """fp32 truncated normal by inverse CDF, on the generator's device:
    u ~ U[2*cdf(lo)-1, 2*cdf(hi)-1], erfinv, scale by std*sqrt(2), shift,
    clamp (jepa_tpu/models/initializers.py:23)."""
    lo = (1.0 + math.erf(((a - mean) / std) / math.sqrt(2.0))) / 2.0
    hi = (1.0 + math.erf(((b - mean) / std) / math.sqrt(2.0))) / 2.0
    device = generator.device if generator is not None else "cpu"
    x = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    x.uniform_(2 * lo - 1, 2 * hi - 1, generator=generator)
    x.erfinv_().mul_(std * math.sqrt(2.0)).add_(mean)
    return x.clamp_(a, b)


def residual_rescale(layer_id: int) -> float:
    """Divisor for residual-branch output projections; layer_id is 1-indexed."""
    return math.sqrt(2.0 * layer_id)


@torch.no_grad()
def init_linear_(linear: torch.nn.Linear, generator: Optional[torch.Generator],
                 std: float = 0.02, rescale: float = 1.0) -> None:
    """trunc-normal(std) / rescale weight, zero bias, in place."""
    w = trunc_normal(linear.weight.shape, generator, std=std)
    if rescale != 1.0:
        w = w / rescale
    linear.weight.copy_(w)
    if linear.bias is not None:
        linear.bias.zero_()


@torch.no_grad()
def init_layernorm_(ln: torch.nn.LayerNorm) -> None:
    ln.weight.fill_(1.0)
    ln.bias.zero_()
