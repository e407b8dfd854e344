"""V-JEPA losses (counterpart of jepa_tpu/train/losses.py; reference
app/vjepa/train.py:440-459).

  * jepa loss: mean(|pred - target|^loss_exp) / loss_exp, averaged over
    the mask configs (loss_exp = 1 is L1);
  * variance regularizer: mean(relu(1 - mean_i sqrt(var_tokens(pred_i) +
    1e-4))), the variance over the token axis, unbiased;
  * target LayerNorm over the feature dim, no affine, eps 1e-5.

Optional per-token validity weights serve the padded mode.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from jepa_tpu_torch.ops.masking import masked_mean


def jepa_loss(preds: List[torch.Tensor], targets: List[torch.Tensor],
              loss_exp: float = 1.0,
              weights: Optional[List[Optional[torch.Tensor]]] = None,
              denoms: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """preds/targets: per-mask-config lists of [B, K, D] fp32. ``denoms``:
    per mask config, the normalizer of the weighted mean (``masked_mean``'s
    ``denom``; data-parallel ranks pass the global batch's)."""
    weights = weights or [None] * len(preds)
    denoms = denoms or [None] * len(preds)
    total = 0.0
    for z, h, w, den in zip(preds, targets, weights, denoms):
        err = (z.float() - h.float()).abs()
        if loss_exp != 1.0:
            err = err**loss_exp
        total = total + masked_mean(err, w, denom=den) / loss_exp
    return total / len(preds)


def variance_reg(preds: List[torch.Tensor],
                 weights: Optional[List[Optional[torch.Tensor]]] = None) -> torch.Tensor:
    """Penalize collapsed (low token-variance) predictions."""
    weights = weights or [None] * len(preds)
    pstd = 0.0
    for z, w in zip(preds, weights):
        zf = z.float()
        if w is None:
            var = zf.var(dim=1, unbiased=True)  # [B, D]
        else:
            wf = w[..., None].float()
            cnt = wf.sum(dim=1).clamp(min=2.0)
            mean = (zf * wf).sum(dim=1) / cnt
            var = (wf * (zf - mean[:, None, :]) ** 2).sum(dim=1) / (cnt - 1.0)
        pstd = pstd + torch.sqrt(var + 1e-4)
    pstd = pstd / len(preds)
    return torch.relu(1.0 - pstd).mean()


def layer_norm_targets(h: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Feature-dim LayerNorm without affine, fp32 (reference train.py:424)."""
    hf = h.float()
    mean = hf.mean(dim=-1, keepdim=True)
    var = (hf - mean).square().mean(dim=-1, keepdim=True)
    return (hf - mean) * torch.rsqrt(var + eps)
