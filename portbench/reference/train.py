"""V-JEPA pretraining updates in plain PyTorch, fp32 (reference
app/vjepa/train.py and the V-JEPA paper): per update the target encoder's
features (final LayerNorm, then a LayerNorm without affine, eps 1e-5) at
each mask config's targets; the context encoder over the kept tokens; the
predictor; the L1 loss averaged over the mask configs; the backward;
per-module gradient clipping once past the warm-up epochs; AdamW (decoupled
decay of the tensors of two or more dims, bias-corrected moments); the EMA
of the target. lr and wd of update i are the schedules' values at i + 1,
the momentum at i.

The gradient of the whole batch is summed over blocks of rows, so that the
activations of one block fit; the loss is the mean over the whole batch.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

from portbench.reference import vjepa
from portbench.reference.numerics import Numerics


def schedules(opt: dict, step: int):
    """(lr, wd, momentum) of update ``step`` (0-indexed) from a config's
    ``optimization`` section (reference src/utils/schedulers.py)."""
    ipe, epochs, scale = opt["ipe"], opt["epochs"], opt["ipe_scale"]
    t_max = int(scale * epochs * ipe)
    warm = int(opt["warmup"] * ipe)
    i = step + 1
    if i < warm:
        lr = opt["start_lr"] + i / max(1, warm) * (opt["lr"] - opt["start_lr"])
    else:
        prog = (i - warm) / max(1, t_max - warm)
        lr = max(opt["final_lr"], opt["final_lr"] + (opt["lr"] - opt["final_lr"])
                 * 0.5 * (1.0 + math.cos(math.pi * prog)))
    wd = opt["final_weight_decay"] + (opt["weight_decay"] - opt["final_weight_decay"]) * 0.5 * (
        1.0 + math.cos(math.pi * i / t_max))
    wd = max(wd, opt["final_weight_decay"]) if opt["final_weight_decay"] <= opt["weight_decay"] \
        else min(wd, opt["final_weight_decay"])
    ema0, ema1 = opt["ema"]
    mom = ema0 + step * (ema1 - ema0) / t_max
    return lr, wd, mom


class Trainer:
    """fp32 master weights of the encoder and the predictor, the target, and
    the AdamW moments; ``update(batch)`` runs one update."""

    def __init__(self, cfg: dict, enc: Dict[str, torch.Tensor], pred: Dict[str, torch.Tensor],
                 num: Numerics, rows: int, step: int):
        self.cfg, self.num, self.rows = cfg, num, rows
        self.params = {**{f"encoder.{k}": v.float().clone().requires_grad_(True)
                          for k, v in enc.items()},
                       **{f"predictor.{k}": v.float().clone().requires_grad_(True)
                          for k, v in pred.items()}}
        self.target = {k: v.float().clone() for k, v in enc.items()}
        self.mu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.step = step
        self.module_norms = []  # each update's pre-clip (encoder, predictor) norms

    def _module(self, prefix: str) -> Dict[str, torch.Tensor]:
        n = len(prefix) + 1
        return {k[n:]: v for k, v in self.params.items() if k.startswith(prefix + ".")}

    def loss_and_grads(self, clips: torch.Tensor, masks_enc: Sequence[torch.Tensor],
                       masks_pred: Sequence[torch.Tensor]) -> float:
        """The batch's loss; the gradients land in ``.grad``."""
        m, pr, num = self.cfg["model"], self.cfg["predictor"], self.num
        enc, pred = self._module("encoder"), self._module("predictor")
        bsz, d, total = clips.shape[0], m["embed_dim"], 0.0
        for p in self.params.values():
            p.grad = None
        for lo in range(0, bsz, self.rows):
            rows = slice(lo, lo + self.rows)
            x = clips[rows]
            with torch.no_grad():
                h = vjepa.encoder(num, self.target, m, x)
                h = torch.nn.functional.layer_norm(h, (d,), eps=1e-5)
            loss = 0.0
            for i, (me, mp) in enumerate(zip(masks_enc, masks_pred)):
                tgt = torch.gather(h, 1, mp[rows][:, :, None].expand(-1, -1, d))
                z = vjepa.encoder(num, enc, m, x, keep=me[rows])
                out = vjepa.predictor(num, pred, m, pr, z, me[rows], mp[rows], i)
                loss = loss + (out - tgt).abs().sum() / (bsz * mp.shape[1] * d)
            loss = loss / len(masks_enc)
            loss.backward()
            total += float(loss.detach())
        return total

    @torch.no_grad()
    def apply(self) -> None:
        """Clip, AdamW, EMA; advances the step."""
        opt = self.cfg["train"]["optimization"]
        lr, wd, mom = schedules(opt, self.step)
        b1, b2, eps = 0.9, 0.999, 1e-8
        clip_after = int((opt["warmup"] + 1) * opt["ipe"])
        norms = []
        for prefix in ("encoder.", "predictor."):
            grads = [p.grad for k, p in self.params.items() if k.startswith(prefix)]
            norms.append(float(torch.linalg.vector_norm(torch.stack([g.norm() for g in grads]))))
            if self.step >= clip_after and norms[-1] > opt["clip_grad"]:
                for g in grads:
                    g.mul_(opt["clip_grad"] / (norms[-1] + 1e-6))
        self.module_norms.append(tuple(norms))
        t = self.step + 1
        for k, p in self.params.items():
            g = p.grad
            if p.dim() >= 2:
                p.mul_(1.0 - lr * wd)
            self.mu[k].mul_(b1).add_(g, alpha=1.0 - b1)
            self.nu[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            den = (self.nu[k] / (1.0 - b2**t)).sqrt_().add_(eps)
            p.sub_(lr * (self.mu[k] / (1.0 - b1**t)) / den)
        for k, v in self.target.items():
            v.mul_(mom).add_(self.params[f"encoder.{k}"], alpha=1.0 - mom)
        for p in self.params.values():
            p.grad = None
        self.step += 1

    def state(self) -> Dict[str, torch.Tensor]:
        """Every leaf: "encoder.*", "predictor.*", "target.*"."""
        out = {k: v.detach() for k, v in self.params.items()}
        out.update({f"target.{k}": v for k, v in self.target.items()})
        return out


def run(cfg: dict, enc, pred, batches: List, num: Numerics, rows: int, start_step: int,
        on_first_grads=None) -> Dict:
    """Follow ``len(batches)`` updates from (enc, pred) at step counter
    ``start_step`` (fresh moments); batches are (clips, masks_enc,
    masks_pred). ``on_first_grads(trainer)`` sees the first update's
    gradients before they are applied. Returns the losses, each update's
    pre-clip norms and the trainer."""
    tr = Trainer(cfg, enc, pred, num, rows, start_step)
    losses = []
    for i, (clips, me, mp) in enumerate(batches):
        losses.append(tr.loss_and_grads(clips, me, mp))
        if i == 0 and on_first_grads is not None:
            on_first_grads(tr)
        tr.apply()
    return {"losses": losses, "module_norms": tr.module_norms, "trainer": tr}
