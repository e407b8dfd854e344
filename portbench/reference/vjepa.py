"""V-JEPA's models in plain PyTorch, fp32, over dicts of leaves named as the
reference zoo names them (portbench/weights.py), following the V-JEPA paper
(arXiv:2404.08471) and its reference code:

  * the encoder: a tubelet patch embedding (the zoo's Conv3d, kernel =
    stride, as a reshape and one product), the fixed 3-D sin-cos position
    table (``uniform_power``: depth, height and width each get ceil(D/6)*2
    channels, cut to D), token drop at the context indices, pre-LN blocks
    (multi-head softmax attention, GELU MLP with the exact erf), a final
    LayerNorm;
  * the predictor: embed to its width, the sin-cos table at its width
    gathered at the context and target indices, the mask token of the mask
    config added at the targets, pre-LN blocks over [context || targets],
    LayerNorm, projection back, the outputs at the targets. (The reference
    sorts the tokens by position first; attention without a mask is
    permutation-equivariant, so the outputs are the same.)
  * the attentive probe: one query token cross-attends over the LayerNormed
    features (no output projection), a residual MLP, a linear head.

Attention is computed in blocks of rows of the batch by the callers, so the
full score matrices of one block fit.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.numerics import Numerics

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _sincos_1d(dim: int, pos: np.ndarray) -> np.ndarray:
    omega = 1.0 / 10000 ** (np.arange(dim // 2, dtype=np.float64) / (dim / 2.0))
    out = pos.reshape(-1).astype(np.float64)[:, None] * omega[None]
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def sincos_3d(dim: int, grid: int, depth: int, uniform_power: bool) -> torch.Tensor:
    """[depth * grid * grid, dim] fp32, rows (t, h, w) row-major."""
    tt, hh, ww = np.meshgrid(np.arange(depth), np.arange(grid), np.arange(grid), indexing="ij")
    if uniform_power:
        dims = [int(math.ceil(dim / 6) * 2)] * 3
    else:
        dims = [dim // 2, dim // 4, dim // 4]
    table = np.concatenate([_sincos_1d(d, a) for d, a in zip(dims, (tt, hh, ww))], axis=1)
    return torch.from_numpy(table[:, :dim].astype(np.float32))


def _linear(num: Numerics, x, w, b):
    return num.mm(x, w.t()) + b


def _ln(x, w, b, eps):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def _attention(num: Numerics, x, p, pre, heads):
    bsz, n, d = x.shape
    c = d // heads
    qkv = _linear(num, x, p[f"{pre}.qkv.weight"], p[f"{pre}.qkv.bias"])
    q, k, v = qkv.reshape(bsz, n, 3, heads, c).permute(2, 0, 3, 1, 4)
    s = num.mm(q, k.transpose(-1, -2)) * c**-0.5
    o = num.mm(torch.softmax(s, dim=-1), v).transpose(1, 2).reshape(bsz, n, d)
    return _linear(num, o, p[f"{pre}.proj.weight"], p[f"{pre}.proj.bias"])


def block(num: Numerics, x, p, pre, heads, eps):
    x = x + _attention(num, _ln(x, p[f"{pre}.norm1.weight"], p[f"{pre}.norm1.bias"], eps), p,
                       f"{pre}.attn", heads)
    h = _ln(x, p[f"{pre}.norm2.weight"], p[f"{pre}.norm2.bias"], eps)
    h = F.gelu(_linear(num, h, p[f"{pre}.mlp.fc1.weight"], p[f"{pre}.mlp.fc1.bias"]))
    return x + _linear(num, h, p[f"{pre}.mlp.fc2.weight"], p[f"{pre}.mlp.fc2.bias"])


def _blocks(num, x, p, prefix, depth, heads, eps):
    for i in range(depth):
        x = block(num, x, p, f"{prefix}.{i}", heads, eps)
    return x


def patchify(clips: torch.Tensor, patch: int, tubelet: int) -> torch.Tensor:
    """[B, T, H, W, C] -> [B, N, C * tubelet * patch * patch], tokens (t, h, w)
    row-major, each vector in the Conv3d weight's (C, t, ph, pw) order."""
    b, t, h, w, c = clips.shape
    x = clips.reshape(b, t // tubelet, tubelet, h // patch, patch, w // patch, patch, c)
    x = x.permute(0, 1, 3, 5, 7, 2, 4, 6)
    return x.reshape(b, -1, c * tubelet * patch * patch)


def encoder(num: Numerics, p: Dict[str, torch.Tensor], m: dict, clips: torch.Tensor,
            keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """clips [B, T, H, W, 3] normalized -> [B, N or K, D]."""
    d = m["embed_dim"]
    x = patchify(clips.float(), m["patch_size"], m["tubelet_size"])
    x = _linear(num, x, p["patch_embed.proj.weight"].reshape(d, -1), p["patch_embed.proj.bias"])
    pe = sincos_3d(d, m["img_size"] // m["patch_size"], m["num_frames"] // m["tubelet_size"],
                   m["uniform_power"]).to(x.device)
    x = x + pe
    if keep is not None:
        x = torch.gather(x, 1, keep[:, :, None].expand(-1, -1, d))
    x = _blocks(num, x, p, "blocks", m["depth"], m["num_heads"], m["ln_eps"])
    return _ln(x, p["norm.weight"], p["norm.bias"], m["ln_eps"])


def predictor(num: Numerics, p: Dict[str, torch.Tensor], m: dict, pr: dict, ctx: torch.Tensor,
              keep_ctx: torch.Tensor, keep_tgt: torch.Tensor, mask_index: int) -> torch.Tensor:
    """Predicted target features [B, K_t, D]."""
    dp = pr["embed_dim"]
    pe = sincos_3d(dp, m["img_size"] // m["patch_size"], m["num_frames"] // m["tubelet_size"],
                   m["uniform_power"]).to(ctx.device)
    x = _linear(num, ctx, p["predictor_embed.weight"], p["predictor_embed.bias"])
    x = x + pe[keep_ctx]
    tok = p[f"mask_tokens.{mask_index % pr['num_mask_tokens']}"]
    seq = torch.cat([x, tok + pe[keep_tgt]], dim=1)
    seq = _blocks(num, seq, p, "predictor_blocks", pr["depth"], m["num_heads"], m["ln_eps"])
    seq = _ln(seq, p["predictor_norm.weight"], p["predictor_norm.bias"], m["ln_eps"])
    return _linear(num, seq[:, x.shape[1]:], p["predictor_proj.weight"], p["predictor_proj.bias"])


def normalize_uint8(clips: torch.Tensor) -> torch.Tensor:
    """uint8 frames -> ImageNet-normalized fp32."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=clips.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=clips.device)
    return (clips.float() / 255.0 - mean) / std


def probe(num: Numerics, p: Dict[str, torch.Tensor], m: dict, pb: dict,
          feats: torch.Tensor) -> torch.Tensor:
    """Logits [B, classes] of the attentive probe over features [B, N, D]."""
    d, heads, eps = m["embed_dim"], m["num_heads"], pb["ln_eps"]
    c = d // heads
    cab = "pooler.cross_attention_block"
    bsz, n, _ = feats.shape
    q = p["pooler.query_tokens"].expand(bsz, -1, -1)
    xn = _ln(feats, p[f"{cab}.norm1.weight"], p[f"{cab}.norm1.bias"], eps)
    qh = _linear(num, q, p[f"{cab}.xattn.q.weight"], p[f"{cab}.xattn.q.bias"])
    qh = qh.reshape(bsz, 1, heads, c).transpose(1, 2)
    kv = _linear(num, xn, p[f"{cab}.xattn.kv.weight"], p[f"{cab}.xattn.kv.bias"])
    k, v = kv.reshape(bsz, n, 2, heads, c).permute(2, 0, 3, 1, 4)
    s = num.mm(qh, k.transpose(-1, -2)) * c**-0.5
    y = num.mm(torch.softmax(s, dim=-1), v).transpose(1, 2).reshape(bsz, 1, d)
    q = q + y
    h = _ln(q, p[f"{cab}.norm2.weight"], p[f"{cab}.norm2.bias"], eps)
    h = F.gelu(_linear(num, h, p[f"{cab}.mlp.fc1.weight"], p[f"{cab}.mlp.fc1.bias"]))
    q = q + _linear(num, h, p[f"{cab}.mlp.fc2.weight"], p[f"{cab}.mlp.fc2.bias"])
    return _linear(num, q[:, 0], p["linear.weight"], p["linear.bias"])


@torch.no_grad()
def classify(num: Numerics, p_enc, p_probe, m: dict, pb: dict, clips_uint8: torch.Tensor,
             rows: int) -> torch.Tensor:
    """Softmax probabilities [B, classes] fp32 of uint8 clips, ``rows`` clips
    at a time."""
    out = []
    for i in range(0, clips_uint8.shape[0], rows):
        feats = encoder(num, p_enc, m, normalize_uint8(clips_uint8[i:i + rows]))
        out.append(torch.softmax(probe(num, p_probe, m, pb, feats), dim=-1))
    return torch.cat(out)
