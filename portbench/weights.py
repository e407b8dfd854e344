"""Seeded weights of the cells, made by the benchmark and handed to the
program and the reference alike.

A model's leaves are listed in the reference V-JEPA zoo's state-dict names
(which the port keeps); ``make`` draws every leaf of a list from one
generator on the device in one call: matrices ~ N(0, 0.02^2) (the residual
projections of layer i divided by sqrt(2 i), as the reference init does),
biases and the LayerNorms' shifts ~ N(0, 0.02^2), the LayerNorms' scales
1 + N(0, 0.02^2). Nonzero biases and shifts make a fault that drops one
show from the first step.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

STD = 0.02
Leaf = Tuple[str, Tuple[int, ...], str, float]  # name, shape, kind, divisor


def derive_seed(seed: int, *purpose) -> int:
    """A 63-bit seed for one purpose of one run, from the run's --seed."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF]
    words += [sum(ord(ch) << (8 * (i % 4)) for i, ch in enumerate(str(p))) for p in purpose]
    return int(np.random.SeedSequence(words).generate_state(2, np.uint64)[0] >> np.uint64(1))


def _block(prefix: str, dim: int, hidden: int, layer_id: int) -> List[Leaf]:
    r = math.sqrt(2.0 * layer_id)
    return [(f"{prefix}.norm1.weight", (dim,), "scale", 1.0),
            (f"{prefix}.norm1.bias", (dim,), "shift", 1.0),
            (f"{prefix}.attn.qkv.weight", (3 * dim, dim), "matrix", 1.0),
            (f"{prefix}.attn.qkv.bias", (3 * dim,), "shift", 1.0),
            (f"{prefix}.attn.proj.weight", (dim, dim), "matrix", r),
            (f"{prefix}.attn.proj.bias", (dim,), "shift", 1.0),
            (f"{prefix}.norm2.weight", (dim,), "scale", 1.0),
            (f"{prefix}.norm2.bias", (dim,), "shift", 1.0),
            (f"{prefix}.mlp.fc1.weight", (hidden, dim), "matrix", 1.0),
            (f"{prefix}.mlp.fc1.bias", (hidden,), "shift", 1.0),
            (f"{prefix}.mlp.fc2.weight", (dim, hidden), "matrix", r),
            (f"{prefix}.mlp.fc2.bias", (dim,), "shift", 1.0)]


def encoder_leaves(m: dict) -> List[Leaf]:
    """The encoder of a config's ``model`` section."""
    d, p, t = m["embed_dim"], m["patch_size"], m["tubelet_size"]
    hidden = int(d * m["mlp_ratio"])
    out = [("patch_embed.proj.weight", (d, 3, t, p, p), "matrix", 1.0),
           ("patch_embed.proj.bias", (d,), "shift", 1.0)]
    for i in range(m["depth"]):
        out += _block(f"blocks.{i}", d, hidden, i + 1)
    return out + [("norm.weight", (d,), "scale", 1.0), ("norm.bias", (d,), "shift", 1.0)]


def predictor_leaves(m: dict, pr: dict, num_mask_tokens: int) -> List[Leaf]:
    """The predictor of a config's ``predictor`` section over its encoder."""
    d, dp = m["embed_dim"], pr["embed_dim"]
    out = [("predictor_embed.weight", (dp, d), "matrix", 1.0),
           ("predictor_embed.bias", (dp,), "shift", 1.0)]
    out += [(f"mask_tokens.{k}", (1, 1, dp), "matrix", 1.0) for k in range(num_mask_tokens)]
    for i in range(pr["depth"]):
        out += _block(f"predictor_blocks.{i}", dp, int(dp * pr["mlp_ratio"]), i + 1)
    return out + [("predictor_norm.weight", (dp,), "scale", 1.0),
                  ("predictor_norm.bias", (dp,), "shift", 1.0),
                  ("predictor_proj.weight", (d, dp), "matrix", 1.0),
                  ("predictor_proj.bias", (d,), "shift", 1.0)]


def probe_leaves(m: dict, pb: dict) -> List[Leaf]:
    """A depth-1 attentive probe with one query over the encoder's features."""
    d = m["embed_dim"]
    hidden = int(d * pb["mlp_ratio"])
    r = math.sqrt(2.0)
    cab = "pooler.cross_attention_block"
    return [("pooler.query_tokens", (1, 1, d), "matrix", 1.0),
            (f"{cab}.norm1.weight", (d,), "scale", 1.0), (f"{cab}.norm1.bias", (d,), "shift", 1.0),
            (f"{cab}.xattn.q.weight", (d, d), "matrix", 1.0),
            (f"{cab}.xattn.q.bias", (d,), "shift", 1.0),
            (f"{cab}.xattn.kv.weight", (2 * d, d), "matrix", 1.0),
            (f"{cab}.xattn.kv.bias", (2 * d,), "shift", 1.0),
            (f"{cab}.xattn.proj.weight", (d, d), "matrix", r),
            (f"{cab}.xattn.proj.bias", (d,), "shift", 1.0),
            (f"{cab}.norm2.weight", (d,), "scale", 1.0), (f"{cab}.norm2.bias", (d,), "shift", 1.0),
            (f"{cab}.mlp.fc1.weight", (hidden, d), "matrix", 1.0),
            (f"{cab}.mlp.fc1.bias", (hidden,), "shift", 1.0),
            (f"{cab}.mlp.fc2.weight", (d, hidden), "matrix", r),
            (f"{cab}.mlp.fc2.bias", (d,), "shift", 1.0),
            ("linear.weight", (pb["num_classes"], d), "matrix", 1.0),
            ("linear.bias", (pb["num_classes"],), "shift", 1.0)]


def make(leaves: List[Leaf], seed: int, device, matrix_dtype=torch.float32
         ) -> Dict[str, torch.Tensor]:
    """Every leaf of ``leaves`` from one normal draw on ``device``; matrices
    (two or more dims) in ``matrix_dtype``, the rest fp32."""
    sizes = [math.prod(shape) for _, shape, _, _ in leaves]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for (name, shape, kind, div), size in zip(leaves, sizes):
        z = flat[at:at + size].view(shape)
        at += size
        if kind == "scale":
            out[name] = 1.0 + STD * z
        elif kind == "shift":
            out[name] = STD * z
        else:
            out[name] = (z * (STD / div)).to(matrix_dtype)
    return out
