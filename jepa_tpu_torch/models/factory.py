"""Model factories for the reference's size ladder (counterpart of
jepa_tpu/models/factory.py).

Name -> (embed_dim, depth, num_heads, mlp_ratio, default_patch). The
reference's vit_gigantic passes a typo'd ``mpl_ratio`` that is swallowed,
so every real gigantic checkpoint has 4.0 MLPs; ``vit_gigantic`` keeps that
effective 4.0 and ``vit_gigantic_intended`` carries the intended 64/13.
"""

from __future__ import annotations

import torch

from jepa_tpu_torch.models.vit import ViTCfg

_SPECS = {
    "vit_tiny": (192, 12, 3, 4.0, 16),
    "vit_small": (384, 12, 6, 4.0, 16),
    "vit_base": (768, 12, 12, 4.0, 16),
    "vit_large": (1024, 24, 16, 4.0, 16),
    "vit_huge": (1280, 32, 16, 4.0, 16),
    "vit_giant": (1408, 40, 16, 48 / 11, 16),
    "vit_gigantic": (1664, 48, 16, 4.0, 14),  # reference mpl_ratio typo quirk
    "vit_gigantic_intended": (1664, 48, 16, 64 / 13, 14),
}


def vit_cfg(
    model_name: str,
    *,
    img_size: int = 224,
    patch_size: int = None,
    num_frames: int = 1,
    tubelet_size: int = 2,
    uniform_power: bool = False,
    compute_dtype: torch.dtype = torch.bfloat16,
    attn_impl: str = "auto",
    fused_mlp: object = False,
) -> ViTCfg:
    if model_name not in _SPECS:
        raise ValueError(f"unknown model {model_name!r}; options: {sorted(_SPECS)}")
    dim, depth, heads, ratio, default_patch = _SPECS[model_name]
    return ViTCfg(
        img_size=img_size,
        patch_size=patch_size or default_patch,
        num_frames=num_frames,
        tubelet_size=tubelet_size,
        embed_dim=dim,
        depth=depth,
        num_heads=heads,
        mlp_ratio=ratio,
        uniform_power=uniform_power,
        compute_dtype=compute_dtype,
        attn_impl=attn_impl,
        fused_mlp=fused_mlp,
    )
