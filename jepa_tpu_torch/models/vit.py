"""Video/image Vision Transformer encoder (counterpart of
jepa_tpu/models/vit.py).

  * channels-last input [B, T, H, W, C] (video) or [B, H, W, C] (image);
  * the tubelet "conv" is a reshape plus one matmul (kernel size equals
    stride, so each token is an independent patch projection). The weight
    keeps the zoo's Conv3d shape [D, C, t, p, p] and the patch vector's
    element order is (C, t, ph, pw), so zoo files load as they are;
    nn.Conv3d is not used (cuDNN would run it in TF32 by default);
  * the frozen sincos pos-embed is a buffer, added in fp32 then cast;
  * optional token-drop ``masks`` [B, K] before the blocks; pre-LN blocks;
    final LayerNorm; fp32 output.

An input whose token grid differs from the config's gets the table
resized to its grid (trilinear for video, cubic for images, as
``jax.image.resize`` computes them).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn as nn

from jepa_tpu_torch.models.initializers import init_layernorm_, trunc_normal
from jepa_tpu_torch.models.pos_embed import (
    get_2d_sincos_pos_embed,
    get_3d_sincos_pos_embed,
    resize_pos_embed_2d,
    resize_pos_embed_3d,
)
from jepa_tpu_torch.models.transformer import (
    Block,
    BlockCfg,
    layer_norm,
    matmul_f32,
    run_blocks,
)
from jepa_tpu_torch.ops.masking import gather_tokens


@dataclasses.dataclass(frozen=True)
class ViTCfg:
    img_size: int = 224
    patch_size: int = 16
    num_frames: int = 1
    tubelet_size: int = 2
    in_chans: int = 3
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    ln_eps: float = 1e-6
    init_std: float = 0.02
    uniform_power: bool = False
    compute_dtype: torch.dtype = torch.bfloat16
    attn_impl: str = "auto"
    fused_mlp: object = False  # grad-free forwards only; see BlockCfg
    # activation checkpointing of the blocks: False | True/'full' | 'attn'
    # (``transformer.run_blocks``)
    remat: object = False

    @property
    def is_video(self) -> bool:
        return self.num_frames > 1

    @property
    def grid_size(self) -> int:
        return self.img_size // self.patch_size

    @property
    def grid_depth(self) -> int:
        return self.num_frames // self.tubelet_size if self.is_video else 1

    @property
    def num_patches(self) -> int:
        n = self.grid_size * self.grid_size
        return n * self.grid_depth if self.is_video else n

    @property
    def patch_dim(self) -> int:
        p = self.patch_size * self.patch_size * self.in_chans
        return p * self.tubelet_size if self.is_video else p

    @property
    def patch_kernel_shape(self):
        """The zoo's Conv3d (video) or Conv2d (image) weight shape."""
        p = self.patch_size
        if self.is_video:
            return (self.embed_dim, self.in_chans, self.tubelet_size, p, p)
        return (self.embed_dim, self.in_chans, p, p)

    @property
    def mlp_hidden(self) -> int:
        return int(self.embed_dim * self.mlp_ratio)

    def block_cfg(self) -> BlockCfg:
        return BlockCfg(
            dim=self.embed_dim,
            num_heads=self.num_heads,
            mlp_hidden=self.mlp_hidden,
            ln_eps=self.ln_eps,
            compute_dtype=self.compute_dtype,
            attn_impl=self.attn_impl,
            fused_mlp=self.fused_mlp,
        )


class _PatchProj(nn.Module):
    """Holds ``patch_embed.proj.{weight,bias}`` in the zoo's conv layout."""

    def __init__(self, cfg: ViTCfg, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cfg.patch_kernel_shape, device=device))
        self.bias = nn.Parameter(torch.empty(cfg.embed_dim, device=device))


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: ViTCfg, device=None):
        super().__init__()
        self.proj = _PatchProj(cfg, device)


def sincos_table(cfg: ViTCfg) -> torch.Tensor:
    """The config's frozen pos-embed, [1, N, D] fp32."""
    if cfg.is_video:
        pe = get_3d_sincos_pos_embed(cfg.embed_dim, cfg.grid_size, cfg.grid_depth,
                                     uniform_power=cfg.uniform_power)
    else:
        pe = get_2d_sincos_pos_embed(cfg.embed_dim, cfg.grid_size)
    return torch.from_numpy(pe.astype("float32"))[None]


class VisionTransformer(nn.Module):
    def __init__(self, cfg: ViTCfg, device=None):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = _PatchEmbed(cfg, device)
        self.register_buffer("pos_embed", sincos_table(cfg).to(device))
        bc = cfg.block_cfg()
        self.blocks = nn.ModuleList(Block(bc, device=device) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(cfg.embed_dim, eps=cfg.ln_eps, device=device)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None) -> "VisionTransformer":
        cfg = self.cfg
        w = trunc_normal((cfg.embed_dim, cfg.patch_dim), generator, std=cfg.init_std)
        self.patch_embed.proj.weight.copy_(w.reshape(cfg.patch_kernel_shape))
        self.patch_embed.proj.bias.zero_()
        for i, blk in enumerate(self.blocks):
            blk.init_weights(generator, i + 1, cfg.init_std)
        init_layernorm_(self.norm)
        return self

    def forward(self, x, masks=None, kv_mask=None, out_layers=None):
        return vit_forward(self, x, masks=masks, kv_mask=kv_mask, out_layers=out_layers)


def init_vit(cfg: ViTCfg, generator: Optional[torch.Generator] = None,
             device=None) -> VisionTransformer:
    """A ViT with the reference init drawn from ``generator``."""
    return VisionTransformer(cfg, device=device).init_weights(generator)


def patchify_video(x: torch.Tensor, cfg: ViTCfg) -> torch.Tensor:
    """[B, T, H, W, C] -> [B, N, C*t*p*p], element order (C, t, ph, pw)."""
    b, t, hpx, wpx, c = x.shape
    tt, p = cfg.tubelet_size, cfg.patch_size
    gt, gh, gw = t // tt, hpx // p, wpx // p
    x = x.reshape(b, gt, tt, gh, p, gw, p, c)
    x = x.permute(0, 1, 3, 5, 7, 2, 4, 6)  # [B, gt, gh, gw, C, tt, p, p]
    return x.reshape(b, gt * gh * gw, c * tt * p * p)


def patchify_image(x: torch.Tensor, cfg: ViTCfg) -> torch.Tensor:
    """[B, H, W, C] -> [B, N, C*p*p], element order (C, ph, pw)."""
    b, hpx, wpx, c = x.shape
    p = cfg.patch_size
    gh, gw = hpx // p, wpx // p
    x = x.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, gh * gw, c * p * p)


def _pos_embed_for_input(model: VisionTransformer, cfg: ViTCfg, shape) -> torch.Tensor:
    """The pos-embed table [1, N, D], resized when the input's token grid
    is off-size (jepa_tpu/models/vit.py::_pos_embed_for_input)."""
    pe = model.pos_embed[0]
    if cfg.is_video:
        _, t, hpx, wpx, _ = shape
        dst = (t // cfg.tubelet_size, hpx // cfg.patch_size, wpx // cfg.patch_size)
        pe = resize_pos_embed_3d(pe, (cfg.grid_depth, cfg.grid_size, cfg.grid_size), dst)
    else:
        _, hpx, wpx, _ = shape
        dst = (hpx // cfg.patch_size, wpx // cfg.patch_size)
        pe = resize_pos_embed_2d(pe, (cfg.grid_size, cfg.grid_size), dst)
    return pe[None]


def vit_forward(
    model: VisionTransformer,
    x: torch.Tensor,
    cfg: Optional[ViTCfg] = None,
    masks: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,
    out_layers: Optional[Sequence[int]] = None,
):
    """Encoder forward. x: normalized video [B,T,H,W,C] or image [B,H,W,C],
    any float dtype; ``cfg`` overrides the model's own (e.g. fused_mlp).
    masks: [B, K] keep-indices or None. Returns [B, K, D] fp32, or a list
    of per-layer normed outputs when out_layers is given."""
    cfg = cfg or model.cfg
    cd = cfg.compute_dtype
    tokens = patchify_video(x, cfg) if cfg.is_video else patchify_image(x, cfg)
    proj = model.patch_embed.proj
    w = proj.weight.reshape(cfg.embed_dim, -1).to(cd)
    tokens = (matmul_f32(tokens.to(cd), w) + proj.bias.float()).to(cd)
    pe = _pos_embed_for_input(model, cfg, x.shape)
    tokens = (tokens.float() + pe.float()).to(cd)
    if masks is not None:
        tokens = gather_tokens(tokens, masks)
    collect = out_layers is not None
    final, layers = run_blocks(tokens, model.blocks, cfg.block_cfg(),
                               kv_mask=kv_mask, collect_layers=collect, remat=cfg.remat)
    if collect:
        return [layer_norm(layers[i], model.norm, cfg.ln_eps).float() for i in out_layers]
    return layer_norm(final, model.norm, cfg.ln_eps).float()
