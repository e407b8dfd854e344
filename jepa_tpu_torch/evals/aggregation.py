"""Clip and frame aggregation for the frozen-encoder evals (counterpart of
jepa_tpu/evals/aggregation.py; reference
evals/video_classification_frozen/utils.py:23-159).

Every (temporal segment x spatial view) clip goes through the encoder in
ONE forward, concatenated on the batch axis, and is regrouped by view.
Under ``attend_across_segments`` the token sequences of all segments are
concatenated, optionally plus a 1D temporal sin-cos pos-embed indexed by
the true frame indices, so the probe attends across the whole video.
``frame_aggregation`` is the image-encoder variant: every frame through a
2D encoder, tokens concatenated over time. Clips arrive stacked as
[B, S, V, T, H, W, C]; everything else is reshapes around the one call.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from jepa_tpu_torch.models.pos_embed import get_1d_sincos_pos_embed
from jepa_tpu_torch.models.vit import ViTCfg, VisionTransformer, vit_forward


def temporal_pos_embed_table(embed_dim: int, max_frames: int = 10000,
                             tubelet_size: int = 2, device=None) -> torch.Tensor:
    """Frozen 1D sin-cos table over temporal token slots, [max_frames //
    tubelet_size, D] fp32."""
    table = get_1d_sincos_pos_embed(embed_dim, max_frames // tubelet_size)
    return torch.from_numpy(table.astype("float32")).to(device)


def clip_aggregation(model: VisionTransformer, clips: torch.Tensor, cfg: ViTCfg,
                     attend_across_segments: bool = False,
                     pos_embed_table: Optional[torch.Tensor] = None,
                     clip_indices: Optional[torch.Tensor] = None) -> List:
    """Encode all views in one forward and regroup.

    clips [B, S, V, T, H, W, C]; clip_indices [B, S, T] true frame indices
    (for the optional temporal pos-embed, strided by the tubelet). Returns
    a list over V of [B, S*N, D] (attend_across_segments) or a list over V
    of lists over S of [B, N, D]; fp32, as the encoder returns them."""
    b, s, v, t, h, w, c = clips.shape
    tokens = vit_forward(model, clips.reshape(b * s * v, t, h, w, c), cfg)
    n, d = tokens.shape[1], tokens.shape[2]
    tokens = tokens.reshape(b, s, v, n, d)
    if not attend_across_segments:
        return [[tokens[:, si, vi] for si in range(s)] for vi in range(v)]
    t_tokens = t // cfg.tubelet_size
    n_spatial = n // t_tokens
    outs = []
    for vi in range(v):
        seq = tokens[:, :, vi].reshape(b, s * n, d)
        if pos_embed_table is not None and clip_indices is not None:
            slots = clip_indices[:, :, ::cfg.tubelet_size].reshape(b, s * t_tokens)
            pe = pos_embed_table[slots.long()]  # [B, S*t, D]
            seq = seq + pe.repeat_interleave(n_spatial, dim=1)  # token-major (t, spatial)
        outs.append(seq)
    return outs


def frame_aggregation(model: VisionTransformer, clips: torch.Tensor, cfg: ViTCfg,
                      pos_embed_table: Optional[torch.Tensor] = None,
                      clip_indices: Optional[torch.Tensor] = None) -> List:
    """Image-encoder variant: clips [B, S, V, T, H, W, C], every frame
    through a 2D ViT -> a list over V of [B, S*T*N, D]; the optional
    pos-embed is indexed by the raw frame indices clip_indices [B, S, T]."""
    b, s, v, t, h, w, c = clips.shape
    tokens = vit_forward(model, clips.reshape(b * s * v * t, h, w, c), cfg)
    n, d = tokens.shape[1], tokens.shape[2]
    tokens = tokens.reshape(b, s, v, t, n, d)
    outs = []
    for vi in range(v):
        seq = tokens[:, :, vi].reshape(b, s * t * n, d)
        if pos_embed_table is not None and clip_indices is not None:
            pe = pos_embed_table[clip_indices.reshape(b, s * t).long()]
            seq = seq + pe.repeat_interleave(n, dim=1)
        outs.append(seq)
    return outs
