"""Video augmentation on the clips' device (counterpart of
jepa_tpu/data/transforms.py: AugmentCfg and pretrain_augment).

The decode workers hand over raw uint8 frames; everything after decode
runs as batched torch ops on the device the clips lie on, drawing from an
explicit ``torch.Generator`` (the app seeds one per step):

  * random-resized crop: a per-sample box from (scale, ratio) by the
    reference's 10-try rejection loop (area uniform in scale*HW, aspect
    log-uniform in ratio, the first box that fits wins, else the centred
    max-area box with the aspect clamped into ratio), resampled bilinearly
    (reference transforms.py:503-577). ``valid_hw`` keeps the box inside
    the un-letterboxed region of aspect-preserving decode;
  * motion shift: boxes at the first and last frame, interpolated
    linearly per frame (reference transforms.py:580-622);
  * horizontal flip with p = 0.5;
  * normalize with the 0-255-scaled ImageNet statistics;
  * the cube random erase (RandomErasing pixel mode, cube=True; reference
    randerase.py:116-156).

The draws come from torch's generator, so the boxes differ from the JAX
package's ``jax.random`` ones; the resampling and normalization are the
same arithmetic (tests hold them against the JAX functions on one box).
RandAugment (``auto_augment``) is not ported yet and raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
_RRC_TRIES = 10


@dataclasses.dataclass(frozen=True)
class AugmentCfg:
    crop_size: int = 224
    random_resize_scale: Tuple[float, float] = (0.3, 1.0)
    random_resize_aspect_ratio: Tuple[float, float] = (0.75, 1.35)
    random_horizontal_flip: bool = True
    motion_shift: bool = False
    reprob: float = 0.0
    # timm RandAugment config string (e.g. 'rand-m7-n4-mstd0.5-inc1') or None
    auto_augment: Optional[str] = None
    normalize_mean: Tuple[float, float, float] = IMAGENET_MEAN
    normalize_std: Tuple[float, float, float] = IMAGENET_STD


def sample_crop_boxes(gen: torch.Generator, h: torch.Tensor, w: torch.Tensor,
                      scale, ratio):
    """One crop box per sample, (i, j, bh, bw) each [B] fp32 in source
    pixels, for source sizes h, w ([B] fp32)."""
    b = h.shape[0]
    u = torch.rand((b, 2 * _RRC_TRIES + 2), generator=gen, device=h.device)
    h2, w2 = h[:, None], w[:, None]
    area = h2 * w2 * (scale[0] + u[:, :_RRC_TRIES] * (scale[1] - scale[0]))
    lo, hi = math.log(ratio[0]), math.log(ratio[1])
    r = torch.exp(lo + u[:, _RRC_TRIES:2 * _RRC_TRIES] * (hi - lo))
    bws, bhs = torch.sqrt(area * r), torch.sqrt(area / r)
    ok = (bws <= w2) & (bhs <= h2)
    first = ok.to(torch.uint8).argmax(dim=1, keepdim=True)  # the first box that fits
    any_ok = ok.any(dim=1)
    in_r = w / h
    fb_w = torch.where(in_r > ratio[1], h * ratio[1], w)
    fb_h = torch.where(in_r < ratio[0], w / ratio[0], h)
    bw = torch.where(any_ok, bws.gather(1, first)[:, 0], fb_w)
    bh = torch.where(any_ok, bhs.gather(1, first)[:, 0], fb_h)
    u_i = torch.where(any_ok, u[:, -2], 0.5)
    u_j = torch.where(any_ok, u[:, -1], 0.5)
    return u_i * (h - bh), u_j * (w - bw), bh, bw


def bilinear_crop_resize(frames: torch.Tensor, i, j, bh, bw, out_hw,
                         valid_hw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Crop box (i, j, bh, bw) of frames [B, T, H, W, C] (any dtype),
    resampled bilinearly to out_hw with align-corners-False positions.
    i/j/bh/bw: [B] or per-frame [B, T]. valid_hw [B, 2] clamps sampling
    to the un-letterboxed region. Returns [B, T, oh, ow, C] fp32."""
    b, t, hh, ww, _ = frames.shape
    dev = frames.device
    oh, ow = out_hw
    if valid_hw is None:
        hmax = torch.full((b,), hh - 1, device=dev)
        wmax = torch.full((b,), ww - 1, device=dev)
    else:
        hmax, wmax = valid_hw[:, 0].long() - 1, valid_hw[:, 1].long() - 1
    box = [torch.as_tensor(v, dtype=torch.float32, device=dev) for v in (i, j, bh, bw)]
    i, j, bh, bw = [v[:, None].expand(b, t) if v.dim() == 1 else v for v in box]
    ys = (torch.arange(oh, dtype=torch.float32, device=dev) + 0.5) / oh
    xs = (torch.arange(ow, dtype=torch.float32, device=dev) + 0.5) / ow
    src_y = i[..., None] + ys * bh[..., None] - 0.5  # [B, T, oh]
    src_x = j[..., None] + xs * bw[..., None] - 0.5  # [B, T, ow]
    y0f, x0f = torch.floor(src_y), torch.floor(src_x)
    wy, wx = src_y - y0f, src_x - x0f
    hmax, wmax = hmax[:, None, None], wmax[:, None, None]
    y0 = torch.minimum(y0f.long().clamp(min=0), hmax)
    y1 = torch.minimum((y0 + 1).clamp(min=0), hmax)
    x0 = torch.minimum(x0f.long().clamp(min=0), wmax)
    x1 = torch.minimum((x0 + 1).clamp(min=0), wmax)
    bi = torch.arange(b, device=dev)[:, None, None, None]
    ti = torch.arange(t, device=dev)[None, :, None, None]

    def at(yy, xx):  # [B, T, oh, ow, C]
        return frames[bi, ti, yy[..., :, None], xx[..., None, :]].float()

    wx = wx[:, :, None, :, None]
    wy = wy[:, :, :, None, None]
    top = at(y0, x0) * (1 - wx) + at(y0, x1) * wx
    bot = at(y1, x0) * (1 - wx) + at(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def random_resized_crop(gen: torch.Generator, clips: torch.Tensor, cfg: AugmentCfg,
                        valid_hw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """clips [B, T, H, W, C] -> [B, T, crop, crop, C] fp32."""
    b, t, hh, ww, _ = clips.shape
    dev = clips.device
    if valid_hw is not None:
        src_h, src_w = valid_hw[:, 0].float(), valid_hw[:, 1].float()
    else:
        src_h = torch.full((b,), float(hh), device=dev)
        src_w = torch.full((b,), float(ww), device=dev)
    sample = lambda: sample_crop_boxes(gen, src_h, src_w, cfg.random_resize_scale,
                                       cfg.random_resize_aspect_ratio)
    if cfg.motion_shift:
        box0, box1 = sample(), sample()
        a = torch.linspace(0.0, 1.0, t, device=dev)
        box = [p0[:, None] * (1 - a) + p1[:, None] * a for p0, p1 in zip(box0, box1)]
    else:
        box = sample()
    return bilinear_crop_resize(clips, *box, (cfg.crop_size, cfg.crop_size),
                                valid_hw=valid_hw)


def normalize(x: torch.Tensor, mean=IMAGENET_MEAN, std=IMAGENET_STD) -> torch.Tensor:
    """(x - 255*mean) / (255*std) over the channel axis, fp32."""
    m = torch.tensor(mean, dtype=torch.float32, device=x.device) * 255.0
    s = torch.tensor(std, dtype=torch.float32, device=x.device) * 255.0
    return (x - m) / s


def erase_cube(gen: torch.Generator, clips: torch.Tensor, reprob: float) -> torch.Tensor:
    """Per sample with probability ``reprob``: one [t0:t1, y0:y1, x0:x1]
    block of the clip [B, T, H, W, C] replaced by standard normal noise."""
    b, t, h, w, _ = clips.shape
    dev = clips.device
    u = torch.rand((b, 7), generator=gen, device=dev)
    apply = u[:, 0] < reprob
    target = h * w * (0.02 + u[:, 1] * (1 / 3 - 0.02))
    lo, hi = math.log(0.3), math.log(10 / 3)
    r = torch.exp(lo + u[:, 2] * (hi - lo))
    eh = torch.sqrt(target * r).clamp(1, h - 1)
    ew = torch.sqrt(target / r).clamp(1, w - 1)
    y0, x0 = u[:, 3] * (h - eh), u[:, 4] * (w - ew)
    t0 = u[:, 5] * (t - 1)
    t1 = t0 + u[:, 6] * (t - t0)
    ar = lambda n: torch.arange(n, dtype=torch.float32, device=dev)[None]
    col = lambda v: v[:, None]
    in_t = (ar(t) >= col(t0)) & (ar(t) <= col(t1))
    in_y = (ar(h) >= col(y0)) & (ar(h) < col(y0 + eh))
    in_x = (ar(w) >= col(x0)) & (ar(w) < col(x0 + ew))
    inside = (apply[:, None, None, None] & in_t[:, :, None, None]
              & in_y[:, None, :, None] & in_x[:, None, None, :])
    noise = torch.randn(clips.shape, generator=gen, device=dev, dtype=clips.dtype)
    return torch.where(inside[..., None], noise, clips)


def pretrain_augment(gen: torch.Generator, clips_uint8: torch.Tensor, cfg: AugmentCfg,
                     valid_hw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, T, H, W, C] uint8 -> [B, T, crop, crop, C] fp32 normalized, on
    the clips' device (the reference's pretrain VideoTransform,
    app/vjepa/transforms.py:86-115)."""
    if cfg.auto_augment:
        raise NotImplementedError("auto_augment (RandAugment) is not ported to "
                                  "jepa_tpu_torch yet (ROADMAP Queue 1)")
    out = random_resized_crop(gen, clips_uint8, cfg, valid_hw)
    if cfg.random_horizontal_flip:
        flip = torch.rand((out.shape[0],), generator=gen, device=out.device) < 0.5
        out = torch.where(flip[:, None, None, None, None], out.flip(3), out)
    out = normalize(out, cfg.normalize_mean, cfg.normalize_std)
    if cfg.reprob > 0:
        out = erase_cube(gen, out, cfg.reprob)
    return out
