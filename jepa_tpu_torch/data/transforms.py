"""Video augmentation and the eval transforms on the clips' device
(counterpart of jepa_tpu/data/transforms.py).

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

  * ``auto_augment``: 'original' runs AutoAugment's ImageNet policy, any
    other string the RandAugment it names (``data.randaugment``), on the
    full frames before the crop, as the JAX package does.

The draws come from torch's generator, so the boxes differ from the JAX
package's ``jax.random`` ones; the resampling and normalization are the
same arithmetic (tests hold them against the JAX functions on one box).

The eval side: ``multiview_crops`` (the video probe's validation views,
with or without the letterbox ``valid_hw``) and ``eval_transform``
(short-side resize, centre crop, normalize).
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
    app/vjepa/transforms.py:86-115, with the probes' auto-augment)."""
    x = clips_uint8
    if cfg.auto_augment:
        from jepa_tpu_torch.data import randaugment as ra

        x = clips_uint8.float()
        if cfg.auto_augment == "original":
            # AutoAugment's ImageNet policy, the reference image probe's default
            # (reference evals/image_classification_frozen/eval.py:394-403)
            ra.autoaugment_original_batch(gen, x)
        else:
            ra.randaugment_batch(gen, x, ra.RandAugmentCfg.from_string(cfg.auto_augment))
    out = random_resized_crop(gen, x, cfg, valid_hw)
    if cfg.random_horizontal_flip:
        flip = torch.rand((out.shape[0],), generator=gen, device=out.device) < 0.5
        out = torch.where(flip[:, None, None, None, None], out.flip(3), out)
    out = normalize(out, cfg.normalize_mean, cfg.normalize_std)
    if cfg.reprob > 0:
        out = erase_cube(gen, out, cfg.reprob)
    return out


def multiview_crops(clips: torch.Tensor, crop_size: int, num_views: int,
                    valid_hw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Validation views: ``num_views`` square crops slid along the long side
    of frames whose short side is ``crop_size``, normalized (reference
    EvalVideoTransform, evals/video_classification_frozen/utils.py:286-323).

    clips [B, S, T, H, W, C] uint8; ``valid_hw`` [B, 2] gives each sample's
    un-letterboxed region (aspect-preserving decode), whose true long side
    the views slide along. Returns [B, S, num_views, T, crop, crop, C] fp32.
    """
    b, s, t, h, w, c = clips.shape
    denom = max(1, num_views - 1)
    if valid_hw is None:
        step = (max(h, w) - crop_size) // denom
        span = lambda i: slice(i * step, i * step + crop_size)
        views = [clips[:, :, :, span(i)] if h > w else clips[:, :, :, :, span(i)]
                 for i in range(num_views)]
        out = torch.stack(views, dim=2)
    else:
        hv, wv = valid_hw[:, 0].long(), valid_hw[:, 1].long()
        step = torch.clamp(torch.maximum(hv, wv) - crop_size, min=0).float() / denom
        tall = hv > wv
        per_sample = []
        for i in range(num_views):
            start = torch.round(i * step).long()
            sy = torch.where(tall, start, 0).clamp(0, h - crop_size).tolist()
            sx = torch.where(tall, 0, start).clamp(0, w - crop_size).tolist()
            per_sample.append(torch.stack([
                clips[k, :, :, sy[k]:sy[k] + crop_size, sx[k]:sx[k] + crop_size]
                for k in range(b)]))
        out = torch.stack(per_sample, dim=2)
    return normalize(out.float())


def resize_short_side(clips_uint8: torch.Tensor, out_size: int) -> torch.Tensor:
    """[B, T, H, W, C] -> fp32 frames resized so the short side is
    ``out_size``, bilinear with antialiasing when it shrinks (what
    ``jax.image.resize(..., 'bilinear')`` computes)."""
    b, t, h, w, c = clips_uint8.shape
    scale = out_size / min(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    x = clips_uint8.float().reshape(b * t, h, w, c).permute(0, 3, 1, 2)
    x = torch.nn.functional.interpolate(x, size=(nh, nw), mode="bilinear",
                                        align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1).reshape(b, t, nh, nw, c)


def eval_transform(clips_uint8: torch.Tensor, crop_size: int = 224,
                   resize_size: Optional[int] = None) -> torch.Tensor:
    """Validation transform: short-side resize (default crop * 256/224),
    centre crop, normalize. [B, T, H, W, C] uint8 -> [B, T, crop, crop, C]
    fp32 (reference EvalVideoTransform)."""
    if resize_size is None:
        resize_size = int(crop_size * 256 / 224)
    x = resize_short_side(clips_uint8, resize_size)
    i = (x.shape[2] - crop_size) // 2
    j = (x.shape[3] - crop_size) // 2
    return normalize(x[:, :, i:i + crop_size, j:j + crop_size])
