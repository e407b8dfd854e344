"""RandAugment and AutoAugment 'original' on the clips' device
(counterpart of jepa_tpu/data/randaugment.py; reference
src/datasets/utils/video/randaugment.py:351-465 and timm's policies).

Clips are [B, T, H, W, C] float in 0..255. Every op takes per-sample
parameters as [B] tensors (or Python numbers) and applies them to all of a
clip's frames (temporal consistency), as the reference does:

  * pixel ops: invert, autocontrast and equalize (per frame and channel,
    equalize by the 256-bin histogram LUT of PIL), posterize, solarize,
    solarize-add, and the color / contrast / brightness / sharpness blends
    (sharpness against PIL's SMOOTH filter with unfiltered borders);
  * geometric ops (rotate, shear, translate): PIL's ``Image.transform``
    affine semantics (the output pixel's centre maps through the matrix,
    the filter samples half a pixel back), a per-op BILINEAR or BICUBIC
    filter (PIL's Geometry.c cubic) and the gray fill of 128 outside the
    source.

The policies draw from an explicit ``torch.Generator`` on the clips' device:

  * ``randaugment_batch``: per sample and layer an op drawn uniformly from
    the 'inc1' set, applied with probability ``prob`` at a gaussian-jittered
    magnitude (m +/- mstd, clipped to [0, 10]), a random sign and filter —
    the 'rand-mN-nK-mstdS-inc1' family;
  * ``autoaugment_original_batch``: per sample one of the 25 sub-policies
    of AutoAugment's ImageNet policy, each applying two ops with fixed
    (probability, level).

The JAX package evaluates every op for every clip under ``vmap`` and
selects; here each layer groups the samples by the op they drew and runs
each op once on its group (one host read of the draws per layer). The
draws come from torch's generator, so they differ from ``jax.random``'s;
the ops are the same arithmetic (tests hold each against the JAX op).
"""

from __future__ import annotations

import dataclasses

import torch

_FILL = 128.0


def _v(p, x: torch.Tensor):
    """A per-sample parameter ([B] tensor) broadcast against clips x
    [B, T, H, W, C]; a Python number passes through."""
    if isinstance(p, torch.Tensor):
        return p.to(torch.float32).reshape(-1, *([1] * (x.dim() - 1)))
    return p


# ---------------------------------------------------------------------------
# pixel ops
# ---------------------------------------------------------------------------


def _blend(a, b, factor):
    return b + (a - b) * factor


def _gray(x):
    return (0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2])[..., None]


def op_invert(x, m):
    return 255.0 - x


def op_autocontrast(x, m):
    lo = x.amin(dim=(2, 3), keepdim=True)  # per frame and channel
    hi = x.amax(dim=(2, 3), keepdim=True)
    out = (x - lo) * (255.0 / torch.clamp(hi - lo, min=1e-5))
    return torch.where(hi > lo, out, x)


def op_equalize(x, m):
    """PIL ImageOps.equalize per frame and channel: step = (total - count of
    the last nonempty bin) // 255, lut[i] = (step // 2 + cumsum_excl[i]) // step."""
    b, t, h, w, c = x.shape
    flat = x.clamp(0, 255).to(torch.int64).permute(0, 1, 4, 2, 3).reshape(b * t * c, h * w)
    hist = torch.zeros((b * t * c, 256), dtype=torch.int64, device=x.device)
    hist.scatter_add_(1, flat, torch.ones_like(flat))
    last = 255 - (hist > 0).flip(1).to(torch.uint8).argmax(dim=1, keepdim=True)
    step = (hist.sum(1, keepdim=True) - hist.gather(1, last)) // 255
    excl = hist.cumsum(1) - hist
    lut = (step // 2 + excl) // step.clamp(min=1)
    ident = torch.arange(256, device=x.device).expand_as(lut)
    lut = torch.where(step > 0, lut.clamp(0, 255), ident)
    out = lut.gather(1, flat).to(torch.float32)
    return out.reshape(b, t, c, h, w).permute(0, 1, 3, 4, 2)


def op_posterize(x, m):
    # PosterizeIncreasing: bits = 4 - round(m/10*4), keep (4 + bits) MSBs
    bits = 4 - torch.round(torch.as_tensor(_v(m, x), dtype=torch.float32) / 10.0 * 4.0)
    q = 2.0 ** torch.clamp(8.0 - (4.0 + bits), 0.0, 8.0)
    return torch.floor(x.clamp(0, 255) / q) * q


def op_solarize(x, m):
    return torch.where(x < 256.0 - _v(m, x) / 10.0 * 256.0, x, 255.0 - x)


def op_solarize_add(x, m):
    return torch.where(x < 128.0, torch.clamp(x + _v(m, x) / 10.0 * 110.0, 0, 255), x)


def _smooth(x):
    """PIL SMOOTH filter ([[1,1,1],[1,5,1],[1,1,1]] / 13), borders unfiltered."""
    b, t, h, w, c = x.shape
    k = torch.tensor([[1.0, 1.0, 1.0], [1.0, 5.0, 1.0], [1.0, 1.0, 1.0]]) / 13.0
    pad = torch.nn.functional.pad(x.reshape(b * t, h, w, c).permute(0, 3, 1, 2),
                                  (1, 1, 1, 1), mode="replicate")
    pad = pad.permute(0, 2, 3, 1).reshape(b, t, h + 2, w + 2, c)
    sm = 0.0
    for i in range(3):
        for j in range(3):
            sm = sm + float(k[i, j]) * pad[:, :, i:i + h, j:j + w, :]
    yy = torch.arange(h, device=x.device)[:, None, None]
    xx = torch.arange(w, device=x.device)[None, :, None]
    interior = (yy > 0) & (yy < h - 1) & (xx > 0) & (xx < w - 1)
    return torch.where(interior, sm, x)


def _enhance(m, sign):
    # timm increasing enhance: factor = 1 + sign * m/10 * 0.9
    return 1.0 + sign * (m / 10.0) * 0.9


def op_color(x, m, sign):
    return _blend(x, _gray(x), _v(_enhance(m, sign), x))


def op_contrast(x, m, sign):
    mean = _gray(x).mean(dim=(2, 3, 4), keepdim=True)  # per frame
    return _blend(x, mean, _v(_enhance(m, sign), x))


def op_brightness(x, m, sign):
    return _blend(x, torch.zeros_like(x), _v(_enhance(m, sign), x))


def op_sharpness(x, m, sign):
    return _blend(x, _smooth(x), _v(_enhance(m, sign), x))


# ---------------------------------------------------------------------------
# geometric ops
# ---------------------------------------------------------------------------


def _cubic_weights(d):
    """PIL Geometry.c BICUBIC tap weights at offsets -1, 0, 1, 2."""
    return (d * (-1.0 + d * (2.0 - d)), 1.0 + d * d * (-2.0 + d),
            d * (1.0 + d * (1.0 - d)), d * d * (-1.0 + d))


def _take(x, yi, xi):
    """x [B, T, H, W, C] at per-sample pixel indices yi, xi [B, H, W]."""
    b, t, h, w, c = x.shape
    idx = (yi * w + xi).reshape(b, 1, h * w, 1).expand(b, t, h * w, c)
    return x.reshape(b, t, h * w, c).gather(2, idx).reshape(b, t, h, w, c)


def _coords(x, a, b_, c_, d, e, f):
    """Source sample positions (sx, sy) [B, H, W] of PIL's affine transform:
    the output pixel's centre maps through (a b c; d e f), then the filter
    samples half a pixel back."""
    bsz, _, h, w, _ = x.shape
    col = lambda p: torch.as_tensor(p, dtype=torch.float32, device=x.device).reshape(-1, 1, 1)
    a, b_, c_, d, e, f = map(col, (a, b_, c_, d, e, f))
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=x.device),
                            torch.arange(w, dtype=torch.float32, device=x.device),
                            indexing="ij")
    sx = a * xx + b_ * yy + (c_ + 0.5 * (a + b_) - 0.5)
    sy = d * xx + e * yy + (f + 0.5 * (d + e) - 0.5)
    return sx.expand(bsz, h, w), sy.expand(bsz, h, w)


def _bilinear(x, sx, sy):
    _, _, h, w, _ = x.shape
    x0, y0 = torch.floor(sx), torch.floor(sy)
    wx, wy = (sx - x0)[:, None, :, :, None], (sy - y0)[:, None, :, :, None]
    valid = (sx >= -1) & (sx <= w) & (sy >= -1) & (sy <= h)
    # clamp each tap on its own (PIL's edges): at sx in (-1, 0) both taps
    # read column 0
    x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)
    x1i, y1i = (x0i + 1).clamp(0, w - 1), (y0i + 1).clamp(0, h - 1)
    x0i, y0i = x0i.clamp(0, w - 1), y0i.clamp(0, h - 1)
    top = _take(x, y0i, x0i) * (1 - wx) + _take(x, y0i, x1i) * wx
    bot = _take(x, y1i, x0i) * (1 - wx) + _take(x, y1i, x1i) * wx
    out = top * (1 - wy) + bot * wy
    return torch.where(valid[:, None, :, :, None], out, _FILL)


def _bicubic(x, sx, sy):
    """PIL's Geometry.c cubic: taps floor(s)-1 .. floor(s)+2 with clamped
    edges; valid where 0 <= s + 0.5 < size on each axis."""
    _, _, h, w, _ = x.shape
    x0, y0 = torch.floor(sx), torch.floor(sy)
    wxs = [v[:, None, :, :, None] for v in _cubic_weights(sx - x0)]
    wys = [v[:, None, :, :, None] for v in _cubic_weights(sy - y0)]
    valid = (sx + 0.5 >= 0) & (sx + 0.5 < w) & (sy + 0.5 >= 0) & (sy + 0.5 < h)
    x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)
    xti = [(x0i - 1 + i).clamp(0, w - 1) for i in range(4)]
    yti = [(y0i - 1 + j).clamp(0, h - 1) for j in range(4)]
    out = 0.0
    for i in range(4):
        row = 0.0
        for j in range(4):
            row = row + wys[j] * _take(x, yti[j], xti[i])
        out = out + wxs[i] * row
    return torch.where(valid[:, None, :, :, None], out, _FILL)


def affine_sample(x, a, b, c, d, e, f, interp=None):
    """PIL ``Image.transform(AFFINE, (a, b, c, d, e, f))`` of every frame,
    each coefficient a number or a per-sample [B] tensor. ``interp``: None
    (bilinear) or a [B] bool tensor choosing bicubic (True) or bilinear per
    sample; each filter runs on its own samples only."""
    sx, sy = _coords(x, a, b, c, d, e, f)
    if interp is None:
        return _bilinear(x, sx, sy)
    interp = interp.to(torch.bool)
    out = torch.empty_like(x)
    for pick, fn in ((~interp, _bilinear), (interp, _bicubic)):
        idx = pick.nonzero()[:, 0]
        if idx.numel():
            out[idx] = fn(x[idx], sx[idx], sy[idx])
    return out


def rotate_deg(x, deg, interp=None):
    """PIL ``img.rotate(deg)``: an affine warp about (w/2, h/2) by -deg,
    which under the half-pixel convention samples about PIL's centre."""
    rad = torch.deg2rad(torch.as_tensor(deg, dtype=torch.float32, device=x.device))
    _, _, h, w, _ = x.shape
    cx, cy = w / 2.0, h / 2.0
    cos, sin = torch.cos(rad), torch.sin(rad)
    a, b, d, e = cos, -sin, sin, cos
    return affine_sample(x, a, b, cx - a * cx - b * cy, d, e, cy - d * cx - e * cy, interp)


def op_rotate(x, m, sign, interp=None):
    return rotate_deg(x, sign * m / 10.0 * 30.0, interp)


def op_shear_x(x, m, sign, interp=None):
    return affine_sample(x, 1.0, sign * m / 10.0 * 0.3, 0.0, 0.0, 1.0, 0.0, interp)


def op_shear_y(x, m, sign, interp=None):
    return affine_sample(x, 1.0, 0.0, 0.0, sign * m / 10.0 * 0.3, 1.0, 0.0, interp)


def op_translate_x(x, m, sign, interp=None):
    return affine_sample(x, 1.0, 0.0, sign * m / 10.0 * 0.45 * x.shape[3], 0.0, 1.0, 0.0,
                         interp)


def op_translate_y(x, m, sign, interp=None):
    return affine_sample(x, 1.0, 0.0, 0.0, 0.0, 1.0, sign * m / 10.0 * 0.45 * x.shape[2],
                         interp)


# the 'inc1' op set in the JAX package's order; every entry takes
# (clips, magnitude, sign, interp), the unsigned and pixel ops ignore some
_OPS = [
    ("AutoContrast", lambda x, m, s, i: op_autocontrast(x, m)),
    ("Equalize", lambda x, m, s, i: op_equalize(x, m)),
    ("Invert", lambda x, m, s, i: op_invert(x, m)),
    ("Rotate", op_rotate),
    ("Posterize", lambda x, m, s, i: op_posterize(x, m)),
    ("Solarize", lambda x, m, s, i: op_solarize(x, m)),
    ("SolarizeAdd", lambda x, m, s, i: op_solarize_add(x, m)),
    ("Color", lambda x, m, s, i: op_color(x, m, s)),
    ("Contrast", lambda x, m, s, i: op_contrast(x, m, s)),
    ("Brightness", lambda x, m, s, i: op_brightness(x, m, s)),
    ("Sharpness", lambda x, m, s, i: op_sharpness(x, m, s)),
    ("ShearX", op_shear_x),
    ("ShearY", op_shear_y),
    ("TranslateX", op_translate_x),
    ("TranslateY", op_translate_y),
]
OP_NAMES = [n for n, _ in _OPS]


@dataclasses.dataclass(frozen=True)
class RandAugmentCfg:
    magnitude: float = 7.0
    num_layers: int = 4
    mstd: float = 0.5
    prob: float = 0.5

    @staticmethod
    def from_string(spec: str) -> "RandAugmentCfg":
        """Parse 'rand-m7-n4-mstd0.5-inc1' (timm config string); 'inc' and
        'p' parts are accepted and ignored, as in the JAX package."""
        m, n, mstd = 10.0, 2, 0.0
        for part in spec.split("-")[1:]:
            if part.startswith("mstd"):
                mstd = float(part[4:])
            elif part.startswith("m"):
                m = float(part[1:])
            elif part.startswith("n"):
                n = int(part[1:])
        return RandAugmentCfg(magnitude=m, num_layers=n, mstd=mstd)


def _sign(u: torch.Tensor) -> torch.Tensor:
    return torch.where(u < 0.5, 1.0, -1.0)


def randaugment_batch(gen: torch.Generator, clips: torch.Tensor,
                      cfg: RandAugmentCfg) -> torch.Tensor:
    """[B, T, H, W, C] float 0..255 -> augmented, per-sample policies, the
    same parameters for all frames of a clip. Updates ``clips`` in place
    and returns it."""
    b, dev = clips.shape[0], clips.device
    for _ in range(cfg.num_layers):
        op = torch.randint(0, len(_OPS), (b,), generator=gen, device=dev)
        u = torch.rand((b, 3), generator=gen, device=dev)  # apply, sign, filter
        mag = (cfg.magnitude + cfg.mstd * torch.randn((b,), generator=gen, device=dev)
               ).clamp(0.0, 10.0)
        chosen = torch.where(u[:, 0] < cfg.prob, op, -1).tolist()
        for k in sorted(set(chosen) - {-1}):
            idx = torch.tensor([i for i, o in enumerate(chosen) if o == k], device=dev)
            fn = _OPS[k][1]
            clips[idx] = fn(clips[idx], mag[idx], _sign(u[idx, 1]),
                            u[idx, 2] < 0.5).clamp(0.0, 255.0)
    return clips


# ---------------------------------------------------------------------------
# AutoAugment 'original' (AutoAugment's ImageNet policy, Cubuk et al. 2019)
# ---------------------------------------------------------------------------
# The reference image probe trains with timm's create_transform(...,
# auto_augment='original'): one of 25 sub-policies per image, each applying
# two ops with fixed (probability, level). Level -> argument follows timm's
# 'original' scheme: enhance factor = level/10*1.8 + 0.1, posterize bits =
# int(level/10*4) + 4, solarize threshold = int(level/10*256), rotate
# level/10*30 degrees and shear level/10*0.3, each with a random sign.

AA_ORIGINAL_POLICY = [
    [("PosterizeOriginal", 0.4, 8), ("Rotate", 0.6, 9)],
    [("Solarize", 0.6, 5), ("AutoContrast", 0.6, 5)],
    [("Equalize", 0.8, 8), ("Equalize", 0.6, 3)],
    [("PosterizeOriginal", 0.6, 7), ("PosterizeOriginal", 0.6, 6)],
    [("Equalize", 0.4, 7), ("Solarize", 0.2, 4)],
    [("Equalize", 0.4, 4), ("Rotate", 0.8, 8)],
    [("Solarize", 0.6, 3), ("Equalize", 0.6, 7)],
    [("PosterizeOriginal", 0.8, 5), ("Equalize", 1.0, 2)],
    [("Rotate", 0.2, 3), ("Solarize", 0.6, 8)],
    [("Equalize", 0.6, 8), ("PosterizeOriginal", 0.4, 6)],
    [("Rotate", 0.8, 8), ("Color", 0.4, 0)],
    [("Rotate", 0.4, 9), ("Equalize", 0.6, 2)],
    [("Equalize", 0.0, 7), ("Equalize", 0.8, 8)],
    [("Invert", 0.6, 4), ("Equalize", 1.0, 8)],
    [("Color", 0.6, 4), ("Contrast", 1.0, 8)],
    [("Rotate", 0.8, 8), ("Color", 1.0, 2)],
    [("Color", 0.8, 8), ("Solarize", 0.8, 7)],
    [("Sharpness", 0.4, 7), ("Invert", 0.6, 8)],
    [("ShearX", 0.6, 5), ("Equalize", 1.0, 9)],
    [("Color", 0.4, 0), ("Equalize", 0.6, 3)],
    [("Equalize", 0.4, 7), ("Solarize", 0.2, 4)],
    [("Solarize", 0.6, 5), ("AutoContrast", 0.6, 5)],
    [("Invert", 0.6, 4), ("Equalize", 1.0, 8)],
    [("Color", 0.6, 4), ("Contrast", 1.0, 8)],
    [("Equalize", 0.8, 8), ("Equalize", 0.6, 3)],
]


def aa_apply(name: str, level: float, x, sign, interp=None):
    """One 'original'-policy op at its level; ``sign`` and ``interp`` are
    per-sample [B] tensors (or numbers / None) for the signed and
    geometric ops."""
    l10 = level / 10.0
    if name == "PosterizeOriginal":
        bits = int(l10 * 4) + 4
        if bits >= 8:
            return x
        q = 2.0 ** (8 - bits)
        return torch.floor(x.clamp(0, 255) / q) * q
    if name == "Solarize":
        return torch.where(x < float(int(l10 * 256)), x, 255.0 - x)
    if name == "Rotate":
        return rotate_deg(x, sign * (l10 * 30.0), interp)
    if name == "ShearX":
        return affine_sample(x, 1.0, sign * (l10 * 0.3), 0.0, 0.0, 1.0, 0.0, interp)
    if name == "AutoContrast":
        return op_autocontrast(x, 0.0)
    if name == "Equalize":
        return op_equalize(x, 0.0)
    if name == "Invert":
        return op_invert(x, 0.0)
    factor = l10 * 1.8 + 0.1
    if name == "Color":
        return _blend(x, _gray(x), factor)
    if name == "Contrast":
        return _blend(x, _gray(x).mean(dim=(2, 3, 4), keepdim=True), factor)
    if name == "Sharpness":
        return _blend(x, _smooth(x), factor)
    raise ValueError(f"unknown AutoAugment op {name}")


def autoaugment_original_batch(gen: torch.Generator, clips: torch.Tensor) -> torch.Tensor:
    """[B, T, H, W, C] float 0..255 through a random sub-policy per sample,
    the same parameters for all frames. Updates ``clips`` in place and
    returns it."""
    b, dev = clips.shape[0], clips.device
    pol = torch.randint(0, len(AA_ORIGINAL_POLICY), (b,), generator=gen, device=dev)
    u = torch.rand((b, 2, 3), generator=gen, device=dev)  # per op: apply, sign, filter
    probs = torch.tensor([[p for _, p, _ in e] for e in AA_ORIGINAL_POLICY], device=dev)
    gate = (u[..., 0] < probs[pol]).tolist()
    pol = pol.tolist()
    for j in range(2):
        groups = {}
        for i in range(b):
            if gate[i][j]:
                name, _, level = AA_ORIGINAL_POLICY[pol[i]][j]
                groups.setdefault((name, level), []).append(i)
        for (name, level), rows in sorted(groups.items()):
            idx = torch.tensor(rows, device=dev)
            clips[idx] = aa_apply(name, float(level), clips[idx], _sign(u[idx, j, 1]),
                                  u[idx, j, 2] < 0.5).clamp(0.0, 255.0)
    return clips
