"""The port's RandAugment and AutoAugment 'original' (jepa_tpu_torch.data.
randaugment) vs the JAX package's on the CPU.

Every op at a fixed magnitude, sign and filter on a seeded [T=2, 32, 32, 3]
clip gives the JAX op's pixels: exactly for invert, posterize, solarize and
equalize (integer-valued arithmetic), within 1e-3 on the 0..255 scale for
the blends and autocontrast (fp32 sums in another order), and within
AFFINE_TOL for the affine warps. The random draws of the two packages
differ (jax.random vs torch.Generator), so the policies are held to their
distributions over >= 2000 draws. JAX runs first in each test, torch after.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepa_tpu.data import randaugment as jra
from jepa_tpu_torch.data import randaugment as ra

EXACT = {"Invert", "Posterize", "PosterizeOriginal", "Solarize", "Equalize"}
BLEND_TOL = 1e-3  # 0..255 scale
# The warps sum 4 (bilinear) or 16 (bicubic) weighted taps in fp32, in the
# JAX package's order but with XLA's and torch's own fusions, and their
# positions come from fp32 cos/sin: pixels move by a few fp32 ulps of 255
# (measured <= 4.2e-4, the bicubic shears).
AFFINE_TOL = 1e-3
GEOMETRIC = {"Rotate", "ShearX", "ShearY", "TranslateX", "TranslateY"}


def _clip(seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(30, 220, size=(2, 32, 32, 3)).astype(np.float32)


def _tol(name):
    if name in EXACT:
        return 0.0
    return AFFINE_TOL if name in GEOMETRIC else BLEND_TOL


def _ra_cases():
    cases = []
    for name in jra.OP_NAMES:
        if name in GEOMETRIC:
            cases += [(name, 7.0, s, i) for s in (1.0, -1.0) for i in (False, True)]
        elif name in ("Color", "Contrast", "Brightness", "Sharpness"):
            cases += [(name, 7.0, s, False) for s in (1.0, -1.0)]
        else:
            cases.append((name, 7.0, 1.0, False))
    cases.append(("Posterize", 10.0, 1.0, False))  # 0 bits kept: the image goes to 0
    return cases


def _aa_cases():
    ops = sorted({(n, lv) for sub in jra._AA_ORIGINAL_POLICY for n, _, lv in sub})
    return [(n, lv, s, i) for n, lv in ops
            for s, i in ([(1.0, False), (-1.0, True)] if n in ("Rotate", "ShearX")
                         else [(1.0, False)])]


@pytest.mark.parametrize("name,m,sign,interp", _ra_cases())
def test_randaugment_op_matches_jax(name, m, sign, interp):
    clip = _clip(len(name))
    fn = dict(jra._OPS)[name]
    want = np.asarray(fn(jnp.asarray(clip), m, sign, jnp.asarray(interp)))
    got = dict(ra._OPS)[name](torch.from_numpy(clip)[None], torch.tensor([m]),
                              torch.tensor([sign]), torch.tensor([interp]))[0]
    assert got.shape == clip.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=_tol(name), rtol=0)


@pytest.mark.parametrize("name,level,sign,interp", _aa_cases())
def test_autoaugment_op_matches_jax(name, level, sign, interp):
    clip = _clip(int(level) + 1)
    want = np.asarray(jra._aa_apply(name, float(level), jnp.asarray(clip), sign,
                                    jnp.asarray(interp)))
    got = ra.aa_apply(name, float(level), torch.from_numpy(clip)[None],
                      torch.tensor([sign]), torch.tensor([interp]))[0]
    np.testing.assert_allclose(got.numpy(), want, atol=_tol(name), rtol=0)


def test_per_sample_params_match_one_by_one():
    """A batch with a different magnitude, sign and filter per sample equals
    the samples run one at a time (the grouping is per-sample exact)."""
    x = torch.from_numpy(np.stack([_clip(s) for s in range(3)]))
    m, sign = torch.tensor([3.0, 7.0, 9.5]), torch.tensor([1.0, -1.0, 1.0])
    interp = torch.tensor([False, True, True])
    for fn in (ra.op_rotate, ra.op_shear_x, ra.op_translate_y):
        batch = fn(x, m, sign, interp)
        for i in range(3):
            one = fn(x[i:i + 1], m[i:i + 1], sign[i:i + 1], interp[i:i + 1])
            torch.testing.assert_close(batch[i:i + 1], one, rtol=0, atol=0)


@pytest.mark.parametrize("spec", ["rand-m7-n4-mstd0.5-inc1", "rand-m9-mstd0.5",
                                  "rand-n2-m5-inc1-p0.5", "rand"])
def test_randaugment_cfg_from_string_matches_jax(spec):
    want = jra.RandAugmentCfg.from_string(spec)
    got = ra.RandAugmentCfg.from_string(spec)
    assert (got.magnitude, got.num_layers, got.mstd, got.prob) == (
        want.magnitude, want.num_layers, want.mstd, want.prob)


def _binomial_ok(count, n, p, sigmas=5.0):
    return abs(count - n * p) <= sigmas * np.sqrt(n * p * (1 - p))


def test_randaugment_policy_distribution(monkeypatch):
    """2000 clips x 4 layers: ops drawn uniformly from the 15, applied with
    probability 0.5, magnitudes N(7, 0.5) clipped, random signs and
    filters, and every result in 0..255."""
    calls = {name: [] for name in ra.OP_NAMES}

    def recorder(name, fn):
        def op(x, m, sign, interp):
            calls[name].append((m.clone(), sign.clone(), interp.clone()))
            return fn(x, m, sign, interp)
        return op

    monkeypatch.setattr(ra, "_OPS", [(n, recorder(n, f)) for n, f in ra._OPS])
    cfg = ra.RandAugmentCfg.from_string("rand-m7-n4-mstd0.5-inc1")
    n = 2000
    clips = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (n, 1, 2, 2, 3)).astype(np.float32))
    out = ra.randaugment_batch(torch.Generator().manual_seed(0), clips, cfg)
    assert out.shape == (n, 1, 2, 2, 3) and out.min() >= 0 and out.max() <= 255
    per_op = {k: sum(len(c[0]) for c in v) for k, v in calls.items()}
    applied = sum(per_op.values())
    assert _binomial_ok(applied, n * cfg.num_layers, cfg.prob)
    for name, count in per_op.items():
        assert _binomial_ok(count, applied, 1 / len(ra.OP_NAMES)), (name, count)
    mags = torch.cat([c[0] for v in calls.values() for c in v])
    signs = torch.cat([c[1] for v in calls.values() for c in v])
    interps = torch.cat([c[2] for v in calls.values() for c in v])
    assert abs(mags.mean().item() - 7.0) <= 5 * 0.5 / np.sqrt(applied)
    assert abs(mags.std().item() - 0.5) <= 0.05 and mags.min() >= 0 and mags.max() <= 10
    assert _binomial_ok(int((signs > 0).sum()), applied, 0.5)
    assert _binomial_ok(int(interps.sum()), applied, 0.5)


def test_autoaugment_policy_distribution(monkeypatch):
    """2000 clips: sub-policies uniform over the 25, each op gated at its
    probability; every (op, level) is applied as often as the policy
    table says within a 5-sigma binomial bound."""
    seen = {}
    real = ra.aa_apply

    def recorder(name, level, x, sign, interp=None):
        seen[(name, level)] = seen.get((name, level), 0) + x.shape[0]
        return real(name, level, x, sign, interp)

    monkeypatch.setattr(ra, "aa_apply", recorder)
    n = 2000
    clips = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (n, 1, 2, 2, 3)).astype(np.float32))
    out = ra.autoaugment_original_batch(torch.Generator().manual_seed(1), clips)
    assert out.min() >= 0 and out.max() <= 255
    want = {}
    for sub in ra.AA_ORIGINAL_POLICY:
        for name, prob, level in sub:
            key = (name, float(level))
            want[key] = want.get(key, 0.0) + prob / len(ra.AA_ORIGINAL_POLICY)
    assert set(seen) == {k for k, p in want.items() if p > 0}
    for key, p in want.items():
        assert _binomial_ok(seen.get(key, 0), n, min(p, 1.0)), (key, seen.get(key), n * p)
    assert ra.AA_ORIGINAL_POLICY == jra._AA_ORIGINAL_POLICY


def test_pretrain_augment_with_auto_augment_is_seeded():
    """The auto_augment branch of pretrain_augment: RandAugment or AutoAugment
    on the full frames, then the crop; same generator seed, same output."""
    from jepa_tpu_torch.data import transforms

    clips = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (3, 2, 40, 48, 3), dtype=np.uint8))
    for aa in ("rand-m7-n4-mstd0.5-inc1", "original"):
        cfg = transforms.AugmentCfg(crop_size=16, auto_augment=aa, reprob=0.25)
        a = transforms.pretrain_augment(torch.Generator().manual_seed(5), clips, cfg)
        b = transforms.pretrain_augment(torch.Generator().manual_seed(5), clips, cfg)
        plain = transforms.pretrain_augment(
            torch.Generator().manual_seed(5), clips, transforms.AugmentCfg(crop_size=16))
        assert a.shape == (3, 2, 16, 16, 3) and torch.isfinite(a).all()
        assert torch.equal(a, b) and not torch.equal(a, plain)
