"""The port's data path vs the JAX package on the CPU: the samplers, the
manifest and clip-index sampling, the synthetic and npy decode, the
collate and the loader give identical arrays; the device augmentation's
bilinear crop-resize and normalization match the JAX functions on a given
box, and the crop boxes drawn by torch's generator stay inside the
configured scale and aspect ranges. JAX runs first in each test, torch
after.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepa_tpu.data import loader as jax_loader
from jepa_tpu.data import synthetic as jax_synthetic
from jepa_tpu.data import transforms as jax_tf
from jepa_tpu.data import video_dataset as jax_vd
from jepa_tpu_torch.data import loader, synthetic, transforms, video_dataset
from jepa_tpu_torch.data.manager import init_data


@pytest.mark.parametrize("world", [1, 3])
def test_samplers_match_jax(world):
    for rank in range(world):
        for epoch in (0, 4):
            kw = dict(rank=rank, world_size=world, seed=5)
            js = jax_loader.ShardedSampler(23, **kw)
            ps = loader.ShardedSampler(23, **kw)
            weights = np.linspace(1.0, 3.0, 17)
            jw = jax_loader.WeightedShardedSampler(weights, **kw)
            pw = loader.WeightedShardedSampler(weights, **kw)
            for j, p in ((js, ps), (jw, pw)):
                j.set_epoch(epoch)
                p.set_epoch(epoch)
                assert list(p) == list(j) and len(p) == len(j)


def test_clip_indices_and_manifests_match_jax(tmp_path):
    for args in ((300, 16, 4, 1, True, False), (50, 16, 4, 2, True, False),
                 (40, 8, 4, 3, False, True), (30, 16, 2, 1, True, True)):
        want = jax_vd.sample_clip_indices(*args, np.random.default_rng(3))
        got = video_dataset.sample_clip_indices(*args, np.random.default_rng(3))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    a, b = tmp_path / "a.csv", tmp_path / "b.npy"
    a.write_text("x/one.mp4 3\nx/two three.mp4 1\n\n")
    np.save(b, np.asarray(["p0.npy", "p1.npy", "p2.npy"]))
    want = jax_vd.load_manifests([str(a), str(b)], [0.25, 0.75])
    got = video_dataset.load_manifests([str(a), str(b)], [0.25, 0.75])
    assert got[:2] == want[:2]
    np.testing.assert_array_equal(got[2], want[2])


def test_synthetic_and_npy_decode_match_jax(tmp_path):
    idx = np.array([0, 3, 7, 7, 12])
    want = jax_vd.SyntheticBackend(height=24, width=40).decode("synthetic://v3", idx)
    got = video_dataset.SyntheticBackend(height=24, width=40).decode("synthetic://v3", idx)
    np.testing.assert_array_equal(got, want)
    want_a, want_hw = jax_vd.SyntheticBackend(short_side=32).decode_aspect("synthetic://v5", idx)
    got_a, got_hw = video_dataset.SyntheticBackend(short_side=32).decode_aspect("synthetic://v5", idx)
    np.testing.assert_array_equal(got_a, want_a)
    assert got_hw == want_hw
    clip = np.random.default_rng(0).integers(0, 255, (9, 6, 8, 3), dtype=np.uint8)
    np.save(tmp_path / "c.npy", clip)
    np.testing.assert_array_equal(video_dataset.decode_npy(str(tmp_path / "c.npy"), idx),
                                  jax_vd.decode_npy(str(tmp_path / "c.npy"), idx))
    for kind in ("grating_video", "gabor_field_video"):
        want = getattr(jax_synthetic, kind)(np.random.default_rng(2), 1, num_frames=3, size=32)
        got = getattr(synthetic, kind)(np.random.default_rng(2), 1, num_frames=3, size=32)
        np.testing.assert_array_equal(got, want)


def test_loader_batches_match_jax(tmp_path):
    """make_video_loader over a synthetic manifest: the same batches (clips,
    labels, clip indices, valid sizes) for the same seed and epoch."""
    manifest = tmp_path / "m.csv"
    manifest.write_text("".join(f"synthetic://video{i} {i % 3}\n" for i in range(7)))
    kw = dict(data_paths=[str(manifest)], batch_size=3, frames_per_clip=4, frame_step=2,
              num_clips=2, decode_backend="synthetic", decode_size=(24, 32),
              num_workers=2, seed=11)
    _, jl, js = jax_loader.make_video_loader(**kw)
    js.set_epoch(1)
    want = list(jl)
    _, pl, ps = loader.make_video_loader(**kw)
    ps.set_epoch(1)
    got = list(pl)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["clips"].shape == (6, 4, 24, 32, 3) and g["clips"].dtype == np.uint8
        for key in ("clips", "labels", "valid_hw"):
            np.testing.assert_array_equal(g[key], w[key])
        for gi, wi in zip(g["clip_indices"], w["clip_indices"]):
            for a, b in zip(gi, wi):
                np.testing.assert_array_equal(a, b)
    _, dl, _ = init_data("videodataset", batch_size=3, root_path=[str(manifest)],
                         clip_len=4, frame_sample_rate=2, decode_backend="synthetic",
                         decode_size=(24, 32), num_workers=1, seed=11)
    assert len(dl) == 2
    # the image branch (ported with the image eval): a tiny ImageFolder
    from PIL import Image

    for i, cls in enumerate(("a", "a", "b")):
        (tmp_path / "imgs" / "train" / cls).mkdir(parents=True, exist_ok=True)
        Image.fromarray(np.full((20, 30, 3), 40 * i, np.uint8)).save(
            tmp_path / "imgs" / "train" / cls / f"{i}.png")
    ds, dl, _ = init_data("imagenet", batch_size=2, root_path=str(tmp_path),
                          image_folder="imgs", output_size=16, num_workers=1)
    assert len(ds) == 3 and len(dl) == 1 and ds.class_to_idx == {"a": 0, "b": 1}
    batch = next(iter(dl))
    assert batch["images"].shape == (2, 16, 16, 3) and batch["images"].dtype == np.uint8
    # native gives a NativeBackend; auto picks it where the library builds
    from jepa_tpu_torch.native import build, videodec

    try:
        build.build()
    except (RuntimeError, OSError):
        assert isinstance(video_dataset.get_backend("auto"), video_dataset.NpyBackend)
    else:
        assert isinstance(video_dataset.get_backend("native"), videodec.NativeBackend)
        assert isinstance(video_dataset.get_backend("auto"), videodec.NativeBackend)


@pytest.mark.parametrize("motion", [False, True])
@pytest.mark.parametrize("letterbox", [False, True])
def test_crop_resize_and_normalize_match_jax(motion, letterbox):
    """On one given box (per frame under motion shift), the batched torch
    resample and normalize equal the JAX functions within 1e-5."""
    rng = np.random.default_rng(int(motion) + 2 * int(letterbox))
    t, h, w = 3, 40, 56
    frames = rng.integers(0, 256, (2, t, h, w, 3), dtype=np.uint8)
    vhw = np.array([[31, 44], [40, 50]], np.int32) if letterbox else None
    shape = (2, t) if motion else (2,)
    box = [rng.uniform(0, 6, shape), rng.uniform(0, 6, shape),
           rng.uniform(12, 30, shape), rng.uniform(12, 40, shape)]
    box = [b.astype(np.float32) for b in box]
    want = []
    for s in range(2):
        out = jax_tf._bilinear_crop_resize(
            jnp.asarray(frames[s], jnp.float32), *[jnp.asarray(b[s]) for b in box], (16, 16),
            valid_hw=None if vhw is None else jnp.asarray(vhw[s]))
        mean = jnp.asarray(jax_tf.IMAGENET_MEAN, jnp.float32) * 255.0
        std = jnp.asarray(jax_tf.IMAGENET_STD, jnp.float32) * 255.0
        want.append(np.asarray((out - mean) / std))
    want = np.stack(want)

    got = transforms.bilinear_crop_resize(
        torch.from_numpy(frames), *[torch.from_numpy(b) for b in box], (16, 16),
        valid_hw=None if vhw is None else torch.from_numpy(vhw))
    got = transforms.normalize(got)
    assert got.shape == (2, t, 16, 16, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_crop_boxes_stay_in_scale_and_ratio():
    gen = torch.Generator().manual_seed(0)
    h = torch.tensor([256.0, 240.0, 320.0, 100.0] * 64)
    w = torch.tensor([320.0, 427.0, 180.0, 100.0] * 64)
    scale, ratio = (0.3, 1.0), (0.75, 1.35)
    i, j, bh, bw = transforms.sample_crop_boxes(gen, h, w, scale, ratio)
    eps = 1e-4
    assert (i >= 0).all() and (j >= 0).all()
    assert (i + bh <= h + eps).all() and (j + bw <= w + eps).all()
    frac = bh * bw / (h * w)
    assert (frac >= scale[0] - eps).all() and (frac <= scale[1] + eps).all()
    r = bw / bh
    assert (r >= ratio[0] - eps).all() and (r <= ratio[1] + eps).all()
    again = transforms.sample_crop_boxes(torch.Generator().manual_seed(0), h, w, scale, ratio)
    assert all(torch.equal(a, b) for a, b in zip(again, (i, j, bh, bw)))


def test_pretrain_augment_shapes_and_seed():
    clips = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (3, 4, 30, 40, 3), dtype=np.uint8))
    cfg = transforms.AugmentCfg(crop_size=16, motion_shift=True, reprob=1.0)
    out = transforms.pretrain_augment(torch.Generator().manual_seed(3), clips, cfg)
    again = transforms.pretrain_augment(torch.Generator().manual_seed(3), clips, cfg)
    assert out.shape == (3, 4, 16, 16, 3) and torch.isfinite(out).all()
    assert torch.equal(out, again)
    # the probes' RandAugment branch (ported with the frozen evals) runs too
    ra = transforms.pretrain_augment(torch.Generator().manual_seed(3), clips,
                                     transforms.AugmentCfg(crop_size=16, auto_augment="rand-m7-n4"))
    assert ra.shape == (3, 4, 16, 16, 3) and torch.isfinite(ra).all()
