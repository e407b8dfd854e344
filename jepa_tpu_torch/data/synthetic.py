"""Synthetic structure-separable video datasets (no external data needed).

Drifting sinusoidal gratings in two classes — vertical (class 0, intensity
varies along x) vs horizontal (class 1, along y) — with per-video random
phase, spatial period, drift velocity, per-channel gain/offset, and pixel
noise. Mean color / brightness is class-uninformative by construction and
the random phase kills any fixed linear functional of the pixels, so a
linear-ish readout of a random-init encoder has little to latch onto while
orientation (a second-order statistic) is the dominant predictable
structure a V-JEPA objective can learn (counterpart of
jepa_tpu/data/synthetic.py, the same numpy generators).
``write_grating_dataset`` writes them as mpeg4 files with CSV manifests
through the native encoder (``native.videodec.write_video``).
"""

from __future__ import annotations

import os

import numpy as np


def grating_video(
    rng: np.random.Generator,
    cls: int,
    num_frames: int = 16,
    size: int = 64,
    amp_range: tuple = (25.0, 60.0),
    noise: float = 8.0,
) -> np.ndarray:
    """One [T, H, W, 3] uint8 drifting grating; cls 0 vertical, 1 horizontal.

    amp_range/noise set the per-pixel SNR: at low amplitude + heavy iid
    noise the orientation signal survives only as a spatial second-order
    statistic, which random patch projections transmit poorly while a
    pretrained encoder that learned to PREDICT grating structure (denoise)
    keeps it — the regime the representation-quality test runs in."""
    period = rng.uniform(8.0, 16.0)
    phase = rng.uniform(0.0, 2 * np.pi)
    speed = rng.uniform(0.5, 2.5) * (1 if rng.random() < 0.5 else -1)
    amp = rng.uniform(*amp_range, size=3)
    off = rng.uniform(80.0, 170.0, size=3)
    y, x = np.mgrid[0:size, 0:size].astype(np.float32)
    coord = x if cls == 0 else y
    out = np.empty((num_frames, size, size, 3), np.uint8)
    for t in range(num_frames):
        base = np.sin(2 * np.pi * (coord + speed * t) / period + phase)
        frame = off[None, None, :] + amp[None, None, :] * base[:, :, None]
        frame = frame + rng.uniform(-noise, noise, size=frame.shape)
        out[t] = np.clip(frame, 0, 255).astype(np.uint8)
    return out


def gabor_field_video(
    rng: np.random.Generator,
    cls: int,
    num_frames: int = 16,
    size: int = 96,
    n_patches: int = 10,
    noise: float = 20.0,
    photometric: bool = True,
) -> np.ndarray:
    """[T, H, W, 3] uint8 field of localized drifting Gabor patches; class =
    patch orientation band (0: near-vertical +-25deg, 1: near-horizontal).

    Unlike the full-field grating, structure is LOCAL: each token sees a
    different subset of patches at random positions with per-patch phase
    drift, so a useful representation must encode per-location oriented
    structure (high intrinsic dimension — the anti-collapse regime the
    representation-quality test needs; a global grating collapses a tiny
    V-JEPA run to eff-rank ~3 features, scripts/diag_repr.py round 5).

    photometric=False removes the per-video color/brightness draw (fixed
    mid-gray offset, unit gain). Per-video photometry is the EASIEST
    globally-predictable factor, so a tiny V-JEPA run can spend its
    low-rank feature budget on it; but fixing photometry does NOT by
    itself stabilize orientation learning (measured round 5: 768-step
    photometric=False arms across seeds land enc ridge 54-79% — sparse
    n_patches=10 / noise=20 orientation structure is learned or missed
    per-seed regardless of the nuisance). The lever that stabilizes
    learning is SIGNAL DENSITY: n_patches up / noise down makes oriented
    structure the dominant predictable factor everywhere in the frame;
    the same density also raises the random-init second-order leak into
    pooled features (measured ridge 0.729 at n_patches=16/noise=10 vs
    exact chance at n_patches=10/noise=20), so a dense-regime claim is a
    measured MARGIN over random init, not an absolute-chance baseline."""
    base = (0.0 if cls == 0 else np.pi / 2) + rng.uniform(-0.45, 0.45)
    y, x = np.mgrid[0:size, 0:size].astype(np.float32)
    acc = np.zeros((num_frames, size, size), np.float32)
    for _ in range(n_patches):
        theta = base + rng.uniform(-0.12, 0.12)
        period = rng.uniform(6.0, 12.0)
        sigma = rng.uniform(5.0, 9.0)
        cx, cy = rng.uniform(8, size - 8, size=2)
        vx, vy = rng.uniform(-1.5, 1.5, size=2)
        phase = rng.uniform(0, 2 * np.pi)
        drift = rng.uniform(-1.5, 1.5)
        amp = rng.uniform(60.0, 110.0)
        kx, ky = np.cos(theta), np.sin(theta)
        for t in range(num_frames):
            cxt, cyt = cx + vx * t, cy + vy * t
            env = np.exp(-(((x - cxt) ** 2 + (y - cyt) ** 2)
                           / (2 * sigma ** 2)))
            carrier = np.sin(2 * np.pi * (kx * (x - cxt) + ky * (y - cyt)
                                          + drift * t) / period + phase)
            acc[t] += amp * env * carrier
    if photometric:
        off = rng.uniform(90.0, 160.0, size=3)
        gain = rng.uniform(0.8, 1.2, size=3)
    else:
        off = np.full(3, 128.0)
        gain = np.ones(3)
    out = np.empty((num_frames, size, size, 3), np.uint8)
    for t in range(num_frames):
        fr = off[None, None, :] + gain[None, None, :] * acc[t][:, :, None]
        fr = fr + rng.uniform(-noise, noise, size=fr.shape)
        out[t] = np.clip(fr, 0, 255).astype(np.uint8)
    return out


def write_grating_dataset(
    out_dir: str,
    n_train_per_class: int,
    n_val_per_class: int,
    num_frames: int = 16,
    size: int = 64,
    seed: int = 0,
    fps: float = 30.0,
    amp_range: tuple = (25.0, 60.0),
    noise: float = 8.0,
    kind: str = "grating",
    photometric: bool = True,
    n_patches: int = 10,
):
    """Write synthetic videos as mpeg4 files + reference-format CSVs.

    kind: "grating" (full-field, low intrinsic dimension) or "gabor"
    (localized patch field, the representation-quality regime).

    Returns (train_csv, val_csv) with '<path> <label>' rows (the manifest
    ``VideoDataset`` reads). The train split doubles as the unlabeled
    pretraining pool.
    """
    from jepa_tpu_torch.native.videodec import write_video

    os.makedirs(out_dir, exist_ok=True)
    rows = {"train": [], "val": []}
    for split, n in (("train", n_train_per_class), ("val", n_val_per_class)):
        for cls in range(2):
            for i in range(n):
                rng = np.random.default_rng([seed, cls, i, 0 if split == "train" else 1])
                path = os.path.join(out_dir, f"{split}_c{cls}_v{i}.mp4")
                if kind == "gabor":
                    vid = gabor_field_video(rng, cls, num_frames, size, n_patches=n_patches,
                                            noise=noise, photometric=photometric)
                else:
                    vid = grating_video(rng, cls, num_frames, size, amp_range=amp_range,
                                        noise=noise)
                write_video(path, vid, fps)
                rows[split].append(f"{path} {cls}")
    train_csv = os.path.join(out_dir, "train.csv")
    val_csv = os.path.join(out_dir, "val.csv")
    for name, csv in (("train", train_csv), ("val", val_csv)):
        with open(csv, "w") as f:
            f.write("\n".join(rows[name]) + "\n")
    return train_csv, val_csv
