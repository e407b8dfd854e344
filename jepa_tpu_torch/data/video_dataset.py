"""Video dataset: CSV/npy manifests, clip sampling, pluggable decode
(counterpart of jepa_tpu/data/video_dataset.py, the same numpy host code).

Capability parity with reference src/datasets/video_dataset.py:
  * manifests: space-delimited CSV "path label" or .npy path lists
    (reference :129-151), multi-dataset concat with per-dataset sampling
    weights (weight dw spread as dw/num_samples per sample, :147-151)
  * clip sampling: partition the video into num_clips equal segments, take
    a random (or trailing) window of fpc*frame_step frames per segment,
    linspace fpc frames inside it; short-video padding by repeating the
    last frame; optional overlapping clips (reference :223-263)
  * duration mode: frame_step derived from fps (reference :209-214)
  * file-size filters and infinite retry with random resample on corrupt
    videos (reference :159-166, 194-199)

Decoding is a pluggable backend: the native FFmpeg library
(``jepa_tpu_torch.native``, ``decode_backend: native``) for video files,
raw .npy/.npz clip files or synthetic video; ``auto`` takes the native
decoder and falls back to npy, with a warning, only where that library
cannot be built or loaded, as the JAX package does. Augmentation runs on
the device (jepa_tpu_torch/data/transforms.py), so this module returns raw
uint8 frames.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)


# --------------------------------------------------------------------------
# Decode backends
# --------------------------------------------------------------------------

def scaled_size(h: int, w: int, short_side: int, canvas: Tuple[int, int]):
    """Short-side scale capped so the result fits the canvas."""
    scale = min(short_side / min(h, w), canvas[0] / h, canvas[1] / w)
    return max(1, int(round(h * scale))), max(1, int(round(w * scale)))


def letterbox(frames: np.ndarray, canvas: Tuple[int, int]) -> np.ndarray:
    """[T, h, w, 3] -> zero-padded [T, Hc, Wc, 3], content at top-left."""
    t, h, w, c = frames.shape
    if (h, w) == tuple(canvas):
        return frames
    out = np.zeros((t, canvas[0], canvas[1], c), frames.dtype)
    out[:, :h, :w] = frames
    return out


class DecodeError(Exception):
    pass


def decode_npy(path: str, indices: np.ndarray) -> np.ndarray:
    """Raw-clip backend: .npy/.npz file holding uint8 [T, H, W, 3]."""
    arr = np.load(path, allow_pickle=False)
    if hasattr(arr, "files"):  # npz
        arr = arr[arr.files[0]]
    idx = np.clip(indices, 0, len(arr) - 1)
    return np.ascontiguousarray(arr[idx])


def _stable_hash(path: str) -> int:
    """Process-independent path hash (built-in hash() is randomized per
    process, which would give each multi-host rank different synthetic
    content for the same path)."""
    import zlib

    return zlib.crc32(path.encode()) & 0x7FFFFFFF


class SyntheticBackend:
    """Deterministic synthetic video (tests / benchmarks without data)."""

    # per-path native aspect pool for aspect-preserving mode (tests)
    _ASPECTS = ((4, 3), (16, 9), (9, 16), (1, 1))

    def __init__(self, num_frames=300, height=256, width=320, fps=30.0,
                 short_side=None, canvas=None):
        self.num_frames, self.height, self.width, self.fps = num_frames, height, width, fps
        self.short_side = short_side
        self.canvas = canvas if canvas is not None else (
            (2 * short_side, 2 * short_side) if short_side else None
        )

    def probe(self, path: str):
        return self.num_frames, self.fps

    def _render(self, path: str, indices, height: int, width: int) -> np.ndarray:
        seed = _stable_hash(path)
        rng = np.random.default_rng(seed)
        phase = rng.uniform(0, 2 * np.pi, 3)
        freq = rng.uniform(0.02, 0.2, 3)
        y, x = np.mgrid[0:height, 0:width]
        out = np.empty((len(indices), height, width, 3), np.uint8)
        for n, t in enumerate(indices):
            for c in range(3):
                v = 127.5 * (1 + np.sin(freq[c] * (x + 2.0 * t) + phase[c]) * np.cos(freq[c] * (y - t)))
                out[n, :, :, c] = v.astype(np.uint8)
        return out

    def decode(self, path: str, indices: np.ndarray) -> np.ndarray:
        return self._render(path, indices, self.height, self.width)

    def decode_aspect(self, path: str, indices: np.ndarray):
        ar = self._ASPECTS[_stable_hash(path) % len(self._ASPECTS)]
        base = 240
        h, w = base * ar[1] // min(ar), base * ar[0] // min(ar)
        hp, wp = scaled_size(h, w, self.short_side, self.canvas)
        frames = self._render(path, indices, hp, wp)
        return letterbox(frames, self.canvas), (hp, wp)


class NpyBackend:
    def probe(self, path: str):
        arr = np.load(path, mmap_mode="r")
        return len(arr), 30.0

    def decode(self, path: str, indices: np.ndarray) -> np.ndarray:
        return decode_npy(path, indices)


def get_backend(name: str, decode_size=None, short_side=None, canvas=None):
    """decode_size (h, w): fixed decode canvas so raw frames batch uniformly
    (the native decoder resizes inside sws_scale). short_side (+ optional
    canvas): aspect-preserving mode — per-video short-side resize,
    letterboxed onto a static canvas with a valid-size sidecar (see
    ``native.videodec.NativeBackend``)."""
    if name == "synthetic":
        if short_side is not None:
            return SyntheticBackend(short_side=short_side, canvas=canvas)
        if decode_size is not None:
            return SyntheticBackend(height=decode_size[0], width=decode_size[1])
        return SyntheticBackend()
    if name == "npy":
        if short_side is not None:
            raise ValueError("npy backend does not support aspect-preserving decode")
        return NpyBackend()
    if name == "native":
        from jepa_tpu_torch.native.videodec import NativeBackend

        return NativeBackend(out_size=decode_size, short_side=short_side, canvas=canvas)
    if name == "auto":
        try:
            from jepa_tpu_torch.native.videodec import NativeBackend

            return NativeBackend(out_size=decode_size, short_side=short_side, canvas=canvas)
        except Exception as e:
            logger.warning("native video decoder unavailable (%s); using npy backend", e)
            return NpyBackend()
    raise ValueError(f"unknown decode backend {name!r}")


# --------------------------------------------------------------------------
# Manifest + dataset
# --------------------------------------------------------------------------


def load_manifests(data_paths: Sequence[str], datasets_weights=None):
    """Returns (samples, labels, per_sample_weights or None)."""
    samples: List[str] = []
    labels: List[int] = []
    per_dataset_counts: List[int] = []
    for p in data_paths:
        if p.endswith(".csv"):
            rows = []
            with open(p) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    parts = line.rsplit(" ", 1)
                    rows.append((parts[0], int(float(parts[1])) if len(parts) > 1 else 0))
            samples += [r[0] for r in rows]
            labels += [r[1] for r in rows]
            per_dataset_counts.append(len(rows))
        elif p.endswith(".npy"):
            data = np.load(p, allow_pickle=True)
            data = [str(x) for x in data]
            samples += data
            labels += [0] * len(data)
            per_dataset_counts.append(len(data))
        else:
            raise ValueError(f"unsupported manifest type: {p}")
    weights = None
    if datasets_weights is not None:
        assert len(datasets_weights) == len(per_dataset_counts)
        weights = []
        for dw, ns in zip(datasets_weights, per_dataset_counts):
            weights += [dw / ns] * ns
        weights = np.asarray(weights, np.float64)
    return samples, labels, weights


def sample_clip_indices(
    video_len: int,
    fpc: int,
    frame_step: int,
    num_clips: int,
    random_clip_sampling: bool,
    allow_clip_overlap: bool,
    rng: np.random.Generator,
) -> List[np.ndarray]:
    """Per-segment frame indices (reference video_dataset.py:223-263)."""
    clip_len = int(fpc * frame_step)
    partition_len = video_len // num_clips
    clips = []
    for i in range(num_clips):
        if partition_len > clip_len:
            end_indx = clip_len
            if random_clip_sampling:
                end_indx = int(rng.integers(clip_len, partition_len))
            start_indx = end_indx - clip_len
            indices = np.linspace(start_indx, end_indx, num=fpc)
            indices = np.clip(indices, start_indx, end_indx - 1).astype(np.int64)
            indices = indices + i * partition_len
        elif not allow_clip_overlap:
            indices = np.linspace(0, partition_len, num=max(1, partition_len // frame_step))
            indices = np.concatenate(
                [indices, np.ones(fpc - len(indices)) * partition_len]
            )
            indices = np.clip(indices, 0, partition_len - 1).astype(np.int64)
            indices = indices + i * partition_len
        else:
            sample_len = min(clip_len, video_len) - 1
            indices = np.linspace(0, sample_len, num=max(1, sample_len // frame_step))
            indices = np.concatenate([indices, np.ones(fpc - len(indices)) * sample_len])
            indices = np.clip(indices, 0, sample_len - 1).astype(np.int64)
            clip_step = 0
            if video_len > clip_len and num_clips > 1:
                clip_step = (video_len - clip_len) // (num_clips - 1)
            indices = indices + i * clip_step
        clips.append(indices[:fpc])
    return clips


@dataclasses.dataclass
class VideoDataset:
    """Map-style dataset over video manifests returning raw uint8 clips."""

    data_paths: Sequence[str]
    datasets_weights: Optional[Sequence[float]] = None
    frames_per_clip: int = 16
    frame_step: int = 4
    num_clips: int = 1
    random_clip_sampling: bool = True
    allow_clip_overlap: bool = False
    filter_short_videos: bool = False
    filter_long_videos: int = int(1e9)
    duration: Optional[float] = None
    decode_backend: str = "auto"
    decode_size: Optional[Tuple[int, int]] = None
    decode_short_side: Optional[int] = None
    decode_canvas: Optional[Tuple[int, int]] = None
    seed: int = 0

    def __post_init__(self):
        self.samples, self.labels, self.sample_weights = load_manifests(
            self.data_paths, self.datasets_weights
        )
        self.backend = get_backend(
            self.decode_backend, self.decode_size,
            short_side=self.decode_short_side, canvas=self.decode_canvas,
        )
        self._epoch = 0

    def set_epoch(self, epoch: int):
        """Advance the clip-sampling stream. Randomness in __getitem__ is a
        pure function of (seed, epoch, index) — there is NO shared mutable
        rng, so results are identical regardless of worker count, worker
        scheduling, or which rank loads the item (torch's DataLoader gets
        run-to-run reproducibility from deterministic worker index slices,
        reference video_dataset.py:77-85; a dynamically-scheduled pool needs
        item-keyed derivation instead)."""
        self._epoch = int(epoch)

    def __len__(self):
        return len(self.samples)

    def _load(self, path: str, rng: np.random.Generator):
        if self.decode_backend not in ("synthetic",):
            if not os.path.exists(path):
                warnings.warn(f"video path not found {path}")
                return None, None, None
            fsize = os.path.getsize(path)
            if fsize < 1 * 1024:
                warnings.warn(f"video too short {path}")
                return None, None, None
            if fsize > self.filter_long_videos:
                warnings.warn(f"skipping long video of size {fsize} bytes")
                return None, None, None
        try:
            video_len, fps = self.backend.probe(path)
        except Exception as e:
            warnings.warn(f"probe failed for {path}: {e}")
            return None, None, None
        fstp = self.frame_step
        if self.duration is not None and fps:
            fstp = max(1, int(self.duration * fps / self.frames_per_clip))
        clip_len = int(self.frames_per_clip * fstp)
        if self.filter_short_videos and video_len < clip_len:
            warnings.warn(f"skipping short video of length {video_len}")
            return None, None, None
        clip_indices = sample_clip_indices(
            video_len,
            self.frames_per_clip,
            fstp,
            self.num_clips,
            self.random_clip_sampling,
            self.allow_clip_overlap,
            rng,
        )
        all_idx = np.concatenate(clip_indices)
        try:
            if self.decode_short_side is not None:
                buffer, valid_hw = self.backend.decode_aspect(path, all_idx)
            else:
                buffer = self.backend.decode(path, all_idx)
                valid_hw = buffer.shape[1:3]
        except Exception as e:
            warnings.warn(f"decode failed for {path}: {e}")
            return None, None, None
        return buffer, clip_indices, np.asarray(valid_hw, np.int32)

    def __getitem__(self, index: int):
        """Returns (clips: [num_clips, fpc, H, W, 3] uint8, label,
        clip_indices, valid_hw [2] int32 — the un-letterboxed frame size in
        aspect-preserving mode, else the full frame size).

        Corrupt/missing videos are skipped by resampling a random index
        indefinitely (reference :159-166).

        Deterministic: all randomness (clip-window offsets, corrupt-retry
        resampling) comes from an rng derived from (seed, epoch, index), so
        the same item is byte-identical across runs, worker counts, and
        ranks.
        """
        rng = np.random.default_rng((self.seed, self._epoch, index))
        while True:
            buffer, clip_indices, valid_hw = self._load(self.samples[index], rng)
            if buffer is not None:
                break
            index = int(rng.integers(0, len(self)))
        fpc = self.frames_per_clip
        clips = buffer.reshape(self.num_clips, fpc, *buffer.shape[1:])
        return clips, self.labels[index], clip_indices, valid_hw
