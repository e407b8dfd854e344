"""ImageFolder dataset (PIL) for the frozen image-classification probes
(counterpart of jepa_tpu/data/image_dataset.py, the same host code;
reference src/datasets/image_dataset.py:19-79).

Classes are the sorted subdirectories of ``root/image_folder/{train,val}``;
images load through PIL (imported inside the loader, so this module imports
where Pillow is absent) and come out as fixed-size uint8 arrays: a
short-side resize and a centre crop on the host, everything else on the
device (``data.transforms``). With more than one worker the loader decodes
in a process pool (PIL's decode holds the GIL), as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import List, Optional, Tuple

import numpy as np

_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp", ".ppm")


def _resize_short_side(img, size: int):
    w, h = img.size
    scale = size / min(w, h)
    return img.resize((max(size, int(round(w * scale))), max(size, int(round(h * scale)))),
                      2)  # BILINEAR


def _center_crop(arr: np.ndarray, ch: int, cw: int) -> np.ndarray:
    h, w = arr.shape[:2]
    i = max(0, (h - ch) // 2)
    j = max(0, (w - cw) // 2)
    return arr[i:i + ch, j:j + cw]


@dataclasses.dataclass
class ImageFolder:
    """root/image_folder/{train|val}/<class>/<img>; items are (uint8 HWC, label)."""

    root: str
    image_folder: str = "imagenet_full_size/061417/"
    train: bool = True
    output_size: int = 256
    resize_short: Optional[int] = None  # default: output_size

    def __post_init__(self):
        split = "train" if self.train else "val"
        self.data_path = os.path.join(self.root, self.image_folder, split)
        classes = sorted(d for d in os.listdir(self.data_path)
                         if os.path.isdir(os.path.join(self.data_path, d)))
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples: List[Tuple[str, int]] = []
        for c in classes:
            cdir = os.path.join(self.data_path, c)
            for fn in sorted(os.listdir(cdir)):
                if fn.lower().endswith(_EXTS):
                    self.samples.append((os.path.join(cdir, fn), self.class_to_idx[c]))
        if not self.samples:
            raise FileNotFoundError(f"no images under {self.data_path}")

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, index: int):
        from PIL import Image

        # the retry draw on an unreadable file is keyed by the requested
        # index: deterministic across runs and workers
        retry = np.random.default_rng((7, index))
        while True:
            path, label = self.samples[index]
            try:
                with Image.open(path) as im:
                    im = _resize_short_side(im.convert("RGB"),
                                            self.resize_short or self.output_size)
                    arr = np.asarray(im, dtype=np.uint8)
                break
            except OSError as e:
                warnings.warn(f"failed to load image {path}: {e}")
                index = int(retry.integers(0, len(self)))
        return _center_crop(arr, self.output_size, self.output_size), label


def image_collate(items):
    return {"images": np.stack([it[0] for it in items]),
            "labels": np.asarray([it[1] for it in items])}


def make_image_loader(
    *,
    root_path: str,
    image_folder: str,
    batch_size: int,
    training: bool,
    output_size: int = 256,
    resize_short: Optional[int] = None,
    rank: int = 0,
    world_size: int = 1,
    num_workers: int = 8,
    seed: int = 0,
    drop_last: Optional[bool] = None,
    use_processes: Optional[bool] = None,
):
    """(dataset, loader, sampler) over an ImageFolder; drop_last defaults to
    ``training``, use_processes to ``num_workers > 1`` (PIL's JPEG decode
    holds the GIL, so several workers need processes to scale)."""
    from jepa_tpu_torch.data.loader import DataLoader, ShardedSampler

    ds = ImageFolder(root=root_path, image_folder=image_folder, train=training,
                     output_size=output_size, resize_short=resize_short)
    if drop_last is None:
        drop_last = training
    if use_processes is None:
        use_processes = num_workers > 1
    sampler = ShardedSampler(num_samples=len(ds), rank=rank, world_size=world_size,
                             shuffle=training, seed=seed, drop_last=drop_last)
    loader = DataLoader(ds, sampler, batch_size=batch_size, num_workers=num_workers,
                        collate=image_collate, drop_last=drop_last,
                        use_processes=use_processes)
    return ds, loader, sampler
