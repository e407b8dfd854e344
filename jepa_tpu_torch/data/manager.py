"""Dataset factory: one entry point for every dataset family (counterpart
of jepa_tpu/data/manager.py; reference src/datasets/data_manager.py:15-91),
returning (dataset, loader, sampler): the video loader, or the image
evals' ImageFolder loader.
"""

from __future__ import annotations

from typing import Tuple

_IMAGE_DATASETS = {"imagenet", "inat21", "places205", "imagefolder"}


def init_data(
    data: str,
    batch_size: int,
    training: bool = True,
    rank: int = 0,
    world_size: int = 1,
    num_workers: int = 8,
    seed: int = 0,
    # video args
    root_path=None,
    clip_len: int = 16,
    frame_sample_rate: int = 4,
    num_clips: int = 1,
    duration=None,
    allow_clip_overlap: bool = False,
    filter_short_videos: bool = False,
    filter_long_videos: int = int(1e9),
    datasets_weights=None,
    decode_backend: str = "auto",
    decode_size=None,
    drop_last: bool = True,
    # image args
    image_folder: str = "",
    output_size: int = 256,
    resize_short=None,
    **unused,
) -> Tuple:
    """Returns (dataset, loader, sampler)."""
    kind = data.lower()
    if kind in ("videodataset", "video"):
        from jepa_tpu_torch.data.loader import make_video_loader

        return make_video_loader(
            data_paths=root_path,
            batch_size=batch_size,
            frames_per_clip=clip_len,
            frame_step=frame_sample_rate,
            num_clips=num_clips,
            datasets_weights=datasets_weights,
            allow_clip_overlap=allow_clip_overlap,
            filter_short_videos=filter_short_videos,
            filter_long_videos=filter_long_videos,
            duration=duration,
            decode_backend=decode_backend,
            decode_size=decode_size,
            rank=rank, world_size=world_size, num_workers=num_workers,
            seed=seed, training=training, drop_last=drop_last,
        )
    if kind in _IMAGE_DATASETS:
        from jepa_tpu_torch.data.image_dataset import make_image_loader

        return make_image_loader(
            root_path=root_path, image_folder=image_folder, batch_size=batch_size,
            training=training, output_size=output_size, resize_short=resize_short,
            rank=rank, world_size=world_size, num_workers=num_workers, seed=seed,
            drop_last=drop_last if training else False)
    raise ValueError(f"unknown dataset type {data!r}")
