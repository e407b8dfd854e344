"""Host-side batch loader: sharded samplers + threaded prefetch
(counterpart of jepa_tpu/data/loader.py, the same numpy host code).

Replaces the reference's torch DataLoader + DistributedSampler +
DistributedWeightedSampler stack (reference: src/datasets/video_dataset.py:
27-88, src/datasets/utils/weighted_sampler.py). One loader per *host*
(not per chip — a host feeds all its local devices through the sharded
batch), decode work fans out over a thread pool (the native video decoder
releases the GIL) or, with ``use_processes``, a fork-based process pool
(for decoders that hold it, as PIL does), and ready batches sit in a
bounded prefetch queue.

Determinism: batch ORDER is deterministic (a single producer walks the
sampler and pool.map preserves submission order), and item CONTENT is
deterministic because dataset randomness is keyed by (seed, epoch, index)
rather than drawn from shared mutable rng state — so a run is bit-identical
across repeats, worker counts, thread scheduling, and rank topologies.

Sampler semantics:
  * ShardedSampler == torch DistributedSampler(shuffle=True, drop_last):
    per-epoch permutation seeded by (seed + epoch), padded to a multiple of
    world_size, sliced rank::world_size.
  * WeightedShardedSampler == the reference's DistributedWeightedSampler:
    per-epoch weighted-with-replacement draw (numpy, >2^24-safe like
    CustomWeightedRandomSampler, reference weighted_sampler.py:61-75), then
    rank slice.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Sequence

import numpy as np


class ShardedSampler:
    def __init__(self, num_samples: int, rank: int = 0, world_size: int = 1,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True):
        self.num_samples = num_samples
        self.rank, self.world = rank, world_size
        self.shuffle, self.seed = shuffle, seed
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.world
        return -(-self.num_samples // self.world)

    def __iter__(self) -> Iterator[int]:
        if self.shuffle:
            g = np.random.default_rng(self.seed + self.epoch)
            order = g.permutation(self.num_samples)
        else:
            order = np.arange(self.num_samples)
        if self.drop_last:
            usable = (len(order) // self.world) * self.world
            order = order[:usable]
        else:
            pad = (-len(order)) % self.world
            order = np.concatenate([order, order[:pad]])
        return iter(order[self.rank :: self.world].tolist())


class WeightedShardedSampler(ShardedSampler):
    def __init__(self, weights: np.ndarray, num_draws: Optional[int] = None, **kw):
        super().__init__(num_samples=num_draws or len(weights), **kw)
        self.weights = np.asarray(weights, np.float64)
        self.weights = self.weights / self.weights.sum()

    def __iter__(self) -> Iterator[int]:
        g = np.random.default_rng(self.seed + self.epoch)
        order = g.choice(len(self.weights), size=self.num_samples, p=self.weights)
        if self.drop_last:
            usable = (len(order) // self.world) * self.world
            order = order[:usable]
        return iter(order[self.rank :: self.world].tolist())


_PROC_DS = None


def _proc_init(ds):
    """Process-pool worker initializer: pin the (forked) dataset. Dataset
    randomness is (seed, epoch, index)-keyed (no shared mutable rng), so
    workers need no per-worker reseeding to stay both decorrelated and
    run-to-run reproducible."""
    global _PROC_DS
    _PROC_DS = ds


def _proc_get(i):
    return _PROC_DS[i]


class DataLoader:
    """Prefetching loader over a map-style dataset.

    collate: list of dataset items -> batch (default stacks clips into
    [B*num_clips, T, H, W, C] uint8 in the reference's clip-major layout
    plus labels). Exhausted iterators restart on the next __iter__.

    use_processes: decode items in a fork-based process pool instead of a
    thread pool. Threads are right for the GIL-releasing native video
    decoder; PIL's JPEG decode holds the GIL, so the image loader takes
    processes (the reference uses torch DataLoader worker processes,
    video_dataset.py:77-85). The workers fork from a process whose CUDA
    context may be up: the dataset they run touches neither CUDA nor
    torch, only numpy and the decoders.
    """

    def __init__(
        self,
        dataset,
        sampler,
        batch_size: int,
        num_workers: int = 4,
        prefetch: int = 2,
        collate=None,
        drop_last: bool = True,
        use_processes: bool = False,
    ):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.collate = collate or default_collate
        self.drop_last = drop_last
        self.use_processes = use_processes

    def __len__(self):
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batches(self):
        idx = []
        for i in self.sampler:
            idx.append(i)
            if len(idx) == self.batch_size:
                yield idx
                idx = []
        if idx and not self.drop_last:
            yield idx

    def _make_pool(self):
        if self.use_processes:
            import multiprocessing as mp
            from concurrent.futures import ProcessPoolExecutor

            return ProcessPoolExecutor(self.num_workers, mp_context=mp.get_context("fork"),
                                       initializer=_proc_init, initargs=(self.dataset,))
        return ThreadPoolExecutor(self.num_workers)

    def __iter__(self):
        # sync the dataset's item-rng stream to the sampler epoch BEFORE the
        # pool forks (process workers copy the dataset at fork time); with
        # item-keyed rng this is the only mutable dataset state
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(getattr(self.sampler, "epoch", 0))
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        get_item = _proc_get if self.use_processes else self.dataset.__getitem__
        # Create the pool on the CALLING thread, before this loader's
        # producer thread exists: a fork from inside a spawned thread can
        # copy a lock another thread holds into the child. The executor
        # forks lazily on first submit, so force every worker up now.
        pool = self._make_pool()
        if self.use_processes:
            pool.submit(int, 0).result()

        def bounded_put(item) -> bool:
            """put that never wedges the producer: an abandoned consumer
            (break out of the epoch loop) sets stop, and the producer exits
            instead of blocking in q.put forever."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with pool:
                    for batch_idx in self._batches():
                        if stop.is_set():
                            return
                        items = list(pool.map(get_item, batch_idx))
                        if not bounded_put(self.collate(items)):
                            return
                bounded_put(None)
            except BaseException as e:  # propagate: a dead producer must
                bounded_put(e)          # raise in the consumer, not hang it

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # An abandoned epoch returns only once its pool is shut down: a
            # process pool forked while another pool shuts down in a thread
            # can copy that pool's held wakeup lock into its workers, which
            # then hang at exit (concurrent.futures' atexit wakeups).
            t.join()


def default_collate(items):
    """[(clips [nc,T,H,W,3], label, clip_indices, valid_hw), ...] ->
    {'clips': [nc*B, T, H, W, 3] uint8 (clip-major, matching the
    reference's torch.cat over clip list), 'labels': [B], 'clip_indices',
    'valid_hw': [nc*B, 2] int32 (un-letterboxed frame size per clip row)}.
    """
    clips = np.stack([it[0] for it in items])  # [B, nc, T, H, W, 3]
    b, nc = clips.shape[:2]
    clips = clips.transpose(1, 0, 2, 3, 4, 5).reshape((nc * b,) + clips.shape[2:])
    labels = np.asarray([it[1] for it in items])
    valid = np.stack([
        it[3] if len(it) > 3 and it[3] is not None
        else np.asarray(clips.shape[2:4], np.int32)
        for it in items
    ])  # [B, 2], identical for every clip of a sample
    return {
        "clips": clips,
        "labels": labels,
        "clip_indices": [it[2] for it in items],
        "valid_hw": np.tile(valid, (nc, 1)),  # clip-major like clips
    }


def make_video_loader(
    *,
    data_paths: Sequence[str],
    batch_size: int,
    frames_per_clip: int = 16,
    frame_step: int = 4,
    num_clips: int = 1,
    datasets_weights=None,
    random_clip_sampling: bool = True,
    allow_clip_overlap: bool = False,
    filter_short_videos: bool = False,
    filter_long_videos: int = int(1e9),
    duration=None,
    decode_backend: str = "auto",
    decode_size=None,
    decode_short_side=None,
    decode_canvas=None,
    rank: int = 0,
    world_size: int = 1,
    num_workers: int = 8,
    seed: int = 0,
    drop_last: bool = True,
    training: bool = True,
):
    """Factory mirroring make_videodataset (reference video_dataset.py:27-88)."""
    from jepa_tpu_torch.data.video_dataset import VideoDataset

    ds = VideoDataset(
        data_paths=data_paths,
        datasets_weights=datasets_weights,
        frames_per_clip=frames_per_clip,
        frame_step=frame_step,
        num_clips=num_clips,
        random_clip_sampling=random_clip_sampling,
        allow_clip_overlap=allow_clip_overlap,
        filter_short_videos=filter_short_videos,
        filter_long_videos=filter_long_videos,
        duration=duration,
        decode_backend=decode_backend,
        decode_size=decode_size,
        decode_short_side=decode_short_side,
        decode_canvas=decode_canvas,
        # base seed, NOT seed+rank: item randomness is (seed, epoch, index)-
        # keyed, so a given global index yields identical clips on every
        # rank/topology (2-proc == 1-proc equality); ranks read disjoint
        # index shards, so streams stay decorrelated without a rank offset.
        seed=seed,
    )
    if ds.sample_weights is not None:
        sampler = WeightedShardedSampler(
            weights=ds.sample_weights, rank=rank, world_size=world_size,
            shuffle=training, seed=seed, drop_last=drop_last,
        )
    else:
        sampler = ShardedSampler(
            num_samples=len(ds), rank=rank, world_size=world_size,
            shuffle=training, seed=seed, drop_last=drop_last,
        )
    loader = DataLoader(
        ds, sampler, batch_size=batch_size, num_workers=num_workers, drop_last=drop_last
    )
    return ds, loader, sampler
