"""The per-process layout of a data-parallel run (counterpart of
jepa_tpu/parallel/mesh.py).

The JAX package runs one global program over a (data, fsdp) device mesh.
Here every rank is a process with its own device, so the mesh reduces to
what each process must know: its rank, the world size, and, under
``meta.fsdp`` > 1, its place in its fsdp group, over which the AdamW
moments of the large leaves are sharded ZeRO-1-style
(``train_state_shardings`` / ``param_sharding`` in the JAX module). The
ranks of the JAX mesh ``devices.reshape(data, fsdp)`` map to groups of
``fsdp`` consecutive ranks.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Mapping, Optional, Sequence

import numpy as np

MIN_SIZE_TO_SHARD = 2**20


@dataclasses.dataclass(frozen=True)
class Layout:
    """``world`` ranks as ``world // fsdp`` data replicas of ``fsdp``
    consecutive ranks; ``fsdp_group`` is this rank's fsdp process group
    (None: every rank); leaves of at least ``min_size_to_shard`` elements
    have their moments sharded. ``distributed``: made in an initialised
    process group, whose collectives the train step then runs (at any
    world size, 1 included); the default layout runs none."""

    world: int = 1
    rank: int = 0
    fsdp: int = 1
    fsdp_group: object = None
    min_size_to_shard: int = MIN_SIZE_TO_SHARD
    distributed: bool = False

    @property
    def data(self) -> int:
        return self.world // self.fsdp

    @property
    def fsdp_rank(self) -> int:
        return self.rank % self.fsdp


def reduce_fsdp(fsdp: int, world: int) -> int:
    """``make_mesh``'s rule: an fsdp that does not divide the world size is
    reduced to the largest divisor of it that is at most fsdp, with a
    warning (a 1-GPU run of a config written for many must still run)."""
    if world % fsdp != 0 or fsdp > world:
        eff = max(d for d in range(1, min(fsdp, world) + 1) if world % d == 0)
        warnings.warn(f"fsdp={fsdp} does not divide {world} ranks; reducing to fsdp={eff}")
        return eff
    return fsdp


def make_layout(fsdp: int = 1, world: Optional[int] = None, rank: Optional[int] = None,
                min_size_to_shard: int = MIN_SIZE_TO_SHARD) -> Layout:
    """The layout of this process (``world`` / ``rank`` default to the
    initialised group's, or 1 / 0). In an initialised group with 1 < fsdp
    < world, every rank creates every fsdp group (``new_group`` is
    collective) and keeps its own."""
    import torch.distributed as tdist

    from jepa_tpu_torch.parallel import dist as pdist

    world = pdist.world_size() if world is None else int(world)
    rank = pdist.rank() if rank is None else int(rank)
    fsdp = reduce_fsdp(int(fsdp), world)
    group = None
    if 1 < fsdp < world and tdist.is_initialized():

        for lo in range(0, world, fsdp):
            g = tdist.new_group(list(range(lo, lo + fsdp)))
            if lo <= rank < lo + fsdp:
                group = g
    return Layout(world=world, rank=rank, fsdp=fsdp, fsdp_group=group,
                  min_size_to_shard=min_size_to_shard, distributed=tdist.is_initialized())


def eval_batch_geometry(per_rank_batch: int, world: int):
    """(local batch, global batch) of the frozen-probe evals: the
    reference's ``optimization.batch_size`` is per GPU, and one rank drives
    one GPU, so the local batch is the YAML's and the global one ``world``
    times it."""
    return int(per_rank_batch), int(per_rank_batch) * int(world)


def rank_rows(arr, rank: int, world: int):
    """This rank's rows of a global batch (the counterpart of
    ``put_global``): rows ``[rank * B, (rank + 1) * B)`` of ``world * B``."""
    n = arr.shape[0]
    if n % world:
        raise ValueError(f"global batch {n} does not split over {world} ranks")
    b = n // world
    return arr[rank * b:(rank + 1) * b]


def shard_axis(shape: Sequence[int], fsdp: int, min_size_to_shard: int = MIN_SIZE_TO_SHARD):
    """``param_sharding``'s rule for one leaf, in integers: the axis its
    moments are split along over ``fsdp`` ranks, or None (replicated) when
    fsdp is 1, the leaf has fewer than ``min_size_to_shard`` elements, or
    its largest axis (the first of equal ones) does not divide by fsdp."""
    if fsdp == 1 or int(np.prod(shape, dtype=np.int64)) < min_size_to_shard:
        return None
    ax = int(np.argmax(shape))
    return ax if shape[ax] % fsdp == 0 else None


def zero1_plan(named_shapes: Mapping[str, Sequence[int]], fsdp: int,
               min_size_to_shard: int = MIN_SIZE_TO_SHARD) -> Dict[str, Optional[int]]:
    """{parameter name: shard axis or None} over ``named_shapes`` (a name ->
    shape mapping, or named parameters). The port's leaves are per layer,
    so each layer's weight is judged on its own."""
    return {n: shard_axis(tuple(getattr(s, "shape", s)), fsdp, min_size_to_shard)
            for n, s in named_shapes.items()}


def shard(t, axis: Optional[int], layout: Layout):
    """This rank's slice of ``t`` along ``axis`` (a view; ``t`` itself when
    axis is None)."""
    if axis is None:
        return t
    n = t.shape[axis] // layout.fsdp
    return t.narrow(axis, layout.fsdp_rank * n, n)
