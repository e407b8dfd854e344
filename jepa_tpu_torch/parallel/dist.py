"""Process groups for data-parallel runs (counterpart of
jepa_tpu/parallel/dist.py; reference src/utils/distributed.py:18-47).

One process drives one GPU. ``initialize`` joins the ranks of a run into
a ``torch.distributed`` group, resolving, in order:

  1. explicit arguments (``world_size``, ``rank``, ``init_method``);
  2. torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
     ``MASTER_ADDR``, ``MASTER_PORT``): ``env://``;
  3. SLURM's, as the JAX package reads it (``SLURM_NTASKS`` > 1,
     ``SLURM_PROCID``, ``SLURM_LOCALID``; ``MASTER_ADDR`` or the host
     name, ``MASTER_PORT`` default 37123);
  4. one process and no group: world size 1, rank 0, and every collective
     below is the identity, so that path runs the code it ran before there
     were ranks.

Unlike the JAX module, a failed initialisation raises: carrying on as
world 1 would silently train on 1/N of the global batch. The backend is
``nccl`` for the card and ``gloo`` for the CPU; ``backend='gloo'`` on the
card lets two ranks share one GPU.
"""

from __future__ import annotations

import logging
import os
import socket
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

DEFAULT_PORT = 37123
BUCKET_BYTES = 64 * 2**20  # the flat buffer of one collective in all_reduce_ / all_gather


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def _resolve(init_method, world_size, rank) -> Tuple[int, int, Optional[str]]:
    """(world size, rank, init method); init method None: no group."""
    if world_size is not None or init_method is not None:
        world_size = 1 if world_size is None else int(world_size)
        rank = 0 if rank is None else int(rank)
        return world_size, rank, init_method or _master_url()
    if _env_int("WORLD_SIZE") is not None and _env_int("RANK") is not None:
        return _env_int("WORLD_SIZE"), _env_int("RANK"), "env://"
    ntasks = _env_int("SLURM_NTASKS")
    if ntasks is not None and ntasks > 1:
        return ntasks, _env_int("SLURM_PROCID") or 0, _master_url()
    return 1, 0, None


def _master_url() -> str:
    host = os.environ.get("MASTER_ADDR") or os.environ.get("HOSTNAME") or socket.gethostname()
    return f"tcp://{host}:{_env_int('MASTER_PORT') or DEFAULT_PORT}"


def initialize(backend: Optional[str] = None, init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None) -> Tuple[int, int]:
    """Join this process's group (the order in the module docstring) and
    return (world size, rank). An already initialised group is reused.
    ``backend`` None: ``nccl`` where CUDA is available, else ``gloo``."""
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    world_size, rank, url = _resolve(init_method, world_size, rank)
    if url is None:
        return 1, 0
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside world size {world_size}")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    kw = {}
    if backend == "nccl":
        kw["device_id"] = rank_device("cuda")
    dist.init_process_group(backend, init_method=url, world_size=world_size, rank=rank, **kw)
    logger.info("process group: %s, rank %d of %d, local rank %d (%s)", backend, rank,
                world_size, local_rank(), url)
    return world_size, rank


def init_rank(device="cuda") -> Tuple[int, int, torch.device]:
    """An entry point's runtime: ``initialize`` (``gloo`` when ``device``
    is the CPU), then this rank's device (``rank_device``, made current on
    the card). Returns (world size, rank, device)."""
    world, r = initialize(backend=None if torch.device(device).type == "cuda" else "gloo")
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return world, r, dev


def local_rank() -> int:
    """This process's index on its node: ``LOCAL_RANK`` (torchrun), else
    ``SLURM_LOCALID``, else 0."""
    for name in ("LOCAL_RANK", "SLURM_LOCALID"):
        v = _env_int(name)
        if v is not None:
            return v
    return 0


def rank_device(device="cuda") -> torch.device:
    """The device of this rank: ``cuda:<local rank>`` for ``'cuda'`` (a
    missing GPU raises; nothing falls back to the CPU), else ``device``."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is available "
                           "(pass device='cpu' to run on the CPU)")
    idx = local_rank() if device.index is None else device.index
    if idx >= torch.cuda.device_count():
        raise RuntimeError(f"local rank {idx} has no GPU: {torch.cuda.device_count()} visible")
    return torch.device("cuda", idx)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main() -> bool:
    return rank() == 0


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


_OPS = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}


def _buckets(tensors: Sequence[torch.Tensor], limit: int = BUCKET_BYTES) -> List[List[int]]:
    """Indices of ``tensors`` in order, cut into runs of at most ``limit``
    bytes (a larger tensor is a run of its own)."""
    out, cur, size = [], [], 0
    for i, t in enumerate(tensors):
        nbytes = t.numel() * t.element_size()
        if cur and size + nbytes > limit:
            out.append(cur)
            cur, size = [], 0
        cur.append(i)
        size += nbytes
    if cur:
        out.append(cur)
    return out


def all_reduce_(tensors: Sequence[torch.Tensor], op: str = "sum", group=None) -> None:
    """Sum (``op='sum'``), average (``'mean'``: the sum over the group's
    ranks divided by its size), ``'min'`` or ``'max'`` each tensor across
    ``group`` (None: every rank), in place. The tensors are reduced in list
    order, packed into flat buffers of one dtype per bucket; every rank must
    pass the same shapes in the same order. Without a group this is a
    no-op."""
    if not dist.is_initialized():
        return
    if op not in _OPS:
        raise ValueError(f"op {op!r}: one of {sorted(_OPS)}")
    tensors = list(tensors)
    n = dist.get_world_size(group)
    for idx in _buckets(tensors):
        dtypes = {tensors[i].dtype for i in idx}
        if len(dtypes) != 1:
            raise ValueError(f"all_reduce_: one dtype per call, got {dtypes}")
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, op=_OPS[op], group=group)
        if op == "mean":
            flat.div_(n)
        off = 0
        for i in idx:
            t = tensors[i]
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def all_gather(tensors: Sequence[torch.Tensor], group=None) -> List[List[torch.Tensor]]:
    """[tensors of group rank 0, of group rank 1, ...]: every rank passes
    tensors of the same shapes and dtype in the same order (bucketed flat
    buffers, as ``all_reduce_``). Without a group: [tensors]."""
    tensors = list(tensors)
    if not dist.is_initialized():
        return [tensors]
    n = dist.get_world_size(group)
    out = [[None] * len(tensors) for _ in range(n)]
    for idx in _buckets(tensors, BUCKET_BYTES // max(1, n)):
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        bufs = [torch.empty_like(flat) for _ in range(n)]
        dist.all_gather(bufs, flat, group=group)
        for r, buf in enumerate(bufs):
            off = 0
            for i in idx:
                t = tensors[i]
                out[r][i] = buf[off:off + t.numel()].view_as(t)
                off += t.numel()
    return out


def all_reduce_scalars(values: Sequence[float], device, op: str = "sum") -> List[float]:
    """Python floats reduced (``all_reduce_``'s ops) over every rank, in
    float64 on ``device`` (the rank's device: NCCL reduces only on the
    card)."""
    if not dist.is_initialized():
        return [float(v) for v in values]
    t = torch.tensor([float(v) for v in values], dtype=torch.float64, device=device)
    all_reduce_([t], op)
    return t.tolist()


def check_same_across_ranks(value: float, device, what: str) -> None:
    """Raise unless every rank passes the same ``value`` (one all-reduce of
    (value, -value) under max)."""
    hi, neg_lo = all_reduce_scalars([value, -float(value)], device, "max")
    if hi != -neg_lo:
        raise RuntimeError(f"{what} differs across ranks: {-neg_lo} .. {hi}")


def _local_rank_main(rank, fn, world, backend, init_file, out_dir, args, env) -> None:
    import sys

    for k, v in (env[rank] if env else {}).items():
        os.environ[k] = str(v)
    if init_file is not None:
        dist.init_process_group(backend, init_method=f"file://{init_file}", world_size=world,
                                rank=rank)
    try:
        res = fn(rank, world, *args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    res = {"result": res, "jax_imported": any(m == "jax" or m.startswith("jax.")
                                              for m in sys.modules)}
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def run_local_ranks(fn, world: int, args=(), backend: str = "gloo", init_group: bool = True,
                    env=None, timeout: Optional[float] = None) -> List[dict]:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes on
    this host and return, by rank, ``{"result": ..., "jax_imported":
    bool}``. With ``init_group`` each process first joins a ``backend``
    group through a ``file://`` rendezvous in a temporary directory (no
    port); without it ``fn`` initialises its own. ``env[rank]`` (a dict)
    is set in each process's environment first. Processes are spawned,
    never forked (CUDA may be initialised in the caller); a process that
    raises, or a run past ``timeout`` seconds, raises here after every
    process has ended. ``fn`` and ``args`` must pickle (a module-level
    function); results come back through ``torch.save`` files."""
    import tempfile
    import time

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="jepa_ranks_") as tmp:
        init_file = os.path.join(tmp, "rendezvous") if init_group else None
        ctx = mp.spawn(_local_rank_main, nprocs=world, join=False,
                       args=(fn, world, backend, init_file, tmp, tuple(args), env))
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while not ctx.join(timeout=5):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"{world} local ranks ran past {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join()
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
