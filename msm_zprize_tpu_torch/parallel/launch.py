"""Run a function in one process a rank, each in the default process group.

The JAX package drives its mesh from one controller; a ``torch.distributed``
mesh needs one process a rank, so the sharded MSM's tests, the entry twin's
dry run (``graft_entry.py``) and the chip smoke's multi-rank phase start
their ranks here:

    results = spawn(fn, world, device="cpu")   # fn(rank, world, device, *args)

Each rank joins a process group whose store is a file in a fresh temporary
directory (no TCP port, so concurrent launches cannot collide), calls ``fn``
and hands its picklable return value back through a file; ``spawn`` returns
them by rank. A rank that raises makes ``spawn`` raise with that rank's
traceback (the others are terminated). ``fn`` must be importable from a
module that imports no JAX: the children import it by name.

Backends: ``"nccl"`` for ``device="cuda"`` (rank r on ``cuda:r``), ``"gloo"``
for ``"cpu"`` (one thread a rank). ``backend="gloo"`` with ``device="cuda"``
puts every rank on ``cuda:0``: several ranks on one card, which NCCL refuses.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["spawn"]

TIMEOUT = datetime.timedelta(minutes=10)  # of each collective


def _rank_main(rank, fn, world, device, backend, tmp, args):
    if device == "cpu":
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    else:
        dev = torch.device("cuda", rank if backend == "nccl" else 0)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{os.path.join(tmp, 'store')}",
                            rank=rank, world_size=world, timeout=TIMEOUT)
    try:
        result = fn(rank, world, dev, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(result, fh)


def spawn(fn, world: int, *, device, backend: str | None = None, args=()) -> list:
    """Run ``fn(rank, world, device, *args)`` in ``world`` processes and
    return their results by rank. ``device``: "cpu" or "cuda"."""
    device = torch.device(device).type
    if device == "cuda":
        backend = backend or "nccl"
        if not torch.cuda.is_available():
            raise RuntimeError("spawn(device='cuda') needs a GPU; torch.cuda.is_available() is False")
        if backend == "nccl" and world > torch.cuda.device_count():
            raise ValueError(f"NCCL takes one card a rank: {world} ranks, "
                             f"{torch.cuda.device_count()} cards (backend='gloo' shares one)")
    elif device == "cpu":
        backend = backend or "gloo"
    else:
        raise ValueError(f"spawn runs ranks on 'cpu' or 'cuda', not {device!r}")
    if backend not in ("nccl", "gloo") or (backend == "nccl" and device == "cpu"):
        raise ValueError(f"backend {backend!r} does not run ranks on {device!r}")
    if device == "cuda":
        # the ranks share the card with this process: hand its cached blocks back first
        torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="msm_ranks_")
    try:
        mp.spawn(_rank_main, args=(fn, world, device, backend, tmp, tuple(args)), nprocs=world,
                 join=True)
        results = []
        for rank in range(world):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as fh:
                results.append(pickle.load(fh))
        return results
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
