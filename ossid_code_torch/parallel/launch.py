"""Processes joined in one `torch.distributed` group: the port's counterpart
of the JAX package's data-parallel mesh, one process a device (gloo on the
CPU, NCCL on cards).

`spawn(fn, n, backend)` starts n processes with `torch.multiprocessing`;
they meet through a `FileStore` in a fresh temporary directory, so that
concurrent runs never race for a TCP port. Rank r runs fn(rank, world_size,
*args) with the group initialised (with NCCL on card r) and torch capped at
`threads` threads; spawn returns every rank's return value, in rank order.
`process_group(backend)` is a group of this process alone (world size 1).
"""

from __future__ import annotations

import contextlib
import os
import pickle
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _worker(rank, fn, n, backend, tmp, args, threads):
    torch.set_num_threads(threads)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, store=dist.FileStore(os.path.join(tmp, "store"), n),
                            rank=rank, world_size=n)
    try:
        result = fn(rank, n, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def spawn(fn, n: int, backend: str = "gloo", args: tuple = (), threads: int = 1) -> list:
    """Run fn(rank, n, *args) in n processes of one group; a rank's failure
    raises here once every process has ended. fn and args must pickle."""
    if backend == "nccl" and n > torch.cuda.device_count():
        raise ValueError(f"requested {n} devices, have {torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_worker, args=(fn, n, backend, tmp, args, threads), nprocs=n, join=True)
        results = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results


@contextlib.contextmanager
def process_group(backend: str = "gloo"):
    """A process group of this process alone (world size 1), destroyed on
    leaving the block."""
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(backend, store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            yield dist.group.WORLD
        finally:
            dist.destroy_process_group()
