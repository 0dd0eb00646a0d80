"""Multi-process coordination on ``torch.distributed``.

Counterpart of the JAX package's ``parallel/multihost.py``.  The layout is
the reference's own: one process per device, started by ``torchrun
--nproc_per_node N`` (or by ``torch.multiprocessing`` with an explicit
address, world size and rank), each holding its rank's shard of the
dataset.  Per-process results move over the process group's collectives:
gloo for tensors on the CPU, NCCL for tensors on the card.  With no process
group initialised every helper is the one-process identity, so single-device
code runs exactly as before.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def initialize_distributed(backend: Optional[str] = None, init_method: Optional[str] = None,
                           world_size: Optional[int] = None, rank: Optional[int] = None):
    """Join the process group.  Without arguments it reads ``torchrun``'s
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``);
    with neither it is a no-op (one process).  The backend is NCCL where
    CUDA is available, else gloo; with NCCL the process takes the card
    ``LOCAL_RANK`` (or ``rank`` modulo the cards).  A no-op where a group
    is initialised already."""
    if is_initialized():
        return
    if world_size is None and "WORLD_SIZE" not in os.environ:
        print("initialize_distributed skipped: no world size given and no WORLD_SIZE "
              "in the environment (one process)", flush=True)
        return
    world_size = int(world_size if world_size is not None else os.environ["WORLD_SIZE"])
    rank = int(rank if rank is not None else os.environ.get("RANK", 0))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def _collective_device() -> torch.device:
    """Where the group's collectives take their tensors: the current card
    for NCCL, the CPU for gloo."""
    if is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _allgather(x: np.ndarray) -> np.ndarray:
    """Equal-shape all-gather of one host array: (P, *x.shape)."""
    t = torch.as_tensor(np.array(x)).to(_collective_device())
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t)
    return torch.stack(out).cpu().numpy()


def _gather_ragged(x: np.ndarray, allgather) -> np.ndarray:
    """Pad-to-max -> allgather -> trim-per-process -> concat along axis 0.

    ``all_gather`` needs the same shape on every process, but eval shards
    are ceil-divided (``data/mvp.py``), so the last rank may hold fewer
    rows.  Gathering the true lengths first and padding to the largest
    makes the collective shape-uniform; the padding is trimmed per process
    after the gather.  Pure (the collective is injected), so the ragged path
    is testable in one process.
    """
    n = np.asarray([x.shape[0]], np.int64)
    lengths = np.asarray(allgather(n)).reshape(-1)
    max_n = int(lengths.max())
    if x.shape[0] < max_n:
        pad = np.zeros((max_n - x.shape[0],) + x.shape[1:], x.dtype)
        x = np.concatenate([x, pad], axis=0)
    gathered = np.asarray(allgather(x))  # (P, max_n, ...)
    return np.concatenate(
        [gathered[i, : int(lengths[i])] for i in range(len(lengths))], axis=0
    )


def all_gather_host_arrays(x) -> np.ndarray:
    """Every process's rows, concatenated along axis 0 in rank order, on
    every process.  Processes may hold different numbers of rows (the
    ragged last shard); a 0-d array gathers to (P,)."""
    x = np.asarray(x)
    if process_count() == 1:
        return x
    if x.ndim == 0:
        return _allgather(x)
    return _gather_ragged(x, _allgather)


def barrier(name: str = "pdr_barrier") -> None:
    """Wait for every process (``name`` labels the call site only)."""
    if process_count() > 1:
        dist.barrier()


def broadcast_scalar(value: float, root: int = 0) -> float:
    """``root``'s value on every process, so all take the same decision on
    it (the gathered test CD of the in-loop eval)."""
    if process_count() == 1:
        return float(value)
    t = torch.tensor([float(value)], dtype=torch.float64, device=_collective_device())
    dist.broadcast(t, src=root)
    return float(t.item())
