"""The data-parallel layout of the processes, and batch splitting.

Counterpart of the JAX package's ``parallel/mesh.py``.  There one jitted
program spans a (data, model) mesh of devices; here each device runs one
process (``parallel/multihost.py``), so the mesh's ``data`` axis is the
process group's world size and a process holds one device.  The train step
wraps the model in ``DistributedDataParallel`` over it
(``train/step.py::jit_step_for_mesh``), which all-reduces the gradients in
the backward.

The ``model`` axis (the JAX package shards Dense kernels whose trailing
dimension is at least 128 over it) is not ported: ``model_parallel`` > 1
raises.  One card holds every shipped configuration whole.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device
from .multihost import initialize_distributed, is_initialized, process_count, process_index

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the layout: ``rank`` of ``world`` processes,
    computing on ``device``."""

    rank: int
    world: int
    device: torch.device

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.world, MODEL_AXIS: 1}

    @property
    def distributed(self) -> bool:
        """A process group is initialised (even at world 1): the train step
        goes through ``DistributedDataParallel``."""
        return is_initialized()


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              device: DeviceLike = None) -> Mesh:
    """The mesh of the initialised process group, or of this one process
    when there is none.  ``device`` defaults to the current card (the
    process's ``LOCAL_RANK`` after ``initialize_distributed``); pass
    ``"cpu"`` for gloo on the CPU.  ``n_devices``, where given, must be the
    world size."""
    if model_parallel != 1:
        raise ValueError(
            f"model_parallel={model_parallel}: the mesh's model axis (parameter "
            "sharding) is not ported; only data parallelism over processes is")
    world = process_count()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices}, but the process group has {world} "
                         "processes (one device each)")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(rank=process_index(), world=world, device=dev)


def mesh_from_environment(device: DeviceLike = None) -> Optional[Mesh]:
    """Under ``torchrun`` (``WORLD_SIZE`` in the environment): join the
    process group (gloo for ``device="cpu"``, else NCCL on the process's
    card) and return its mesh.  Otherwise None: one process."""
    if "WORLD_SIZE" not in os.environ:
        return None
    cpu = device is not None and torch.device(device).type == "cpu"
    initialize_distributed(backend="gloo" if cpu else None)
    return make_mesh(device=device)


def pad_batch_rows(arr: np.ndarray, multiple: int) -> np.ndarray:
    """Pad the leading (batch) axis up to a multiple by repeating the last
    row, so a ragged batch still divides over the mesh's data axis.  The
    caller drops what the padding rows compute: the resample-to-pad trick
    the reference dataset uses for its last rank."""
    arr = np.asarray(arr)
    rem = arr.shape[0] % multiple
    if rem == 0:
        return arr
    pad = multiple - rem
    return np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)], axis=0)


def shard_batch(batch, mesh: Mesh):
    """This rank's contiguous share of the rows of every array in
    ``batch`` (an array, or a dict, tuple or list of them), whose leading
    axis must divide by the world size (``pad_batch_rows`` first)."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(v, mesh) for v in batch)
    n = batch.shape[0]
    if n % mesh.world:
        raise ValueError(f"{n} rows do not divide over {mesh.world} processes; "
                         "pad them with pad_batch_rows")
    per = n // mesh.world
    return batch[mesh.rank * per:(mesh.rank + 1) * per]


def shard_rows(n: int, mesh: Mesh, pad: bool) -> np.ndarray:
    """Indices of this rank's rows of an ``n``-row dataset: contiguous,
    ceil(n / world) a rank, as ``data/mvp.py`` shards.  With ``pad`` the
    short last rank repeats the last row, so every rank takes as many
    training steps (``DistributedDataParallel`` needs that); without it
    every row is held once (evaluation and generation)."""
    idx = shard_batch(pad_batch_rows(np.arange(n), mesh.world), mesh)
    if pad:
        return idx
    return idx[: max(0, n - mesh.rank * len(idx))]


class _Rows:
    """Rows ``idx`` of a dataset behind the per-item interface."""

    def __init__(self, dataset, idx: np.ndarray):
        self.dataset, self.idx = dataset, idx

    def __len__(self) -> int:
        return len(self.idx)

    def __getitem__(self, i: int) -> dict:
        return self.dataset[int(self.idx[i])]


def shard_dataset(dataset, mesh: Optional[Mesh], pad: bool):
    """This rank's rows of ``dataset`` (``shard_rows``); the dataset itself
    with no mesh or at world 1.  An in-memory ``ArrayDataset`` stays one."""
    if mesh is None or mesh.world == 1:
        return dataset
    from ..data import ArrayDataset

    idx = shard_rows(len(dataset), mesh, pad)
    if isinstance(dataset, ArrayDataset):
        return ArrayDataset(**{k: v[idx] for k, v in dataset.arrays.items()})
    return _Rows(dataset, idx)
