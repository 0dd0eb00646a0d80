"""The (data, model) layout of the processes, parameter sharding, and batch
splitting.

Counterpart of the JAX package's ``parallel/mesh.py``.  There one jitted
program spans a (data, model) mesh of devices; here each device runs one
process (``parallel/multihost.py``), and the mesh lays the process group's
``world`` ranks out as ``world // m`` rows of ``m``: rank r sits at data
index r // m and model index r % m, as JAX's ``reshape(n // m, m)`` places
its devices.

The ``data`` axis is data parallelism.  At ``m`` = 1 the train step wraps
the model in ``DistributedDataParallel`` (``train/step.py::
jit_step_for_mesh``), which all-reduces the gradients in the backward.

The ``model`` axis shards parameters, FSDP-style, under the JAX package's
rule (``param_sharding_rule``): a tensor of rank >= 2 whose dimension that
JAX splits (the Flax leaf's trailing, output dimension) is at least 128 and
divides by ``m`` is stored as 1/m slices over the ranks of a model row;
every other tensor is replicated.  Each rank of a row stores its slice and
the Adam moments of that slice, the train step all-gathers the slices over
the row for the forward and reduce-scatters their gradients
(``shard_params``, ``gather_shards``, ``reduce_scatter_shards``).  The rows
of a global batch are split over all ``world`` processes
(``shard_batch``), where JAX splits them over the ``data`` axis only: in one
SPMD program the ranks of a model row compute the same rows, and in a
program a process here they would run each row's forward ``m`` times for
nothing.  The update is the same either way, the global batch's mean
gradient.

On every backend the port uses (gloo on the CPU and on CUDA tensors, NCCL
across cards) the collectives are ``all_gather`` and ``reduce_scatter`` in
their list forms, and ``all_reduce``: every torch version the port runs on
has them undeprecated, and gloo takes all three for CUDA tensors as well
(torch 2.11 on the H100 machine), so the choice does not depend on the
backend.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import DeviceLike, resolve_device
from .multihost import initialize_distributed, is_initialized, process_count, process_index

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the layout: ``rank`` of ``world`` processes,
    computing on ``device``, in rows of ``model_parallel`` ranks.  With
    ``model_parallel`` > 1, ``model_group`` is this rank's model row and
    ``data_group`` its data column (the ranks that hold the same slices)."""

    rank: int
    world: int
    device: torch.device
    model_parallel: int = 1
    model_group: Any = dataclasses.field(default=None, compare=False, repr=False)
    data_group: Any = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.world // self.model_parallel, MODEL_AXIS: self.model_parallel}

    @property
    def model_index(self) -> int:
        """This rank's place in its model row: which slice it stores."""
        return self.rank % self.model_parallel

    @property
    def distributed(self) -> bool:
        """A process group is initialised (even at world 1): the train step
        goes through ``DistributedDataParallel`` or the sharded step."""
        return is_initialized()


def _axis_groups(world: int, m: int, rank: int):
    """(model row, data column) of ``rank``.  ``new_group`` is a collective
    of the whole group, so every rank creates every group, in one order."""
    mine = []
    for groups in ([list(range(i * m, (i + 1) * m)) for i in range(world // m)],
                   [list(range(j, world, m)) for j in range(m)]):
        for ranks in groups:
            g = dist.new_group(ranks)
            if rank in ranks:
                found = g
        mine.append(found)
    return tuple(mine)


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              device: DeviceLike = None) -> Mesh:
    """The (world // model_parallel, model_parallel) mesh of the initialised
    process group, or of this one process when there is none.  ``device``
    defaults to the current card (the process's ``LOCAL_RANK`` after
    ``initialize_distributed``); pass ``"cpu"`` for gloo on the CPU.
    ``n_devices``, where given, must be the world size, and
    ``model_parallel`` must divide it (``ValueError``)."""
    world = process_count()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices}, but the process group has {world} "
                         "processes (one device each)")
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide the {world} "
                         "processes of the group")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    rank = process_index()
    groups = _axis_groups(world, model_parallel, rank) if model_parallel > 1 else (None, None)
    return Mesh(rank, world, dev, model_parallel, *groups)


def mesh_from_environment(device: DeviceLike = None, model_parallel: int = 1) -> Optional[Mesh]:
    """Under ``torchrun`` (``WORLD_SIZE`` in the environment): join the
    process group (gloo for ``device="cpu"``, else NCCL on the process's
    card) and return its mesh with ``model_parallel`` ranks a row.
    Otherwise None: one process."""
    if "WORLD_SIZE" not in os.environ:
        return None
    cpu = device is not None and torch.device(device).type == "cpu"
    initialize_distributed(backend="gloo" if cpu else None)
    return make_mesh(model_parallel=model_parallel, device=device)


# ---- the model axis: which tensors are sharded, and their collectives ----


def param_sharding_rule(mesh: Mesh, min_shard_dim: int = 128
                        ) -> Callable[[str, Sequence[int]], Optional[int]]:
    """The JAX package's FSDP rule on the port's parameters: a function
    (state-dict name, shape) -> the torch dimension the tensor is split
    along over the mesh's ``model`` axis, or None where it is replicated.

    JAX splits a leaf of rank >= 2 along its trailing dimension when that is
    at least ``min_shard_dim`` and divides by the axis.  A port ``.weight``
    is a Flax ``kernel`` stored (out, in, *window) (``utils/weights.py``),
    so that dimension is its dim 0; any other tensor (an ``Embed`` table)
    keeps the Flax layout, and it is its last."""
    m = mesh.shape[MODEL_AXIS]

    def rule(name: str, shape: Sequence[int]) -> Optional[int]:
        if m == 1 or len(shape) < 2:
            return None
        dim = 0 if name.endswith(".weight") else len(shape) - 1
        return dim if shape[dim] % m == 0 and shape[dim] >= min_shard_dim else None

    return rule


@dataclasses.dataclass(frozen=True)
class Sharding:
    """What ``shard_params`` did to a model: the mesh, and the dimension
    each sharded parameter is split along, by name in parameter order."""

    mesh: Mesh
    dims: Dict[str, int]


_SHARDING = "_model_axis_sharding"


def sharding_of(model: torch.nn.Module) -> Optional[Sharding]:
    """The model's ``Sharding``, or None where ``shard_params`` has not run
    on it (every tensor whole)."""
    return getattr(model, _SHARDING, None)


def _slice(t: torch.Tensor, dim: int, index: int, m: int) -> torch.Tensor:
    k = t.shape[dim] // m
    return t.narrow(dim, index * k, k)


def _own(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of the whole tensor ``t``, in memory of its own."""
    return _slice(t, dim, mesh.model_index, mesh.model_parallel).clone(
        memory_format=torch.contiguous_format)


def shard_params(model: torch.nn.Module, mesh: Mesh, min_shard_dim: int = 128
                 ) -> Dict[str, int]:
    """Store every parameter the rule shards as this rank's slice, in place
    (the ``Parameter`` objects stay, their data shrinks), and mark the model
    with its ``Sharding``.  Returns {name: dim} of the sharded tensors."""
    if sharding_of(model) is not None:
        raise ValueError("the model is sharded already")
    rule = param_sharding_rule(mesh, min_shard_dim)
    dims = {}
    with torch.no_grad():
        for name, p in model.named_parameters():
            dim = rule(name, tuple(p.shape))
            if dim is not None:
                p.data = _own(p.data, dim, mesh)
                dims[name] = dim
    setattr(model, _SHARDING, Sharding(mesh, dims))
    return dims


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    if len({t.dtype for t in tensors}) > 1:
        raise ValueError("the tensors of one collective must share a dtype")
    return torch.cat([t.reshape(-1) for t in tensors])


def gather_shards(shards: Sequence[torch.Tensor], dims: Sequence[int], mesh: Mesh
                  ) -> List[torch.Tensor]:
    """The whole tensors of ``shards`` (this rank's slices, split along
    ``dims``): one all-gather over the model row."""
    if not shards:
        return []
    flat = _flat(shards)
    parts = [torch.empty_like(flat) for _ in range(mesh.model_parallel)]
    dist.all_gather(parts, flat, group=mesh.model_group)
    out, off = [], 0
    for s, d in zip(shards, dims):
        n = s.numel()
        out.append(torch.cat([p[off:off + n].view(s.shape) for p in parts], dim=d))
        off += n
    return out


def reduce_scatter_shards(full: Sequence[torch.Tensor], dims: Sequence[int], mesh: Mesh
                          ) -> List[torch.Tensor]:
    """This rank's slices (along ``dims``) of the sums over the model row of
    ``full``, tensors every rank holds whole: one reduce-scatter."""
    if not full:
        return []
    m = mesh.model_parallel
    buf = _flat([_slice(g, d, i, m) for i in range(m) for g, d in zip(full, dims)])
    out = torch.empty(buf.numel() // m, dtype=buf.dtype, device=buf.device)
    dist.reduce_scatter(out, list(buf.chunk(m)), group=mesh.model_group)
    shards, off = [], 0
    for g, d in zip(full, dims):
        shape = _slice(g, d, 0, m).shape
        n = shape.numel()
        shards.append(out[off:off + n].view(shape))
        off += n
    return shards


def all_reduce_flat(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Sum each of ``tensors`` in place over ``group`` (the world by
    default): one all-reduce of their concatenation."""
    if not tensors:
        return
    flat = _flat(tensors)
    dist.all_reduce(flat, group=group)
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off:off + n].view_as(t))
        off += n


@contextlib.contextmanager
def full_parameters(model: torch.nn.Module):
    """Every tensor ``model`` stores sharded, gathered whole in place for
    the duration (generation and evaluation hold the parameters whole, as
    the JAX package replicates them there), then its slice put back.  The
    ranks of a model row enter it together.  A no-op for a model that is
    not sharded."""
    sh = sharding_of(model)
    if sh is None or not sh.dims:
        yield model
        return
    params = dict(model.named_parameters())
    shards = [params[n].data for n in sh.dims]
    with torch.no_grad():
        full = gather_shards(shards, list(sh.dims.values()), sh.mesh)
    for n, f in zip(sh.dims, full):
        params[n].data = f
    try:
        yield model
    finally:
        for n, s in zip(sh.dims, shards):
            params[n].data = s


def full_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The model's ``state_dict`` with the one-process keys and shapes: the
    sharded tensors gathered (a collective of the model row)."""
    sd = model.state_dict()
    sh = sharding_of(model)
    if sh is not None:
        sd.update(zip(sh.dims, gather_shards([sd[n] for n in sh.dims],
                                             list(sh.dims.values()), sh.mesh)))
    return sd


def shard_state_dict(model: torch.nn.Module, sd: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """A one-process ``state_dict`` with this rank's slice of every tensor
    ``model`` stores sharded: what its ``load_state_dict`` takes."""
    sh = sharding_of(model)
    if sh is None:
        return sd
    return {k: _own(v, sh.dims[k], sh.mesh) if k in sh.dims else v for k, v in sd.items()}


def _optimizer_names(model: torch.nn.Module, optimizer) -> List[str]:
    """The parameter names in the order the optimizer's ``state_dict``
    numbers them."""
    names = {id(p): n for n, p in model.named_parameters()}
    return [names[id(p)] for g in optimizer.param_groups for p in g["params"]]


def full_optimizer_state_dict(model: torch.nn.Module, optimizer) -> dict:
    """The optimizer's ``state_dict`` with the moments of the sharded
    tensors gathered whole (a collective of the model row): what a
    one-process optimizer of the same model holds."""
    osd = optimizer.state_dict()
    sh = sharding_of(model)
    if sh is None:
        return osd
    names = _optimizer_names(model, optimizer)
    state = {i: dict(s) for i, s in osd["state"].items()}  # the live dicts stay
    keys = [(i, k) for i, s in sorted(state.items()) if names[i] in sh.dims
            for k, v in s.items() if v.dim() > 0]
    full = gather_shards([state[i][k] for i, k in keys],
                         [sh.dims[names[i]] for i, _ in keys], sh.mesh)
    for (i, k), t in zip(keys, full):
        state[i][k] = t
    return {**osd, "state": state}


def shard_optimizer_state_dict(model: torch.nn.Module, optimizer, osd: dict) -> dict:
    """A one-process optimizer ``state_dict`` with this rank's slice of the
    moments of every tensor ``model`` stores sharded: what ``optimizer``,
    built over the sharded model, loads."""
    sh = sharding_of(model)
    if sh is None:
        return osd
    names = _optimizer_names(model, optimizer)
    state = {}
    for i, s in osd["state"].items():
        dim = sh.dims.get(names[int(i)])
        state[i] = {k: _own(v, dim, sh.mesh) if dim is not None and v.dim() > 0 else v
                    for k, v in s.items()}
    return {**osd, "state": state}


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
