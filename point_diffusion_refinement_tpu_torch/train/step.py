"""Training steps for the three tasks: DDPM completion, refinement and
denoising.

Counterpart of the JAX package's ``train/step.py``.  One optimizer step is
q-sample (or the refine input) + forward + loss + ``backward()`` + Adam
update.  Each step maker is split into a pure loss function that takes its
random draws (``t`` and ``z``, or the denoise task's noise) as tensors, so
that two implementations can be fed the same draws, and a step that draws
them from the state's generator, eagerly and in a fixed order, and hands
them with the batch to the update: loss, ``backward()`` and Adam, a
function of tensors only.  With ``compiled=True`` the update is a captured
CUDA graph (``utils/graphs.py::CapturedFunction``), one for each input
signature, as the JAX package jits its step; on CPU tensors it runs
eagerly.  The refine step's ``output_scale_factor`` is one of its tensors,
so a ramping schedule replays one graph.  ``state.step`` counts on the
host.

The optimizer is one Adam for both routes and both devices: fused (a few
launches a step where the per-tensor route makes many) and capturable (its
step count on the parameters' device, which a graph needs).

The two fused training routes of the network (``fused_gather``,
``fused_sa``; see ``models/modules.py``) are keyword arguments of the step
makers and are off by default, as their environment opt-ins are in the JAX
package.  Only the PointNet++ network has them: asking for one with the
PVCNN2 or pointwise network raises.  With ``record_stats`` a loss function
returns (loss, stats) and a step (state, loss, stats), where stats are the
neighbour-count histograms the forward recorded
(``models.modules.collect_neighbor_stats``), as the JAX steps return their
``neighbor_stats`` collection.  No step passes a dropout draw, so the
networks' dropout stays off, as in the JAX package.

``jit_step_for_mesh`` is the step over the processes of a mesh, one rank's
rows of the global batch a process, as the JAX package jits its step over
the mesh: the step maker's step on the model wrapped in ``_MeshForward``,
whose update reduces the gradients over the mesh before Adam and takes the
loss's mean over the processes, all inside the one update that
``compiled=True`` captures (NCCL's collectives replay inside the graph).
With a ``model`` axis each rank stores the large tensors as slices
(``parallel/mesh.py``).  The eager step over a data-only mesh is
``DistributedDataParallel``'s, kept as the reference.
"""

from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Callable, Dict, Optional, Union

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from ..diffusion.ddpm import q_sample
from ..diffusion.schedule import DiffusionSchedule
from ..models.condition_net import PointNet2CloudCondition
from ..models.modules import collect_neighbor_stats
from ..models.upsample import point_upsample
from ..ops.chamfer import calc_cd
from ..parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    all_reduce_flat,
    gather_shards,
    reduce_scatter_shards,
    shard_optimizer_state_dict,
    shard_params,
    sharding_of,
)
from ..utils.graphs import CapturedFunction
from ..utils.weights import load_optimizer_state

@dataclasses.dataclass
class TrainState:
    """What a step updates in place: the model's parameters, the Adam
    moments, the step count and the generator the step draws from."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    step: int = 0


def create_train_state(model: torch.nn.Module, seed: int = 0,
                       learning_rate: float = 2e-4) -> TrainState:
    """Adam with optax's defaults (beta 0.9/0.999, eps 1e-8 outside the
    square root, no weight decay) over the model's float32 parameters, fused
    and capturable, and a generator on the model's device seeded with
    ``seed``."""
    device = next(model.parameters()).device
    optimizer = torch.optim.Adam(
        model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=0.0, fused=True, capturable=True,
    )
    generator = torch.Generator(device=device)
    generator.manual_seed(int(seed))
    return TrainState(model=model, optimizer=optimizer, generator=generator)


def _unwrap(model) -> torch.nn.Module:
    """The network inside a ``DistributedDataParallel`` or ``_MeshForward``
    wrapper."""
    return model.module if isinstance(model, (DistributedDataParallel, _MeshForward)) \
        else model


def _route_kwargs(model, fused_gather: bool, fused_sa: bool) -> dict:
    """The fused training routes as forward keywords: the PointNet++
    network takes them; another network has none to take."""
    model = _unwrap(model)
    if isinstance(model, PointNet2CloudCondition):
        return dict(fused_gather=fused_gather, fused_sa=fused_sa)
    if fused_gather or fused_sa:
        raise ValueError(f"{type(model).__name__} has no fused training route: "
                         "fused_gather and fused_sa need a pointnet++ network")
    return {}


def _recording(model, record_stats: bool):
    return collect_neighbor_stats(_unwrap(model)) if record_stats else contextlib.nullcontext()


def _make_update(model, loss_fn: Callable, record_stats: bool) -> Callable:
    """update(optimizer, *inputs) -> loss, or (loss, stats): the loss
    function at ``inputs``, ``backward()`` and one optimizer step.  The
    gradients are set to None first, so that under capture the backward
    allocates them in the graph's pool and every replay writes them anew.
    Over a mesh (``model`` a ``_MeshForward`` or ``DistributedDataParallel``)
    the gradients are reduced over the processes before the optimizer steps
    (``_MeshForward.reduce_gradients``; DDP has done it in the backward) and
    the returned loss is the processes' mean: both collectives are part of
    the update, and of its graph."""
    mesh_net = model if isinstance(model, _MeshForward) else None
    over_mesh = mesh_net is not None or isinstance(model, DistributedDataParallel)

    def update(optimizer: torch.optim.Optimizer, *inputs):
        out = loss_fn(*inputs)
        loss, stats = out if record_stats else (out, None)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if mesh_net is not None:
            mesh_net.reduce_gradients()
        with warnings.catch_warnings():
            # the Adam of create_train_state is capturable for the compiled
            # step and makes the same update eagerly: PyTorch's advice
            # against capturable=True outside a graph does not apply
            warnings.filterwarnings(
                "ignore", message="This instance was constructed with capturable=True")
            optimizer.step()
        loss = loss.detach()
        if over_mesh:
            loss = loss.clone()
            dist.all_reduce(loss)
            loss = loss / dist.get_world_size()
        return (loss, stats) if record_stats else loss

    return update


def _stepper(update: Callable, record_stats: bool, compiled: bool) -> Callable:
    """run(state, *inputs) -> (state, loss), or (state, loss, stats): the
    update on ``state.optimizer``, eager or captured, and the host's step
    count.  ``run.graphs`` is the ``CapturedFunction`` (None when eager)."""
    graphs = CapturedFunction(update) if compiled else None
    call = graphs if compiled else update

    def run(state: TrainState, *inputs):
        out = call(state.optimizer, *inputs)
        state.step += 1
        return (state,) + tuple(out) if record_stats else (state, out)

    run.graphs = graphs
    return run


def make_completion_loss(model, schedule: DiffusionSchedule, *, fused_gather: bool = False,
                         fused_sa: bool = False, record_stats: bool = False) -> Callable:
    """loss(x0, condition, label, t, z) -> scalar epsilon-MSE of the DDPM
    step at the given draws: t (B,) int, z like x0; (loss, stats) with
    ``record_stats``.  ``schedule`` lies on x0's device."""
    routes = _route_kwargs(model, fused_gather, fused_sa)

    def loss_fn(x0, condition, label, t, z):
        x_t = q_sample(x0, t, z, schedule)
        with _recording(model, record_stats) as stats:
            eps_hat = model(x_t, condition, t.to(torch.float32), label, **routes)
        loss = torch.mean(torch.square(eps_hat - z))
        return (loss, stats) if record_stats else loss

    return loss_fn


def make_completion_train_step(model, schedule: DiffusionSchedule, *,
                               record_stats: bool = False, fused_gather: bool = False,
                               fused_sa: bool = False, compiled: bool = False) -> Callable:
    """DDPM epsilon-MSE step: step(state, x0, condition, label, t=None,
    z=None) -> (state, loss), or (state, loss, stats) with
    ``record_stats``, with t ~ U[0, T) and z ~ N(0, 1) drawn from
    ``state.generator`` unless they are passed in.  ``compiled`` captures
    the update (x0, condition, label, t, z) -> loss; ``step.graphs`` holds
    its graphs."""
    device = next(model.parameters()).device
    sched = schedule.to(device)
    loss_fn = make_completion_loss(model, sched, fused_gather=fused_gather,
                                   fused_sa=fused_sa, record_stats=record_stats)
    run = _stepper(_make_update(model, loss_fn, record_stats), record_stats, compiled)

    def step(state: TrainState, x0, condition, label, t=None, z=None):
        B = x0.shape[0]
        if t is None:
            t = torch.randint(0, sched.T, (B,), generator=state.generator, device=x0.device)
        if z is None:
            z = torch.randn(x0.shape, generator=state.generator, device=x0.device,
                            dtype=x0.dtype)
        return run(state, x0, condition, label, t, z)

    step.graphs = run.graphs
    return step


def make_refine_loss(
    model,
    *,
    scale: float = 1.0,
    cd_loss_type: str = "cd_t",
    point_upsample_factor: int = 1,
    include_displacement_center: bool = False,
    intermediate_loss_weight: float = 0.0,
    task: str = "refine_completion",
    fused_gather: bool = False,
    fused_sa: bool = False,
    record_stats: bool = False,
) -> Callable:
    """loss(x_gt, condition, label, generated, output_scale_factor,
    noise=None) -> scalar chamfer loss of the refinement / denoise step, or
    (loss, stats) with ``record_stats``.  For task='denoise' the network
    input is ``x_gt + noise`` and ``generated`` is not read."""
    loss_idx = 1 if cd_loss_type == "cd_t" else 0
    routes = _route_kwargs(model, fused_gather, fused_sa)

    def loss_fn(x_gt, condition, label, generated, output_scale_factor, noise=None):
        generated_in = x_gt + noise if task == "denoise" else generated
        with _recording(model, record_stats) as stats:
            displacement = model(generated_in, condition, None, label, **routes)
        if point_upsample_factor > 1:
            refined, intermediate = point_upsample(
                generated_in, displacement, point_upsample_factor,
                include_displacement_center, output_scale_factor,
            )
        else:
            refined = generated_in + displacement * output_scale_factor
            intermediate = None
        refined = refined / scale / 2.0
        x = x_gt / scale / 2.0
        loss = calc_cd(refined, x)[loss_idx].mean()
        if intermediate is not None and intermediate_loss_weight > 0:
            inter = intermediate / scale / 2.0
            loss = loss + calc_cd(inter, x)[loss_idx].mean() * intermediate_loss_weight
        return (loss, stats) if record_stats else loss

    return loss_fn


def make_refine_train_step(
    model,
    *,
    scale: float = 1.0,
    cd_loss_type: str = "cd_t",
    point_upsample_factor: int = 1,
    include_displacement_center: bool = False,
    intermediate_loss_weight: float = 0.0,
    noise_magnitude: float = 0.0,
    task: str = "refine_completion",
    record_stats: bool = False,
    fused_gather: bool = False,
    fused_sa: bool = False,
    compiled: bool = False,
) -> Callable:
    """Refinement / denoise step: step(state, x_gt, condition, label,
    generated, output_scale_factor, noise=None) -> (state, loss), or
    (state, loss, stats) with ``record_stats``.  The per-step
    ``output_scale_factor`` is an argument, so a schedule can ramp it: a 0-d
    float32 tensor on the batch's device (a Python number is made one).  For
    task='denoise' the input is x_gt + noise, with noise ~ N(0,
    noise_magnitude) drawn from ``state.generator`` unless it is passed in;
    another task reads no noise.
    ``compiled`` captures the update (x_gt, condition, label, generated,
    output_scale_factor, noise) -> loss; ``step.graphs`` holds its
    graphs."""
    loss_fn = make_refine_loss(
        model, scale=scale, cd_loss_type=cd_loss_type,
        point_upsample_factor=point_upsample_factor,
        include_displacement_center=include_displacement_center,
        intermediate_loss_weight=intermediate_loss_weight, task=task,
        fused_gather=fused_gather, fused_sa=fused_sa, record_stats=record_stats,
    )

    run = _stepper(_make_update(model, loss_fn, record_stats), record_stats, compiled)

    def step(state: TrainState, x_gt, condition, label, generated,
             output_scale_factor: Union[float, torch.Tensor],
             noise: Optional[torch.Tensor] = None):
        if task != "denoise":
            noise = None
        elif noise is None:
            noise = noise_magnitude * torch.randn(
                x_gt.shape, generator=state.generator, device=x_gt.device,
                dtype=x_gt.dtype)
        osf = torch.as_tensor(output_scale_factor, dtype=torch.float32, device=x_gt.device)
        return run(state, x_gt, condition, label, generated, osf, noise)

    step.graphs = run.graphs
    return step


class _MeshForward(torch.nn.Module):
    """The network of a train step over a mesh, and the reduction of its
    gradients, which the update runs between ``backward()`` and Adam
    (``reduce_gradients``).  It makes them the global batch's mean gradient
    of what this rank stores, in a fixed order of collectives.

    Without a ``model`` axis nothing is sharded: the forward is the
    network's own, and the reduction sums every gradient over the world in
    one flat all-reduce and divides by the world, the psum that XLA puts
    into the JAX package's jitted mesh step.  With one, the forward
    all-gathers the sharded tensors over the model row into whole leaf
    tensors and runs the network on them (``torch.func.functional_call``),
    so the backward leaves this rank's whole gradients on those leaves; the
    reduction reduce-scatters them over the model row, all-reduces the
    slices over the data column and sums the replicated tensors' gradients
    over the world.  Under capture the gathered leaves, the flat buffers
    and the gradients are the graph's and replay at fixed addresses."""

    def __init__(self, model: torch.nn.Module, mesh):
        super().__init__()
        self.module = model
        self.mesh = mesh
        self._whole: Dict[str, torch.Tensor] = {}

    def _dims(self) -> Dict[str, int]:
        sharding = sharding_of(self.module)
        return sharding.dims if sharding is not None else {}

    def forward(self, *args, **kwargs):
        dims = self._dims()
        if not dims:
            return self.module(*args, **kwargs)
        params = dict(self.module.named_parameters())
        whole = gather_shards([params[n].detach() for n in dims], list(dims.values()),
                              self.mesh)
        self._whole = {n: w.requires_grad_() for n, w in zip(dims, whole)}
        return torch.func.functional_call(self.module, self._whole, args, kwargs)

    def reduce_gradients(self) -> None:
        mesh = self.mesh
        dims = self._dims()
        params = dict(self.module.named_parameters())
        if dims:
            whole = [w.grad if w.grad is not None else torch.zeros_like(w)
                     for w in (self._whole[n] for n in dims)]
            # a slice: summed over the model row, then over the data column
            sliced = reduce_scatter_shards(whole, list(dims.values()), mesh)
            if mesh.shape[DATA_AXIS] > 1:
                all_reduce_flat(sliced, mesh.data_group)
            for n, g in zip(dims, sliced):
                params[n].grad = g
        # a replicated tensor: summed over the world, not only the data
        # column, so that every rank steps it alike (kernel B's float32
        # atomics make one gradient differ in its last bits between ranks)
        replicated = [p for n, p in params.items() if n not in dims]
        for p in replicated:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        all_reduce_flat([p.grad for p in replicated])
        # one multi-tensor launch, not a division a gradient
        torch._foreach_div_([p.grad for p in params.values()], float(mesh.world))
        self._whole = {}


def _shard_train_state(state: TrainState, mesh) -> None:
    """Store the model's sharded tensors as this rank's slices and rebuild
    the optimizer over what the rank now holds: the same hyperparameters
    and flags (fused, capturable), and this rank's slice of any moments it
    had (a resumed state carries over), loaded as a resume loads them
    (``load_optimizer_state``: the step counts on the device)."""
    whole = state.optimizer.state_dict()
    shard_params(state.model, mesh)
    opt = type(state.optimizer)(state.model.parameters(), **state.optimizer.defaults)
    load_optimizer_state(opt, shard_optimizer_state_dict(state.model, opt, whole))
    state.optimizer = opt


def mesh_step_compiled(mesh, compiled: Optional[bool] = None) -> bool:
    """Whether ``jit_step_for_mesh`` takes the compiled step on ``mesh``:
    ``compiled`` where it is given, and by default yes, but for one case.
    Over a gloo process group on CUDA tensors (processes that share a
    card) the step is eager, since a CUDA graph cannot capture gloo's
    collectives, and ``compiled=True`` there raises ``ValueError``.  On
    the CPU the compiled step runs its update eagerly
    (``CapturedFunction``), with the same explicit reduction."""
    if mesh.distributed and mesh.device.type == "cuda" and "nccl" not in dist.get_backend():
        if compiled:
            raise ValueError(
                f"a compiled mesh step on CUDA tensors needs an NCCL process group: a CUDA "
                f"graph cannot capture the collectives of {dist.get_backend()!r} (initialise "
                "the group with backend='nccl', or pass compiled=False)")
        return False
    return True if compiled is None else bool(compiled)


def jit_step_for_mesh(make_step: Callable, mesh, state: TrainState, *args,
                      compiled: Optional[bool] = None, **kwargs):
    """The train step over the processes of ``mesh``: ``make_step``
    (``make_completion_train_step`` or ``make_refine_train_step``, with
    ``*args`` / ``**kwargs``) built on ``state.model``.  Each process passes
    its rank's rows of the global batch, and the step takes the update of
    the global batch's mean gradient, so the returned loss is the
    processes' mean (the global batch's loss when the rank batches are
    equal).

    With a ``model`` axis, ``state`` is sharded in place first
    (``parallel.shard_params``: each rank stores its slice of every tensor
    the JAX rule shards, and the optimizer is rebuilt over the slices with
    its moments sliced alike).  Adam is elementwise, so a slice's update is
    the one-process update of the same gradient.

    ``compiled`` (``mesh_step_compiled``: by default yes, but over gloo on
    CUDA tensors) is the port's ``jax.jit(step, in_shardings=...,
    out_shardings=...)``: one update of forward, loss, ``backward()``, the
    gradients' reduction over the mesh (``_MeshForward``), the fused
    capturable Adam and the loss's mean over the processes, which on the
    card is one captured CUDA graph a step signature, NCCL's collectives
    inside it; a capture that fails raises.  Eager
    (``compiled=False``), a data-only mesh wraps the model in
    ``DistributedDataParallel``, which averages the gradients in the
    backward (every parameter must get a gradient in each step, as the
    PointNet++ network's do with or without the fused routes), and a mesh
    with a ``model`` axis runs the same ``_MeshForward`` step uncaptured.
    Without an initialised process group it is ``make_step``'s own step.
    Returns (step, state); the state keeps the bare model, so checkpoints
    keep their keys (``train/checkpoints.py`` gathers a sharded one)."""
    compiled = mesh_step_compiled(mesh, compiled)
    if not mesh.distributed:
        return make_step(state.model, *args, compiled=compiled, **kwargs), state
    if mesh.shape[MODEL_AXIS] > 1:
        _shard_train_state(state, mesh)
    if compiled or mesh.shape[MODEL_AXIS] > 1:
        net = _MeshForward(state.model, mesh)
    else:
        dev = mesh.device
        net = DistributedDataParallel(
            state.model, device_ids=[dev.index] if dev.type == "cuda" else None)
    return make_step(net, *args, compiled=compiled, **kwargs), state
