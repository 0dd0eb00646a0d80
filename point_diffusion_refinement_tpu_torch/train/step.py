"""Training steps for the three tasks: DDPM completion, refinement and
denoising.

Counterpart of the JAX package's ``train/step.py``.  One optimizer step is
q-sample (or the refine input) + forward + loss + ``backward()`` + Adam
update, run eagerly.  Each step maker is split into a pure loss function
that takes its random draws (``t`` and ``z``, or the denoise task's noise) as
tensors, so that two implementations can be fed the same draws, and a step
that draws them from the state's generator.

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
rows of the global batch a process: the step maker's step on the model
wrapped in ``DistributedDataParallel``, or, with a ``model`` axis, on the
model whose large tensors each rank stores as slices (``parallel/mesh.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional

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
    square root, no weight decay) over the model's float32 parameters, and a
    generator on the model's device seeded with ``seed``."""
    device = next(model.parameters()).device
    optimizer = torch.optim.Adam(
        model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=0.0,
    )
    generator = torch.Generator(device=device)
    generator.manual_seed(int(seed))
    return TrainState(model=model, optimizer=optimizer, generator=generator)


def _unwrap(model) -> torch.nn.Module:
    """The network inside a ``DistributedDataParallel`` or ``_ShardedForward``
    wrapper."""
    return model.module if isinstance(model, (DistributedDataParallel, _ShardedForward)) \
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


def _apply(state: TrainState, loss: torch.Tensor) -> torch.Tensor:
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    return loss.detach()


def _finish(state: TrainState, out, record_stats: bool):
    """One optimizer step on the loss function's output: (state, loss), or
    (state, loss, stats) with ``record_stats``."""
    if record_stats:
        loss, stats = out
        return state, _apply(state, loss), stats
    return state, _apply(state, out)


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
                               fused_sa: bool = False) -> Callable:
    """DDPM epsilon-MSE step: step(state, x0, condition, label, t=None,
    z=None) -> (state, loss), or (state, loss, stats) with
    ``record_stats``, with t ~ U[0, T) and z ~ N(0, 1) drawn from
    ``state.generator`` unless they are passed in."""
    device = next(model.parameters()).device
    sched = schedule.to(device)
    loss_fn = make_completion_loss(model, sched, fused_gather=fused_gather,
                                   fused_sa=fused_sa, record_stats=record_stats)

    def step(state: TrainState, x0, condition, label, t=None, z=None):
        B = x0.shape[0]
        if t is None:
            t = torch.randint(0, sched.T, (B,), generator=state.generator, device=x0.device)
        if z is None:
            z = torch.randn(x0.shape, generator=state.generator, device=x0.device,
                            dtype=x0.dtype)
        return _finish(state, loss_fn(x0, condition, label, t, z), record_stats)

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
) -> Callable:
    """Refinement / denoise step: step(state, x_gt, condition, label,
    generated, output_scale_factor) -> (state, loss), or (state, loss,
    stats) with ``record_stats``.  The per-step ``output_scale_factor`` is
    an argument, so a schedule can ramp it.  For task='denoise' the input is
    made inside the step as x_gt + N(0, noise_magnitude) from
    ``state.generator``."""
    loss_fn = make_refine_loss(
        model, scale=scale, cd_loss_type=cd_loss_type,
        point_upsample_factor=point_upsample_factor,
        include_displacement_center=include_displacement_center,
        intermediate_loss_weight=intermediate_loss_weight, task=task,
        fused_gather=fused_gather, fused_sa=fused_sa, record_stats=record_stats,
    )

    def step(state: TrainState, x_gt, condition, label, generated,
             output_scale_factor):
        noise: Optional[torch.Tensor] = None
        if task == "denoise":
            noise = noise_magnitude * torch.randn(
                x_gt.shape, generator=state.generator, device=x_gt.device,
                dtype=x_gt.dtype)
        out = loss_fn(x_gt, condition, label, generated, output_scale_factor, noise)
        return _finish(state, out, record_stats)

    return step


class _ShardedForward(torch.nn.Module):
    """The network of a train step under the mesh's ``model`` axis.  Its
    forward all-gathers the sharded tensors over the model row into whole
    leaf tensors and runs the network on them (``torch.func.functional_call``),
    so the backward leaves this rank's whole gradients on those leaves.
    ``reduce_gradients``, run just before the optimizer steps, makes them and
    the replicated tensors' gradients the global batch's mean gradient of
    what this rank stores, in a fixed order of collectives."""

    def __init__(self, model: torch.nn.Module, mesh):
        super().__init__()
        self.module = model
        self.mesh = mesh
        self._whole: Dict[str, torch.Tensor] = {}

    def forward(self, *args, **kwargs):
        dims = sharding_of(self.module).dims
        params = dict(self.module.named_parameters())
        whole = gather_shards([params[n].detach() for n in dims], list(dims.values()),
                              self.mesh)
        self._whole = {n: w.requires_grad_() for n, w in zip(dims, whole)}
        return torch.func.functional_call(self.module, self._whole, args, kwargs)

    def reduce_gradients(self) -> None:
        mesh = self.mesh
        dims = sharding_of(self.module).dims
        params = dict(self.module.named_parameters())
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
        for p in params.values():
            p.grad.div_(mesh.world)
        self._whole = {}


def _shard_train_state(state: TrainState, mesh) -> None:
    """Store the model's sharded tensors as this rank's slices and rebuild
    the optimizer over what the rank now holds: the same hyperparameters,
    and this rank's slice of any moments it had (a resumed state carries
    over)."""
    whole = state.optimizer.state_dict()
    shard_params(state.model, mesh)
    opt = type(state.optimizer)(state.model.parameters(), **state.optimizer.defaults)
    opt.load_state_dict(shard_optimizer_state_dict(state.model, opt, whole))
    state.optimizer = opt


def jit_step_for_mesh(make_step: Callable, mesh, state: TrainState, *args, **kwargs):
    """The train step over the processes of ``mesh``: ``make_step``
    (``make_completion_train_step`` or ``make_refine_train_step``, with
    ``*args`` / ``**kwargs``) built on ``state.model``.  Each process passes
    its rank's rows of the global batch, and the step takes the update of
    the global batch's mean gradient, so the returned loss is the
    processes' mean (the global batch's loss when the rank batches are
    equal).

    With ``mesh.shape["model"]`` = 1 the model is wrapped in
    ``DistributedDataParallel``, whose backward averages the gradients;
    every parameter must get a gradient in each step, as the PointNet++
    network's do with or without the fused routes.  With a ``model`` axis,
    ``state`` is sharded in place first (``parallel.shard_params``: each
    rank stores its slice of every tensor the JAX rule shards, and the
    optimizer is rebuilt over the slices with its moments sliced alike); a
    step all-gathers the slices for the forward, and before Adam it
    reduce-scatters their gradients over the model row, sums them over the
    data column and sums the replicated tensors' gradients over the world.
    Adam is elementwise, so a slice's update is the one-process update of
    the same gradient.

    Without an initialised process group it is ``make_step``'s own step.
    Returns (step, state); the state keeps the bare model, so checkpoints
    keep their keys (``train/checkpoints.py`` gathers a sharded one)."""
    if not mesh.distributed:
        return make_step(state.model, *args, **kwargs), state
    if mesh.shape[MODEL_AXIS] > 1:
        net = _ShardedForward(state.model, mesh)
        _shard_train_state(state, mesh)
        state.optimizer.register_step_pre_hook(lambda *_: net.reduce_gradients())
    else:
        dev = mesh.device
        net = DistributedDataParallel(
            state.model, device_ids=[dev.index] if dev.type == "cuda" else None)
    inner = make_step(net, *args, **kwargs)

    def step(state: TrainState, *a, **kw):
        out = inner(state, *a, **kw)
        loss = out[1].clone()
        dist.all_reduce(loss)
        return (out[0], loss / mesh.world) + tuple(out[2:])

    return step, state
