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
package.  The neighbour-statistics collection (``record_stats``) and the
multi-device step (``jit_step_for_mesh``) are not ported yet; asking for
them raises.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..diffusion.ddpm import q_sample
from ..diffusion.schedule import DiffusionSchedule
from ..models.upsample import point_upsample
from ..ops.chamfer import calc_cd


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


def _no_record_stats(record_stats: bool) -> None:
    if record_stats:
        raise NotImplementedError("record_stats (neighbour statistics) is not ported yet")


def _apply(state: TrainState, loss: torch.Tensor) -> torch.Tensor:
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    return loss.detach()


def make_completion_loss(model, schedule: DiffusionSchedule, *, fused_gather: bool = False,
                         fused_sa: bool = False) -> Callable:
    """loss(x0, condition, label, t, z) -> scalar epsilon-MSE of the DDPM
    step at the given draws: t (B,) int, z like x0.  ``schedule`` lies on
    x0's device."""

    def loss_fn(x0, condition, label, t, z):
        x_t = q_sample(x0, t, z, schedule)
        eps_hat = model(x_t, condition, t.to(torch.float32), label,
                        fused_gather=fused_gather, fused_sa=fused_sa)
        return torch.mean(torch.square(eps_hat - z))

    return loss_fn


def make_completion_train_step(model, schedule: DiffusionSchedule, *,
                               record_stats: bool = False, fused_gather: bool = False,
                               fused_sa: bool = False) -> Callable:
    """DDPM epsilon-MSE step: step(state, x0, condition, label) ->
    (state, loss), with t ~ U[0, T) and z ~ N(0, 1) drawn from
    ``state.generator``."""
    _no_record_stats(record_stats)
    device = next(model.parameters()).device
    sched = schedule.to(device)
    loss_fn = make_completion_loss(model, sched, fused_gather=fused_gather,
                                   fused_sa=fused_sa)

    def step(state: TrainState, x0, condition, label):
        B = x0.shape[0]
        t = torch.randint(0, sched.T, (B,), generator=state.generator, device=x0.device)
        z = torch.randn(x0.shape, generator=state.generator, device=x0.device,
                        dtype=x0.dtype)
        return state, _apply(state, loss_fn(x0, condition, label, t, z))

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
) -> Callable:
    """loss(x_gt, condition, label, generated, output_scale_factor,
    noise=None) -> scalar chamfer loss of the refinement / denoise step.
    For task='denoise' the network input is ``x_gt + noise`` and
    ``generated`` is not read."""
    loss_idx = 1 if cd_loss_type == "cd_t" else 0

    def loss_fn(x_gt, condition, label, generated, output_scale_factor, noise=None):
        generated_in = x_gt + noise if task == "denoise" else generated
        displacement = model(generated_in, condition, None, label,
                             fused_gather=fused_gather, fused_sa=fused_sa)
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
        return loss

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
    generated, output_scale_factor) -> (state, loss).  The per-step
    ``output_scale_factor`` is an argument, so a schedule can ramp it.  For
    task='denoise' the input is made inside the step as x_gt +
    N(0, noise_magnitude) from ``state.generator``."""
    _no_record_stats(record_stats)
    loss_fn = make_refine_loss(
        model, scale=scale, cd_loss_type=cd_loss_type,
        point_upsample_factor=point_upsample_factor,
        include_displacement_center=include_displacement_center,
        intermediate_loss_weight=intermediate_loss_weight, task=task,
        fused_gather=fused_gather, fused_sa=fused_sa,
    )

    def step(state: TrainState, x_gt, condition, label, generated,
             output_scale_factor):
        noise: Optional[torch.Tensor] = None
        if task == "denoise":
            noise = noise_magnitude * torch.randn(
                x_gt.shape, generator=state.generator, device=x_gt.device,
                dtype=x_gt.dtype)
        loss = loss_fn(x_gt, condition, label, generated, output_scale_factor, noise)
        return state, _apply(state, loss)

    return step


def jit_step_for_mesh(*args, **kwargs):
    """The JAX package's multi-device train step (data-parallel batch,
    sharded parameters).  Not ported yet."""
    raise NotImplementedError("multi-device training is not ported yet")
