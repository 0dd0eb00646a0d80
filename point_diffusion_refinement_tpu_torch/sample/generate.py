"""Coarse-cloud generation and one-forward refinement.

Counterpart of the JAX package's ``sample/generate.py``:
``make_coarse_sampler`` (ancestral DDPM with t-slices and the warm start,
or FastDPM over a precomputed plan), ``make_refiner`` and ``unaugment``.
The JAX package compiles generation with ``jax.jit``; here the counterpart
of a compiled program is a captured CUDA graph (``utils/graphs.py``):
``make_coarse_sampler(segment_size=S)`` replays one captured reverse step
in chunks of S steps (``diffusion/ddpm.py::make_segmented_sampler``, and its
FastDPM twin), and ``CapturedFunction(make_refiner(...))`` is the compiled
refiner.  Without ``segment_size`` the sampler runs eagerly, as the JAX
function does un-jitted.  The JAX sampler's ``mesh`` option (the batch's
rows split over the devices) is ``sample/pipeline.py::run_generation(mesh=)``'s.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..diffusion import ddpm, fastdpm
from ..diffusion.schedule import DiffusionSchedule
from ..models.upsample import point_upsample


def make_coarse_sampler(
    model,
    schedule: DiffusionSchedule,
    num_points: int,
    *,
    fast_plan: Optional[fastdpm.FastSamplingPlan] = None,
    t_slices: Optional[Sequence[int]] = None,
    warm_start_step: Optional[int] = None,
    segment_size: Optional[int] = None,
    fused_attention: bool = False,
    fused_knn: bool = False,
    packed: bool = False,
):
    """Build a sampler for ``model``, a PointNet2CloudCondition (another
    network raises ``ValueError``).

    Returns fn(condition, label, generator=None, x_T=None, noise=None,
    XT=None) -> x0 (B, num_points, 3) float32 on the model's device, or
    (x0, {t: slice}) with ``t_slices``.  The condition branch runs once;
    every reverse step runs ``denoise`` with the fused kernel routing of
    inference.  With ``fast_plan`` the reverse process is FastDPM's
    (``t_slices`` and the warm start are not read); otherwise it is
    ancestral, warm-started from ``XT`` at ``warm_start_step`` when ``XT``
    is given.

    With ``segment_size`` the reverse steps run as one captured CUDA graph
    of a step, replayed in chunks of ``segment_size`` steps
    (``ddpm.make_segmented_sampler``, ``fastdpm.make_segmented_fast_sampler``;
    a size of at least the number of steps is the whole program in one
    chunk); the label and the condition features are inputs of the graph,
    so one capture serves every batch of a shape.  The result is the eager
    sampler's for the same ``x_T`` and ``noise`` or the same generator.
    The sampler's ``graphs`` attribute (None without ``segment_size``) holds
    the captured step: ``sampler.graphs.release()`` frees it, and must come
    before the model's parameter tensors are replaced (``utils/graphs.py``).

    ``fused_attention``, ``fused_knn`` and ``packed`` turn on the opt-in
    inference routes of ``denoise`` (the fused attention-pool kernel, the
    fused kNN group, merged first-layer products); all off by default.
    """
    if not hasattr(model, "encode_condition"):
        # as in the JAX package, whose sampler reads model.encode_condition
        raise ValueError(f"{type(model).__name__} has no encode_condition: the coarse "
                         "sampler needs the pointnet++ network")
    routes = dict(fused_attention=fused_attention, fused_knn=fused_knn, packed=packed)

    def denoise_apply(batch_ctx, x, ts):
        label, cond = batch_ctx
        return model.denoise(x, ts, label, cond, fused=True, **routes)

    segmented = None
    if segment_size is not None and fast_plan is not None:
        segmented = fastdpm.make_segmented_fast_sampler(denoise_apply, fast_plan, segment_size)
    elif segment_size is not None:
        segmented = ddpm.make_segmented_sampler(denoise_apply, schedule, segment_size,
                                                t_slices=t_slices)

    def sampler(condition: torch.Tensor, label: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                x_T: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None,
                XT: Optional[torch.Tensor] = None):
        device = next(model.parameters()).device
        condition = condition.to(device=device, dtype=torch.float32)
        label = label.to(device)
        shape = (condition.shape[0], num_points, 3)
        with torch.no_grad():
            cond = model.encode_condition(condition)
            if segmented is not None and fast_plan is not None:
                return segmented((label, cond), shape, device=device, generator=generator,
                                 x_T=x_T, noise=noise)
            if segmented is not None:
                return segmented((label, cond), shape, device=device, generator=generator,
                                 x_T=x_T, noise=noise, XT=XT,
                                 warm_start_step=warm_start_step if XT is not None else None)

            def denoise_fn(x, ts):
                return denoise_apply((label, cond), x, ts)

            if fast_plan is not None:
                return fastdpm.fast_sampling(
                    denoise_fn, shape, fast_plan, device=device, generator=generator,
                    x_T=x_T, noise=noise,
                )
            return ddpm.sampling(
                denoise_fn, shape, schedule, device=device, generator=generator,
                x_T=x_T, noise=noise, t_slices=t_slices, XT=XT,
                warm_start_step=warm_start_step if XT is not None else None,
            )

    sampler.graphs = segmented.graphs if segmented is not None else None
    return sampler


def make_refiner(model, point_upsample_factor: int = 1,
                 include_displacement_center: bool = False, *,
                 fused_attention: bool = False, fused_knn: bool = False,
                 packed: bool = False):
    """One-forward refinement with ``model`` (a PointNet2CloudCondition
    built with ``include_t=False``).

    Returns fn(coarse (B, N, 3), condition, label, output_scale_factor) ->
    refined (B, N * point_upsample_factor, 3) float32: one unfused
    ``forward`` gives the displacement, which ``point_upsample`` spreads
    into the upsampled cloud, or which is added as
    ``coarse + displacement * output_scale_factor`` when the factor is 1.

    With ``fused_attention``, ``fused_knn`` or ``packed`` on, the forward
    takes the inference routing instead (``encode_condition`` +
    ``denoise(fused=True, ...)``), where those routes exist.
    """
    routes = dict(fused_attention=fused_attention, fused_knn=fused_knn, packed=packed)

    def refine(coarse: torch.Tensor, condition: torch.Tensor, label: torch.Tensor,
               output_scale_factor: float) -> torch.Tensor:
        device = next(model.parameters()).device
        coarse = coarse.to(device=device, dtype=torch.float32)
        condition = condition.to(device=device, dtype=torch.float32)
        with torch.no_grad():
            if any(routes.values()):
                cond = model.encode_condition(condition)
                displacement = model.denoise(coarse, None, label.to(device), cond,
                                             fused=True, **routes)
            else:
                displacement = model(coarse, condition, None, label.to(device))
            if point_upsample_factor > 1:
                refined, _ = point_upsample(
                    coarse, displacement, point_upsample_factor,
                    include_displacement_center, output_scale_factor,
                )
            else:
                refined = coarse + displacement * output_scale_factor
        return refined

    return refine


def unaugment(x: torch.Tensor, M_inv: torch.Tensor, translation: torch.Tensor) -> torch.Tensor:
    """Undo the per-sample augmentation after generation:
    x = (x - translation) @ M_inv, in full float32 (the contraction depth is
    3, written out so no TF32 matmul path can touch it)."""
    y = (x - translation).to(torch.float32)
    M = M_inv.to(torch.float32)
    return (
        y[..., 0:1] * M[:, None, 0, :]
        + y[..., 1:2] * M[:, None, 1, :]
        + y[..., 2:3] * M[:, None, 2, :]
    )
