"""Coarse-cloud generation: condition-encode once, run the reverse process.

Counterpart of the JAX package's ``sample/generate.py`` (the ancestral path of
``make_coarse_sampler``, and ``unaugment``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..diffusion import ddpm
from ..diffusion.schedule import DiffusionSchedule


def make_coarse_sampler(model, schedule: DiffusionSchedule, num_points: int):
    """Build a sampler for ``model`` (a PointNet2CloudCondition).

    Returns fn(condition, label, generator=None, x_T=None, noise=None) ->
    x0 (B, num_points, 3) float32 on the model's device.  The condition
    branch runs once; every reverse step runs ``denoise`` with the fused
    kernel routing of inference.
    """

    def sampler(condition: torch.Tensor, label: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                x_T: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        device = next(model.parameters()).device
        condition = condition.to(device=device, dtype=torch.float32)
        label = label.to(device)
        with torch.no_grad():
            cond = model.encode_condition(condition)

            def denoise_fn(x, ts):
                return model.denoise(x, ts, label, cond, fused=True)

            return ddpm.sampling(
                denoise_fn, (condition.shape[0], num_points, 3), schedule,
                device=device, generator=generator, x_T=x_T, noise=noise,
            )

    return sampler


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
