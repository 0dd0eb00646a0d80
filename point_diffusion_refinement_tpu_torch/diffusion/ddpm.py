"""DDPM ancestral sampling.

Counterpart of the JAX package's ``diffusion/ddpm.py::sampling``: the reverse
process is a Python loop of T denoiser calls (the caller encodes the
condition once and closes over it in ``denoise_fn``).  The starting noise
``x_T`` and the per-step noise can be passed in, so that two
implementations can be fed the same numbers; otherwise they are drawn from
``generator``.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from .schedule import DiffusionSchedule

# denoise_fn(x: (B, N, 3), ts: (B,) float32) -> eps_hat (B, N, 3)
DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def sampling(
    denoise_fn: DenoiseFn,
    shape: Sequence[int],
    schedule: DiffusionSchedule,
    *,
    device,
    generator: Optional[torch.Generator] = None,
    x_T: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Ancestral reverse diffusion p(x_0 | x_T), from t = T-1 down to 0.

    Args:
      denoise_fn: closure over the model and condition features.
      shape: (B, N, 3).
      device: where the state lives.
      generator: draws x_T and the per-step noise when they are not given
        (a generator on ``device``).
      x_T: optional starting noise of ``shape``.
      noise: optional (T, *shape) per-step noise, row i used at the i-th
        step (t = T-1-i); the row of the last step (t = 0) is not used.

    Returns:
      x_0 of ``shape``, float32.
    """
    shape = tuple(shape)
    B = shape[0]
    sched = schedule.to(device)
    T = sched.T
    if x_T is None:
        x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    else:
        x = x_T.to(device=device, dtype=torch.float32)
    if noise is not None and tuple(noise.shape) != (T,) + shape:
        raise ValueError(f"noise must be {(T,) + shape}, got {tuple(noise.shape)}")
    one = torch.ones((), dtype=torch.float32, device=device)
    for i, t in enumerate(range(T - 1, -1, -1)):
        ts = torch.full((B,), float(t), dtype=torch.float32, device=device)
        eps = denoise_fn(x, ts)
        alpha_t = sched.alpha[t]
        coef = (one - alpha_t) / torch.sqrt(one - sched.alpha_bar[t])
        x = (x - coef * eps) / torch.sqrt(alpha_t)
        if t > 0:
            if noise is not None:
                z = noise[i].to(device=device, dtype=torch.float32)
            else:
                z = torch.randn(shape, generator=generator, device=device,
                                dtype=torch.float32)
            x = x + sched.sigma[t] * z
    return x
