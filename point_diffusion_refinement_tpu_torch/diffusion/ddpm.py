"""DDPM ancestral sampling.

Counterpart of the JAX package's ``diffusion/ddpm.py::sampling``: the reverse
process is a Python loop of denoiser calls (the caller encodes the
condition once and closes over it in ``denoise_fn``), with the warm start
from a precomputed ``XT`` and the noise-free t-slice capture.  The starting
noise ``x_T`` and the per-step noise can be passed in, so that two
implementations can be fed the same numbers; otherwise they are drawn from
``generator``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple, Union

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
    t_slices: Optional[Sequence[int]] = None,
    XT: Optional[torch.Tensor] = None,
    warm_start_step: Optional[int] = None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, Dict[int, torch.Tensor]]]:
    """Ancestral reverse diffusion p(x_0 | x_T), from t = T-1 down to 0.

    Args:
      denoise_fn: closure over the model and condition features.
      shape: (B, N, 3).
      device: where the state lives.
      generator: draws x_T and the per-step noise when they are not given
        (a generator on ``device``).
      x_T: optional starting noise of ``shape`` (with ``XT``: the noise of
        the warm start).
      noise: optional (n, *shape) per-step noise for the n steps run, row i
        used at the i-th step (t = start-i); the row of the last step
        (t = 0) is not used.
      t_slices: optional t values at which the noise-free state (right
        after the mean update, before sigma_t z is added) is recorded.
      XT, warm_start_step: optional warm start (both or neither):
        x = XT + sigma[warm_start_step] * x_T and the loop starts at
        warm_start_step - 1.

    Returns:
      x_0 of ``shape``, float32; with ``t_slices``, (x_0, {t: slice}).
    """
    shape = tuple(shape)
    B = shape[0]
    sched = schedule.to(device)
    if x_T is None:
        x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    else:
        x = x_T.to(device=device, dtype=torch.float32)
    if XT is not None:
        if warm_start_step is None:
            raise ValueError("a warm start needs warm_start_step")
        x = XT.to(device=device, dtype=torch.float32) + sched.sigma[warm_start_step] * x
        start = warm_start_step - 1
    else:
        start = sched.T - 1
    if noise is not None and tuple(noise.shape) != (start + 1,) + shape:
        raise ValueError(f"noise must be {(start + 1,) + shape}, got {tuple(noise.shape)}")
    slices_t = tuple(int(t) for t in t_slices) if t_slices else ()
    slices: Dict[int, torch.Tensor] = {}
    one = torch.ones((), dtype=torch.float32, device=device)
    for i, t in enumerate(range(start, -1, -1)):
        ts = torch.full((B,), float(t), dtype=torch.float32, device=device)
        eps = denoise_fn(x, ts)
        alpha_t = sched.alpha[t]
        coef = (one - alpha_t) / torch.sqrt(one - sched.alpha_bar[t])
        x = (x - coef * eps) / torch.sqrt(alpha_t)
        if t in slices_t:
            slices[t] = x
        if t > 0:
            if noise is not None:
                z = noise[i].to(device=device, dtype=torch.float32)
            else:
                z = torch.randn(shape, generator=generator, device=device,
                                dtype=torch.float32)
            x = x + sched.sigma[t] * z
    if slices_t:
        zeros = torch.zeros(shape, dtype=torch.float32, device=device)
        return x, {t: slices.get(t, zeros) for t in slices_t}
    return x
