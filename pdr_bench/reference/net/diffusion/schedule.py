"""DDPM schedule math and timestep embeddings.

Counterpart of the JAX package's ``diffusion/schedule.py``: schedules are
computed on the host in float64 numpy and kept as float32 tensors.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Linear-beta DDPM hyperparameters, each a (T,) float32 tensor."""

    beta: torch.Tensor
    alpha: torch.Tensor
    alpha_bar: torch.Tensor
    sigma: torch.Tensor  # sqrt of beta_tilde

    @property
    def T(self) -> int:
        return int(self.beta.shape[0])

    def to(self, device) -> "DiffusionSchedule":
        return DiffusionSchedule(
            *(getattr(self, f.name).to(device) for f in dataclasses.fields(self))
        )


def calc_diffusion_hyperparams(T: int, beta_0: float, beta_T: float) -> DiffusionSchedule:
    beta = np.linspace(beta_0, beta_T, T, dtype=np.float64)
    alpha = 1.0 - beta
    alpha_bar = np.cumprod(alpha)
    # beta_tilde_t = beta_t * (1 - abar_{t-1}) / (1 - abar_t);  beta_tilde_0 = beta_0
    beta_tilde = beta.copy()
    beta_tilde[1:] = beta[1:] * (1.0 - alpha_bar[:-1]) / (1.0 - alpha_bar[1:])
    sigma = np.sqrt(beta_tilde)
    f32 = lambda x: torch.from_numpy(x.astype(np.float32))
    return DiffusionSchedule(
        beta=f32(beta), alpha=f32(alpha), alpha_bar=f32(alpha_bar), sigma=f32(sigma)
    )


def calc_t_emb(ts: torch.Tensor, t_emb_dim: int) -> torch.Tensor:
    """Sinusoidal timestep embedding: (B,) -> (B, t_emb_dim) =
    [sin(t * w), cos(t * w)] with w_i = 10000^{-i/(h-1)}."""
    assert t_emb_dim % 2 == 0
    half = t_emb_dim // 2
    # a float32 scalar on the host: an operand of the device op, not a copy
    # to the device (which a captured CUDA graph cannot hold)
    step = torch.tensor(-math.log(10000.0) / (half - 1), dtype=torch.float32)
    freq = torch.exp(torch.arange(half, dtype=torch.float32, device=ts.device) * step)
    arg = ts.to(torch.float32)[:, None] * freq[None, :]
    return torch.cat([torch.sin(arg), torch.cos(arg)], dim=1)
