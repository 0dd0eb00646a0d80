"""Small pointwise baseline denoiser: the ``network_type: "pointwise_net"``
network.

Counterpart of the JAX package's ``models/pointwise_net.py``: six
ConcatSquashLinear layers gated by [beta, sin(beta), cos(beta)] time
features joined with the Pnet2Stage global feature of the condition cloud,
on its own zero-padded linear variance schedule.  It runs no hand-written
kernel.

Flax infers the Pnet2Stage input width from the condition it is first
called with, so the JAX network takes a condition of any width (the
mirrored partials' 4 channels under the default (3, 128, 256) first stage);
here that width is the ``condition_features`` argument.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import Dense
from .pnet import Pnet2Stage


def pointwise_variance_schedule(num_steps: int, beta_1: float, beta_T: float) -> torch.Tensor:
    """Betas of shape (num_steps + 1,) with betas[0] = 0, float32."""
    betas = np.concatenate([[0.0], np.linspace(beta_1, beta_T, num_steps)])
    return torch.tensor(betas, dtype=torch.float32)


class ConcatSquashLinear(nn.Module):
    """Dense(x) * sigmoid(Dense(ctx)) + Dense(ctx) (no bias on the last)."""

    def __init__(self, in_features: int, ctx_features: int, features: int):
        super().__init__()
        self.Dense_0 = Dense(ctx_features, features)
        self.Dense_1 = Dense(ctx_features, features, use_bias=False)
        self.Dense_2 = Dense(in_features, features)

    def forward(self, ctx, x):
        gate = torch.sigmoid(self.Dense_0(ctx))
        return self.Dense_2(x) * gate + self.Dense_1(ctx)


class PointwiseNet(nn.Module):
    # the global encoder's first weight, (width, condition_features)
    CONDITION_WEIGHT = "Pnet2Stage_0.ConditionedMLP_0.SharedMLP_0.Dense_0.weight"

    def __init__(self, *, condition_features: int, point_features: int = 3,
                 residual: bool = True, num_steps: int = 1000, beta_1: float = 1e-4,
                 beta_T: float = 0.05, mode: str = "linear",
                 pnet_global_feature_architecture: Sequence[Sequence[int]] = (
                     (3, 128, 256), (512, 1024)),
                 global_feature_remove_last_activation: bool = False,
                 layer_dims: Sequence[int] = (128, 256, 512, 256, 128, 3)):
        super().__init__()
        # ``mode`` is accepted as the JAX network accepts it: the schedule is linear
        self.residual, self.num_steps = residual, int(num_steps)
        self.register_buffer(
            "betas", pointwise_variance_schedule(self.num_steps, beta_1, beta_T),
            persistent=False)
        arch = pnet_global_feature_architecture
        self.Pnet2Stage_0 = Pnet2Stage(
            int(condition_features), tuple(arch[0]), tuple(arch[1]), bn=False,
            remove_last_activation=global_feature_remove_last_activation)
        ctx_w = 3 + self.Pnet2Stage_0.out_features
        self.n_layers = len(layer_dims)
        width = int(point_features)
        for i, f in enumerate(layer_dims):
            setattr(self, f"ConcatSquashLinear_{i}", ConcatSquashLinear(width, ctx_w, f))
            width = int(f)

    def init_weights(self, generator: torch.Generator) -> None:
        """Re-draw every Dense kernel (lecun normal, zero bias) from
        ``generator``, in module order."""
        for m in self.modules():
            if isinstance(m, Dense):
                m.reset_parameters(generator)

    def forward(self, x, condition, ts=None, label=None):
        """x (B, N, 3); condition (B, M, C); ts (B,) -> (B, N, 3)."""
        if ts is None:
            ts = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
        # the timestep is truncated to an integer and indexes the padded
        # betas, clamped to the table as a JAX gather clamps
        beta = self.betas[ts.to(torch.int64).clamp(0, self.num_steps)][:, None, None]
        context = self.Pnet2Stage_0(condition)[:, None, :]
        ctx = torch.cat([beta, torch.sin(beta), torch.cos(beta), context], dim=-1)
        out = x
        for i in range(self.n_layers):
            out = getattr(self, f"ConcatSquashLinear_{i}")(ctx, out)
            if i < self.n_layers - 1:
                out = F.leaky_relu(out, negative_slope=0.01)
        return x + out if self.residual else out
