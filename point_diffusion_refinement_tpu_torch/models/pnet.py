"""Two-stage PointNet global feature encoder.

Counterpart of the JAX package's ``models/pnet.py``: mlp -> max-pool ->
concat pooled with per-point -> mlp -> max-pool -> (B, mlp2[-1]).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..utils import profiling
from .common import ConditionedMLP


class Pnet2Stage(nn.Module):
    """mlp1/mlp2 are the reference's full specs, e.g. [4, 128, 256],
    [512, 1024]; the input width is ``in_features`` and the second stage
    takes [feature, pooled] with 2 * mlp1[-1] channels."""

    def __init__(self, in_features: int, mlp1: Sequence[int], mlp2: Sequence[int],
                 bn: bool = True, remove_last_activation: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.ConditionedMLP_0 = ConditionedMLP(
            in_features, tuple(mlp1[1:]), bn=bn, bias=True,
            trim_last=remove_last_activation, dtype=dtype,
        )
        self.ConditionedMLP_1 = ConditionedMLP(
            2 * int(mlp1[-1]), tuple(mlp2), bn=bn, bias=True,
            trim_last=remove_last_activation, dtype=dtype,
        )
        self.out_features = int(mlp2[-1])

    @profiling.spanned("pdr.net.mlp", device=True)
    def forward(self, x):
        h = self.ConditionedMLP_0(x[:, :, None, :])  # (B, N, 1, C1)
        pooled = h.amax(dim=1, keepdim=True)
        h = torch.cat([h, pooled.expand_as(h)], dim=-1)
        h = self.ConditionedMLP_1(h)
        return h.amax(dim=1)[:, 0, :]
