"""Three-nearest-neighbour interpolation.

Counterpart of the JAX package's ``ops/interpolate.py``; plain PyTorch on top
of ``knn`` and ``group_points`` (whose backward is the ordered scatter-add on
the card).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .neighbors import knn
from .sampling import group_points


def three_nn(unknown: torch.Tensor, known: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """3 nearest neighbours of each ``unknown`` point among ``known``:
    euclidean (not squared) distances and indices, both (B, n, 3)."""
    d2, idx = knn(unknown, known, 3)
    return torch.sqrt(d2), idx


def three_interpolate(features: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Weighted sum of 3 neighbour features: (B, m, C), (B, n, 3), (B, n, 3)
    -> (B, n, C)."""
    g = group_points(features, idx)  # (B, n, 3, C)
    return (g * weight[..., None]).sum(dim=2)


def inverse_distance_weights(dist: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """1/(d+eps) normalised over the last axis."""
    recip = 1.0 / (dist + eps)
    return recip / recip.sum(dim=-1, keepdim=True)
