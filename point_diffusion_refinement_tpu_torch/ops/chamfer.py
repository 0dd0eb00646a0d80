"""Chamfer distance, F-score and the CD-p / CD-t metrics.

Counterpart of the JAX package's ``ops/chamfer.py`` (plain XLA there, plain
PyTorch here).  The nearest neighbour of every point is the argmin of the
exact per-coordinate distance matrix (``pairwise_sqdist``); above a budget
of 2^26 float32 elements per (B, chunk, N) tile the rows are processed in
chunks, so a 16384-point cloud never holds its 1 GiB full matrix.  The
distance is then recomputed from the gathered neighbour.  ``calc_cd`` runs
in the span ``pdr.loss.chamfer`` (``utils/profiling.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .neighbors import pairwise_sqdist
from ..utils import profiling
from .sampling import gather_points

# Max elements per (B * chunk * N) distance tile before rows are chunked.
TILE_BUDGET = 1 << 26  # 64M f32 elements = 256 MB


def _argmin_chunked(a: torch.Tensor, b: torch.Tensor, chunk: int) -> torch.Tensor:
    """argmin_j ||a_i - b_j||^2 for each row i, over row chunks of ``a``."""
    return torch.cat(
        [pairwise_sqdist(a[:, i: i + chunk], b).argmin(dim=-1)
         for i in range(0, a.shape[1], chunk)],
        dim=1,
    ).to(torch.int32)


def nn_sqdist(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Squared distance of each point of ``a`` (B, M, 3) to its nearest
    neighbour in ``b`` (B, N, 3), and that neighbour's index: (B, M) float32
    and (B, M) int32 (ties to the lowest index)."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    B, M, _ = a.shape
    N = b.shape[1]
    if B * M * N <= TILE_BUDGET:
        idx = pairwise_sqdist(a, b).argmin(dim=-1).to(torch.int32)
    else:
        idx = _argmin_chunked(a, b, min(max(128, TILE_BUDGET // max(B * N, 1)), M))
    diff = a - gather_points(b, idx)
    dist = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1] + diff[..., 2] * diff[..., 2]
    return dist, idx


def chamfer_distance(x: torch.Tensor, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unreduced bidirectional squared chamfer terms: (dist1, dist2), the
    per-point squared NN distances of x in y (B, P1) and of y in x
    (B, P2)."""
    d1, _ = nn_sqdist(x, y)
    d2, _ = nn_sqdist(y, x)
    return d1, d2


def fscore(dist1: torch.Tensor, dist2: torch.Tensor, threshold: float = 1e-4):
    """F-score at a squared-distance threshold; NaN (both precisions zero)
    maps to 0.  Returns (f1, precision1, precision2), each (B,)."""
    p1 = (dist1 < threshold).to(torch.float32).mean(dim=1)
    p2 = (dist2 < threshold).to(torch.float32).mean(dim=1)
    denom = p1 + p2
    safe = torch.where(denom > 0, denom, torch.ones_like(denom))
    f = torch.where(denom > 0, 2.0 * p1 * p2 / safe, torch.zeros_like(denom))
    return f, p1, p2


@profiling.spanned("pdr.loss.chamfer", device=True)
def calc_cd(output: torch.Tensor, gt: torch.Tensor, calc_f1: bool = False,
            f1_threshold: float = 1e-4):
    """Per-sample (cd_p, cd_t[, f1]).  The chamfer terms are taken as
    chamfer_distance(gt, output), so dist1 is gt->output and dist2
    output->gt; cd_p averages the square-root distances and halves, cd_t
    sums the mean squared distances."""
    dist1, dist2 = chamfer_distance(gt, output)
    cd_p = (torch.sqrt(dist1).mean(dim=1) + torch.sqrt(dist2).mean(dim=1)) / 2.0
    cd_t = dist1.mean(dim=1) + dist2.mean(dim=1)
    if calc_f1:
        f1, _, _ = fscore(dist1, dist2, threshold=f1_threshold)
        return cd_p, cd_t, f1
    return cd_p, cd_t
