"""Furthest point sampling and index gathers.

Counterpart of the JAX package's ``ops/sampling.py``.
``furthest_point_sample_and_gather`` launches the CUDA kernel
``csrc/fps.cu`` on GPU tensors; its plain PyTorch version runs for CPU
tensors and is the reference the kernel is held against.  Gathers are plain
indexed loads (the TPU's one-hot matmul gathers and their hi/lo bf16 splits
stay behind).

Quirks reproduced exactly:
  * the first selected index is always 0;
  * points with squared norm <= 1e-3 are padding and never selected;
  * each pick maximises the running minimum squared distance to the
    selected set, ties going to the lowest index.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import kernels

PAD_NORM_SQ = 1e-3
# the kernel keeps x, y, z and the running min distance of a row in shared
# memory: 16 bytes a point within the 227 KB a block may use
FPS_MAX_POINTS = 12288


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) x (B, M) -> (B, M, C)."""
    B = points.shape[0]
    bi = torch.arange(B, device=points.device)[:, None]
    return points[bi, idx.long()]


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) x (B, M, K) -> (B, M, K, C)."""
    B = points.shape[0]
    bi = torch.arange(B, device=points.device)[:, None, None]
    return points[bi, idx.long()]


def furthest_point_sample_plain(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Plain version of the FPS selection: (B, N, 3) -> (B, npoint) int32."""
    x = xyz.to(torch.float32)
    B, N, _ = x.shape
    norm = x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1] + x[..., 2] * x[..., 2]
    valid = norm > PAD_NORM_SQ
    # padding points carry -1: a min with a distance >= 0 keeps them out
    mind = torch.where(
        valid, torch.full_like(norm, 1e10), torch.full_like(norm, -1.0)
    )
    idx = torch.zeros((B, npoint), dtype=torch.int64, device=x.device)
    bi = torch.arange(B, device=x.device)
    old = torch.zeros((B,), dtype=torch.int64, device=x.device)
    for j in range(1, npoint):
        sel = x[bi, old]  # (B, 3)
        dx = x[..., 0] - sel[:, None, 0]
        dy = x[..., 1] - sel[:, None, 1]
        dz = x[..., 2] - sel[:, None, 2]
        d = dx * dx + dy * dy + dz * dz
        mind = torch.minimum(mind, d)
        old = torch.argmax(mind, dim=1)  # first maximal index
        idx[:, j] = old
    return idx.to(torch.int32)


def furthest_point_sample_and_gather_plain(
    xyz: torch.Tensor, npoint: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    idx = furthest_point_sample_plain(xyz, npoint)
    return idx, gather_points(xyz.to(torch.float32), idx)


def furthest_point_sample_and_gather(
    xyz: torch.Tensor, npoint: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """FPS and the selected positions: (B, N, 3) float32 ->
    (idx (B, npoint) int32, new_xyz (B, npoint, 3) float32, bit-exact)."""
    if kernels.use_plain(xyz):
        return furthest_point_sample_and_gather_plain(xyz, npoint)
    xyz = kernels.as_f32(xyz)
    B, N, _ = xyz.shape
    kernels.check(xyz, "fps xyz", torch.float32, (None, None, 3))
    if N > FPS_MAX_POINTS:
        raise ValueError(f"fps kernel takes at most {FPS_MAX_POINTS} points, got {N}")
    idx = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    coords = torch.empty((B, npoint, 3), dtype=torch.float32, device=xyz.device)
    kernels.launch("fps", xyz.data_ptr(), B, N, npoint, idx.data_ptr(), coords.data_ptr())
    return idx, coords


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """FPS indices (B, npoint) int32."""
    return furthest_point_sample_and_gather(xyz, npoint)[0]
