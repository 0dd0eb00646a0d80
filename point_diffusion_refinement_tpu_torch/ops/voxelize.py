"""Point <-> voxel transfers of the PVCNN2 backbone.

Counterpart of the functional half of the JAX package's ``models/pvcnn.py``
(``normalize_coords``, ``avg_voxelize``, ``trilinear_devoxelize``).  The
JAX package computes these in XLA, not in Pallas: a scatter-mean and eight
corner gathers.  Here the scatter-mean's sums and counts are one
``group_scatter_add`` (the ordered kernel on the card, ``index_add_`` on the
CPU) and the corners are ``gather_points`` (whose backward is the ordered
kernel on the card), so a PVD training step repeats run to run.  Grids are
channels-last, (B, r, r, r, C), with the flat voxel index x * r^2 + y * r + z.
"""

from __future__ import annotations

import torch

from .sampling import gather_points
from .scatter import group_scatter_add


def normalize_coords(coords: torch.Tensor, resolution: int, eps: float = 0.0) -> torch.Tensor:
    """Centre and scale (B, N, 3) coordinates into the grid [0, r - 1]: the
    cloud's mean to the centre, its farthest point to the grid's half
    width.  No gradient flows back to ``coords``."""
    c = coords.detach()
    c = c - c.mean(dim=1, keepdim=True)
    norm = torch.linalg.vector_norm(c, dim=-1, keepdim=True)  # (B, N, 1)
    denom = norm.amax(dim=1, keepdim=True) * 2.0 + eps
    c = c / denom + 0.5
    return torch.clamp(c * resolution, 0.0, resolution - 1)


def voxel_index(norm_coords: torch.Tensor) -> torch.Tensor:
    """The voxel of each normalised point, (B, N, 3) int64: rounded half to
    even, as ``jnp.round`` rounds."""
    return torch.round(norm_coords).to(torch.int64)


def _flat(idx: torch.Tensor, r: int) -> torch.Tensor:
    return idx[..., 0] * (r * r) + idx[..., 1] * r + idx[..., 2]


class _VoxelSums(torch.autograd.Function):
    """The float32 sums of (B, N, C) features in their voxels (B, N) int32
    flat indices, and the point counts: (B, V, C + 1), the count last.
    Differentiable in the features, whose gradient is a gather of the
    sums'."""

    @staticmethod
    def forward(ctx, features, flat, n_voxels):
        B, N, _ = features.shape
        ones = torch.ones((B, N, 1), dtype=torch.float32, device=features.device)
        vals = torch.cat([features.to(torch.float32), ones], dim=-1)
        ctx.save_for_backward(flat)
        ctx.dtype = features.dtype
        return group_scatter_add(vals[:, :, None, :], flat[:, :, None], n_voxels)

    @staticmethod
    def backward(ctx, d_sums):
        (flat,) = ctx.saved_tensors
        return gather_points(d_sums[..., :-1], flat).to(ctx.dtype), None, None


def avg_voxelize(features: torch.Tensor, vox_coords: torch.Tensor, r: int) -> torch.Tensor:
    """Scatter-mean of (B, N, C) features into an r^3 grid by their integer
    voxel coordinates (B, N, 3) in [0, r): (B, r, r, r, C); empty voxels
    hold zeros."""
    B, N, C = features.shape
    flat = _flat(vox_coords.to(torch.int64), r).to(torch.int32)
    sums = _VoxelSums.apply(features, flat, r ** 3)
    out = sums[..., :C] / torch.clamp(sums[..., C:], min=1.0)
    return out.to(features.dtype).reshape(B, r, r, r, C)


def trilinear_devoxelize(voxels: torch.Tensor, norm_coords: torch.Tensor, r: int) -> torch.Tensor:
    """Trilinear interpolation of (B, r, r, r, C) voxel features at
    fractional grid coordinates (B, N, 3) in [0, r - 1]: (B, N, C).  The
    upper corner is clamped to r - 1."""
    B, C = voxels.shape[0], voxels.shape[-1]
    v = voxels.reshape(B, r ** 3, C)
    c0f = torch.floor(norm_coords)
    c0 = c0f.to(torch.int64)
    c1 = torch.clamp(c0 + 1, max=r - 1)
    frac = norm_coords - c0f
    out = 0.0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                ix = c1[..., 0] if dx else c0[..., 0]
                iy = c1[..., 1] if dy else c0[..., 1]
                iz = c1[..., 2] if dz else c0[..., 2]
                w = ((frac[..., 0] if dx else 1 - frac[..., 0])
                     * (frac[..., 1] if dy else 1 - frac[..., 1])
                     * (frac[..., 2] if dz else 1 - frac[..., 2]))
                g = gather_points(v, ix * (r * r) + iy * r + iz)
                out = out + g * w[..., None]
    return out
