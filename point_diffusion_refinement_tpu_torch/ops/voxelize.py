"""Point <-> voxel transfers of the PVCNN2 backbone.

Counterpart of the functional half of the JAX package's ``models/pvcnn.py``
(``normalize_coords``, ``avg_voxelize``, ``trilinear_devoxelize``).  The
JAX package computes these in XLA, not in Pallas, so they are plain PyTorch
here: a scatter-mean by ``index_add_`` and eight corner gathers.  Grids are
channels-last, (B, r, r, r, C), with the flat voxel index x * r^2 + y * r + z.
"""

from __future__ import annotations

import torch


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


def avg_voxelize(features: torch.Tensor, vox_coords: torch.Tensor, r: int) -> torch.Tensor:
    """Scatter-mean of (B, N, C) features into an r^3 grid by their integer
    voxel coordinates (B, N, 3) in [0, r): (B, r, r, r, C); empty voxels
    hold zeros."""
    B, N, C = features.shape
    flat = (_flat(vox_coords.to(torch.int64), r)
            + torch.arange(B, device=features.device)[:, None] * (r ** 3)).reshape(-1)
    sums = features.new_zeros(B * r ** 3, C).index_add_(0, flat, features.reshape(B * N, C))
    cnt = features.new_zeros(B * r ** 3).index_add_(0, flat, features.new_ones(B * N))
    out = sums / torch.clamp(cnt, min=1.0)[:, None]
    return out.reshape(B, r, r, r, C)


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
                flat = ix * (r * r) + iy * r + iz
                g = torch.gather(v, 1, flat[..., None].expand(B, flat.shape[1], C))
                out = out + g * w[..., None]
    return out
