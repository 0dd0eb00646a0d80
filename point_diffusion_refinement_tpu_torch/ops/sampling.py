"""Furthest point sampling and index gathers.

Counterpart of the JAX package's ``ops/sampling.py``.  On GPU tensors
``furthest_point_sample`` launches the idx-only kernel and
``furthest_point_sample_and_gather`` the kernel that also emits the picked
coordinates, both in ``csrc/fps.cu``; their plain PyTorch version
(``furthest_point_sample_plain``) runs for CPU tensors and is the reference
the kernels are held against.  Gathers are plain indexed loads (the TPU's
one-hot matmul gathers and their hi/lo bf16 splits stay behind).

Quirks reproduced exactly:
  * the first selected index is always 0;
  * points with squared norm <= 1e-3 are padding and never selected;
  * each pick maximises the running minimum squared distance to the
    selected set, ties going to the lowest index.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import kernels

PAD_NORM_SQ = 1e-3
# the kernel keeps a row's points and running minima in registers and an
# (x, y, z, 0) copy of the row in shared memory up to this many points (16
# bytes a point within the 227 KB a block may use), and all of them in a
# global-memory workspace beyond it
FPS_SMEM_MAX_POINTS = 12288
# (threads, points a thread) of the register path that csrc/fps.cu builds,
# in the order of its list: the choices of FPS_BLOCKS, then the runners-up
# that chip_smoke.py times beside them
FPS_CONFIGS = (
    (256, 4), (256, 8), (512, 6), (256, 16), (256, 24), (256, 32), (256, 48),
    (128, 16), (512, 4), (256, 12), (128, 32), (512, 24),
)
# the wrapper's choice by N, (largest N, threads, points a thread): the
# fastest pair at each N of a sweep on an H100 (chip_smoke.py phase 2, PERF.md)
FPS_BLOCKS = (
    (1024, 256, 4), (2048, 256, 8), (3072, 512, 6), (4096, 256, 16),
    (6144, 256, 24), (8192, 256, 32), (FPS_SMEM_MAX_POINTS, 256, 48),
)
# the largest row the JAX package's TPU dispatcher serves
FPS_MAX_POINTS = 2 ** 18


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


def fps_block_config(n: int) -> Tuple[int, int]:
    """(threads, points a thread) of the FPS kernel's register path for a
    row of ``n`` points, 1 <= n <= FPS_SMEM_MAX_POINTS."""
    for max_n, threads, per in FPS_BLOCKS:
        if n <= max_n:
            return threads, per
    raise ValueError(f"rows of more than {FPS_SMEM_MAX_POINTS} points take the workspace path")


def _fps_launch(xyz: torch.Tensor, npoint: int, coords: bool,
                config: Optional[Tuple[int, int]] = None):
    """Launch ``fps`` (with coordinates) or ``fps_idx`` on a CUDA tensor;
    ``config`` overrides ``fps_block_config`` (one of FPS_CONFIGS covering N)
    for a row in shared memory."""
    xyz = kernels.as_f32(xyz)
    B, N, _ = xyz.shape
    kernels.check(xyz, "fps xyz", torch.float32, (None, None, 3))
    if N > FPS_MAX_POINTS:
        raise ValueError(f"fps kernel takes at most {FPS_MAX_POINTS} points, got {N}")
    work = None
    threads = per = 0
    if N > FPS_SMEM_MAX_POINTS:
        work = torch.empty((B, 4, N), dtype=torch.float32, device=xyz.device)
    else:
        threads, per = config or fps_block_config(N)
        if (threads, per) not in FPS_CONFIGS or threads * per < N:
            raise ValueError(f"fps kernel has no block of {threads} x {per} for {N} points")
    work_ptr = 0 if work is None else work.data_ptr()
    idx = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    if not coords:
        kernels.launch("fps_idx", xyz.data_ptr(), B, N, npoint, idx.data_ptr(), work_ptr,
                       threads, per)
        return idx, None
    co = torch.empty((B, npoint, 3), dtype=torch.float32, device=xyz.device)
    kernels.launch("fps", xyz.data_ptr(), B, N, npoint, idx.data_ptr(), co.data_ptr(),
                   work_ptr, threads, per)
    return idx, co


def furthest_point_sample_and_gather(
    xyz: torch.Tensor, npoint: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """FPS and the selected positions: (B, N, 3) float32 ->
    (idx (B, npoint) int32, new_xyz (B, npoint, 3) float32, bit-exact)."""
    if kernels.use_plain(xyz):
        return furthest_point_sample_and_gather_plain(xyz, npoint)
    return _fps_launch(xyz, npoint, coords=True)


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """FPS indices (B, npoint) int32, from the idx-only kernel on GPU
    tensors (N up to 2^18)."""
    if kernels.use_plain(xyz):
        return furthest_point_sample_plain(xyz, npoint)
    return _fps_launch(xyz, npoint, coords=False)[0]
