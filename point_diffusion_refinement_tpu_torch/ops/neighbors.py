"""Neighbourhood queries: ball query and k nearest neighbours.

Counterpart of the JAX package's ``ops/neighbors.py``.  ``ball_query``,
``knn`` and ``ball_query_group`` (ball query + gather of float32 table rows,
the counterpart of ``ops/pallas_neighbors.py::ball_query_group_pallas``)
launch the CUDA kernels ``csrc/ball_query.cu``, ``csrc/knn.cu`` and
``csrc/ball_query_group.cu`` on GPU tensors; their plain PyTorch versions
(``*_plain``) run for CPU tensors and serve as the reference the kernels are
held against.

Reference semantics:
  * ball query: for each centre, the first <= nsample points with
    d^2 < r^2 in index order; slots past the count repeat the first
    neighbour; an empty ball keeps index 0; counts are capped at nsample;
    nsample may exceed N.
  * kNN: the k nearest squared distances ascending, ties to the lowest
    index.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from . import kernels
from .sampling import group_points


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distance matrix (..., M, 3) x (..., N, 3) -> (..., M, N) in the
    exact per-coordinate form (dx*dx + dy*dy) + dz*dz, never the matmul
    identity, whose cancellation noise moves radius boundaries."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    d = None
    for c in range(a.shape[-1]):
        diff = a[..., :, None, c] - b[..., None, :, c]
        d = diff * diff if d is None else d + diff * diff
    return d


def _radius_sq(radius: float) -> float:
    """r^2 rounded to float32 once, as the JAX reference compares it."""
    return float(torch.tensor(radius * radius, dtype=torch.float32))


def ball_query_plain(
    xyz: torch.Tensor, new_xyz: torch.Tensor, radius: float, nsample: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``ball_query``: a distance matrix and a top-k over a
    key that ranks in-radius points by ascending index."""
    N = xyz.shape[1]
    d = pairwise_sqdist(new_xyz, xyz)  # (B, M, N)
    mask = d < _radius_sq(radius)
    pos = torch.arange(N, device=xyz.device, dtype=torch.int64)
    key = torch.where(mask, 2 * N - pos, torch.zeros_like(pos))
    k_eff = min(nsample, N)
    topi = torch.topk(key, k_eff, dim=-1, sorted=True).indices
    if k_eff < nsample:
        pad = topi[..., :1].expand(*topi.shape[:-1], nsample - k_eff)
        topi = torch.cat([topi, pad], dim=-1)
    counts = mask.sum(-1).clamp(max=nsample).to(torch.int32)
    slot = torch.arange(nsample, device=xyz.device)
    first = topi[..., :1]
    idx = torch.where(slot < counts[..., None], topi, first)
    idx = torch.where(counts[..., None] > 0, idx, torch.zeros_like(idx))
    return idx.to(torch.int32), counts


def ball_query(
    xyz: torch.Tensor, new_xyz: torch.Tensor, radius: float, nsample: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """idx (B, M, nsample) int32, counts (B, M) int32 of the first <= nsample
    in-radius points.  xyz (B, N, 3), new_xyz (B, M, 3) float32."""
    if kernels.use_plain(xyz):
        return ball_query_plain(xyz, new_xyz, radius, nsample)
    xyz, new_xyz = kernels.as_f32(xyz), kernels.as_f32(new_xyz)
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    kernels.check(xyz, "ball_query xyz", torch.float32, (None, None, 3))
    kernels.check(new_xyz, "ball_query new_xyz", torch.float32, (B, None, 3))
    idx = torch.empty((B, M, nsample), dtype=torch.int32, device=xyz.device)
    counts = torch.empty((B, M), dtype=torch.int32, device=xyz.device)
    kernels.launch(
        "ball_query", xyz.data_ptr(), new_xyz.data_ptr(), B, N, M, nsample,
        _radius_sq(radius), idx.data_ptr(), counts.data_ptr(),
    )
    return idx, counts


BALL_QUERY_GROUP_MAX_K = 128


def ball_query_group_plain(
    xyz: torch.Tensor, new_xyz: torch.Tensor, table: torch.Tensor, radius: float,
    nsample: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of ``ball_query_group``: ball query, then an indexed
    gather of the table rows."""
    idx, counts = ball_query_plain(xyz, new_xyz, radius, nsample)
    return group_points(table.to(torch.float32), idx), idx, counts


def ball_query_group(
    xyz: torch.Tensor, new_xyz: torch.Tensor, table: torch.Tensor, radius: float,
    nsample: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Ball query and gather in one kernel: gathered (B, M, nsample, C)
    float32 = table[idx], idx (B, M, nsample) int32 and counts (B, M) int32
    as ``ball_query`` gives them (repeat-first padding, row 0 for an empty
    ball).  xyz (B, N, 3), new_xyz (B, M, 3), table (B, N, C) float32.  The
    gathered rows are exact (the TPU kernel keeps ~16 mantissa bits)."""
    if kernels.use_plain(xyz):
        return ball_query_group_plain(xyz, new_xyz, table, radius, nsample)
    xyz, new_xyz, table = kernels.as_f32(xyz), kernels.as_f32(new_xyz), kernels.as_f32(table)
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    C = table.shape[-1]
    kernels.check(xyz, "ball_query_group xyz", torch.float32, (None, None, 3))
    kernels.check(new_xyz, "ball_query_group new_xyz", torch.float32, (B, None, 3))
    kernels.check(table, "ball_query_group table", torch.float32, (B, N, None))
    if not 1 <= nsample <= BALL_QUERY_GROUP_MAX_K:
        raise ValueError(
            f"ball_query_group kernel needs 1 <= nsample <= {BALL_QUERY_GROUP_MAX_K}")
    if C < 1:
        raise ValueError("ball_query_group: the table needs at least one channel")
    gathered = torch.empty((B, M, nsample, C), dtype=torch.float32, device=xyz.device)
    idx = torch.empty((B, M, nsample), dtype=torch.int32, device=xyz.device)
    counts = torch.empty((B, M), dtype=torch.int32, device=xyz.device)
    kernels.launch(
        "ball_query_group", xyz.data_ptr(), new_xyz.data_ptr(), table.data_ptr(),
        B, N, M, nsample, C, _radius_sq(radius), gathered.data_ptr(), idx.data_ptr(),
        counts.data_ptr(),
    )
    return gathered, idx, counts


KNN_MAX_K = 16


def knn_plain(
    query: torch.Tensor, points: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``knn``: a stable sort of the distance matrix."""
    d = pairwise_sqdist(query, points)
    dist, idx = torch.sort(d, dim=-1, stable=True)
    return dist[..., :k].contiguous(), idx[..., :k].to(torch.int32)


def knn(
    query: torch.Tensor, points: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest neighbours: dists (B, M, k) squared, ascending, and idx
    (B, M, k) int32.  Callers pass k <= N."""
    if kernels.use_plain(query):
        return knn_plain(query, points, k)
    query, points = kernels.as_f32(query), kernels.as_f32(points)
    B, M, _ = query.shape
    N = points.shape[1]
    kernels.check(query, "knn query", torch.float32, (None, None, 3))
    kernels.check(points, "knn points", torch.float32, (B, None, 3))
    if not 1 <= k <= min(N, KNN_MAX_K):
        raise ValueError(f"knn kernel needs 1 <= k <= min(N, {KNN_MAX_K}), got k={k}, N={N}")
    dist = torch.empty((B, M, k), dtype=torch.float32, device=query.device)
    idx = torch.empty((B, M, k), dtype=torch.int32, device=query.device)
    kernels.launch(
        "knn", query.data_ptr(), points.data_ptr(), B, M, N, k,
        dist.data_ptr(), idx.data_ptr(),
    )
    return dist, idx


def count_to_mask(counts: torch.Tensor, k: int) -> torch.Tensor:
    """(B, M) counts -> (B, M, k) boolean validity mask."""
    slot = torch.arange(k, device=counts.device, dtype=counts.dtype)
    return slot < counts[..., None]


def masked_mean(
    feature: torch.Tensor, counts: Union[torch.Tensor, str], axis: int = -2
) -> torch.Tensor:
    """Average over the neighbour axis honouring per-centre counts (clamped to
    >= 1, padded slots zeroed); ``counts == 'all'`` means every slot."""
    k = feature.shape[axis]
    if isinstance(counts, str) and counts == "all":
        return feature.mean(dim=axis)
    c = counts.clamp(min=1)
    mask = count_to_mask(c, k)[..., None].to(feature.dtype)
    s = (feature * mask).sum(dim=axis)
    return s / c[..., None].to(feature.dtype)
