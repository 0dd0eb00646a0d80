"""Neighbourhood queries: ball query and k nearest neighbours.

Counterpart of the JAX package's ``ops/neighbors.py``: ``ball_query``,
``knn``, ``ball_query_group`` (ball query + gather of float32 table rows)
and ``knn_group`` (kNN + gather + position channels), each its plain
PyTorch version.

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
    return ball_query_plain(xyz, new_xyz, radius, nsample)


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
    """Ball query and gather: gathered (B, M, nsample, C) float32 =
    table[idx], idx (B, M, nsample) int32 and counts (B, M) int32 as
    ``ball_query`` gives them (repeat-first padding, row 0 for an empty
    ball; any nsample >= 1, nsample > N included).  xyz (B, N, 3), new_xyz
    (B, M, 3), table (B, N, C) float32."""
    return ball_query_group_plain(xyz, new_xyz, table, radius, nsample)


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
    (B, M, k) int32, ties to the lowest index.  Any 1 <= k <= N."""
    return knn_plain(query, points, k)


def _pack_knn_group(query, points, table, dist, idx) -> torch.Tensor:
    """[table rows, squared distance, inverse-distance weight, neighbour xyz,
    neighbour - query, query xyz] in bf16, each channel rounded from float32
    once; the weights' denominator is summed in slot order."""
    nn_abs = group_points(points.to(torch.float32), idx)
    rows = group_points(table.to(torch.bfloat16), idx)
    centre = query.to(torch.float32)[:, :, None, :].expand_as(nn_abs)
    recip = 1.0 / (dist + 1e-8)
    wsum = recip[..., 0]
    for j in range(1, recip.shape[-1]):
        wsum = wsum + recip[..., j]
    weight = recip / wsum[..., None]
    parts = [dist[..., None], weight[..., None], nn_abs, nn_abs - centre, centre]
    return torch.cat([rows] + [p.to(torch.bfloat16) for p in parts], dim=-1)


def knn_group_plain(query: torch.Tensor, points: torch.Tensor, table: torch.Tensor,
                    k: int) -> torch.Tensor:
    """Plain version of ``knn_group``: the plain kNN, an indexed gather and
    the channel packing."""
    dist, idx = knn_plain(query, points, k)
    return _pack_knn_group(query, points, table, dist, idx)


def knn_group(query: torch.Tensor, points: torch.Tensor, table: torch.Tensor,
              k: int) -> torch.Tensor:
    """kNN + gather + the 11 distance and position channels of a kNN feature
    propagation, in the queries' own order.

    query (B, M, 3), points (B, N, 3), table (B, N, C) -> (B, M, k, C + 11)
    bf16: [table rows (rounded to bf16), squared distance, w_j =
    (1 / (d_j + 1e-8)) / sum_i 1 / (d_i + 1e-8), neighbour xyz, neighbour -
    query, query xyz].  Neighbours as ``knn`` gives them (ascending, ties to
    the lowest index), any 1 <= k <= N."""
    return knn_group_plain(query, points, table, k)


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
