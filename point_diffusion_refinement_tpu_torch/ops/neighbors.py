"""Neighbourhood queries: ball query and k nearest neighbours.

Counterpart of the JAX package's ``ops/neighbors.py``.  ``ball_query``,
``knn``, ``ball_query_group`` (ball query + gather of float32 table rows,
the counterpart of ``ops/pallas_neighbors.py::ball_query_group_pallas``) and
``knn_group`` (kNN + gather + position channels, the counterpart of
``ops/pallas_window.py::windowed_knn_group``) launch the CUDA kernels
``csrc/ball_query.cu``, ``csrc/knn.cu``, ``csrc/ball_query_group.cu`` and
``csrc/knn_group.cu`` on GPU tensors; their plain PyTorch versions
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

from typing import Optional, Tuple, Union

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


# centres each warp of the fused ball query + gather takes in turn.  A block
# stages its support row once for all of its warps' centres, which pays
# where the support is large: the most of 1, 2, 4, 8 that leaves at least
# GATHER_POINTS_A_CENTRE support points a centre and still gives a grid of
# GATHER_MIN_BLOCKS blocks of 8 warps.  On an H100 (80GB HBM3, 700 W) that
# is the fastest choice, or within 1%, at every shape of a B = 32 DDPM
# training step and at the level-0 feature transfer at B = 4: 2 there, 8 at
# B = 32 (support 3072), 2 at a 1024-point support, 1 at 256 and below,
# where more centres a warp ran up to 5x slower (chip_smoke.py's phase 10
# times each at the feature transfer).
GATHER_POINTS_A_CENTRE = 384
GATHER_MIN_BLOCKS = 512
GATHER_WARPS = 8


def gather_queries_per_warp(B: int, M: int, N: int) -> int:
    """Centres a warp of ``ball_query_group``'s kernel takes, for B x M
    centres over a support of N points."""
    qpw = 1
    while (qpw < 8 and N >= GATHER_POINTS_A_CENTRE * 2 * qpw
           and B * -(-M // (GATHER_WARPS * 2 * qpw)) >= GATHER_MIN_BLOCKS):
        qpw *= 2
    return qpw


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
    ball; any nsample >= 1, nsample > N included).  xyz (B, N, 3), new_xyz
    (B, M, 3), table (B, N, C) float32.  The gathered rows are exact (the
    TPU kernel keeps ~16 mantissa bits)."""
    if kernels.use_plain(xyz):
        return ball_query_group_plain(xyz, new_xyz, table, radius, nsample)
    xyz, new_xyz, table = kernels.as_f32(xyz), kernels.as_f32(new_xyz), kernels.as_f32(table)
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    C = table.shape[-1]
    kernels.check(xyz, "ball_query_group xyz", torch.float32, (None, None, 3))
    kernels.check(new_xyz, "ball_query_group new_xyz", torch.float32, (B, None, 3))
    kernels.check(table, "ball_query_group table", torch.float32, (B, N, None))
    if nsample < 1:
        raise ValueError(f"ball_query_group needs nsample >= 1, got {nsample}")
    if C < 1:
        raise ValueError("ball_query_group: the table needs at least one channel")
    gathered = torch.empty((B, M, nsample, C), dtype=torch.float32, device=xyz.device)
    idx = torch.empty((B, M, nsample), dtype=torch.int32, device=xyz.device)
    counts = torch.empty((B, M), dtype=torch.int32, device=xyz.device)
    if M > 0:
        _gather_launch(xyz, new_xyz, table, radius, gathered, idx, counts,
                       gather_queries_per_warp(B, M, N))
    return gathered, idx, counts


def _gather_launch(xyz, new_xyz, table, radius, gathered, idx, counts,
                   queries_per_warp: int) -> None:
    """One launch of ``csrc/ball_query_group.cu`` on checked tensors."""
    B, N, _ = xyz.shape
    M, nsample, C = gathered.shape[1:]
    kernels.launch(
        "ball_query_group", xyz.data_ptr(), new_xyz.data_ptr(), table.data_ptr(),
        B, N, M, nsample, C, _radius_sq(radius), queries_per_warp, gathered.data_ptr(),
        idx.data_ptr(), counts.data_ptr(),
    )


# lanes a query of the kNN kernel: enough that B * M * lanes reaches this
# many threads, up to 8.  At the level-0 feature propagation of a B=4
# denoise step (8192 queries) 8 lanes ran fastest; at B=32 (65536 queries)
# one lane, since every lane pays its own insertions (chip_smoke.py's phase
# 2 times each lane count at both).
KNN_THREADS = 65536
KNN_MAX_LANES = 8


def knn_lanes(queries: int) -> int:
    """Lanes a query for ``queries`` = B * M queries: 1, 2, 4 or 8."""
    lanes = 1
    while lanes < KNN_MAX_LANES and queries * lanes < KNN_THREADS:
        lanes *= 2
    return lanes


def knn_plain(
    query: torch.Tensor, points: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``knn``: a stable sort of the distance matrix."""
    d = pairwise_sqdist(query, points)
    dist, idx = torch.sort(d, dim=-1, stable=True)
    return dist[..., :k].contiguous(), idx[..., :k].to(torch.int32)


def _knn_launch(query: torch.Tensor, points: torch.Tensor, k: int,
                lanes: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/knn.cu`` with ``lanes`` lanes a query (by default
    ``knn_lanes(B * M)``)."""
    query, points = kernels.as_f32(query), kernels.as_f32(points)
    B, M, _ = query.shape
    N = points.shape[1]
    kernels.check(query, "knn query", torch.float32, (None, None, 3))
    kernels.check(points, "knn points", torch.float32, (B, None, 3))
    if not 1 <= k <= N:
        raise ValueError(f"knn needs 1 <= k <= N, got k={k}, N={N}")
    lanes = knn_lanes(B * M) if lanes is None else lanes
    if lanes not in (1, 2, 4, 8):
        raise ValueError(f"knn kernel takes 1, 2, 4 or 8 lanes a query, got {lanes}")
    dist = torch.empty((B, M, k), dtype=torch.float32, device=query.device)
    idx = torch.empty((B, M, k), dtype=torch.int32, device=query.device)
    if M > 0:
        kernels.launch(
            "knn", query.data_ptr(), points.data_ptr(), B, M, N, k, lanes,
            dist.data_ptr(), idx.data_ptr(),
        )
    return dist, idx


def knn(
    query: torch.Tensor, points: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest neighbours: dists (B, M, k) squared, ascending, and idx
    (B, M, k) int32, ties to the lowest index.  Any 1 <= k <= N."""
    if kernels.use_plain(query):
        return knn_plain(query, points, k)
    return _knn_launch(query, points, k)


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
    propagation in one kernel (the counterpart of
    ``ops/pallas_window.py::windowed_knn_group`` and its layout twin
    ``windowed_knn_group_t``), in the queries' own order.

    query (B, M, 3), points (B, N, 3), table (B, N, C) -> (B, M, k, C + 11)
    bf16: [table rows (rounded to bf16), squared distance, w_j =
    (1 / (d_j + 1e-8)) / sum_i 1 / (d_i + 1e-8), neighbour xyz, neighbour -
    query, query xyz].  Neighbours as ``knn`` gives them (ascending, ties to
    the lowest index), any 1 <= k <= N; positions come from the float32
    support, so they may differ from the TPU kernel's hi/lo bf16
    reconstruction by one bf16 ulp.  The kernel shares ``knn``'s selection
    and its lanes-a-query rule (``knn_lanes``)."""
    if kernels.use_plain(query):
        return knn_group_plain(query, points, table, k)
    query, points = kernels.as_f32(query), kernels.as_f32(points)
    table = table.to(torch.bfloat16).contiguous()
    B, M, _ = query.shape
    N, C = points.shape[1], table.shape[-1]
    kernels.check(query, "knn_group query", torch.float32, (None, None, 3))
    kernels.check(points, "knn_group points", torch.float32, (B, None, 3))
    kernels.check(table, "knn_group table", torch.bfloat16, (B, N, None))
    if not 1 <= k <= N:
        raise ValueError(f"knn_group needs 1 <= k <= N, got k={k}, N={N}")
    if C < 1:
        raise ValueError("knn_group: the table needs at least one channel")
    out = torch.empty((B, M, k, C + 11), dtype=torch.bfloat16, device=query.device)
    if M > 0:
        # the selection's (distance, index) pairs, scratch of the kernel
        dist = torch.empty((B, M, k), dtype=torch.float32, device=query.device)
        idx = torch.empty((B, M, k), dtype=torch.int32, device=query.device)
        kernels.launch(
            "knn_group", query.data_ptr(), points.data_ptr(), table.data_ptr(), B, M, N, C,
            k, knn_lanes(B * M), dist.data_ptr(), idx.data_ptr(), out.data_ptr(),
        )
    return out


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
