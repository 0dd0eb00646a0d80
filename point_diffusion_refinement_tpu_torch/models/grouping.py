"""Grouping feature assembly: QueryAndGroup and group_knn, channels-last.

Counterpart of the JAX package's ``models/grouping.py``.  Pure functions;
variable neighbour counts ride as a (B, M) count tensor plus repeat-first /
zero-feature padding.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from ..ops.neighbors import ball_query, knn
from ..ops.sampling import group_points

Counts = Union[torch.Tensor, str]  # (B, M) int32, or 'all' for kNN groups


class Grouped(NamedTuple):
    features: torch.Tensor  # (B, M, K, C_total)
    counts: Counts


def grouped_width(in_features: int, use_xyz: bool, include_abs: bool,
                  include_center: bool) -> int:
    """Channel count of ``query_and_group``'s output."""
    pos = 3 + 3 * int(include_abs) + 3 * int(include_center)
    if in_features:
        return in_features + (pos if use_xyz else 0)
    return pos


def query_and_group(
    xyz: torch.Tensor,
    new_xyz: torch.Tensor,
    features: Optional[torch.Tensor],
    *,
    radius: float,
    nsample: int,
    neighbor_def: str = "radius",
    use_xyz: bool = True,
    include_abs_coordinate: bool = False,
    include_center_coordinate: bool = False,
    subset: bool = True,
) -> Grouped:
    """Ball-query or kNN grouping with positional channels, in the channel
    order [features, relative_xyz, abs_xyz?, center_xyz?].  With subset=False
    and radius neighbours, centres with empty balls substitute themselves as
    the neighbour with zero features.

    Args:
      xyz: (B, N, 3) support points; new_xyz: (B, M, 3) centres;
      features: (B, N, C) or None.
    """
    if neighbor_def == "radius":
        idx, counts_arr = ball_query(xyz, new_xyz, radius, nsample)
        counts: Counts = counts_arr
    elif neighbor_def == "nn":
        _, idx = knn(new_xyz, xyz, min(nsample, xyz.shape[1]))
        counts = "all"
    else:
        raise ValueError(f"Neighbor definition {neighbor_def} is not supported")

    abs_xyz = group_points(xyz.to(torch.float32), idx)
    center = new_xyz.to(torch.float32)[:, :, None, :]
    substitute = (not subset) and neighbor_def == "radius"
    if substitute:
        have = (counts_arr > 0).to(abs_xyz.dtype)[..., None, None]
        abs_xyz = have * abs_xyz + (1.0 - have) * center
    relative = abs_xyz - center

    grouped_xyz = relative
    if include_abs_coordinate:
        grouped_xyz = torch.cat([relative, abs_xyz], dim=-1)
    if include_center_coordinate:
        grouped_xyz = torch.cat([grouped_xyz, center.expand_as(abs_xyz)], dim=-1)

    if features is not None:
        grouped_features = group_points(features, idx)
        if substitute:
            grouped_features = have.to(grouped_features.dtype) * grouped_features
        if not use_xyz:
            return Grouped(grouped_features, counts)
        dt = torch.promote_types(grouped_features.dtype, grouped_xyz.dtype)
        return Grouped(
            torch.cat([grouped_features.to(dt), grouped_xyz.to(dt)], dim=-1), counts
        )
    assert use_xyz, "Cannot have no features and not use xyz as a feature!"
    return Grouped(grouped_xyz, counts)


def group_all(
    xyz: torch.Tensor, features: Optional[torch.Tensor], use_xyz: bool = True
) -> Grouped:
    """Group every point into one group: (B, 1, N, C [+3])."""
    grouped_xyz = xyz[:, None, :, :]
    if features is not None:
        grouped = features[:, None, :, :]
        if use_xyz:
            grouped = torch.cat([grouped, grouped_xyz.to(grouped.dtype)], dim=-1)
    else:
        grouped = grouped_xyz
    return Grouped(grouped, "all")


def group_knn_features(
    x: torch.Tensor, y: torch.Tensor, features_at_y: torch.Tensor, k: int,
    lossy_features: bool = False,
) -> torch.Tensor:
    """kNN gather producing group_knn's (C+11) channels:
    [neighbour feats (C), squared dist (1), inverse-distance weight (1),
    abs neighbour pos (3), relative pos (3), query pos (3)].

    x: (B, N1, 3) queries; y: (B, N2, 3) support; features_at_y: (B, N2, C)
    -> (B, N1, k, C+11), bf16 when ``lossy_features`` (the consumer Dense
    computes in bf16 anyway)."""
    dist, idx = knn(x, y, k)
    nn_abs = group_points(y.to(torch.float32), idx)
    neigh_feats = group_points(features_at_y, idx)
    x_rep = x.to(torch.float32)[:, :, None, :].expand_as(nn_abs)
    nn_rel = nn_abs - x_rep
    d = dist[..., None]
    recip = 1.0 / (d + 1e-8)
    weight = recip / recip.sum(dim=-2, keepdim=True)
    parts = [neigh_feats, d, weight, nn_abs, nn_rel, x_rep]
    if lossy_features:
        parts = [p.to(torch.bfloat16) for p in parts]
    else:
        dt = torch.promote_types(neigh_feats.dtype, torch.float32)
        parts = [p.to(dt) for p in parts]
    return torch.cat(parts, dim=-1)
