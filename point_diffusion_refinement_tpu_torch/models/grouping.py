"""Grouping feature assembly: QueryAndGroup and group_knn, channels-last.

Counterpart of the JAX package's ``models/grouping.py``.  Pure functions;
variable neighbour counts ride as a (B, M) count tensor plus repeat-first /
zero-feature padding.  ``fused_ball_gather`` is the differentiable ball
query + gather in one kernel (the counterpart of ``_fused_ball_gather``
there), which ``query_and_group(fused_gather=True)`` takes for radius
neighbourhoods; it is off by default, as in the JAX package.  Each
grouping runs in the span ``pdr.net.group`` (``utils/profiling.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from ..ops.neighbors import ball_query, ball_query_group, knn, knn_group
from ..ops.sampling import group_points
from ..ops.scatter import group_scatter_add
from ..utils import profiling

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


class _FusedBallGather(torch.autograd.Function):
    """``ball_query_group`` with the scatter-add of the gathered cotangent as
    its backward.  Differentiable in ``table`` only: the neighbour selection
    carries no gradient."""

    @staticmethod
    def forward(ctx, xyz, new_xyz, table, radius, nsample):
        gathered, idx, counts = ball_query_group(xyz, new_xyz, table, radius, nsample)
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[1]
        ctx.table_dtype = table.dtype
        ctx.mark_non_differentiable(idx, counts)
        return gathered, idx, counts

    @staticmethod
    def backward(ctx, d_gathered, _d_idx, _d_counts):
        (idx,) = ctx.saved_tensors
        d_table = group_scatter_add(d_gathered, idx, ctx.n_rows).to(ctx.table_dtype)
        return None, None, d_table, None, None


@profiling.spanned("pdr.net.group", device=True)
def fused_ball_gather(xyz: torch.Tensor, new_xyz: torch.Tensor, table: torch.Tensor,
                      radius: float, nsample: int):
    """Ball query + gather of table rows as one kernel: equivalent to
    ``idx, counts = ball_query(...); g = group_points(table, idx)``.  Returns
    (gathered (B, M, nsample, C) float32, idx, counts); gradients flow to
    ``table`` through a float32 scatter-add."""
    return _FusedBallGather.apply(xyz, new_xyz, table, float(radius), int(nsample))


@profiling.spanned("pdr.net.group", device=True)
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
    fused_gather: bool = False,
) -> Grouped:
    """Ball-query or kNN grouping with positional channels, in the channel
    order [features, relative_xyz, abs_xyz?, center_xyz?].  With subset=False
    and radius neighbours, centres with empty balls substitute themselves as
    the neighbour with zero features.  ``fused_gather`` routes a radius
    grouping through ``fused_ball_gather`` on the table [xyz, features]
    (float32), with the same values as the unfused route.

    Args:
      xyz: (B, N, 3) support points; new_xyz: (B, M, 3) centres;
      features: (B, N, C) or None.
    """
    fused = fused_gather and neighbor_def == "radius"
    if fused:
        xyz32 = xyz.to(torch.float32)
        table = (torch.cat([xyz32, features.to(torch.float32)], dim=-1)
                 if features is not None else xyz32)
        gathered, idx, counts_arr = fused_ball_gather(xyz, new_xyz, table, radius, nsample)
        counts: Counts = counts_arr
    elif neighbor_def == "radius":
        idx, counts_arr = ball_query(xyz, new_xyz, radius, nsample)
        counts = counts_arr
    elif neighbor_def == "nn":
        _, idx = knn(new_xyz, xyz, min(nsample, xyz.shape[1]))
        counts = "all"
    else:
        raise ValueError(f"Neighbor definition {neighbor_def} is not supported")

    abs_xyz = gathered[..., :3] if fused else group_points(xyz.to(torch.float32), idx)
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
        grouped_features = gathered[..., 3:] if fused else group_points(features, idx)
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


@profiling.spanned("pdr.net.group", device=True)
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


@profiling.spanned("pdr.net.group", device=True)
def group_knn_features(
    x: torch.Tensor, y: torch.Tensor, features_at_y: torch.Tensor, k: int,
    lossy_features: bool = False, fused: bool = False,
) -> torch.Tensor:
    """kNN gather producing group_knn's (C+11) channels:
    [neighbour feats (C), squared dist (1), inverse-distance weight (1),
    abs neighbour pos (3), relative pos (3), query pos (3)].

    x: (B, N1, 3) queries; y: (B, N2, 3) support; features_at_y: (B, N2, C)
    -> (B, N1, k, C+11), bf16 when ``lossy_features`` (the consumer Dense
    computes in bf16 anyway).  ``fused`` (inference, bf16 output only) does
    the selection, the gather and the packing in one kernel,
    ``ops.knn_group``."""
    if fused:
        if not lossy_features:
            raise ValueError("the fused kNN group emits bf16: it needs lossy_features=True")
        return knn_group(x, y, features_at_y, k)
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
