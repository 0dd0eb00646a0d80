"""Fused ball query + gather of feature tables with position channels.

Counterpart of the JAX package's ``ops/pallas_window.py``
(``windowed_ball_group_t`` and its lane-major twin ``windowed_ball_group``):
the same function without the TPU windowing.  There is no support or query
sort, so the output is in original query order and the JAX package's
``build_query_ctx``/``sort_rows``/``unsort_rows`` have no counterpart.
``ball_group`` launches ``csrc/ball_group.cu`` on GPU tensors; its plain
PyTorch version runs for CPU tensors.  ``ball_group_train`` is its
differentiable form for the training step, the counterpart of
``ops/windowed_grad.py::windowed_group_train``: the backward scatters the
grouped cotangent by the neighbour indices (``ops/scatter.py``).  ``idx``
has one contract everywhere: original support indices, padded as the ball
query pads them (repeat-first, zeros for an empty ball).

Per table the grouped channels are ``[features, rel, abs, center?]`` in
bfloat16, where ``abs`` is the neighbour's float32 position rounded once
and ``rel = abs - query`` is rounded from float32.  (The TPU kernel first
rebuilds positions from hi/lo bf16 halves, ~16 mantissa bits, so its
position channels can differ from these by one bf16 ulp; feature channels
agree exactly.)
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple, Union

import torch

from . import kernels
from .neighbors import _radius_sq, ball_query_plain
from .sampling import group_points
from .scatter import group_scatter_add, group_scatter_add_pair

EMPTY_MODES = {"center_zero": 0, "row0": 1}
# queries each warp of the kernel takes in turn (its block stages the support
# once for 8 warps x this many queries; chip_smoke.py's phase 2 times 1, 2
# and 4 at the level-0 feature transfer, where 2 is the fastest)
BALL_GROUP_QUERIES_PER_WARP = 2


def ball_group_plain(
    support: torch.Tensor,
    tables: Sequence[torch.Tensor],
    queries: torch.Tensor,
    radius: float,
    nsample: int,
    include_center: bool = False,
    empty_mode: str = "center_zero",
    return_idx: bool = False,
) -> Union[Tuple[List[torch.Tensor], torch.Tensor],
           Tuple[List[torch.Tensor], torch.Tensor, torch.Tensor]]:
    """Plain version of ``ball_group``: ball query, then indexed gathers.
    Rows are gathered before the bfloat16 cast (same values either way), so
    that autograd through this version sums cotangents in the table's own
    dtype: with float32 tables it is the reference of ``ball_group_train``'s
    backward."""
    if empty_mode not in EMPTY_MODES:
        raise ValueError(f"unknown empty_mode {empty_mode!r}")
    idx, counts = ball_query_plain(support, queries, radius, nsample)
    have = (counts > 0)[..., None, None]  # (B, M, 1, 1)
    absx = group_points(support.to(torch.float32), idx)  # (B, M, K, 3)
    center = queries.to(torch.float32)[:, :, None, :].expand_as(absx)
    if empty_mode == "center_zero":
        absx = torch.where(have, absx, center)
    pos = [(absx - center).to(torch.bfloat16), absx.to(torch.bfloat16)]
    if include_center:
        pos.append(center.to(torch.bfloat16))
    outs = []
    for t in tables:
        f = group_points(t, idx).to(torch.bfloat16)
        if empty_mode == "center_zero":
            f = torch.where(have, f, torch.zeros_like(f))
        outs.append(torch.cat([f] + pos, dim=-1))
    return (outs, counts, idx) if return_idx else (outs, counts)


def ball_group(
    support: torch.Tensor,
    tables: Sequence[torch.Tensor],
    queries: torch.Tensor,
    radius: float,
    nsample: int,
    include_center: bool = False,
    empty_mode: str = "center_zero",
    return_idx: bool = False,
) -> Union[Tuple[List[torch.Tensor], torch.Tensor],
           Tuple[List[torch.Tensor], torch.Tensor, torch.Tensor]]:
    """Group one or two feature tables around each query.

    Args:
      support: (B, N, 3) float32 support positions.
      tables: one or two (B, N, Ci) feature tables (cast to bfloat16).
      queries: (B, M, 3) float32 query positions.
      empty_mode: "center_zero" (zero features, abs = query) or "row0"
        (support row 0) for an empty ball.

    Returns:
      ([(B, M, nsample, Ci + 6|9) bfloat16 per table], counts (B, M) int32),
      in original query order; with ``return_idx`` also idx (B, M, nsample)
      int32, the neighbours' original support indices, from the same launch.
    """
    if kernels.use_plain(support):
        return ball_group_plain(
            support, tables, queries, radius, nsample, include_center, empty_mode,
            return_idx,
        )
    if empty_mode not in EMPTY_MODES:
        raise ValueError(f"unknown empty_mode {empty_mode!r}")
    if not 1 <= len(tables) <= 2:
        raise ValueError(f"ball_group takes one or two tables, got {len(tables)}")
    if nsample < 1:
        raise ValueError(f"ball_group needs nsample >= 1, got {nsample}")
    support, queries = kernels.as_f32(support), kernels.as_f32(queries)
    B, N, _ = support.shape
    M = queries.shape[1]
    kernels.check(support, "ball_group support", torch.float32, (None, None, 3))
    kernels.check(queries, "ball_group queries", torch.float32, (B, None, 3))
    tabs = [t.to(torch.bfloat16).contiguous() for t in tables]
    for t in tabs:
        kernels.check(t, "ball_group table", torch.bfloat16, (B, N, None))
        if t.shape[-1] < 1:
            raise ValueError("ball_group: a table needs at least one channel")
    too_wide = _smem_excess(support.device.index, N, tabs[0].shape[-1],
                            tabs[1].shape[-1] if len(tabs) == 2 else 0, include_center)
    if too_wide:
        raise ValueError(f"ball_group: {too_wide}")
    pos_cols = 9 if include_center else 6
    outs = [
        torch.empty((B, M, nsample, t.shape[-1] + pos_cols), dtype=torch.bfloat16,
                    device=support.device)
        for t in tabs
    ]
    counts = torch.empty((B, M), dtype=torch.int32, device=support.device)
    idx = (torch.empty((B, M, nsample), dtype=torch.int32, device=support.device)
           if return_idx else None)
    if M > 0:
        _launch(support, tabs, queries, radius, nsample, include_center, empty_mode, outs,
                counts, idx)
    return (outs, counts, idx) if return_idx else (outs, counts)


@functools.lru_cache(maxsize=None)
def _smem_excess(device: int, N: int, C0: int, C1: int, include_center: bool) -> str:
    """Why a launch at these sizes cannot run on the card, or "" if it can:
    its dynamic shared memory against what a block may opt in to."""
    smem = kernels.query("ball_group_smem", N, C0, C1, int(include_center))
    limit = torch.cuda.get_device_properties(device).shared_memory_per_block_optin
    if smem <= limit:
        return ""
    return (f"tables of {C0} and {C1} channels over a support of {N} points need {smem} "
            f"bytes of shared memory a block, above {limit}")


def _launch(support, tabs, queries, radius, nsample, include_center, empty_mode, outs,
            counts, idx, queries_per_warp: int = BALL_GROUP_QUERIES_PER_WARP) -> None:
    """One launch of ``csrc/ball_group.cu`` on checked tensors; ``outs=None``
    writes counts and idx only (the scan without the write)."""
    B, N, _ = support.shape
    t1 = tabs[1] if len(tabs) == 2 else None
    o1 = outs[1] if outs is not None and len(outs) == 2 else None
    kernels.launch(
        "ball_group", support.data_ptr(), queries.data_ptr(), B, N, queries.shape[1],
        nsample, _radius_sq(radius), int(include_center), EMPTY_MODES[empty_mode],
        queries_per_warp, tabs[0].data_ptr(), tabs[0].shape[-1],
        outs[0].data_ptr() if outs is not None else None,
        t1.data_ptr() if t1 is not None else None,
        t1.shape[-1] if t1 is not None else 0,
        o1.data_ptr() if o1 is not None else None,
        counts.data_ptr(), idx.data_ptr() if idx is not None else None,
    )


class _BallGroupTrain(torch.autograd.Function):
    """``ball_group`` on one table with the backward of
    ``ops/windowed_grad.py::_bwd``: the feature cotangent scatters into the
    support rows by idx; the neighbour position feeds both ``rel`` and
    ``abs``, so ``d_rel + d_abs`` scatters into the support positions; the
    query gets ``-sum_k d_rel`` (``+ sum_k d_center``).  Under
    "center_zero" an empty ball's features are zeros and its position is the
    query itself: its feature and ``rel`` cotangents vanish and its ``d_abs``
    goes to the query.  The neighbour selection carries no gradient."""

    @staticmethod
    def forward(ctx, support, features, queries, radius, nsample, include_center,
                empty_mode):
        (grouped,), counts, idx = ball_group(
            support, [features], queries, radius, nsample, include_center, empty_mode,
            return_idx=True,
        )
        ctx.save_for_backward(idx, counts)
        ctx.n_rows = support.shape[1]
        ctx.n_features = features.shape[-1]
        ctx.include_center = include_center
        ctx.center_zero = empty_mode == "center_zero"
        ctx.dtypes = (support.dtype, features.dtype, queries.dtype)
        ctx.mark_non_differentiable(counts, idx)
        return grouped, counts, idx

    @staticmethod
    def backward(ctx, d_grouped, _d_counts, _d_idx):
        idx, counts = ctx.saved_tensors
        C, N = ctx.n_features, ctx.n_rows
        skip_empty = counts if ctx.center_zero else None
        d_support = d_features = d_queries = None
        need_support, need_features = ctx.needs_input_grad[0], ctx.needs_input_grad[1]
        if need_support or ctx.needs_input_grad[2]:
            d_pos = d_grouped[..., C:].to(torch.float32)
            d_rel, d_abs = d_pos[..., 0:3], d_pos[..., 3:6]
        if need_support and need_features:
            # both tables through one inverse index of idx
            d_features, d_support = group_scatter_add_pair(
                d_grouped[..., :C], (d_rel + d_abs).contiguous(), idx, N, skip_empty)
        elif need_features:
            d_features = group_scatter_add(d_grouped[..., :C], idx, N, skip_empty)
        elif need_support:
            d_support = group_scatter_add((d_rel + d_abs).contiguous(), idx, N, skip_empty)
        if d_features is not None:
            d_features = d_features.to(ctx.dtypes[1])
        if d_support is not None:
            d_support = d_support.to(ctx.dtypes[0])
        if ctx.needs_input_grad[2]:
            if ctx.center_zero:
                have = (counts > 0).to(torch.float32)[..., None, None]
                d_queries = (d_abs * (1.0 - have) - d_rel * have).sum(dim=2)
            else:
                d_queries = -d_rel.sum(dim=2)
            if ctx.include_center:
                d_queries = d_queries + d_pos[..., 6:9].sum(dim=2)
            d_queries = d_queries.to(ctx.dtypes[2])
        return d_support, d_features, d_queries, None, None, None, None


def ball_group_train(
    support: torch.Tensor,
    features: torch.Tensor,
    queries: torch.Tensor,
    radius: float,
    nsample: int,
    include_center: bool = False,
    empty_mode: str = "row0",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Differentiable fused ball grouping of one feature table.

    Returns (grouped (B, M, nsample, C + 6|9) bfloat16 in original query
    order, counts (B, M) int32, idx (B, M, nsample) int32 original support
    indices).  Gradients flow to ``features``, ``support`` and ``queries``
    (float32 sums of the bfloat16 cotangent); counts and idx carry none.
    """
    return _BallGroupTrain.apply(
        support, features, queries, float(radius), int(nsample), bool(include_center),
        empty_mode,
    )
