"""Fused ball query + gather of feature tables with position channels.

Counterpart of the JAX package's ``ops/pallas_window.py``
(``windowed_ball_group_t`` and its lane-major twin ``windowed_ball_group``):
the same function without the TPU windowing.  There is no support or query
sort, so the output is in original query order and the JAX package's
``build_query_ctx``/``sort_rows``/``unsort_rows`` have no counterpart.
``ball_group`` launches ``csrc/ball_group.cu`` on GPU tensors; its plain
PyTorch version runs for CPU tensors.

Per table the grouped channels are ``[features, rel, abs, center?]`` in
bfloat16, where ``abs`` is the neighbour's float32 position rounded once
and ``rel = abs - query`` is rounded from float32.  (The TPU kernel first
rebuilds positions from hi/lo bf16 halves, ~16 mantissa bits, so its
position channels can differ from these by one bf16 ulp; feature channels
agree exactly.)
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from . import kernels
from .neighbors import _radius_sq, ball_query_plain
from .sampling import group_points

EMPTY_MODES = {"center_zero": 0, "row0": 1}
BALL_GROUP_MAX_K = 64


def ball_group_plain(
    support: torch.Tensor,
    tables: Sequence[torch.Tensor],
    queries: torch.Tensor,
    radius: float,
    nsample: int,
    include_center: bool = False,
    empty_mode: str = "center_zero",
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Plain version of ``ball_group``: ball query, then indexed gathers."""
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
        f = group_points(t.to(torch.bfloat16), idx)
        if empty_mode == "center_zero":
            f = torch.where(have, f, torch.zeros_like(f))
        outs.append(torch.cat([f] + pos, dim=-1))
    return outs, counts


def ball_group(
    support: torch.Tensor,
    tables: Sequence[torch.Tensor],
    queries: torch.Tensor,
    radius: float,
    nsample: int,
    include_center: bool = False,
    empty_mode: str = "center_zero",
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Group one or two feature tables around each query.

    Args:
      support: (B, N, 3) float32 support positions.
      tables: one or two (B, N, Ci) feature tables (cast to bfloat16).
      queries: (B, M, 3) float32 query positions.
      empty_mode: "center_zero" (zero features, abs = query) or "row0"
        (support row 0) for an empty ball.

    Returns:
      ([(B, M, nsample, Ci + 6|9) bfloat16 per table], counts (B, M) int32),
      in original query order.
    """
    if kernels.use_plain(support):
        return ball_group_plain(
            support, tables, queries, radius, nsample, include_center, empty_mode
        )
    if empty_mode not in EMPTY_MODES:
        raise ValueError(f"unknown empty_mode {empty_mode!r}")
    if not 1 <= len(tables) <= 2:
        raise ValueError(f"ball_group takes one or two tables, got {len(tables)}")
    if not 1 <= nsample <= BALL_GROUP_MAX_K:
        raise ValueError(f"ball_group kernel needs 1 <= nsample <= {BALL_GROUP_MAX_K}")
    support, queries = kernels.as_f32(support), kernels.as_f32(queries)
    B, N, _ = support.shape
    M = queries.shape[1]
    kernels.check(support, "ball_group support", torch.float32, (None, None, 3))
    kernels.check(queries, "ball_group queries", torch.float32, (B, None, 3))
    tabs = [t.to(torch.bfloat16).contiguous() for t in tables]
    for t in tabs:
        kernels.check(t, "ball_group table", torch.bfloat16, (B, N, None))
    pos_cols = 9 if include_center else 6
    outs = [
        torch.empty((B, M, nsample, t.shape[-1] + pos_cols), dtype=torch.bfloat16,
                    device=support.device)
        for t in tabs
    ]
    counts = torch.empty((B, M), dtype=torch.int32, device=support.device)
    t1 = tabs[1] if len(tabs) == 2 else None
    o1 = outs[1] if len(outs) == 2 else None
    kernels.launch(
        "ball_group", support.data_ptr(), queries.data_ptr(), B, N, M, nsample,
        _radius_sq(radius), int(include_center), EMPTY_MODES[empty_mode],
        tabs[0].data_ptr(), tabs[0].shape[-1], outs[0].data_ptr(),
        t1.data_ptr() if t1 is not None else None,
        t1.shape[-1] if t1 is not None else 0,
        o1.data_ptr() if o1 is not None else None,
        counts.data_ptr(),
    )
    return outs, counts
