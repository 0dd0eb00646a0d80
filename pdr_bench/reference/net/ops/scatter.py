"""Scatter-add of grouped cotangents into table rows.

The backward of every gather of the training step (``ops/neighbors.py::
ball_query_group``, ``ops/ball_group.py::ball_group``, ``ops/sampling.py::
gather_points`` / ``group_points`` and what calls them):
``out[b, idx[b, m, k], c] += dg[b, m, k, c]`` over all (m, k), summed in
float32.  The JAX package computes it as an einsum against a (B, M, K, N)
bf16 one-hot with bf16-rounded cotangents (``models/grouping.py::
_fused_ball_gather_bwd``, ``ops/windowed_grad.py::_bwd``), whose sums XLA
takes in a fixed order; the port scatters directly and does not round the
cotangent.

The order of the sum, the same on every device and in every run: a run is a
maximal stretch of consecutive slots (m, k), (m, k + 1), ... of one ball
whose idx equals the row (a ball that ``counts`` skips has no runs).  Each
run's terms are summed in slot order from 0.0, then the runs' partials are
summed into the row in ascending order of their first slot, from 0.0.
Where K = 1 every run is one slot and that is plain slot order.  The
plain version takes that order by two ``index_add_``;
``group_scatter_add_pair`` sums two cotangents gathered with the same idx.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def group_scatter_add_plain(
    dg: torch.Tensor, idx: torch.Tensor, n_rows: int,
    counts: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of ``group_scatter_add``, in the module's order, by two
    ``index_add_`` (on the CPU each a serial loop over its index): the kept
    slots into a (runs, C) float32 buffer by run id (the running count of
    run starts), then the runs' partials into the (B * n_rows, C) rows, by
    each run's row in run order."""
    B, M, K, C = dg.shape
    idx = idx.long()
    starts = torch.ones((B, M, K), dtype=torch.bool, device=idx.device)
    starts[..., 1:] = idx[..., 1:] != idx[..., :-1]
    kept = torch.ones((B * M * K,), dtype=torch.bool, device=idx.device)
    if counts is not None:
        keep = (counts != 0)[..., None]
        starts &= keep
        kept = keep.expand(B, M, K).reshape(-1)
    starts = starts.reshape(-1)
    run = torch.cumsum(starts, 0) - 1
    partial = torch.zeros((B * M * K, C), dtype=torch.float32, device=dg.device)
    partial.index_add_(0, run[kept], dg.reshape(-1, C)[kept].to(torch.float32))
    rows = (idx + torch.arange(B, device=idx.device)[:, None, None] * n_rows).reshape(-1)[starts]
    out = torch.zeros((B * n_rows, C), dtype=torch.float32, device=dg.device)
    out.index_add_(0, rows, partial[: rows.numel()])
    return out.reshape(B, n_rows, C)


def group_scatter_add(
    dg: torch.Tensor, idx: torch.Tensor, n_rows: int,
    counts: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sum grouped values back into the rows they were gathered from.

    Args:
      dg: (B, M, K, C) float32 or bfloat16; may be a channel slice of a wider
        contiguous tensor (it is read in place).
      idx: (B, M, K) int32 row indices in [0, n_rows).
      n_rows: N of the (B, N, C) result.
      counts: optional (B, M) int32; balls with count 0 are skipped.

    Returns:
      (B, N, C) float32.
    """
    return group_scatter_add_plain(dg, idx, n_rows, counts)


def group_scatter_add_pair(
    dg: torch.Tensor, dg2: torch.Tensor, idx: torch.Tensor, n_rows: int,
    counts: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``group_scatter_add`` of two cotangents gathered with the same idx
    (and counts), (B, M, K, C) and (B, M, K, C2).  Each result equals its
    own ``group_scatter_add``."""
    return (group_scatter_add_plain(dg, idx, n_rows, counts),
            group_scatter_add_plain(dg2, idx, n_rows, counts))
