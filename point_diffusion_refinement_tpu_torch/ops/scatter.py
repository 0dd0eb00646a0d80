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
Where K = 1 every run is one slot and that is plain slot order.  On GPU
tensors ``group_scatter_add`` launches ``csrc/group_scatter_ordered.cu``,
which sums in that order, so a run repeats bit for bit and equals the plain
version (two ``index_add_``, serial on the CPU) on CPU copies;
``group_scatter_add_pair`` sums two cotangents gathered with the same idx
through one inverse index.  ``deterministic=False`` takes the atomic kernel
B, ``csrc/group_scatter.cu``, whose sums vary in the last float32 bits from
run to run: kept to be timed beside the ordered kernel, never a default.
The plain version runs for CPU tensors.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from . import kernels


# consecutive balls a thread of the atomic kernel B takes in turn.  A
# thread carries its run across its balls, so consecutive empty balls (all
# slots row 0) merge into one atomic: two a thread where the support has at
# least SCATTER_PAIR_MIN_ROWS rows (the large, sparsely covered levels,
# where empty balls are common), one elsewhere and where two would leave
# fewer than SCATTER_MIN_THREADS threads.  On an H100 (80GB HBM3, 700 W)
# that is the fastest choice, or within 5%, at every shape of a B = 32 DDPM
# training step and at the level-0 feature transfer at B = 4; four a thread
# was never faster by more than 8%, eight ran up to 71% slower
# (chip_smoke.py's phase 10 times each at the feature transfer).
SCATTER_PAIR_MIN_ROWS = 1024
SCATTER_MIN_THREADS = 1 << 16


def scatter_balls_per_thread(balls: int, C: int, n_rows: int) -> int:
    """Balls a thread of the atomic kernel B takes, for ``balls`` = B * M
    balls of C channels each, scattered into ``n_rows`` rows."""
    if n_rows >= SCATTER_PAIR_MIN_ROWS and -(-balls // 2) * C >= SCATTER_MIN_THREADS:
        return 2
    return 1


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


def _checked(dg: torch.Tensor, idx: torch.Tensor, counts: Optional[torch.Tensor]):
    """(dg, ld, idx, counts) for a launch on GPU tensors: dg float32 or
    bfloat16 (B, M, K, C), read in place where its rows lie ``ld >= C``
    elements apart (a channel slice of a wider tensor), else copied; idx
    and counts contiguous int32.  Raises on what the kernels do not take."""
    if dg.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"group_scatter_add: expected float32 or bfloat16, got {dg.dtype}")
    if dg.dim() != 4:
        raise ValueError(f"group_scatter_add: expected (B, M, K, C), got {tuple(dg.shape)}")
    B, M, K, C = dg.shape
    ld = dg.stride(2)
    if dg.stride() != (M * K * ld, K * ld, ld, 1) or ld < C:
        dg = dg.contiguous()
        ld = C
    if dg.device.type != "cuda":
        raise ValueError(f"group_scatter_add: expected a CUDA tensor, got {dg.device}")
    idx = idx.contiguous()
    kernels.check(idx, "group_scatter_add idx", torch.int32, (B, M, K))
    if counts is not None:
        counts = counts.contiguous()
        kernels.check(counts, "group_scatter_add counts", torch.int32, (B, M))
    return dg, ld, idx, counts


def group_scatter_add(
    dg: torch.Tensor, idx: torch.Tensor, n_rows: int,
    counts: Optional[torch.Tensor] = None, *, deterministic: bool = True,
) -> torch.Tensor:
    """Sum grouped values back into the rows they were gathered from.

    Args:
      dg: (B, M, K, C) float32 or bfloat16; may be a channel slice of a wider
        contiguous tensor (it is read in place).
      idx: (B, M, K) int32 row indices in [0, n_rows).
      n_rows: N of the (B, N, C) result.
      counts: optional (B, M) int32; balls with count 0 are skipped.
      deterministic: the ordered kernel (True) or the atomic kernel B
        (False) on GPU tensors.

    Returns:
      (B, N, C) float32.
    """
    if kernels.use_plain(dg):
        return group_scatter_add_plain(dg, idx, n_rows, counts)
    dg, ld, idx, counts = _checked(dg, idx, counts)
    if deterministic:
        return _ordered_launch([(dg, ld)], idx, n_rows, counts)[0]
    B, M, _, C = dg.shape
    return _scatter_launch(dg, ld, idx, n_rows, counts,
                           scatter_balls_per_thread(B * M, C, n_rows))


def group_scatter_add_pair(
    dg: torch.Tensor, dg2: torch.Tensor, idx: torch.Tensor, n_rows: int,
    counts: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``group_scatter_add`` of two cotangents gathered with the same idx
    (and counts), (B, M, K, C) and (B, M, K, C2): on GPU tensors one launch
    of the ordered kernel, which builds the inverse index once for both.
    Each result equals its own ``group_scatter_add``."""
    if kernels.use_plain(dg):
        return (group_scatter_add_plain(dg, idx, n_rows, counts),
                group_scatter_add_plain(dg2, idx, n_rows, counts))
    if dg2.shape[:3] != dg.shape[:3]:
        raise ValueError(f"group_scatter_add_pair: (B, M, K) of {tuple(dg.shape)} and "
                         f"{tuple(dg2.shape)} differ")
    dg, ld, idx, counts = _checked(dg, idx, counts)
    dg2, ld2, _, _ = _checked(dg2, idx, None)
    out, out2 = _ordered_launch([(dg, ld), (dg2, ld2)], idx, n_rows, counts)
    return out, out2


def _ordered_launch(tables, idx, n_rows, counts) -> List[torch.Tensor]:
    """One launch of ``csrc/group_scatter_ordered.cu`` on checked tensors:
    ``tables``, one or two (dg, ld) of the same (B, M, K), gives one (B,
    n_rows, C) float32 sum each, in the module's order.  The workspace (the
    inverse index and the runs' partials) comes from PyTorch's allocator on
    the current stream, sized from B * M * K, B * n_rows and the channels
    alone."""
    B, M, K, _ = tables[0][0].shape
    dev = tables[0][0].device
    if B * n_rows * K == 0 or any(dg.shape[-1] == 0 for dg, _ in tables):
        return [torch.zeros((B, n_rows, dg.shape[-1]), dtype=torch.float32, device=dev)
                for dg, _ in tables]
    outs = [torch.empty((B, n_rows, dg.shape[-1]), dtype=torch.float32, device=dev)
            for dg, _ in tables]
    c_all = sum(dg.shape[-1] for dg, _ in tables)
    words = kernels.query("group_scatter_ordered_workspace", B, n_rows, M, K, c_all)
    if words < 0:
        raise ValueError(f"group_scatter_add: (B, N, M, K, C) = {(B, n_rows, M, K, c_all)} is "
                         "beyond the ordered kernel's int32 indexing")
    work = torch.empty(words, dtype=torch.int32, device=dev)
    (dg, ld), (dg2, ld2) = tables[0], (tables[1] if len(tables) > 1 else (None, 0))
    kernels.launch(
        "group_scatter_ordered", dg.data_ptr(), int(dg.dtype == torch.bfloat16), ld,
        dg.shape[-1],
        dg2.data_ptr() if dg2 is not None else None,
        int(dg2 is not None and dg2.dtype == torch.bfloat16), ld2,
        dg2.shape[-1] if dg2 is not None else 0,
        idx.data_ptr(), counts.data_ptr() if counts is not None else None,
        B, n_rows, M, K, work.data_ptr(), outs[0].data_ptr(),
        outs[1].data_ptr() if dg2 is not None else None,
    )
    return outs


def _scatter_launch(dg, ld, idx, n_rows, counts, balls_per_thread: int) -> torch.Tensor:
    """One launch of ``csrc/group_scatter.cu`` on checked tensors (``ld``
    elements of dg between consecutive slots): the (B, n_rows, C) float32
    sum."""
    B, M, K, C = dg.shape
    # zeroed on the current stream, which the launch also uses
    out = torch.zeros((B, n_rows, C), dtype=torch.float32, device=dg.device)
    if B * M * K * C > 0:
        kernels.launch(
            "group_scatter_add", dg.data_ptr(), int(dg.dtype == torch.bfloat16), ld,
            idx.data_ptr(), counts.data_ptr() if counts is not None else None,
            B, n_rows, M, K, C, balls_per_thread, out.data_ptr(),
        )
    return out
