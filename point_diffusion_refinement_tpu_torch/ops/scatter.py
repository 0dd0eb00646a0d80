"""Scatter-add of grouped cotangents into table rows.

The backward of every gather of the training step (``ops/neighbors.py::
ball_query_group``, ``ops/ball_group.py::ball_group``, ``ops/sampling.py::
gather_points`` / ``group_points`` and what calls them):
``out[b, idx[b, m, k], c] += dg[b, m, k, c]`` over all (m, k), summed in
float32.  The JAX package computes it as an einsum against a (B, M, K, N)
bf16 one-hot with bf16-rounded cotangents (``models/grouping.py::
_fused_ball_gather_bwd``, ``ops/windowed_grad.py::_bwd``), whose sums XLA
takes in a fixed order; the port scatters directly and does not round the
cotangent.  On GPU tensors ``group_scatter_add`` launches
``csrc/group_scatter_ordered.cu``, which sums each row's terms in ascending
slot order from 0.0, the order of the plain version (``index_add_``, serial
on the CPU), so a run repeats bit for bit and equals the plain version on
CPU copies.  ``deterministic=False`` takes the atomic kernel B,
``csrc/group_scatter.cu``, whose sums vary in the last float32 bits from run
to run: kept to be timed beside the ordered kernel, never a default.  The
plain version runs for CPU tensors.
"""

from __future__ import annotations

from typing import Optional

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
    """Plain version of ``group_scatter_add``: one ``index_add_`` over the
    flattened (b, row) index (on the CPU a serial loop over the slots, so
    each row sums its terms in ascending slot order from 0.0)."""
    B, M, K, C = dg.shape
    vals = dg.to(torch.float32)
    if counts is not None:
        vals = vals * (counts > 0).to(torch.float32)[..., None, None]
    flat = idx.long() + torch.arange(B, device=idx.device)[:, None, None] * n_rows
    out = torch.zeros((B * n_rows, C), dtype=torch.float32, device=dg.device)
    out.index_add_(0, flat.reshape(-1), vals.reshape(-1, C))
    return out.reshape(B, n_rows, C)


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
    if deterministic:
        return _ordered_launch(dg, ld, idx, n_rows, counts)
    return _scatter_launch(dg, ld, idx, n_rows, counts,
                           scatter_balls_per_thread(B * M, C, n_rows))


def _ordered_launch(dg, ld, idx, n_rows, counts) -> torch.Tensor:
    """One launch of ``csrc/group_scatter_ordered.cu`` on checked tensors:
    the (B, n_rows, C) float32 sum, each row's terms in slot order.  Its
    workspace (the inverse index) comes from PyTorch's allocator on the
    current stream, sized from B * M * K and B * n_rows alone."""
    B, M, K, C = dg.shape
    if B * n_rows * C == 0:
        return torch.zeros((B, n_rows, C), dtype=torch.float32, device=dg.device)
    words = kernels.query("group_scatter_ordered_workspace", B, n_rows, M, K)
    if words < 0:
        raise ValueError(f"group_scatter_add: (B, N, M, K) = {(B, n_rows, M, K)} is beyond "
                         "the ordered kernel's int32 indexing")
    work = torch.empty(words, dtype=torch.int32, device=dg.device)
    out = torch.empty((B, n_rows, C), dtype=torch.float32, device=dg.device)
    kernels.launch(
        "group_scatter_ordered", dg.data_ptr(), int(dg.dtype == torch.bfloat16), ld,
        idx.data_ptr(), counts.data_ptr() if counts is not None else None,
        B, n_rows, M, K, C, work.data_ptr(), out.data_ptr(),
    )
    return out


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
