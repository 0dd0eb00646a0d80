"""Approximate Earth Mover's Distance (auction / epsilon-scaling matching).

Counterpart of the JAX package's ``ops/emd.py``: ``earth_mover_distance``
and ``approx_match`` (plain XLA there, plain PyTorch here): 10
epsilon-scaling rounds (level = -4^j for j = 7..-1, then 0) of
softmax-weighted bipartite mass assignment between clouds of n and m
points, with the initial masses set by integer division as in the original
CUDA kernel; the cost is sum(match * squared distance) / max(n, m).
Above 2^26 float32 elements of (B, n, m) plane the rounds run row-tiled,
recomputing each chunk's distance plane, so the whole plane is never held.

Gradients: when an input requires grad, the forward keeps the thin per-round
mass ratios ((10, B, n) and (10, B, m) floats) and the backward accumulates
the analytic gradient with the match held fixed, d cost / d x1_k = sum_l 2
match[l, k] (x1_k - x2_l) / max(n, m), from the round decomposition match =
sum_r ratioL_r (x) w_r (x) ratioR_r, untiled or row-tiled like the forward,
without replaying the auction.  When no input requires grad nothing is kept
and the forward runs as before.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from .neighbors import pairwise_sqdist

# level schedule: j = 7..-1 -> -4^j, final round level = 0
LEVELS = tuple([-(4.0 ** j) for j in range(7, -2, -1)] + [0.0])
# materialized (B, n, m) element budget of the untiled auction
EMD_TILE_ELEMS = 2 ** 26


def _init_masses(n: int, m: int) -> Tuple[float, float]:
    # integer division exactly as the CUDA code: multiR = n/m with ints
    if n >= m:
        return 1.0, float(n // m)
    return float(m // n), 1.0


Ratios = Optional[List[Tuple[torch.Tensor, torch.Tensor]]]


def _auction_rounds(d: torch.Tensor, n: int, m: int, ratios: Ratios = None) -> torch.Tensor:
    """The 10 rounds on a materialized (B, n, m) squared-distance plane;
    returns the un-normalized cost (B,).  Each round's (ratioL, ratioR) is
    appended to ``ratios`` when a list is given."""
    B = d.shape[0]
    multiL, multiR = _init_masses(n, m)
    remainL = torch.full((B, n), multiL, dtype=torch.float32, device=d.device)
    remainR = torch.full((B, m), multiR, dtype=torch.float32, device=d.device)
    cost = torch.zeros((B,), dtype=torch.float32, device=d.device)
    for level in LEVELS:
        w = torch.exp(level * d)  # (B, n, m); level <= 0
        suml = torch.einsum("bnm,bm->bn", w, remainR) + 1e-9
        ratioL = remainL / suml
        sumr = torch.einsum("bnm,bn->bm", w, ratioL) * remainR
        consumption = torch.clamp(remainR / (sumr + 1e-9), max=1.0)
        ratioR = consumption * remainR
        remainR = torch.clamp(remainR - sumr, min=0.0)
        # delta[k, l] = w * ratioL[k] * ratioR[l]
        delta_row_sum = ratioL * torch.einsum("bnm,bm->bn", w, ratioR)
        remainL = torch.clamp(remainL - delta_row_sum, min=0.0)
        cost = cost + torch.einsum("bn,bnm,bm->b", ratioL, w * d, ratioR)
        if ratios is not None:
            ratios.append((ratioL, ratioR))
    return cost


def emd_row_chunk(B: int, n: int, m: int) -> int:
    """Row-chunk size of the tiled auction (0: the untiled plane fits the
    budget)."""
    if B * n * m <= EMD_TILE_ELEMS:
        return 0
    nc = max(256, EMD_TILE_ELEMS // (B * m) // 256 * 256)
    return min(nc, n)


def _auction_rounds_tiled(xyz1: torch.Tensor, xyz2: torch.Tensor, nc: int,
                          ratios: Ratios = None) -> torch.Tensor:
    """Row-chunked rounds: each round sweeps the chunks twice, once for the
    row ratios and the column sums, once (after the column ratios are known)
    for the row-mass deltas and the cost.  Returns the un-normalized cost
    (B,), equal to the untiled one up to float32 summation order."""
    B, n, _ = xyz1.shape
    m = xyz2.shape[1]
    multiL, multiR = _init_masses(n, m)
    dev = xyz1.device
    chunks = [(i, min(i + nc, n)) for i in range(0, n, nc)]
    remainL = torch.full((B, n), multiL, dtype=torch.float32, device=dev)
    remainR = torch.full((B, m), multiR, dtype=torch.float32, device=dev)
    cost = torch.zeros((B,), dtype=torch.float32, device=dev)
    for level in LEVELS:
        ratioL = torch.empty_like(remainL)
        sumr = torch.zeros((B, m), dtype=torch.float32, device=dev)
        for lo, hi in chunks:
            w = torch.exp(level * pairwise_sqdist(xyz1[:, lo:hi], xyz2))
            suml = torch.einsum("bnm,bm->bn", w, remainR) + 1e-9
            ratioL[:, lo:hi] = remainL[:, lo:hi] / suml
            sumr = sumr + torch.einsum("bnm,bn->bm", w, ratioL[:, lo:hi])
        sumr = sumr * remainR
        consumption = torch.clamp(remainR / (sumr + 1e-9), max=1.0)
        ratioR = consumption * remainR
        remainR = torch.clamp(remainR - sumr, min=0.0)
        drs = torch.empty_like(remainL)
        for lo, hi in chunks:
            d = pairwise_sqdist(xyz1[:, lo:hi], xyz2)
            w = torch.exp(level * d)
            drs[:, lo:hi] = ratioL[:, lo:hi] * torch.einsum("bnm,bm->bn", w, ratioR)
            cost = cost + torch.einsum("bn,bnm,bm->b", ratioL[:, lo:hi], w * d, ratioR)
        remainL = torch.clamp(remainL - drs, min=0.0)
        if ratios is not None:
            ratios.append((ratioL, ratioR))
    return cost


def _emd_forward(xyz1: torch.Tensor, xyz2: torch.Tensor, ratios: Ratios = None) -> torch.Tensor:
    B, n, _ = xyz1.shape
    m = xyz2.shape[1]
    with torch.no_grad():
        nc = emd_row_chunk(B, n, m)
        if nc:
            cost = _auction_rounds_tiled(xyz1, xyz2, nc, ratios)
        else:
            cost = _auction_rounds(pairwise_sqdist(xyz1, xyz2), n, m, ratios)
    return cost / max(n, m)


def _match_contractions(xyz1, xyz2, ratios, nc: int):
    """(match @ [1, xyz2] (B, n, 4), match^T @ [1, xyz1] (B, m, 4)) from the
    stored round ratios: per round two thin contractions of w = exp(level *
    d) against [ratio, ratio * xyz], over row chunks of ``nc`` rows when
    ``nc`` is not 0."""
    B, n, _ = xyz1.shape
    m = xyz2.shape[1]
    rhs2 = torch.cat([xyz2.new_ones(B, m, 1), xyz2], dim=-1)
    rhs1 = torch.cat([xyz1.new_ones(B, n, 1), xyz1], dim=-1)
    chunks = [(i, min(i + nc, n)) for i in range(0, n, nc)] if nc else [(0, n)]
    d_full = None if nc else pairwise_sqdist(xyz1, xyz2)
    acc1 = xyz1.new_zeros(B, n, 4)
    acc2 = xyz2.new_zeros(B, m, 4)
    for level, (ratioL, ratioR) in zip(LEVELS, ratios):
        rr_rhs2 = ratioR[..., None] * rhs2
        a = xyz1.new_empty(B, n, 4)
        b = xyz2.new_zeros(B, m, 4)
        for lo, hi in chunks:
            d = d_full if d_full is not None else pairwise_sqdist(xyz1[:, lo:hi], xyz2)
            w = torch.exp(level * d)
            a[:, lo:hi] = torch.einsum("bnm,bmc->bnc", w, rr_rhs2)
            b = b + torch.einsum("bnm,bnc->bmc", w,
                                 ratioL[:, lo:hi, None] * rhs1[:, lo:hi])
        acc1 = acc1 + ratioL[..., None] * a
        acc2 = acc2 + ratioR[..., None] * b
    return acc1, acc2


class _EarthMoverDistance(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xyz1, xyz2):
        ratios: list = []
        cost = _emd_forward(xyz1, xyz2, ratios)
        ctx.save_for_backward(xyz1, xyz2, *(r for pair in ratios for r in pair))
        return cost

    @staticmethod
    def backward(ctx, g):
        xyz1, xyz2, *flat = ctx.saved_tensors
        ratios = list(zip(flat[0::2], flat[1::2]))
        B, n, _ = xyz1.shape
        m = xyz2.shape[1]
        acc1, acc2 = _match_contractions(xyz1, xyz2, ratios, emd_row_chunk(B, n, m))
        row, mx2 = acc1[..., 0], acc1[..., 1:]  # match @ 1, match @ xyz2
        col, mx1 = acc2[..., 0], acc2[..., 1:]  # match^T @ 1, match^T @ xyz1
        scale = (g / max(n, m))[:, None, None]
        g1 = 2.0 * scale * (xyz1 * row[..., None] - mx2)
        g2 = 2.0 * scale * (xyz2 * col[..., None] - mx1)
        return g1, g2


def approx_match(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """The full (B, m, n) match matrix of the auction, in the reference
    layout: match[b, l, k] is the mass between xyz2[b, l] and xyz1[b, k]
    (xyz1 (B, n, 3), xyz2 (B, m, 3)).  Accumulated round by round from the
    rounds' mass ratios, so one (B, n, m) plane is held at a time beside
    the distances."""
    xyz1 = xyz1.to(torch.float32)
    xyz2 = xyz2.to(torch.float32)
    n, m = xyz1.shape[1], xyz2.shape[1]
    d = pairwise_sqdist(xyz1, xyz2)  # (B, n, m)
    ratios: List[Tuple[torch.Tensor, torch.Tensor]] = []
    _auction_rounds(d, n, m, ratios)
    match = torch.zeros_like(d)
    for level, (ratio_l, ratio_r) in zip(LEVELS, ratios):
        match = match + ratio_l[:, :, None] * torch.exp(level * d) * ratio_r[:, None, :]
    return match.transpose(1, 2)


def earth_mover_distance(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """Approximate EMD per batch element, normalized by max(n, m):
    xyz1 (B, n, 3), xyz2 (B, m, 3) -> (B,) float32.  Large clouds run the
    row-tiled rounds.  Differentiable in both clouds (analytic gradient with
    the match held fixed)."""
    xyz1 = xyz1.to(torch.float32)
    xyz2 = xyz2.to(torch.float32)
    if torch.is_grad_enabled() and (xyz1.requires_grad or xyz2.requires_grad):
        return _EarthMoverDistance.apply(xyz1, xyz2)
    return _emd_forward(xyz1, xyz2)
