"""Generation-quality metrics: MMD / COV / 1-NNA over pairwise CD and EMD,
and the JSD of occupancy grids.

Counterpart of the JAX package's ``metrics/generation.py``, on the port's
``ops/chamfer.py`` and ``ops/emd.py``.  The (S, R) pairwise matrices are
computed a tile of Sb samples against Rb references at a time, the Sb * Rb
pairs flattened into one batch of the chamfer and EMD functions, on the
device the clouds lie on (numpy input runs on the CPU).  The occupancy JSD
quantises to the nearest cell of the uniform lattice directly, as the JAX
package does in place of the reference's nearest-neighbour search.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.chamfer import chamfer_distance, fscore
from ..ops.emd import earth_mover_distance


def _tensor(x) -> torch.Tensor:
    return torch.as_tensor(x if isinstance(x, torch.Tensor) else np.asarray(x, np.float32),
                           dtype=torch.float32)


def emd_cd(sample_pcs, ref_pcs, f1_threshold: float = 1e-3) -> dict:
    """Per-pair CD / EMD / F1 of two (B, N, 3) batches: tensors on their
    device."""
    sample_pcs, ref_pcs = _tensor(sample_pcs), _tensor(ref_pcs)
    with torch.no_grad():
        dl, dr = chamfer_distance(sample_pcs, ref_pcs)
        f1, _, _ = fscore(dl, dr, threshold=f1_threshold)
        cd = dl.mean(dim=1) + dr.mean(dim=1)
        emd = earth_mover_distance(sample_pcs, ref_pcs)
    return {"CD": cd, "EMD": emd, "fscore": f1}


def _block_vs_block(sample_block: torch.Tensor, ref_block: torch.Tensor):
    """(Sb, N, 3) x (Rb, N, 3) -> ((Sb, Rb) cd, (Sb, Rb) emd), all pairs in
    one batch."""
    Sb, Rb = sample_block.shape[0], ref_block.shape[0]
    s = sample_block.repeat_interleave(Rb, dim=0)  # (Sb * Rb, N, 3)
    r = ref_block.repeat(Sb, 1, 1)
    with torch.no_grad():
        dl, dr = chamfer_distance(s, r)
        cd = dl.mean(dim=1) + dr.mean(dim=1)
        emd = earth_mover_distance(s, r)
    return cd.reshape(Sb, Rb), emd.reshape(Sb, Rb)


def pairwise_emd_cd(sample_pcs, ref_pcs, batch_size: int = 16, sample_batch_size: int = 16):
    """Full (S, R) pairwise CD and EMD matrices as float32 numpy, tiled
    ``sample_batch_size`` x ``batch_size`` pairs a call.  Shrink the tiles
    where the (Sb * Rb, N, N) distance planes press on device memory (EMD
    row-tiles its planes beyond 2^26 elements, ``ops/emd.py``)."""
    sample, ref = _tensor(sample_pcs), _tensor(ref_pcs)
    S, R = sample.shape[0], ref.shape[0]
    Sb = max(1, min(sample_batch_size, S))
    Rb = max(1, min(batch_size, R))
    all_cd = np.zeros((S, R), np.float32)
    all_emd = np.zeros((S, R), np.float32)
    for i in range(0, S, Sb):
        for j in range(0, R, Rb):
            cd, emd = _block_vs_block(sample[i:i + Sb], ref[j:j + Rb])
            all_cd[i:i + Sb, j:j + Rb] = cd.cpu().numpy()
            all_emd[i:i + Sb, j:j + Rb] = emd.cpu().numpy()
    return all_cd, all_emd


def lgan_mmd_cov(all_dist: np.ndarray) -> dict:
    """MMD and coverage from an (S, R) distance matrix."""
    min_from_sample = all_dist.min(axis=1)
    min_idx = all_dist.argmin(axis=1)
    min_from_ref = all_dist.min(axis=0)
    return {
        "lgan_mmd": float(min_from_ref.mean()),
        "lgan_cov": float(len(np.unique(min_idx)) / all_dist.shape[1]),
        "lgan_mmd_smp": float(min_from_sample.mean()),
    }


def one_nn_accuracy(Mxx: np.ndarray, Mxy: np.ndarray, Myy: np.ndarray, k: int = 1) -> dict:
    """1-NN two-sample classifier accuracy; about 0.5 means the sample
    distribution cannot be told from the reference."""
    n0, n1 = Mxx.shape[0], Myy.shape[0]
    label = np.concatenate([np.ones(n0), np.zeros(n1)])
    M = np.block([[Mxx, Mxy], [Mxy.T, Myy]]).astype(np.float64)
    np.fill_diagonal(M, np.inf)
    idx = np.argsort(M, axis=0)[:k]  # k smallest per column
    count = label[idx].sum(axis=0)
    pred = (count >= k / 2.0).astype(np.float64)
    tp = (pred * label).sum()
    fp = (pred * (1 - label)).sum()
    fn = ((1 - pred) * label).sum()
    tn = ((1 - pred) * (1 - label)).sum()
    return {
        "tp": tp, "fp": fp, "fn": fn, "tn": tn,
        "precision": tp / (tp + fp + 1e-10),
        "recall": tp / (tp + fn + 1e-10),
        "acc_t": tp / (tp + fn + 1e-10),
        "acc_f": tn / (tn + fp + 1e-10),
        "acc": float((pred == label).mean()),
    }


def compute_all_metrics(sample_pcs, ref_pcs, batch_size: int = 16) -> dict:
    """MMD / COV and 1-NNA over both CD and EMD."""
    results = {}
    M_rs_cd, M_rs_emd = pairwise_emd_cd(ref_pcs, sample_pcs, batch_size)
    for name, M in (("CD", M_rs_cd), ("EMD", M_rs_emd)):
        for k, v in lgan_mmd_cov(M.T).items():
            results[f"{k}-{name}"] = v
    M_rr_cd, M_rr_emd = pairwise_emd_cd(ref_pcs, ref_pcs, batch_size)
    M_ss_cd, M_ss_emd = pairwise_emd_cd(sample_pcs, sample_pcs, batch_size)
    for name, (rr, rs, ss) in (
        ("CD", (M_rr_cd, M_rs_cd, M_ss_cd)),
        ("EMD", (M_rr_emd, M_rs_emd, M_ss_emd)),
    ):
        res = one_nn_accuracy(rr, rs, ss, 1)
        results.update({f"1-NN-{name}-{k}": v for k, v in res.items() if "acc" in k})
    return results


# ---- JSD of occupancy grids ---------------------------------------------


def unit_cube_grid_point_cloud(resolution: int, clip_sphere: bool = False):
    """Cell centres of a resolution^3 lattice in the unit cube, and their
    spacing."""
    spacing = 1.0 / (resolution - 1)
    ax = np.arange(resolution) * spacing - 0.5
    grid = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), axis=-1).astype(np.float32)
    if clip_sphere:
        grid = grid.reshape(-1, 3)
        grid = grid[np.linalg.norm(grid, axis=1) <= 0.5]
    return grid, spacing


def _occupancy_counts(pclouds: np.ndarray, resolution: int, in_sphere: bool):
    """Nearest lattice cell by rounding; with ``in_sphere`` a point outside
    the radius-0.5 sphere is projected onto it first and the cells are
    those inside."""
    spacing = 1.0 / (resolution - 1)
    n_cells = resolution ** 3
    counters = np.zeros(n_cells)
    bernoulli = np.zeros(n_cells)
    if in_sphere:
        full, _ = unit_cube_grid_point_cloud(resolution, False)
        inside = np.linalg.norm(full.reshape(-1, 3), axis=1) <= 0.5
        remap = -np.ones(n_cells, dtype=np.int64)
        remap[inside] = np.arange(inside.sum())
        counters = np.zeros(inside.sum())
        bernoulli = np.zeros(inside.sum())
    for pc in pclouds:
        if in_sphere:
            r = np.linalg.norm(pc, axis=1, keepdims=True)
            pc = np.where(r > 0.5, pc * (0.5 / np.maximum(r, 1e-9)), pc)
        cells = np.clip(np.round((pc + 0.5) / spacing), 0, resolution - 1).astype(np.int64)
        flat = cells[:, 0] * resolution ** 2 + cells[:, 1] * resolution + cells[:, 2]
        if in_sphere:
            flat = remap[flat]
            flat = flat[flat >= 0]
        np.add.at(counters, flat, 1)
        bernoulli[np.unique(flat)] += 1
    return counters, bernoulli


def entropy_of_occupancy_grid(pclouds, grid_resolution: int, in_sphere: bool = False):
    """(mean Bernoulli entropy of the cells, occupancy counters)."""
    pclouds = pclouds.cpu().numpy() if isinstance(pclouds, torch.Tensor) else pclouds
    counters, bernoulli = _occupancy_counts(np.asarray(pclouds), grid_resolution, in_sphere)
    n = float(len(pclouds))
    p = bernoulli[bernoulli > 0] / n
    p = np.clip(p, 1e-12, 1 - 1e-12)
    ent = -(p * np.log(p) + (1 - p) * np.log(1 - p))
    return float(ent.sum() / len(counters)), counters


def jensen_shannon_divergence(P: np.ndarray, Q: np.ndarray) -> float:
    """Base-2 JSD of two histograms."""
    P = np.asarray(P, np.float64)
    Q = np.asarray(Q, np.float64)
    if (P < 0).any() or (Q < 0).any():
        raise ValueError("Negative values.")
    if len(P) != len(Q):
        raise ValueError("Non equal size.")
    P_ = P / P.sum()
    Q_ = Q / Q.sum()
    M = 0.5 * (P_ + Q_)

    def kl(a, b):
        idx = (a > 0) & (b > 0)
        return float(np.sum(a[idx] * np.log2(a[idx] / b[idx])))

    return 0.5 * (kl(P_, M) + kl(Q_, M))


def jsd_between_point_cloud_sets(sample_pcs, ref_pcs, resolution: int = 28) -> float:
    """JSD of the two sets' in-sphere occupancy counters."""
    _, sample_counters = entropy_of_occupancy_grid(sample_pcs, resolution, True)
    _, ref_counters = entropy_of_occupancy_grid(ref_pcs, resolution, True)
    return jensen_shannon_divergence(sample_counters, ref_counters)
