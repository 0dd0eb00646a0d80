"""Metrics: completion (Chamfer / F1 / EMD, re-exported from ``ops``) and
generation quality (MMD / COV / 1-NNA / JSD)."""

from ..ops.chamfer import calc_cd, chamfer_distance, fscore
from ..ops.emd import earth_mover_distance
from .generation import (
    compute_all_metrics,
    emd_cd,
    entropy_of_occupancy_grid,
    jensen_shannon_divergence,
    jsd_between_point_cloud_sets,
    lgan_mmd_cov,
    one_nn_accuracy,
    pairwise_emd_cd,
    unit_cube_grid_point_cloud,
)

__all__ = [
    "calc_cd",
    "chamfer_distance",
    "compute_all_metrics",
    "earth_mover_distance",
    "emd_cd",
    "entropy_of_occupancy_grid",
    "fscore",
    "jensen_shannon_divergence",
    "jsd_between_point_cloud_sets",
    "lgan_mmd_cov",
    "one_nn_accuracy",
    "pairwise_emd_cd",
    "unit_cube_grid_point_cloud",
]
