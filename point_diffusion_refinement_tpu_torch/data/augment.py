"""Random cloud augmentation shared across all clouds of a sample.

The port's own copy of the JAX package's ``data/augment.py`` (numpy only):
one random linear map M (uniform scale, y-axis rotation, x/z mirror) plus a
gaussian translation applied identically to every cloud of the sample;
optionally returns M_inv + translation so generation can be un-augmented
(``sample/generate.py::unaugment``).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np


def _rot_y(angle: float) -> np.ndarray:
    c, s = math.cos(angle), math.sin(angle)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def _mirror(axis: int) -> np.ndarray:
    m = np.eye(3)
    m[axis, axis] = -1.0
    return m


def augment_cloud(
    Ps: list[np.ndarray],
    args: dict,
    return_augmentation_params: bool = False,
    rng: Optional[np.random.Generator] = None,
):
    """Apply one shared random augmentation to a list of clouds (first 3
    columns only; extra columns like the mirror flag pass through)."""
    rng = rng or np.random.default_rng()
    M = np.eye(3)

    if args.get("pc_augm_scale", 0) > 1:
        s = rng.uniform(1.0 / args["pc_augm_scale"], args["pc_augm_scale"])
        M = (np.eye(3) * s) @ M

    if args.get("pc_augm_rot", False):
        scale = args.get("pc_rot_scale", 0)  # degrees, 0..180
        if scale > 0:
            angle = rng.uniform(-math.pi, math.pi) * scale / 180.0
            M = _rot_y(angle) @ M  # y = upright axis of MVP shapes

    mirror_prob = args.get("pc_augm_mirror_prob", 0)
    if mirror_prob > 0:  # mirror x and z, never y
        if rng.random() < mirror_prob / 2:
            M = _mirror(0) @ M
        if rng.random() < mirror_prob / 2:
            M = _mirror(2) @ M

    translation_sigma = args.get("translation_magnitude", 0)
    translation_sigma = max(args.get("pc_augm_scale", 1), 1) * translation_sigma
    noise = None
    if translation_sigma > 0:
        noise = rng.normal(scale=translation_sigma, size=(1, 3)).astype(Ps[0].dtype)

    result = []
    for P in Ps:
        P = P.copy()
        P[:, :3] = P[:, :3] @ M.T
        if noise is not None:
            P[:, :3] = P[:, :3] + noise
        if args.get("pc_augm_jitter", False):
            sigma, clip = 0.01, 0.05
            P = P + np.clip(
                sigma * rng.standard_normal(P.shape), -clip, clip
            ).astype(np.float32)
        result.append(P)

    if return_augmentation_params:
        params = {
            "M_inv": np.linalg.inv(M.T).astype(Ps[0].dtype),
            "translation": (
                noise if noise is not None else np.zeros((1, 3), dtype=Ps[0].dtype)
            ),
        }
        return result, params
    return result


def sample_transforms(B: int, args: dict, rng: Optional[np.random.Generator] = None):
    """Draw B random similarity transforms with augment_cloud's distribution.

    Returns (M (B, 3, 3), t (B, 3), M_inv (B, 3, 3)) for a batched
    application: p' = p @ M^T + t.
    """
    rng = rng or np.random.default_rng()
    Ms = np.empty((B, 3, 3), np.float32)
    ts = np.zeros((B, 3), np.float32)
    translation_sigma = args.get("translation_magnitude", 0)
    translation_sigma = max(args.get("pc_augm_scale", 1), 1) * translation_sigma
    for b in range(B):
        M = np.eye(3)
        if args.get("pc_augm_scale", 0) > 1:
            s = rng.uniform(1.0 / args["pc_augm_scale"], args["pc_augm_scale"])
            M = (np.eye(3) * s) @ M
        if args.get("pc_augm_rot", False) and args.get("pc_rot_scale", 0) > 0:
            angle = rng.uniform(-math.pi, math.pi) * args["pc_rot_scale"] / 180.0
            M = _rot_y(angle) @ M
        mp = args.get("pc_augm_mirror_prob", 0)
        if mp > 0:
            if rng.random() < mp / 2:
                M = _mirror(0) @ M
            if rng.random() < mp / 2:
                M = _mirror(2) @ M
        Ms[b] = M.astype(np.float32)
        if translation_sigma > 0:
            ts[b] = rng.normal(scale=translation_sigma, size=3).astype(np.float32)
    M_inv = np.linalg.inv(np.transpose(Ms, (0, 2, 1))).astype(np.float32)
    return Ms, ts, M_inv
