"""Refinement-time point upsampling.

Counterpart of the JAX package's ``models/upsample.py``: split the
network's displacement output into a centre displacement plus a grid of
per-point offsets scaled by 1/sqrt(factor), giving N*factor refined points.
float32 throughout.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def point_upsample(
    coarse: torch.Tensor,
    displacement: torch.Tensor,
    point_upsample_factor: int,
    include_displacement_center_to_final_output: bool,
    output_scale_factor_value: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """coarse (B, N, 3); displacement (B, N, 3*(F+1)), or (B, N, 3*F) with
    the centre included -> (refined (B, N*F, 3), intermediate (B, N, 3))."""
    F = point_upsample_factor
    grid_scale = float(1.0 / np.sqrt(F))
    coarse = coarse.to(torch.float32)
    displacement = displacement.to(torch.float32)
    center = displacement[:, :, 0:3]
    grid = displacement[:, :, 3:] * grid_scale
    intermediate = coarse + center * output_scale_factor_value

    B, N, _ = coarse.shape
    per_point = F - 1 if include_displacement_center_to_final_output else F
    grid = grid.reshape(B, N, per_point, 3)
    upsampled = intermediate[:, :, None, :] + grid * output_scale_factor_value
    upsampled = upsampled.reshape(B, N * per_point, 3)
    if include_displacement_center_to_final_output:
        refined = torch.cat([upsampled, intermediate], dim=1)
    else:
        refined = upsampled
    return refined, intermediate
