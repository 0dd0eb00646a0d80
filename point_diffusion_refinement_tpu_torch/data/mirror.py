"""Mirror-and-concat preprocessing of partial clouds.

Counterpart of the JAX package's ``data/mirror.py``: reflect the partial
across the xy-plane (negate z), tag original points +1 and mirrored points
-1 in a 4th channel, concatenate to 2N points, and downsample to the target
count with the idx-only furthest point sampling (the ``fps_idx`` kernel on
the GPU).  Points on z = 0 are their own mirror images, so the 2N points
hold exact duplicates: the FPS tie-break (lowest index) decides between
them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.sampling import furthest_point_sample, gather_points
from ..utils.device import DeviceLike, resolve_device


def mirror_and_concat(partial: torch.Tensor, num_points: int, axis: int = 2) -> torch.Tensor:
    """(B, N, 3) partials -> (B, num_points, 4) mirrored, tagged and
    FPS-downsampled; channel 3 is +1 for original points, -1 for reflected
    ones."""
    B, N, _ = partial.shape
    sign = torch.ones(3, dtype=partial.dtype, device=partial.device)
    sign[axis] = -1.0
    mirrored = partial * sign
    flags = torch.ones((B, N, 1), dtype=partial.dtype, device=partial.device)
    both = torch.cat(
        [torch.cat([partial, flags], dim=-1), torch.cat([mirrored, -flags], dim=-1)],
        dim=1,
    )  # (B, 2N, 4)
    idx = furthest_point_sample(both[..., :3], num_points)
    return gather_points(both, idx)


def generate_mirrored_partials(
    partials: np.ndarray, num_points: int, batch_size: int = 64, axis: int = 2,
    device: DeviceLike = None,
) -> np.ndarray:
    """Host driver over a large array of partials: batches of ``batch_size``
    go to ``device`` (``cuda`` unless ``"cpu"`` is asked for) as float32 and
    come back as one (len(partials), num_points, 4) float32 array."""
    dev = resolve_device(device)
    out = []
    with torch.no_grad():
        for i in range(0, partials.shape[0], batch_size):
            chunk = torch.as_tensor(
                np.asarray(partials[i: i + batch_size], dtype=np.float32)).to(dev)
            out.append(mirror_and_concat(chunk, num_points, axis).cpu().numpy())
    return np.concatenate(out, axis=0)
