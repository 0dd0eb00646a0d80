"""Seeded inputs of the benchmark, made on the device in a few large calls.

Clouds of the MVP kind: the surfaces of spheres, boxes and cylinders of
random size and orientation, in the training scale [-1, 1] (MVP's [-0.5,
0.5] times two, as ``MVPDataset`` scales them).  A partial scan is the
half of a surface that faces a random direction; its condition is the
scan mirrored across the xy-plane with a +1 / -1 flag channel (the
reference's ``mirror_and_concat`` layout), 1536 + 1536 = 3072 points, so no
downsampling is needed.  Every draw comes from the ``torch.Generator``
passed in, in a fixed order, so a seed gives the same tensors.
"""

from __future__ import annotations

import math

import torch

NUM_CLASSES = 16


def generator(device, *parts: int) -> torch.Generator:
    """A generator on ``device`` seeded from the integers ``parts`` (the run's
    seed, then what the draw is for), any size."""
    h = 1469598103934665603
    for p in parts:
        h = ((h ^ (int(p) & (2 ** 64 - 1))) * 1099511628211) % (2 ** 64)
    g = torch.Generator(device=device)
    g.manual_seed(h % (2 ** 63))
    return g


def _rotations(g: torch.Generator, n: int, device) -> torch.Tensor:
    """n uniformly random rotation matrices, from normalised gaussian
    quaternions."""
    q = torch.randn(n, 4, generator=g, device=device)
    w, x, y, z = (q / q.norm(dim=1, keepdim=True)).unbind(1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
    ], dim=1).reshape(n, 3, 3)


def surfaces(g: torch.Generator, n: int, points: int, device) -> torch.Tensor:
    """(n, points, 3) points on n random shape surfaces in [-1, 1]: cloud i
    is a sphere, a box or a cylinder by i mod 3, with random half-extents
    and orientation."""
    u = torch.rand(n, points, 3, generator=g, device=device)
    extent = 0.35 + 0.6 * torch.rand(n, 1, 3, generator=g, device=device)
    kind = torch.arange(n, device=device)[:, None, None] % 3
    # sphere: a normalised gaussian
    s = torch.randn(n, points, 3, generator=g, device=device)
    sphere = s / s.norm(dim=-1, keepdim=True).clamp(min=1e-6)
    # box: one face of six, uniform on it
    face = (u[..., :1] * 6).floor().clamp(max=5)
    axis = face % 3
    sign = torch.where(face < 3, 1.0, -1.0)
    uv = u[..., 1:] * 2 - 1
    box = torch.cat([uv, sign], dim=-1)
    box = torch.where(axis == 0, box[..., [2, 0, 1]], torch.where(axis == 1, box[..., [0, 2, 1]],
                                                                   box))
    # cylinder: the side, around y
    theta = u[..., :1] * (2 * math.pi)
    cyl = torch.cat([torch.cos(theta), u[..., 1:2] * 2 - 1, torch.sin(theta)], dim=-1)
    shape = torch.where(kind == 0, sphere, torch.where(kind == 1, box, cyl)) * extent
    return shape @ _rotations(g, n, device).transpose(1, 2)


def partials(clouds: torch.Tensor, g: torch.Generator, points: int) -> torch.Tensor:
    """(n, points, 3): the ``points`` points of each cloud that lie farthest
    along a random view direction, a partial scan of its near side."""
    n = clouds.shape[0]
    view = torch.randn(n, 1, 3, generator=g, device=clouds.device)
    score = (clouds * view).sum(-1)
    idx = score.topk(points, dim=1).indices
    return torch.gather(clouds, 1, idx[..., None].expand(-1, -1, 3))


def mirrored(partial: torch.Tensor) -> torch.Tensor:
    """(n, P, 3) -> (n, 2P, 4): the scan and its mirror image across the
    xy-plane, flagged +1 and -1."""
    mirror = partial * partial.new_tensor([1.0, 1.0, -1.0])
    ones = partial.new_ones(partial.shape[:2] + (1,))
    return torch.cat([torch.cat([partial, ones], -1), torch.cat([mirror, -ones], -1)], 1)


def conditions(g: torch.Generator, n: int, condition_points: int, device,
               surface_points: int = 4096) -> torch.Tensor:
    """(n, condition_points, 4) mirrored partial scans of random shapes."""
    clouds = surfaces(g, n, surface_points, device)
    return mirrored(partials(clouds, g, condition_points // 2))


def labels(g: torch.Generator, n: int, device) -> torch.Tensor:
    return torch.randint(0, NUM_CLASSES, (n,), generator=g, device=device)


def completion_items(g: torch.Generator, n: int, npoints: int, condition_points: int,
                     device, coarse_points: int = 0, coarse_noise: float = 0.02) -> dict:
    """``n`` training items: 'complete' (n, npoints, 3) surfaces, 'partial'
    (n, condition_points, 4) mirrored scans of them, 'label' (n,), and with
    ``coarse_points`` a 'generated' coarse cloud (n, coarse_points, 3): a
    random subset of the complete cloud with gaussian noise, standing in
    for a DDPM's output."""
    complete = surfaces(g, n, npoints, device)
    out = {"complete": complete,
           "partial": mirrored(partials(complete, g, condition_points // 2)),
           "label": labels(g, n, device)}
    if coarse_points:
        pick = torch.rand(n, npoints, generator=g, device=device).argsort(dim=1)[:, :coarse_points]
        coarse = torch.gather(complete, 1, pick[..., None].expand(-1, -1, 3))
        out["generated"] = coarse + coarse_noise * torch.randn(coarse.shape, generator=g,
                                                               device=device)
    return out
