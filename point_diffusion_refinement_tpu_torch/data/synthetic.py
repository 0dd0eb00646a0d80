"""Synthetic completion data for tests and smoke runs (no MVP h5 needed).

The port's own copy of the JAX package's ``data/synthetic.py`` (numpy only):
simple parametric shapes (spheres/boxes/cylinders scaled into [-0.5, 0.5]
like MVP) and partial views by half-space cropping, from a seed.
``write_mvp_style_h5`` writes them in the MVP file layout where ``h5py``
imports.  ``ArrayDataset`` holds such arrays in memory behind the per-item
dict interface that ``iterate_batches`` reads, and ``synthetic_dataset``
builds one of 'complete' / 'partial' / 'label' items.
"""

from __future__ import annotations

import os

import numpy as np

VIEWS_PER_SHAPE = 26  # partial views of each MVP shape


def _unit_shape(rng: np.random.Generator, kind: int, n: int) -> np.ndarray:
    if kind == 0:  # sphere surface
        v = rng.standard_normal((n, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True) + 1e-9
        return v * 0.5
    if kind == 1:  # box surface
        face = rng.integers(0, 6, n)
        uv = rng.uniform(-0.5, 0.5, (n, 2))
        pts = np.zeros((n, 3))
        axis = face % 3
        sign = np.where(face < 3, 0.5, -0.5)
        for i in range(n):
            rest = [a for a in range(3) if a != axis[i]]
            pts[i, axis[i]] = sign[i]
            pts[i, rest[0]] = uv[i, 0]
            pts[i, rest[1]] = uv[i, 1]
        return pts
    # cylinder
    theta = rng.uniform(0, 2 * np.pi, n)
    z = rng.uniform(-0.5, 0.5, n)
    return np.stack([0.4 * np.cos(theta), z, 0.4 * np.sin(theta)], axis=1)


def make_synthetic_clouds(
    num_shapes: int = 4,
    npoints: int = 2048,
    partial_points: int = 2048,
    num_classes: int = 16,
    seed: int = 0,
):
    """Returns (complete (S, npoints, 3), partials (S*26, partial_points, 3),
    labels (S*26,)) in MVP scale [-0.5, 0.5]."""
    rng = np.random.default_rng(seed)
    completes, partials, labels = [], [], []
    for s in range(num_shapes):
        kind = s % 3
        label = s % num_classes
        comp = _unit_shape(rng, kind, npoints).astype(np.float32)
        completes.append(comp)
        for v in range(VIEWS_PER_SHAPE):
            # partial: crop by a random half-space, resample to fixed size
            normal = rng.standard_normal(3)
            normal /= np.linalg.norm(normal)
            keep = comp @ normal > rng.uniform(-0.2, 0.1)
            pts = comp[keep]
            if pts.shape[0] < 8:
                pts = comp
            idx = rng.integers(0, pts.shape[0], partial_points)
            partials.append(pts[idx])
            labels.append(label)
    return (
        np.stack(completes),
        np.stack(partials).astype(np.float32),
        np.asarray(labels, dtype=np.int64),
    )


def write_mvp_style_h5(
    data_dir: str,
    num_shapes: int = 4,
    npoints: int = 2048,
    partial_points: int = 2048,
    seed: int = 0,
):
    """Write mvp_{train,test}_input.h5 / gt h5 files in the MVP dataset
    layout.  Needs ``h5py``."""
    import h5py

    os.makedirs(data_dir, exist_ok=True)
    for split, s in (("train", seed), ("test", seed + 1)):
        comp, part, labels = make_synthetic_clouds(
            num_shapes, npoints, partial_points, seed=s
        )
        novel_comp, novel_part, novel_labels = make_synthetic_clouds(
            max(1, num_shapes // 2), npoints, partial_points, seed=s + 100
        )
        with h5py.File(os.path.join(data_dir, f"mvp_{split}_input.h5"), "w") as f:
            f["incomplete_pcds"] = part
            f["labels"] = labels
            f["novel_incomplete_pcds"] = novel_part
            f["novel_labels"] = novel_labels
        with h5py.File(
            os.path.join(data_dir, f"mvp_{split}_gt_{npoints}pts.h5"), "w"
        ) as f:
            f["complete_pcds"] = comp
            f["novel_complete_pcds"] = novel_comp
    return data_dir


class ArrayDataset:
    """In-memory dataset: equal-length arrays behind ``len`` and a per-item
    dict, the interface ``iterate_batches`` reads."""

    def __init__(self, **arrays):
        self.arrays = {k: np.asarray(v) for k, v in arrays.items()}
        sizes = {len(v) for v in self.arrays.values()}
        if len(sizes) != 1:
            raise ValueError(f"arrays differ in length: {sorted(sizes)}")
        self.n = sizes.pop()

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> dict:
        return {k: v[i] for k, v in self.arrays.items()}


def synthetic_dataset(
    num_samples: int,
    npoints: int = 2048,
    partial_points: int = 2048,
    num_classes: int = 16,
    seed: int = 0,
    mirror_to: int = 0,
) -> ArrayDataset:
    """``num_samples`` items of 'complete' (npoints, 3), 'partial' and
    'label' from ``make_synthetic_clouds``.  With ``mirror_to`` > 0 the
    partial is the mirrored condition (mirror_to, 4) of
    ``data/mirror.py::mirror_and_concat`` (computed on the CPU)."""
    shapes = max(1, -(-num_samples // VIEWS_PER_SHAPE))
    completes, partials, labels = make_synthetic_clouds(
        shapes, npoints, partial_points, num_classes, seed)
    complete = np.repeat(completes, VIEWS_PER_SHAPE, axis=0)[:num_samples]
    partial = partials[:num_samples]
    if mirror_to:
        import torch

        from .mirror import mirror_and_concat

        partial = mirror_and_concat(torch.from_numpy(partial), mirror_to).numpy()
    return ArrayDataset(complete=complete.astype(np.float32),
                        partial=partial.astype(np.float32), label=labels[:num_samples])
