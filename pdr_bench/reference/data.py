"""The training batches rebuilt without the program: a plain copy of the
port's augmentation (``data/augment.py::augment_cloud`` at ``fddce06``,
without the returned parameters) and of its batch order
(``data/batches.py::iterate_batches``: a shuffle of the item indices from
the epoch's seed, items fetched one by one in that order, a short last
batch dropped), driven by the same seeds as the program's iterator.  The
check holds the batches the program fed against these."""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterator, List

import numpy as np

CLOUDS = ("partial", "complete", "generated")


def _rot_y(angle: float) -> np.ndarray:
    c, s = math.cos(angle), math.sin(angle)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def _mirror(axis: int) -> np.ndarray:
    m = np.eye(3)
    m[axis, axis] = -1.0
    return m


def augment_cloud(Ps: List[np.ndarray], args: dict, rng: np.random.Generator) -> list:
    """One shared random augmentation of a list of clouds (first 3 columns
    only): uniform scale, y-axis rotation, x/z mirror, gaussian
    translation, optional jitter."""
    M = np.eye(3)
    if args.get("pc_augm_scale", 0) > 1:
        s = rng.uniform(1.0 / args["pc_augm_scale"], args["pc_augm_scale"])
        M = (np.eye(3) * s) @ M
    if args.get("pc_augm_rot", False):
        scale = args.get("pc_rot_scale", 0)
        if scale > 0:
            angle = rng.uniform(-math.pi, math.pi) * scale / 180.0
            M = _rot_y(angle) @ M
    mirror_prob = args.get("pc_augm_mirror_prob", 0)
    if mirror_prob > 0:
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
            P = P + np.clip(0.01 * rng.standard_normal(P.shape), -0.05, 0.05).astype(np.float32)
        result.append(P)
    return result


def training_batches(arrays: Dict[str, np.ndarray], augmentation: dict, batch_size: int,
                     seed: int, epoch_seed: Callable[[int], int]) -> Iterator[dict]:
    """Batches of ``arrays`` (clouds by name and ``label``, one row an item)
    as the benchmark's training set gives them to the program's iterator:
    each epoch shuffled from ``epoch_seed(e)``, each item's clouds augmented
    together from one generator seeded with ``seed`` and, for refinement,
    its coarse cloud given the configuration's noise."""
    rng = np.random.default_rng(seed)
    keys = [k for k in CLOUDS if k in arrays]
    sigma = augmentation.get("noise_magnitude_for_generated_samples", 0)
    n = len(arrays["label"])
    e = 0
    while True:
        order = np.arange(n)
        np.random.default_rng(epoch_seed(e)).shuffle(order)
        for i in range(0, n - batch_size + 1, batch_size):
            items = []
            for j in order[i: i + batch_size]:
                item = dict(zip(keys, augment_cloud([arrays[k][j] for k in keys],
                                                    augmentation, rng)))
                if "generated" in item and sigma > 0:
                    item["generated"] = item["generated"] + rng.normal(
                        scale=sigma, size=item["generated"].shape).astype(np.float32)
                item["label"] = arrays["label"][j]
                items.append(item)
            yield {k: np.stack([it[k] for it in items]) for k in items[0]}
        e += 1
