"""MVP completion dataset: h5 loading, rank sharding, batched collation.

The port's own copy of the JAX package's ``data/mvp.py`` (numpy on the host;
the clouds become tensors only in their consumers):
  * 26 partial views per GT shape; item i pairs partial[i] with gt[i // 26];
  * novel inputs appended (or mirrored 4-channel partials loaded instead);
  * optional DDPM-generated coarse clouds, with a random ``trial_*``
    directory picked each time the dataset is built (refinement training);
  * optional precomputed XT (warm-start generation);
  * static rank sharding over GT shapes with random resampling to pad the
    last rank;
  * random eval subsampling with the partial -> gt index carried along;
  * coordinates scaled by 2 * scale.

Two random streams, drawn in the JAX package's order: a ``random.Random``
seeded with ``cfg.seed`` (the trial directory, the last-rank padding, the
eval subsample; the JAX package draws these from the module ``random``, so
``random.seed(s)`` there gives the same stream), and a numpy generator
seeded with ``cfg.seed`` for the augmentation.  ``get_batch_fast`` is the
batched collation in numpy (the JAX package's goes through its C++ loader).
Reading h5 needs ``h5py``.
"""

from __future__ import annotations

import glob
import os
import random
from dataclasses import dataclass
from typing import Optional

import numpy as np

from .augment import augment_cloud, sample_transforms

VIEWS_PER_SHAPE = 26  # partial views of each MVP shape


def _find_h5(dir_path: str, canonical: str, pattern: str) -> str:
    """A generated-data h5: ``canonical`` (the 2048-point name) if it exists,
    else the one file matching ``pattern`` (the generation pipeline writes
    ``mvp_generated_data_{n}pts.h5`` at other resolutions)."""
    p = os.path.join(dir_path, canonical)
    if os.path.exists(p):
        return p
    matches = sorted(glob.glob(os.path.join(dir_path, pattern)))
    if len(matches) == 1:
        return matches[0]
    raise FileNotFoundError(
        f"no {canonical} (or unique {pattern}) under {dir_path}; found {matches}")


def _read(path: str, *keys: str):
    import h5py

    with h5py.File(path, "r") as f:
        return tuple(np.array(f[k]) for k in keys)


@dataclass
class MVPDatasetConfig:
    data_dir: str
    train: bool = True
    npoints: int = 2048
    novel_input: bool = True
    novel_input_only: bool = False
    scale: float = 1.0
    rank: int = 0
    world_size: int = 1
    random_subsample: bool = False
    num_samples: int = 1000
    augmentation: Optional[dict] = None
    return_augmentation_params: bool = False
    include_generated_samples: bool = False
    generated_sample_path: Optional[str] = None
    randomly_select_generated_samples: bool = False
    use_mirrored_partial_input: bool = False
    number_partial_points: int = 2048
    load_pre_computed_XT: bool = False
    T_step: int = 100
    XT_folder: Optional[str] = None
    append_samples_to_last_rank: bool = True
    seed: Optional[int] = None


class MVPDataset:
    """In-memory MVP dataset read from the reference's file layout."""

    def __init__(self, cfg: MVPDatasetConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        draw = random.Random(cfg.seed)
        split = "train" if cfg.train else "test"
        d = cfg.data_dir

        input_data, labels, novel_input, novel_labels = _read(
            os.path.join(d, f"mvp_{split}_input.h5"),
            "incomplete_pcds", "labels", "novel_incomplete_pcds", "novel_labels")
        gt_data, novel_gt = _read(
            os.path.join(d, f"mvp_{split}_gt_{cfg.npoints}pts.h5"),
            "complete_pcds", "novel_complete_pcds")

        self.generated_XT = None
        if cfg.load_pre_computed_XT:
            xt_file = _find_h5(
                os.path.join(cfg.XT_folder, split),
                f"mvp_generated_data_2048pts_T{cfg.T_step}.h5",
                f"mvp_generated_data_*pts_T{cfg.T_step}.h5")
            (self.generated_XT,) = _read(xt_file, "data")

        self.generated_sample = None
        if cfg.include_generated_samples:
            gen_dir = os.path.join(d, cfg.generated_sample_path)
            if cfg.randomly_select_generated_samples:
                # os.listdir order, as the JAX package draws from it
                trials = [os.path.join(gen_dir, f) for f in os.listdir(gen_dir)
                          if f.startswith("trial")]
                gen_dir = draw.choice([gen_dir] + trials)
            gen_file = _find_h5(os.path.join(gen_dir, split),
                                "mvp_generated_data_2048pts.h5", "mvp_generated_data_*pts.h5")
            (self.generated_sample,) = _read(gen_file, "data")

        if cfg.novel_input_only:
            input_data, gt_data, labels = novel_input, novel_gt, novel_labels
        elif cfg.novel_input:
            if cfg.use_mirrored_partial_input:
                (input_data,) = _read(os.path.join(
                    d, "mirror_and_concated_partial",
                    f"mvp_{split}_input_mirror_and_concat_{cfg.number_partial_points}pts.h5"),
                    "data")
            else:
                input_data = np.concatenate([input_data, novel_input], axis=0)
            gt_data = np.concatenate([gt_data, novel_gt], axis=0)
            labels = np.concatenate([labels, novel_labels], axis=0)

        # static rank sharding over GT shapes
        if cfg.world_size > 1:
            n_gt = gt_data.shape[0]
            per = int(np.ceil(n_gt / cfg.world_size))
            start, end = cfg.rank * per, (cfg.rank + 1) * per
            sl_p = slice(start * VIEWS_PER_SHAPE, end * VIEWS_PER_SHAPE)
            missing = end - n_gt
            if (cfg.rank == cfg.world_size - 1 and cfg.append_samples_to_last_rank
                    and missing > 0):
                if not cfg.train:
                    raise ValueError("last-rank padding is for the train split only")
                supp_gt = np.array(draw.sample(range(n_gt), missing), dtype=np.int64)
                supp_p = (supp_gt[:, None] * VIEWS_PER_SHAPE
                          + np.arange(VIEWS_PER_SHAPE)[None, :]).reshape(-1)
                rows = lambda a: np.concatenate([a[sl_p], a[supp_p]], axis=0)
                gt_data = np.concatenate([gt_data[start:end], gt_data[supp_gt]], axis=0)
            else:
                rows = lambda a: a[sl_p]
                gt_data = gt_data[start:end]
            input_data, labels = rows(input_data), rows(labels)
            if self.generated_sample is not None:
                self.generated_sample = rows(self.generated_sample)
            if self.generated_XT is not None:
                self.generated_XT = rows(self.generated_XT)

        self.partial_to_gt = np.arange(input_data.shape[0], dtype=np.int64) // VIEWS_PER_SHAPE

        self.random_subsample = cfg.random_subsample
        if cfg.random_subsample and cfg.num_samples < input_data.shape[0]:
            idx = np.array(draw.sample(range(input_data.shape[0]), cfg.num_samples))
            input_data, labels = input_data[idx], labels[idx]
            self.partial_to_gt = self.partial_to_gt[idx]
            if self.generated_sample is not None:
                self.generated_sample = self.generated_sample[idx]
            if self.generated_XT is not None:
                self.generated_XT = self.generated_XT[idx]

        # shapes in [-0.5, 0.5] -> [-scale, scale]; a mirrored partial's
        # +-1 flag channel is not a coordinate
        s = 2.0 * cfg.scale
        input_data = input_data.astype(np.float32)
        if cfg.use_mirrored_partial_input and input_data.shape[-1] == 4:
            input_data[:, :, :3] *= s
        else:
            input_data *= s
        self.input_data = input_data
        self.gt_data = gt_data.astype(np.float32) * s
        if self.generated_sample is not None:
            self.generated_sample = self.generated_sample.astype(np.float32) * s
        if self.generated_XT is not None:
            self.generated_XT = self.generated_XT.astype(np.float32) * s
        self.labels = labels.astype(np.int64)

    def __len__(self):
        return self.input_data.shape[0]

    def __getitem__(self, index: int) -> dict:
        result = {
            "partial": self.input_data[index].copy(),
            "complete": self.gt_data[self.partial_to_gt[index]].copy(),
        }
        if self.generated_sample is not None:
            result["generated"] = self.generated_sample[index].copy()
        if self.generated_XT is not None:
            result["XT"] = self.generated_XT[index].copy()

        aug = self.cfg.augmentation
        if isinstance(aug, dict):
            clouds = list(result.values())
            params = None
            if self.cfg.return_augmentation_params:
                clouds, params = augment_cloud(
                    clouds, aug, return_augmentation_params=True, rng=self.rng)
            else:
                clouds = augment_cloud(clouds, aug, rng=self.rng)
            for k, v in zip(result.keys(), clouds):
                result[k] = v
            sigma = aug.get("noise_magnitude_for_generated_samples", 0)
            if "generated" in result and sigma > 0:
                result["generated"] = result["generated"] + self.rng.normal(
                    scale=sigma, size=result["generated"].shape).astype(np.float32)
            if params is not None:
                result.update(params)
        result["label"] = self.labels[index]
        return result


def _apply_similarity(clouds: np.ndarray, M: np.ndarray, t: np.ndarray) -> np.ndarray:
    """p' = p @ M_b^T + t_b per sample, in float32 in the order
    x * m0 + y * m1 + z * m2 + t; trailing channels pass through."""
    out = clouds.copy()
    x, y, z = (clouds[..., c: c + 1] for c in range(3))
    out[..., :3] = x * M[:, None, :, 0] + y * M[:, None, :, 1] + z * M[:, None, :, 2] \
        + t[:, None, :]
    return out


def get_batch_fast(dataset: MVPDataset, idx: np.ndarray) -> Optional[dict]:
    """Batched collation and augmentation: one gather per array and one
    similarity transform per sample, drawn together for the batch
    (``sample_transforms``).  Returns None when the per-item path is needed
    (jitter or generated-sample noise on)."""
    aug = dataset.cfg.augmentation
    if isinstance(aug, dict) and (
            aug.get("pc_augm_jitter", False)
            or aug.get("noise_magnitude_for_generated_samples", 0) > 0):
        return None

    idx = np.asarray(idx, np.int64)
    batch = {"partial": dataset.input_data[idx],
             "complete": dataset.gt_data[dataset.partial_to_gt[idx]]}
    if dataset.generated_sample is not None:
        batch["generated"] = dataset.generated_sample[idx]
    if dataset.generated_XT is not None:
        batch["XT"] = dataset.generated_XT[idx]

    B = len(idx)
    if isinstance(aug, dict):
        M, t, M_inv = sample_transforms(B, aug, dataset.rng)
        for k in list(batch.keys()):
            batch[k] = _apply_similarity(batch[k], M, t)
        if dataset.cfg.return_augmentation_params:
            batch["M_inv"] = M_inv
            batch["translation"] = t[:, None, :]
    elif dataset.cfg.return_augmentation_params:
        batch["M_inv"] = np.broadcast_to(np.eye(3, dtype=np.float32), (B, 3, 3)).copy()
        batch["translation"] = np.zeros((B, 1, 3), np.float32)
    batch["label"] = dataset.labels[idx]
    return batch
