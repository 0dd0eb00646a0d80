"""The port's MVP dataset and batches against the JAX package's, on the same
h5 bytes (written by the JAX package's ``write_mvp_style_h5``).

Both datasets draw from two streams seeded with the config's seed: the JAX
package from the module ``random`` (which these tests seed with
``random.seed``) and a numpy generator, the port from its own
``random.Random`` and numpy generator, in the same order.  The dataset arrays must be bit-equal.
Batches: the batched collation (the JAX package's through its C++ loader
where ``g++`` builds it, numpy otherwise) against the port's numpy, within
1e-6; the per-item path (generated-sample noise on) likewise.
"""

import os
import random

import h5py
import numpy as np
import pytest

from point_diffusion_refinement_tpu.data import MVPDataset as JDataset
from point_diffusion_refinement_tpu.data import MVPDatasetConfig as JConfig
from point_diffusion_refinement_tpu.data import iterate_batches as j_iterate
from point_diffusion_refinement_tpu.data import write_mvp_style_h5
from point_diffusion_refinement_tpu.train.loop import make_dataset as j_make_dataset
from point_diffusion_refinement_tpu_torch.data import (
    MVPDataset,
    MVPDatasetConfig,
    get_batch_fast,
    iterate_batches,
)
from point_diffusion_refinement_tpu_torch.train.loop import make_dataset
from torch_threads import one_torch_thread  # noqa: F401

NPTS, PARTIAL, SHAPES = 32, 24, 5  # 5 + 2 novel GT shapes: 3 ranks pad the last
T_STEP = 5
GEN = "generated_samples/exp/ckpt_3"
DDPM_AUG = {"pc_augm_scale": 1.2, "pc_augm_rot": True, "pc_rot_scale": 90,
            "pc_augm_mirror_prob": 0.5, "pc_augm_jitter": False,
            "translation_magnitude": 0.1, "noise_magnitude_for_generated_samples": 0}
REFINE_AUG = {"pc_augm_scale": 1.01, "pc_augm_rot": True, "pc_rot_scale": 3.0,
              "pc_augm_mirror_prob": 0.5, "pc_augm_jitter": False,
              "translation_magnitude": 0.005, "noise_magnitude_for_generated_samples": 0.01}
ARRAYS = ("input_data", "gt_data", "labels", "partial_to_gt", "generated_sample",
          "generated_XT")


def _h5(path, data):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with h5py.File(path, "w") as f:
        f.create_dataset("data", data=data)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mvp"))
    write_mvp_style_h5(d, num_shapes=SHAPES, npoints=NPTS, partial_points=PARTIAL)
    rng = np.random.default_rng(7)
    n = (SHAPES + 2) * 26  # items of a split with the novel inputs
    for split in ("train", "test"):
        mirrored = np.concatenate([rng.uniform(-0.5, 0.5, (n, 40, 3)),
                                   rng.integers(0, 2, (n, 40, 1)) * 2.0 - 1.0], axis=-1)
        _h5(f"{d}/mirror_and_concated_partial/mvp_{split}_input_mirror_and_concat_40pts.h5",
            mirrored.astype(np.float32))
        # generated clouds: the bare directory and two trials, each its own
        for sub in ("", "trial_1", "trial_2"):
            _h5(os.path.join(d, GEN, sub, split, f"mvp_generated_data_{NPTS}pts.h5"),
                rng.uniform(-0.5, 0.5, (n, NPTS, 3)).astype(np.float32))
        _h5(f"{d}/xt/{split}/mvp_generated_data_{NPTS}pts_T{T_STEP}.h5",
            rng.standard_normal((n, NPTS, 3)).astype(np.float32))
    return d


def _pair(data_dir, seed, **kw):
    kw = dict(data_dir=data_dir, npoints=NPTS, seed=seed, **kw)
    random.seed(seed)
    return JDataset(JConfig(**kw)), MVPDataset(MVPDatasetConfig(**kw))


def _assert_same(j, p):
    for name in ARRAYS:
        a, b = getattr(j, name), getattr(p, name)
        if a is None:
            assert b is None, name
        else:
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)


CASES = {
    "novel_input": dict(train=True),
    "test_split": dict(train=False),
    "novel_input_only": dict(novel_input_only=True),
    "no_novel_input": dict(novel_input=False),
    "mirrored": dict(use_mirrored_partial_input=True, number_partial_points=40),
    "generated_random_trials": dict(include_generated_samples=True, generated_sample_path=GEN,
                                    randomly_select_generated_samples=True),
    "world3_rank2_padded": dict(world_size=3, rank=2, include_generated_samples=True,
                                generated_sample_path=GEN),
    "world3_rank0": dict(world_size=3, rank=0),
    "world3_rank2_eval_unpadded": dict(world_size=3, rank=2, train=False,
                                       append_samples_to_last_rank=False),
    "random_subsample": dict(random_subsample=True, num_samples=30,
                             include_generated_samples=True, generated_sample_path=GEN,
                             randomly_select_generated_samples=True),
    "scale_1.2_mirrored": dict(scale=1.2, use_mirrored_partial_input=True,
                               number_partial_points=40),
    "precomputed_XT": dict(load_pre_computed_XT=True, T_step=T_STEP, random_subsample=True,
                           num_samples=17),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_dataset_arrays_bit_equal(data_dir, case):
    kw = dict(CASES[case])
    if "XT" in case:
        kw["XT_folder"] = os.path.join(data_dir, "xt")
    for seed in (0, 1, 2):
        j, p = _pair(data_dir, seed, **kw)
        _assert_same(j, p)
        assert len(p) == len(j)
    if case == "world3_rank2_padded":  # 7 GT shapes over 3 ranks: 2 drawn to pad
        assert p.gt_data.shape[0] == 3 and len(p) == 3 * 26
    if case == "scale_1.2_mirrored":  # xyz scaled by 2.4, the +-1 flag not
        assert set(np.unique(p.input_data[..., 3])) == {-1.0, 1.0}
        assert np.abs(p.input_data[..., :3]).max() > 1.0


def test_random_trials_reach_every_directory(data_dir):
    seen = set()
    for seed in range(12):
        j, p = _pair(data_dir, seed, include_generated_samples=True, generated_sample_path=GEN,
                     randomly_select_generated_samples=True)
        _assert_same(j, p)
        seen.add(p.generated_sample[0, 0, 0])
    assert len(seen) == 3  # the bare directory and both trials


def _compare_batches(jb, pb, keys):
    assert sorted(jb) == sorted(pb)
    for k in keys:
        if k == "label":
            np.testing.assert_array_equal(jb[k], pb[k])
        else:
            np.testing.assert_allclose(pb[k], jb[k], rtol=0, atol=1e-6, err_msg=k)


def test_batched_augmented_batches_match(data_dir):
    kw = dict(augmentation=DDPM_AUG, return_augmentation_params=True,
              use_mirrored_partial_input=True, number_partial_points=40,
              include_generated_samples=True, generated_sample_path=GEN)
    j, p = _pair(data_dir, 3, **kw)
    assert get_batch_fast(p, np.arange(4)) is not None  # the batched path
    j, p = _pair(data_dir, 3, **kw)
    jbs = list(j_iterate(j, 16, shuffle=True, seed=5))
    pbs = list(iterate_batches(p, 16, shuffle=True, seed=5))
    assert len(jbs) == len(pbs) == -(-len(p) // 16)
    for jb, pb in zip(jbs, pbs):
        _compare_batches(jb, pb, ("partial", "complete", "generated", "label", "M_inv",
                                  "translation"))
        np.testing.assert_array_equal(pb["partial"][..., 3], np.sign(pb["partial"][..., 3]))
    # the transforms undo: (x - translation) @ M_inv gives back the raw rows
    idx = np.random.default_rng(5).permutation(len(p))[:16]
    rec = np.einsum("bnc,bcd->bnd", pbs[0]["complete"] - pbs[0]["translation"],
                    pbs[0]["M_inv"])
    np.testing.assert_allclose(rec, p.gt_data[p.partial_to_gt[idx]], atol=2e-5)


def test_identity_transform_without_augmentation(data_dir):
    j, p = _pair(data_dir, 0, return_augmentation_params=True, train=False)
    jb = next(j_iterate(j, 8, shuffle=False))
    pb = next(iterate_batches(p, 8, shuffle=False))
    _compare_batches(jb, pb, ("partial", "complete", "label", "M_inv", "translation"))
    np.testing.assert_array_equal(pb["M_inv"], np.broadcast_to(np.eye(3), (8, 3, 3)))
    assert not pb["translation"].any()


def test_per_item_batches_with_generated_noise_match(data_dir):
    kw = dict(augmentation=REFINE_AUG, return_augmentation_params=True,
              include_generated_samples=True, generated_sample_path=GEN,
              randomly_select_generated_samples=True)
    j, p = _pair(data_dir, 4, **kw)
    assert get_batch_fast(p, np.arange(4)) is None  # the per-item path
    j, p = _pair(data_dir, 4, **kw)
    for jb, pb in zip(j_iterate(j, 32, shuffle=True, seed=1, drop_last=True),
                      iterate_batches(p, 32, shuffle=True, seed=1, drop_last=True)):
        _compare_batches(jb, pb, ("partial", "complete", "generated", "label", "M_inv",
                                  "translation"))


@pytest.mark.parametrize("phase", ["train", "test", "test_trainset"])
def test_make_dataset_phases(data_dir, phase):
    """The phase picks the split, the augmentation and the padding as the
    JAX package's ``make_dataset`` does; the eval subset has its size."""
    cfg = {"data_dir": data_dir, "npoints": NPTS, "augmentation": DDPM_AUG, "scale": 1,
           "augment_data_during_generation": phase == "test_trainset",
           "include_generated_samples": True, "generated_sample_path": GEN,
           "randomly_select_generated_samples": True}
    j = j_make_dataset(cfg, phase, 0, 1)
    p = make_dataset(cfg, phase, 0, 1)
    for name in ("gt_data", "labels", "partial_to_gt"):
        np.testing.assert_array_equal(getattr(p, name), getattr(j, name))
    for name in ("train", "augmentation", "append_samples_to_last_rank",
                 "randomly_select_generated_samples", "world_size", "rank"):
        assert getattr(p.cfg, name) == getattr(j.cfg, name), name
    assert (p.cfg.augmentation is not None) == (phase != "test")
    sub = make_dataset(cfg, phase, eval_subset=9)
    assert len(sub) == 9 and sub.cfg.random_subsample
