"""The port's generation pipeline against the JAX package's.

``generation_save_dir`` must give the same string in every branch.  The
refine task is deterministic (one forward a batch), so with the same
float32 weights (the port's seeded weights carried into the JAX model as a
Flax tree, handed to both as ``state_override``) and the same h5 bytes the
two packages' metrics agree within ``tests/test_torch_refine.py``'s float32
tolerance and write the same file tree.  Coarse generation draws its noise
from each package's own generator, so there only the tree and finite
metrics are compared.  ``gather_generated_results`` merges the same rank
directories into the same h5 and pickle.
"""

import os
import pickle
import shutil

import h5py
import numpy as np
import pytest
import torch

from point_diffusion_refinement_tpu.config import tiny_pointnet_config
from point_diffusion_refinement_tpu.data import write_mvp_style_h5
from point_diffusion_refinement_tpu.sample import pipeline as jpipe
from point_diffusion_refinement_tpu_torch.models import PointNet2CloudCondition
from point_diffusion_refinement_tpu_torch.parallel import make_mesh
from point_diffusion_refinement_tpu_torch.sample import pipeline as ppipe
from point_diffusion_refinement_tpu_torch.train import create_train_state
from point_diffusion_refinement_tpu_torch.utils.weights import state_dict_to_flax
from torch_threads import one_torch_thread  # noqa: F401

F32_TOL = dict(rtol=1e-4, atol=2e-5)  # tests/test_torch_refine.py's
N, F, M = 32, 2, 32  # coarse points, upsampling, mirrored partial points
GEN = "generated_samples/ddpm/ckpt_7"


def _randomize(model, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("scale"):
                p.copy_(1.0 + 0.2 * torch.randn(p.shape, generator=g))
            elif name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
    return model


def _config(data_dir, task):
    refine = task == "refine_completion"
    pc = {**tiny_pointnet_config(include_t=not refine), "model_name": "tiny",
          "compute_dtype": "float32"}
    if refine:
        pc.update(point_upsample_factor=F, include_displacement_center_to_final_output=False)
    return {
        "diffusion_config": {"T": 8, "beta_0": 1e-4, "beta_T": 0.02},
        "pointnet_config": pc,
        "train_config": {"task": task, "root_directory": "unused"},
        "mvp_dataset_config": {
            "data_dir": data_dir, "npoints": N * F if refine else N, "scale": 1,
            "eval_batch_size": 16, "use_mirrored_partial_input": True,
            "number_partial_points": M, "include_generated_samples": refine,
            "generated_sample_path": GEN,
            "augmentation": {"pc_augm_scale": 1.2, "pc_augm_rot": True, "pc_rot_scale": 90,
                             "pc_augm_mirror_prob": 0.5, "translation_magnitude": 0.1}},
        "refine_config": {"exp_name": "sub/r", "output_scale_factor": 0.001},
    }


def _h5(path, data):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with h5py.File(path, "w") as f:
        f.create_dataset("data", data=data)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mvp"))
    rng = np.random.default_rng(3)
    for npoints in (N, N * F):  # the GT at both resolutions (parametric shapes)
        write_mvp_style_h5(d, num_shapes=1, npoints=npoints, partial_points=24)
    n = 2 * 26  # one shape and one novel shape a split
    for split in ("train", "test"):
        mirrored = np.concatenate([rng.uniform(-0.5, 0.5, (n, M, 3)),
                                   rng.integers(0, 2, (n, M, 1)) * 2.0 - 1.0], axis=-1)
        _h5(f"{d}/mirror_and_concated_partial/mvp_{split}_input_mirror_and_concat_{M}pts.h5",
            mirrored.astype(np.float32))
        _h5(f"{d}/{GEN}/{split}/mvp_generated_data_{N}pts.h5",
            rng.uniform(-0.5, 0.5, (n, N, 3)).astype(np.float32))
    return d


def _tree(root):
    return sorted(os.path.relpath(os.path.join(dp, f), root)
                  for dp, _, files in os.walk(root) for f in files)


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("task", ["completion", "refine_completion"])
@pytest.mark.parametrize("fast", [None, {"length": 50, "sampling_method": "var",
                                         "schedule": "quadratic", "kappa": 0.5}])
@pytest.mark.parametrize("trial", [None, 3])
@pytest.mark.parametrize("phase", ["test", "test_trainset"])
def test_generation_save_dir_matches(task, fast, trial, phase):
    cfg = _config("/data/mvp", task)
    for base in (None, "/elsewhere"):
        kw = dict(fast_sampling=fast is not None, fast_sampling_config=fast,
                  trial_index=trial, phase=phase, base_dir=base)
        got = ppipe.generation_save_dir(cfg, 12, **kw)
        assert got == jpipe.generation_save_dir(cfg, 12, **kw)
    assert got.startswith("/elsewhere/T8_betaT0.02_tiny/")
    assert got.endswith("/test" if phase == "test" else "/train")


def test_refine_generation_matches_jax(data_dir, tmp_path):
    cfg = _config(data_dir, "refine_completion")
    port = _randomize(PointNet2CloudCondition.from_config(
        cfg["pointnet_config"], device="cpu", seed=21), 21)
    params = state_dict_to_flax(port.state_dict())
    kw = dict(phase="test", save_generated=True, compute_emd=True)
    (jres,) = jpipe.run_generation(cfg, state_override=params,
                                   base_save_dir=str(tmp_path / "jax"), **kw)
    (pres,) = ppipe.run_generation(cfg, state_override=create_train_state(port),
                                   base_save_dir=str(tmp_path / "port"), device="cpu", **kw)
    assert len(pres.metrics["cd_distance"]) == 52
    np.testing.assert_allclose(pres.avg_cd, jres.avg_cd, **F32_TOL)
    np.testing.assert_allclose(pres.avg_emd, jres.avg_emd, **F32_TOL)
    for k, v in jres.metrics.items():
        np.testing.assert_allclose(pres.metrics[k], np.asarray(v), **F32_TOL, err_msg=k)

    tree = _tree(tmp_path / "port")
    assert tree == _tree(tmp_path / "jax")
    leaf = os.path.join("T8_betaT0.02_tiny", "sub", "refine_exp_r", "ckpt_0", "test")
    assert tree == [os.path.join(leaf, "eval_result.pkl"),
                    os.path.join(leaf, f"mvp_generated_data_{N * F}pts.h5")]
    for name in tree:
        a, b = tmp_path / "jax" / name, tmp_path / "port" / name
        if name.endswith(".h5"):
            with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
                np.testing.assert_allclose(np.array(fb["data"]), np.array(fa["data"]),
                                           **F32_TOL)
        else:
            ja, pb = _load(a), _load(b)
            assert sorted(ja) == sorted(pb)
            np.testing.assert_array_equal(pb["labels"], ja["labels"])
            np.testing.assert_allclose(pb["avg_cd"], ja["avg_cd"], **F32_TOL)


def test_coarse_generation_trials_tree(data_dir, tmp_path):
    """Augmented train-set generation over two trials at T = 8: the tree
    the JAX package's taxonomy and file names give, finite metrics, other
    noise in each trial.  (The JAX run itself is left out: it compiles its
    sampler anew for each trial.)"""
    cfg = _config(data_dir, "completion")
    port = _randomize(PointNet2CloudCondition.from_config(
        cfg["pointnet_config"], device="cpu", seed=5), 5)
    base = str(tmp_path / "port")
    results = ppipe.run_generation(
        cfg, state_override=port, device="cpu", base_save_dir=base, phase="test_trainset",
        num_trials=2, augment_data_during_generation=True, compute_emd=False,
        num_samples_tested=20)
    want = sorted(
        os.path.relpath(os.path.join(jpipe.generation_save_dir(
            cfg, 0, trial_index=i, phase="test_trainset", base_dir=base), f), base)
        for i in (1, 2) for f in ("eval_result.pkl", f"mvp_generated_data_{N}pts.h5"))
    assert _tree(base) == want
    assert len(results) == 2
    for res in results:
        assert res.generated.shape == (20, N, 3) and np.isfinite(res.generated).all()
        assert all(np.isfinite(v).all() and len(v) == 20 for v in res.metrics.values())
    assert not np.array_equal(results[0].generated, results[1].generated)


def test_gather_generated_results_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    for r, n in enumerate((5, 3)):
        d = tmp_path / "a" / f"rank_{r}"
        _h5(str(d / "mvp_generated_data_16pts.h5"), rng.standard_normal((n, 16, 3)))
        _h5(str(d / "mvp_generated_data_16pts_T5.h5"), rng.standard_normal((n, 16, 3)))
        metrics = {k: rng.random(n) for k in ("cd_distance", "emd_distance", "cd_p", "f1")}
        with open(d / "eval_result.pkl", "wb") as f:
            pickle.dump({"avg_cd": 0.0, "avg_emd": 0.0, "metrics": metrics,
                         "labels": rng.integers(0, 16, n)}, f)
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    got = ppipe.gather_generated_results(str(tmp_path / "b"), 2, delete_rank_dirs=True)
    want = jpipe.gather_generated_results(str(tmp_path / "a"), 2)
    assert os.path.basename(got) == os.path.basename(want)
    assert sorted(os.listdir(tmp_path / "b")) == [
        "eval_result.pkl", "mvp_generated_data_16pts.h5", "mvp_generated_data_16pts_T5.h5"]
    for name in os.listdir(tmp_path / "b"):
        if name.endswith(".h5"):
            with h5py.File(tmp_path / "a" / name, "r") as fa, \
                    h5py.File(tmp_path / "b" / name, "r") as fb:
                assert fb["data"].shape[0] == 8
                np.testing.assert_array_equal(np.array(fb["data"]), np.array(fa["data"]))
    ja, pb = _load(tmp_path / "a" / "eval_result.pkl"), _load(tmp_path / "b" / "eval_result.pkl")
    assert ja["avg_cd"] == pb["avg_cd"] and ja["avg_emd"] == pb["avg_emd"]
    np.testing.assert_array_equal(ja["labels"], pb["labels"])
    for k in ja["metrics"]:
        np.testing.assert_array_equal(ja["metrics"][k], pb["metrics"][k])
    assert ppipe.gather_generated_results(str(tmp_path / "b"), 2) is None  # rank dirs gone


def test_missing_checkpoint_and_mesh_raise(data_dir, tmp_path):
    cfg = _config(data_dir, "completion")
    cfg["train_config"]["root_directory"] = str(tmp_path)
    for it in ("max", "best", 3):
        with pytest.raises(FileNotFoundError):
            ppipe.run_generation(cfg, ckpt_iter=it, device="cpu")
    with pytest.raises(FileNotFoundError):  # the one-process mesh reads the same checkpoints
        ppipe.run_generation(cfg, mesh=make_mesh(device="cpu"))
