"""The port's file-driven pipeline end to end on the CPU, through its CLIs:
``preprocess_cli`` (its h5 bit-equal to the JAX package's on the same
input) -> ``train_cli`` (DDPM) -> ``generate_cli`` on the test set and on
the train set (bare and two augmented trials) -> ``train_cli`` on a refine
config that reads the generated h5 -> ``generate_cli`` on it.  Checks the
files and their taxonomy, and that the in-loop eval evaluates
``num_samples_tested`` clouds, not the whole split."""

import copy
import json
import os
import pickle
import shutil
import subprocess
import sys

import h5py
import numpy as np

from point_diffusion_refinement_tpu.cli import preprocess_cli as j_preprocess_cli
from point_diffusion_refinement_tpu.data import write_mvp_style_h5
from point_diffusion_refinement_tpu_torch.cli import generate_cli, preprocess_cli, train_cli
from point_diffusion_refinement_tpu_torch.config import tiny_pointnet_config
from point_diffusion_refinement_tpu_torch.train import find_max_epoch
from point_diffusion_refinement_tpu_torch.train.loop import local_experiment_path
from torch_threads import one_torch_thread  # noqa: F401

N, F, M = 32, 2, 32  # coarse points, upsampling, mirrored partial points
TESTED = 10  # num_samples_tested, of 52 clouds a split
FAST = ["--fast_sampling", "--fast_sampling_length", "4"]
FAST_TAG = ("fast_sampling/fast_sampling_config_length_4_sampling_method_var_schedule_"
            "quadratic_kappa_0.5")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ddpm_config(data_dir, root):
    return {
        "diffusion_config": {"T": 8, "beta_0": 1e-4, "beta_T": 0.02},
        "pointnet_config": {**tiny_pointnet_config(), "model_name": "tiny"},
        "train_config": {"task": "completion", "root_directory": root, "n_epochs": 1,
                         "epochs_per_ckpt": 1, "iters_per_logging": 1, "compute_emd": False,
                         "eval_sampling_steps": 2, "shuffle_seed": 0},
        "mvp_dataset_config": {
            "data_dir": data_dir, "npoints": N, "scale": 1, "batch_size": 16,
            "eval_batch_size": 4, "num_samples_tested": TESTED,
            "test_trainset_during_eval": True, "use_mirrored_partial_input": True,
            "number_partial_points": M,
            "augmentation": {"pc_augm_scale": 1.2, "pc_augm_rot": True, "pc_rot_scale": 90,
                             "pc_augm_mirror_prob": 0.5, "translation_magnitude": 0.1}},
        "gen_config": {"ckpt_path": "logs/checkpoint"},
    }


def _refine_config(ddpm, generated_sample_path):
    cfg = copy.deepcopy(ddpm)
    cfg["pointnet_config"].update(include_t=False, point_upsample_factor=F,
                                  include_displacement_center_to_final_output=False)
    cfg["train_config"].update(task="refine_completion", only_save_the_best_model=True)
    cfg["mvp_dataset_config"].update(
        npoints=N * F, include_generated_samples=True,
        generated_sample_path=generated_sample_path, randomly_select_generated_samples=True,
        augmentation={"pc_augm_scale": 1.01, "pc_augm_rot": True, "pc_rot_scale": 3.0,
                      "pc_augm_mirror_prob": 0.5, "translation_magnitude": 0.005,
                      "noise_magnitude_for_generated_samples": 0.01})
    # the reference schema: refine keys override the sections' own
    cfg["refine_config"] = {"exp_name": "cli", "cd_loss_type": "cd_t",
                            "output_scale_factor": 0.001, "epochs_per_ckpt": 1,
                            "n_epochs": 2, "num_samples_tested": TESTED // 2}
    return cfg


def _write(path, cfg):
    with open(path, "w") as f:
        json.dump(cfg, f)
    return str(path)


def _evaluated(eval_dir, it, tag=""):
    with open(os.path.join(eval_dir, f"eval_result_ckpt_{it}_rank_0{tag}.pkl"), "rb") as f:
        return len(pickle.load(f)["cd_distance"])


def test_preprocess_cli_matches_jax(tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    write_mvp_style_h5(a, num_shapes=1, npoints=N, partial_points=24)
    shutil.copytree(a, b)
    args = ["--num_points", str(M), "20", "--batch_size", "16"]
    j_preprocess_cli.main(["--data_dir", a] + args)
    preprocess_cli.main(["--data_dir", b, "--device", "cpu"] + args)
    sub = "mirror_and_concated_partial"
    names = sorted(os.listdir(os.path.join(b, sub)))
    assert names == sorted(os.listdir(os.path.join(a, sub))) and len(names) == 4
    for name in names:
        with h5py.File(os.path.join(a, sub, name), "r") as fa, \
                h5py.File(os.path.join(b, sub, name), "r") as fb:
            got, want = np.array(fb["data"]), np.array(fa["data"])
            assert got.dtype == want.dtype and got.shape == want.shape == (52, got.shape[1], 4)
            np.testing.assert_array_equal(got, want)


def test_cli_chain(tmp_path):
    data_dir, root = str(tmp_path / "mvp"), str(tmp_path / "exp")
    for npoints in (N, N * F):  # the GT at both resolutions (parametric shapes)
        write_mvp_style_h5(data_dir, num_shapes=1, npoints=npoints, partial_points=24)
    preprocess_cli.main(["--data_dir", data_dir, "--num_points", str(M), "--device", "cpu"])

    ddpm = _ddpm_config(data_dir, root)
    ddpm_path = _write(tmp_path / "config_ddpm.json", ddpm)
    result = train_cli.main(["-c", ddpm_path, "--max_steps", "4", "--device", "cpu",
                             "--fused_gather", "--fused_sa"])
    assert result["n_iter"] == 3 and np.isfinite(result["losses"]).all()
    assert len(result["step_seconds"]) == 3
    assert all(0 <= b <= t for b, t in zip(result["batch_seconds"], result["step_seconds"]))
    exp = os.path.join(root, local_experiment_path(ddpm))
    assert find_max_epoch(os.path.join(exp, "logs", "checkpoint"), "all") == [3, 2]
    # the in-loop eval at the checkpoint of iteration 2 evaluated a subset
    # of num_samples_tested clouds of each split, not the 52 of the split
    assert result["eval_records"]["iter"] == [2]
    assert _evaluated(os.path.join(exp, "eval_result"), 2) == TESTED
    assert _evaluated(os.path.join(exp, "eval_result"), 2, "_trainset") == TESTED

    common = ["-c", ddpm_path, "--device", "cpu", "--no_emd"] + FAST
    (test_res,) = generate_cli.main(common + ["--batch_size", "16"])
    generate_cli.main(common + ["--phase", "test_trainset"])
    trials = generate_cli.main(common + ["--phase", "test_trainset", "--num_trials", "2",
                                         "--augment_data_during_generation"])
    assert test_res.generated.shape == (52, N, 3) and len(trials) == 2
    gen_rel = os.path.join("generated_samples", local_experiment_path(ddpm), "ckpt_3", FAST_TAG)
    gen_dir = os.path.join(data_dir, gen_rel)
    for sub in ("test", "train", "trial_1/train", "trial_2/train"):
        assert sorted(os.listdir(os.path.join(gen_dir, sub))) == [
            "eval_result.pkl", f"mvp_generated_data_{N}pts.h5"], sub

    refine = _refine_config(ddpm, gen_rel)
    refine_path = _write(tmp_path / "config_refine.json", refine)
    rresult = train_cli.main(["-c", refine_path, "--max_steps", "4", "--device", "cpu"])
    assert np.isfinite(rresult["losses"]).all() and len(rresult["losses"]) == 4
    rexp = os.path.join(root, local_experiment_path(refine))
    assert rexp.endswith(os.path.join("T8_betaT0.02_tiny", "refine_exp_cli"))
    ckpts = os.listdir(os.path.join(rexp, "logs", "checkpoint"))
    assert any(c.endswith("_best_cd") for c in ckpts)
    assert rresult["eval_records"]["iter"] == [2]
    assert _evaluated(os.path.join(rexp, "eval_result"), 2) == TESTED // 2

    it = find_max_epoch(os.path.join(rexp, "logs", "checkpoint"), "max")
    (refined,) = generate_cli.main(["-c", refine_path, "--device", "cpu", "--no_emd"])
    assert refined.generated.shape == (52, N * F, 3) and np.isfinite(refined.avg_cd)
    out = os.path.join(data_dir, "generated_samples", local_experiment_path(refine),
                       f"ckpt_{it}", "test")
    assert sorted(os.listdir(out)) == ["eval_result.pkl", f"mvp_generated_data_{N * F}pts.h5"]


def test_in_loop_eval_takes_num_samples_tested_of_synthetic_data(tmp_path):
    """The in-memory dataset of a ``synthetic`` spec honours the eval subset
    too: 20 clouds a split, 6 evaluated (the whole split before the
    repair)."""
    cfg = _ddpm_config(str(tmp_path / "mvp"), str(tmp_path))
    cfg["mvp_dataset_config"] = {
        "data_dir": str(tmp_path / "mvp"), "batch_size": 8, "eval_batch_size": 4,
        "num_samples_tested": 6, "npoints": N,
        "synthetic": dict(num_samples=20, npoints=N, partial_points=24, seed=3, mirror_to=M)}
    path = _write(tmp_path / "c.json", cfg)
    result = train_cli.main(["-c", path, "--device", "cpu"])
    exp = os.path.join(str(tmp_path), local_experiment_path(cfg))
    assert result["eval_records"]["iter"] == [1]
    assert _evaluated(os.path.join(exp, "eval_result"), 1) == 6
    # generation over it: never augmented, so the identity transform undoes it
    (res,) = generate_cli.main(["-c", path, "--device", "cpu", "--no_emd", "--phase",
                                "test_trainset", "--augment_data_during_generation",
                                "--num_samples_tested", "6"] + FAST)
    assert res.generated.shape == (6, N, 3) and np.isfinite(res.avg_cd)


def test_cli_modules_import_standalone():
    """``python -m`` imports each CLI first, before pytest's import order
    can hide a circular import between ``train/`` and ``sample/``."""
    for name in ("train_cli", "generate_cli"):
        out = subprocess.run(
            [sys.executable, "-m", f"point_diffusion_refinement_tpu_torch.cli.{name}", "-h"],
            cwd=REPO, capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert "--device" in out.stdout
