"""The two-stage demo (``cli/two_stage_demo.py``) on the CPU at tiny widths:
T = 4, 2 DDPM + 2 refine steps, a 64-point GT with 96 x 4 mirrored
partials, one shape and one novel shape a split (52 clouds), one augmented
train-set trial; in memory (the route of the H100 machine, which has no
``h5py``; 8 test clouds) and through the JAX demo's h5 files.  The summary
carries every key of the JAX package's record
(``tools/demo_out/two_stage_demo.json``) and the port's additions, its CDs
and losses are finite, the generated clouds have their shapes, and nothing
is written inside the repository."""

import json
import os

import numpy as np
import pytest

from point_diffusion_refinement_tpu_torch.cli.two_stage_demo import (
    AugmentedArrays,
    DDPM_AUGMENTATION,
    demo_configs,
    run_demo,
)
from point_diffusion_refinement_tpu_torch.config import tiny_pointnet_config
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, P = 64, 96


def _files():
    return {os.path.join(d, f) for d, dirs, files in os.walk(REPO)
            for f in files if ".git" not in d.split(os.sep) and "__pycache__" not in d}


@pytest.fixture(scope="module", params=[True, False], ids=["in_memory", "h5_files"])
def demo(tmp_path_factory, request):
    work = tmp_path_factory.mktemp("demo")
    before = _files()
    art = {}
    summary = run_demo(steps_ddpm=2, steps_refine=2, T=4, num_shapes=1, batch_size=8,
                       workdir=str(work / "work"), out_dir=str(work / "out"), device="cpu",
                       pointnet_config={**tiny_pointnet_config(), "compute_dtype": "float32"},
                       npoints=N, partial_points=P, num_tested=8, trainset_trials=1,
                       in_memory=request.param, artifacts=art)
    return summary, art, work, _files() - before, 8 if request.param else 52


def test_summary_keys_and_values(demo):
    summary, _, work, _, n_test = demo
    with open(os.path.join(REPO, "tools", "demo_out", "two_stage_demo.json")) as f:
        jax_keys = set(json.load(f))
    assert jax_keys <= set(summary)
    assert set(summary["stage_seconds"]) == {"data", "ddpm_train", "coarse_generation",
                                             "refine_train", "refine_eval"}
    for split in summary["train_seconds"].values():  # two steps: none after the first two
        assert split["later_steps"] == 0 and split["later_step_median_ms"] is None
        assert 0 <= split["batch_assembly"] <= split["first_two_steps"]
        assert split["outside_steps"] >= -0.02  # stage seconds rounded to 0.01
    for k in ("coarse_cd_t_2048", "refined_cd_t_4096", "ddpm_final_loss",
              "ddpm_loss_first10", "ddpm_loss_last10"):
        assert np.isfinite(summary[k]), k
    assert summary["refined_beats_coarse"] == (summary["refined_cd_t_4096"]
                                               < summary["coarse_cd_t_2048"])
    assert (summary["steps_ddpm"], summary["steps_refine"], summary["T"]) == (2, 2, 4)
    assert summary["devices"] == "cpu" and summary["card"] is None
    assert (summary["num_train"], summary["num_test"], summary["trainset_trials"]) == \
        (52, n_test, 1)
    with open(work / "out" / "two_stage_demo.json") as f:
        assert json.load(f) == summary


def test_clouds_and_losses(demo):
    _, art, _, _, n_test = demo
    assert art["coarse"].shape == art["coarse_gt"].shape == (n_test, N, 3)
    assert art["refined"].shape == art["refined_gt"].shape == (n_test, 2 * N, 3)
    assert art["trials"][0].generated.shape == (52, N, 3)
    for k in ("coarse", "refined"):
        assert np.isfinite(art[k]).all(), k
    assert len(art["ddpm"]["losses"]) == 2 and len(art["refine"]["losses"]) == 2
    assert np.isfinite(art["ddpm"]["losses"]).all()


def test_nothing_written_in_the_repo(demo):
    assert demo[3] == set()


def test_augmented_arrays_undo():
    rng = np.random.default_rng(0)
    complete = rng.uniform(-1, 1, (3, 16, 3)).astype(np.float32)
    partial = np.concatenate([complete[:, :8], np.ones((3, 8, 1), np.float32)], -1)
    ds = AugmentedArrays(DDPM_AUGMENTATION, return_augmentation_params=True, seed=0,
                         complete=complete, partial=partial, label=np.arange(3))
    item = ds[1]
    back = (item["complete"] - item["translation"]) @ item["M_inv"]
    np.testing.assert_allclose(back, complete[1], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(item["partial"][:, 3], 1.0)  # the flag passes
    assert item["label"] == 1


def test_configs_follow_the_jax_demo():
    ddpm, refine = demo_configs("r", "d", 100, 8, 2048, 3072)
    assert ddpm["pointnet_config"]["compute_dtype"] == "bfloat16"
    rp, rm = refine["pointnet_config"], refine["mvp_dataset_config"]
    assert (rp["include_t"], rp["point_upsample_factor"]) == (False, 2)
    assert rm["npoints"] == 4096 and rm["randomly_select_generated_samples"]
    assert refine["refine_config"]["cd_loss_type"] == "cd_t"
    assert rm["augmentation"]["noise_magnitude_for_generated_samples"] == 0.01
