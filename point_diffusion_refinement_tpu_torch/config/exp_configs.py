"""The shipped experiment configurations, as plain dicts.

The port's own copy of the JAX package's ``config/exp_configs.py`` (same
hyperparameters, native lists).  Seven experiments:
  * ddpm            - train the conditional DDPM (T=1000)
  * ddpm_avg_max    - avg_max pooling + coarse-level global attention variant
  * refine          - refinement net on 10-trial DDPM generations (2048 pts)
  * refine_fast50   - refinement on FastDPM length-50 generations
  * upsample_4096 / upsample_8192 / upsample_16384 - refine + upsample

``write_all(dir)`` writes them as JSON files.
"""

from __future__ import annotations

import copy
import json
import os

from .loader import DEFAULT_POINTNET_CONFIG

_REFINE_AUGMENTATION = {
    "pc_augm_scale": 1.01,
    "pc_augm_rot": True,
    "pc_rot_scale": 3.0,
    "pc_augm_mirror_prob": 0.5,
    "pc_augm_jitter": False,
    "translation_magnitude": 0.005,
    "noise_magnitude_for_generated_samples": 0.01,
}

_DDPM_AUGMENTATION = {
    "pc_augm_scale": 1.2,
    "pc_augm_rot": True,
    "pc_rot_scale": 90,
    "pc_augm_mirror_prob": 0.5,
    "pc_augm_jitter": False,
    "translation_magnitude": 0.1,
    "noise_magnitude_for_generated_samples": 0,
}


def ddpm_config(data_dir: str = "./data/mvp_dataset") -> dict:
    return {
        "diffusion_config": {"T": 1000, "beta_0": 0.0001, "beta_T": 0.02},
        "pointnet_config": {
            **copy.deepcopy(dict(DEFAULT_POINTNET_CONFIG)),
            "compute_dtype": "bfloat16",
        },
        "train_config": {
            "task": "completion",
            "dataset": "mvp_dataset",
            "root_directory": "exp_mvp_dataset_completion",
            "output_directory": "logs/checkpoint",
            "tensorboard_directory": "logs/tensorboard",
            "ckpt_iter": "max",
            "epochs_per_ckpt": 20,
            "iters_per_logging": 50,
            "n_epochs": 350,
            "eval_start_epoch": 0,
            "eval_per_ckpt": 1,
            "learning_rate": 0.0002,
            "loss_type": "mse",
            "conditioned_on_cloud": True,
            "random_shuffle_points": True,
            "only_save_the_best_model": False,
            "compute_emd": True,
            "split_dataset_to_multi_gpus": True,
        },
        "mvp_dataset_config": {
            "dataset": "mvp_dataset",
            "data_dir": data_dir,
            "npoints": 2048,
            "novel_input": True,
            "novel_input_only": False,
            "scale": 1,
            "batch_size": 32,
            "eval_batch_size": 200,
            "num_samples_tested": 1600,
            "test_trainset_during_eval": True,
            "include_generated_samples": False,
            "augmentation": copy.deepcopy(_DDPM_AUGMENTATION),
            "use_mirrored_partial_input": True,
            "number_partial_points": 3072,
        },
        "gen_config": {"ckpt_path": "logs/checkpoint"},
    }


def ddpm_avg_max_config(data_dir: str = "./data/mvp_dataset") -> dict:
    """The avg_max-pooling + coarse-level global-attention DDPM variant.

    The reference README's warm-start pipeline uses a checkpoint trained with
    this configuration (generate_samples.py:273,315:
    T1000_betaT0.02_shape_completion_avg_max_pooling_...); the JSON itself is
    not shipped there, so the architecture deltas are reconstructed from the
    experiment name and the global_attention_setting consumption in
    pointnet2_ssg_sem.py:86-89."""
    cfg = ddpm_config(data_dir)
    pc = cfg["pointnet_config"]
    pc["model_name"] = (
        "shape_completion_avg_max_pooling_mirror_rot_90_scale_1.2_translation_0.2"
    )
    pc["pooling"] = "avg_max"
    pc["global_attention_setting"] = {
        "use_global_attention_module": True,
        "attention_bn": True,
        "last_activation": True,
        "global_attention_layer_index": [2, 3],  # coarsest SA levels only
    }
    aug = cfg["mvp_dataset_config"]["augmentation"]
    if "translation_magnitude" in aug:
        aug["translation_magnitude"] = 0.2
    return cfg


def refine_config(
    data_dir: str = "./data/mvp_dataset",
    generated_sample_path: str = (
        "generated_samples/T1000_betaT0.02_shape_completion_mirror_rot_90_"
        "scale_1.2_translation_0.1/pointnet_ckpt_max"
    ),
    *,
    npoints: int = 2048,
    point_upsample_factor: int = 1,
    cd_loss_thred: float = 0.00058,
    fast_sampling: bool = False,
) -> dict:
    """Refinement experiment (config_refine_standard_attention_10_trials.json
    and the upsample/fast-sampling variants)."""
    cfg = ddpm_config(data_dir)
    pc = cfg["pointnet_config"]
    pc["include_t"] = False
    if point_upsample_factor > 1:
        pc["point_upsample_factor"] = point_upsample_factor
        pc["include_displacement_center_to_final_output"] = False
        pc["intermediate_refined_X_loss_weight"] = 0
    tc = cfg["train_config"]
    tc["task"] = "refine_completion"
    tc["n_epochs"] = 100
    tc["only_save_the_best_model"] = True
    tc["compute_emd"] = npoints <= 2048
    mc = cfg["mvp_dataset_config"]
    mc["npoints"] = npoints
    mc["include_generated_samples"] = True
    mc["generated_sample_path"] = generated_sample_path
    mc["randomly_select_generated_samples"] = True
    mc["augmentation"] = copy.deepcopy(_REFINE_AUGMENTATION)
    name = f"refine_{npoints}pts" + ("_fast50" if fast_sampling else "")
    cfg["refine_config"] = {
        "exp_name": name,
        "cd_loss_type": "cd_p",
        "output_scale_factor": 0.001,
        "epochs_per_ckpt": 10 if point_upsample_factor == 1 else 5,
        "eval_per_ckpt": 1,
        "num_samples_tested": 100000,
        "randomly_select_generated_samples": True,
        "decrease_epochs_per_ckpt_for_fine_tuning": point_upsample_factor == 1,
        "cd_loss_thred": cd_loss_thred,
        "epochs_per_ckpt_fine_tune": 2 if point_upsample_factor == 1 else 5,
    }
    return cfg


EXPERIMENTS = {
    "ddpm": lambda: ddpm_config(),
    "ddpm_avg_max": lambda: ddpm_avg_max_config(),
    "refine": lambda: refine_config(),
    "refine_fast50": lambda: refine_config(
        cd_loss_thred=0.00062, fast_sampling=True,
        generated_sample_path=(
            "generated_samples/T1000_betaT0.02_shape_completion_mirror_rot_90_"
            "scale_1.2_translation_0.1/pointnet_ckpt_max/fast_sampling/"
            "fast_sampling_config_length_50_sampling_method_var_schedule_"
            "quadratic_kappa_0.5"
        ),
    ),
    "upsample_4096": lambda: refine_config(
        npoints=4096, point_upsample_factor=2, cd_loss_thred=0.0006
    ),
    "upsample_8192": lambda: refine_config(
        npoints=8192, point_upsample_factor=4, cd_loss_thred=0.0004
    ),
    "upsample_16384": lambda: refine_config(
        npoints=16384, point_upsample_factor=8, cd_loss_thred=0.0003
    ),
}


def write_all(out_dir: str) -> list[str]:
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for name, make in EXPERIMENTS.items():
        p = os.path.join(out_dir, f"config_{name}.json")
        with open(p, "w") as f:
            json.dump(make(), f, indent=2)
        paths.append(p)
    return paths
