"""The two-stage pipeline demo, end to end at the shipped model scale.

    python -m point_diffusion_refinement_tpu_torch.cli.two_stage_demo \
        [--steps_ddpm 600] [--steps_refine 300] [--T 100] [--num_shapes 6] \
        [--batch_size 8] [--workdir DIR] [--out_dir DIR] [--device cuda|cpu]

Counterpart of the JAX package's ``tools/two_stage_demo.py``, with its
arguments, defaults, stages and configs.  It closes the loop the reference
README describes, on synthetic MVP-style shapes (``data/synthetic.py``):

  1. data: train and test splits of ``num_shapes`` shapes and half as many
     novel ones, 26 partial views each, as 2048-point GT clouds with
     3072 x 4 mirrored partials, and the same surfaces at 4096 points for
     the refinement;
  2. DDPM training of ``DEFAULT_POINTNET_CONFIG`` in bf16 (T=100 for demo
     speed), the fused training routes on;
  3. coarse generation of the test set and of augmented train-set trials;
  4. training of the refinement + x2 upsampling net on the generated clouds
     (``include_generated_samples``, random trials, cd_t);
  5. the refined test set: refined CD-t at 4096 points against coarse CD-t
     at 2048.

Where ``h5py`` imports the stages run on the JAX demo's h5 files under
``<workdir>/mvp`` (``write_mvp_style_h5``, ``preprocess_cli``, the
generated h5 of the reference's taxonomy that the refine set reads back).
Where it does not, as on the H100 machine, they hand their data over in
memory, as the file-driven pipeline does there: ``train(dataset_override=
...)`` and ``run_generation(state_override=..., dataset_override=...)``, the
generated clouds (rescaled by 2 * scale, as the h5 dataset scales them) in
the refine set's ``generated`` arrays, the clouds scaled and augmented as
the h5 dataset would (``AugmentedArrays``), every train-set trial in the
refine set at once.  The summary (the JAX demo's keys, the
seconds of each stage and where each training stage's seconds went, the
DDPM loss over its first and last 10 steps and the card's name and power
limit) is printed and written to
``<out_dir>/two_stage_demo.json``; ``run_demo`` returns it.
"""

from __future__ import annotations

import argparse
import copy
import importlib.util
import json
import os
import shutil
import subprocess
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from ..config.loader import DEFAULT_POINTNET_CONFIG
from ..data import VIEWS_PER_SHAPE, ArrayDataset, augment_cloud, synthetic_dataset
from ..sample.pipeline import run_generation
from ..train.loop import train
from ..utils.device import DeviceLike, resolve_device

DDPM_AUGMENTATION = {
    "pc_augm_scale": 1.2,
    "pc_augm_rot": True,
    "pc_rot_scale": 90,
    "pc_augm_mirror_prob": 0.5,
    "pc_augm_jitter": False,
    "translation_magnitude": 0.1,
}
REFINE_AUGMENTATION = {
    "pc_augm_scale": 1.01,
    "pc_augm_rot": True,
    "pc_rot_scale": 3.0,
    "pc_augm_mirror_prob": 0.5,
    "pc_augm_jitter": False,
    "translation_magnitude": 0.005,
    "noise_magnitude_for_generated_samples": 0.01,
}


class AugmentedArrays(ArrayDataset):
    """In-memory items augmented as the h5 dataset augments them
    (``data/mvp.py::MVPDataset.__getitem__``): one random similarity a
    sample over all its clouds, noise on the generated cloud, and with
    ``return_augmentation_params`` the inverse (``M_inv``, ``translation``)
    that generation undoes.  Every access draws anew, from ``seed``."""

    def __init__(self, augmentation: dict, return_augmentation_params: bool = False,
                 seed: Optional[int] = None, **arrays):
        super().__init__(**arrays)
        self.augmentation = augmentation
        self.return_params = return_augmentation_params
        self.rng = np.random.default_rng(seed)

    def __getitem__(self, i: int) -> dict:
        item = super().__getitem__(i)
        label = item.pop("label")
        keys = list(item)
        out = augment_cloud([item[k] for k in keys], self.augmentation,
                            return_augmentation_params=self.return_params, rng=self.rng)
        clouds, params = out if self.return_params else (out, {})
        item = dict(zip(keys, clouds))
        sigma = self.augmentation.get("noise_magnitude_for_generated_samples", 0)
        if "generated" in item and sigma > 0:
            item["generated"] = item["generated"] + self.rng.normal(
                scale=sigma, size=item["generated"].shape).astype(np.float32)
        return {**item, **params, "label": label}


def _scaled(arrays: dict, s: float) -> dict:
    """The h5 dataset's scaling: coordinates times 2 * scale (a mirrored
    partial's flag channel is not a coordinate)."""
    out = dict(arrays)
    out["complete"] = arrays["complete"] * s
    partial = arrays["partial"].copy()
    partial[..., :3] *= s
    out["partial"] = partial
    return out


def card() -> Optional[str]:
    """``nvidia-smi``'s name and power limit of the card, where it runs."""
    if shutil.which("nvidia-smi") is None:
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    return out.splitlines()[0] if out else None


def demo_configs(root: str, data_dir: str, T: int, batch_size: int, npoints: int,
                 partial_points: int, pointnet_config: Optional[dict] = None):
    """The JAX demo's DDPM and refine configs (``tools/two_stage_demo.py``)."""
    pc = copy.deepcopy(dict(pointnet_config)) if pointnet_config else {
        **copy.deepcopy(dict(DEFAULT_POINTNET_CONFIG)), "compute_dtype": "bfloat16"}
    ddpm = {
        "diffusion_config": {"T": T, "beta_0": 1e-4, "beta_T": 0.02},
        "pointnet_config": pc,
        "train_config": {
            "task": "completion",
            "root_directory": root,
            "output_directory": "logs/checkpoint",
            "ckpt_iter": "max",
            "epochs_per_ckpt": 10 ** 6,  # no mid-run eval
            "iters_per_logging": 50,
            "n_epochs": 10 ** 6,  # bounded by max_steps
            "learning_rate": 2e-4,
            "conditioned_on_cloud": True,
            "compute_emd": False,
        },
        "mvp_dataset_config": {
            "data_dir": data_dir,
            "npoints": npoints,
            "novel_input": True,
            "scale": 1,
            "batch_size": batch_size,
            "eval_batch_size": batch_size,
            "num_samples_tested": 0,
            "use_mirrored_partial_input": True,
            "number_partial_points": partial_points,
            "augmentation": dict(DDPM_AUGMENTATION),
        },
        "gen_config": {"ckpt_path": "logs/checkpoint"},
    }
    refine = copy.deepcopy(ddpm)
    rpc = refine["pointnet_config"]
    rpc["include_t"] = False
    rpc["point_upsample_factor"] = 2
    rpc["include_displacement_center_to_final_output"] = False
    rpc["intermediate_refined_X_loss_weight"] = 0
    refine["train_config"]["task"] = "refine_completion"
    mc = refine["mvp_dataset_config"]
    mc["npoints"] = 2 * npoints
    mc["include_generated_samples"] = True
    mc["randomly_select_generated_samples"] = True
    mc["augmentation"] = dict(REFINE_AUGMENTATION)
    refine["refine_config"] = {
        "exp_name": "two_stage_demo",
        "cd_loss_type": "cd_t",
        "output_scale_factor": 0.001,
        "use_output_scale_factor_schedule": False,
        "cd_loss_thred": 0.0,
    }
    return ddpm, refine


def run_demo(steps_ddpm: int = 600, steps_refine: int = 300, T: int = 100,
             num_shapes: int = 6, batch_size: int = 8, workdir: Optional[str] = None,
             out_dir: Optional[str] = None, device: DeviceLike = None,
             pointnet_config: Optional[dict] = None, npoints: int = 2048,
             partial_points: int = 3072, num_tested: Optional[int] = None,
             trainset_trials: int = 3, in_memory: Optional[bool] = None,
             artifacts: Optional[dict] = None) -> dict:
    """Run the five stages; returns the summary.

    ``pointnet_config`` replaces ``DEFAULT_POINTNET_CONFIG`` (bf16) and
    ``npoints`` / ``partial_points`` the 2048-point GT and 3072-point
    mirrored partials, for runs at small widths; ``trainset_trials`` sets
    the augmented train-set generations (the JAX demo's three: the bare
    directory and two trials).  Both fused training routes are on.  The
    stages hand their data over in memory where ``h5py`` does not import,
    else through the h5 files of the JAX demo (``write_mvp_style_h5``,
    ``preprocess_cli``, the generated h5 the refine set reads);
    ``in_memory`` chooses.  In memory, ``num_tested`` cuts the test set to
    its first clouds.  ``artifacts``, when given, receives the in-memory
    results: the coarse and refined test clouds with their GT, the training
    results and the generation results."""
    dev = resolve_device(device)
    if in_memory is None:
        in_memory = importlib.util.find_spec("h5py") is None
    workdir = workdir or os.path.join(tempfile.gettempdir(), "pdr_two_stage_demo")
    out_dir = out_dir or workdir
    data_dir, root = os.path.join(workdir, "mvp"), os.path.join(workdir, "exp")
    ddpm_cfg, refine_cfg = demo_configs(root, data_dir, T, batch_size, npoints,
                                        partial_points, pointnet_config)
    t0 = time.time()
    stages = {}

    def done(stage: str, t_stage: float, what: str) -> None:
        stages[stage] = round(time.time() - t_stage, 2)
        print(f"[{time.time() - t0:.0f}s] {what}", flush=True)

    stage_args = (ddpm_cfg, refine_cfg, steps_ddpm, steps_refine, num_shapes, batch_size,
                  trainset_trials, dev, done)
    out = _in_memory(*stage_args, num_tested) if in_memory else _on_files(*stage_args)
    res, rres, coarse, refined = out["ddpm"], out["refine"], out["coarse_result"], \
        out["refined_result"]
    coarse_cd, refined_cd = float(coarse.avg_cd), float(refined.avg_cd)
    summary = {
        "steps_ddpm": steps_ddpm,
        "steps_refine": steps_refine,
        "T": T,
        "ddpm_final_loss": res["final_loss"],
        "coarse_cd_t_2048": coarse_cd,
        "refined_cd_t_4096": refined_cd,
        "refined_beats_coarse": bool(refined_cd < coarse_cd),
        "total_wall_s": round(time.time() - t0, 1),
        "devices": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
        "stage_seconds": stages,
        "train_seconds": {"ddpm": _train_split(res, stages["ddpm_train"]),
                          "refine": _train_split(rres, stages["refine_train"])},
        "ddpm_loss_first10": float(np.mean(res["losses"][:10])),
        "ddpm_loss_last10": float(np.mean(res["losses"][-10:])),
        "card": card() if dev.type == "cuda" else None,
        "route": "in memory" if in_memory else "h5 files",
        "num_train": out["num_train"],
        "num_test": len(coarse.metrics["cd_distance"]),
        "trainset_trials": len(out["trials"]),
        "npoints": npoints,
    }
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "two_stage_demo.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2), flush=True)
    if not summary["refined_beats_coarse"]:
        print("WARNING: refinement did not improve CD; train longer", flush=True)
    if artifacts is not None:
        artifacts.update(out, coarse=coarse.generated, refined=refined.generated)
    return summary


def _train_split(res: dict, stage_s: float) -> dict:
    """A training stage's seconds by where they went: assembling the
    batches, the first two steps (the compiled step's warm-up and capture),
    the steps after them, and the stage outside the steps (model build,
    checkpoints, in-loop evals); and the median step after the first two
    without its batch, in ms."""
    steps, batch = np.asarray(res["step_seconds"]), np.asarray(res["batch_seconds"])
    later = (steps - batch)[2:]
    return {"batch_assembly": round(float(batch.sum()), 2),
            "first_two_steps": round(float(steps[:2].sum()), 2),
            "later_steps": round(float(steps[2:].sum()), 2),
            "outside_steps": round(stage_s - float(steps.sum()), 2),
            "later_step_median_ms": round(float(np.median(later)) * 1e3, 2)
            if len(later) else None}


def _in_memory(ddpm_cfg, refine_cfg, steps_ddpm, steps_refine, num_shapes, batch_size,
               trainset_trials, dev, done, num_tested) -> dict:
    """The five stages on in-memory data, scaled and augmented as the h5
    dataset would."""
    mc = ddpm_cfg["mvp_dataset_config"]
    npoints, partial_points = mc["npoints"], mc["number_partial_points"]
    s = 2.0 * mc["scale"]
    routes = dict(fused_gather=True, fused_sa=True)

    # ---- 1. synthetic data: GT + mirrored partials, and GT at 2 x npoints
    t = time.time()
    n_items = (num_shapes + max(1, num_shapes // 2)) * VIEWS_PER_SHAPE  # novel shapes too
    splits = {}
    for split, seed in (("train", 0), ("test", 1)):
        arrays = synthetic_dataset(n_items, npoints, npoints, seed=seed,
                                   mirror_to=partial_points).arrays
        fine = synthetic_dataset(n_items, 2 * npoints, npoints, seed=seed).arrays["complete"]
        if split == "test" and num_tested is not None:
            arrays = {k: v[:num_tested] for k, v in arrays.items()}
            fine = fine[:num_tested]
        splits[split] = (_scaled(arrays, s), fine * s)
    (train_a, train_fine), (test_a, test_fine) = splits["train"], splits["test"]
    done("data", t, f"data in memory: {len(train_a['label'])} train and "
                    f"{len(test_a['label'])} test clouds of {npoints} points, "
                    f"{partial_points} x 4 mirrored partials")

    # ---- 2. DDPM training -------------------------------------------------
    t = time.time()
    res = train(ddpm_cfg, max_steps=steps_ddpm, device=dev, **routes,
                dataset_override=AugmentedArrays(DDPM_AUGMENTATION, seed=0, **train_a))
    done("ddpm_train", t, f"DDPM trained {steps_ddpm} steps, final loss "
                          f"{res['final_loss']:.4f}, ckpt {res['n_iter']}")

    # ---- 3. coarse generation: the test set, augmented train-set trials ---
    t = time.time()
    gen_kw = dict(state_override=res["state"], save_generated=True, compute_emd=False,
                  batch_size=batch_size, device=dev)
    (coarse,) = run_generation(ddpm_cfg, phase="test", num_trials=1,
                               dataset_override=ArrayDataset(**test_a), **gen_kw)
    trials = run_generation(
        ddpm_cfg, phase="test_trainset", num_trials=trainset_trials,
        augment_data_during_generation=True,
        dataset_override=AugmentedArrays(DDPM_AUGMENTATION, return_augmentation_params=True,
                                         seed=1, **train_a), **gen_kw)
    done("coarse_generation", t, f"test-set coarse CD-t {coarse.avg_cd:.6f}; "
                                 f"{len(trials)} train-set trials generated")

    # ---- 4. refinement (+ upsample x2) training on every trial -------------
    t = time.time()
    refine_train = AugmentedArrays(
        REFINE_AUGMENTATION, seed=2,
        complete=np.concatenate([train_fine] * len(trials)),
        partial=np.concatenate([train_a["partial"]] * len(trials)),
        label=np.concatenate([train_a["label"]] * len(trials)),
        generated=np.concatenate([r.generated * s for r in trials]))
    rres = train(refine_cfg, max_steps=steps_refine, device=dev, **routes,
                 dataset_override=refine_train)
    done("refine_train", t, f"refine net trained {steps_refine} steps, final CD loss "
                            f"{rres['final_loss']:.6f}")

    # ---- 5. refined eval on the test set ------------------------------------
    t = time.time()
    (refined,) = run_generation(
        refine_cfg, phase="test", num_trials=1, state_override=rres["state"],
        save_generated=False, keep_generated=True, compute_emd=False,
        batch_size=batch_size, device=dev,
        dataset_override=ArrayDataset(complete=test_fine, partial=test_a["partial"],
                                      label=test_a["label"], generated=coarse.generated * s))
    done("refine_eval", t, f"refined CD-t {refined.avg_cd:.6f}")
    return dict(ddpm=res, refine=rres, coarse_result=coarse, trials=trials,
                refined_result=refined, num_train=len(train_a["label"]),
                coarse_gt=test_a["complete"] / s, refined_gt=test_fine / s)


def _on_files(ddpm_cfg, refine_cfg, steps_ddpm, steps_refine, num_shapes, batch_size,
              trainset_trials, dev, done) -> dict:
    """The five stages through the h5 files, as the JAX demo runs them."""
    from ..data import write_mvp_style_h5
    from ..train.loop import local_experiment_path, make_dataset
    from .preprocess_cli import main as preprocess

    mc = ddpm_cfg["mvp_dataset_config"]
    data_dir, npoints = mc["data_dir"], mc["npoints"]
    routes = dict(fused_gather=True, fused_sa=True)

    # ---- 1. synthetic h5 files (GT at npoints and 2 x npoints; the second
    # write redraws the partials of the same parametric surfaces) + mirror
    t = time.time()
    for n in (npoints, 2 * npoints):
        write_mvp_style_h5(data_dir, num_shapes=num_shapes, npoints=n, partial_points=npoints)
    preprocess(["--data_dir", data_dir, "--num_points", str(mc["number_partial_points"]),
                "--batch_size", "32", "--device", str(dev)])
    done("data", t, f"data as h5 files under {data_dir}, mirrored")

    # ---- 2. DDPM training -------------------------------------------------
    t = time.time()
    res = train(ddpm_cfg, max_steps=steps_ddpm, device=dev, **routes)
    done("ddpm_train", t, f"DDPM trained {steps_ddpm} steps, final loss "
                          f"{res['final_loss']:.4f}, ckpt {res['n_iter']}")

    # ---- 3. coarse generation from the checkpoint: the test set, the bare
    # train directory and augmented trials
    t = time.time()
    gen_kw = dict(save_generated=True, compute_emd=False, batch_size=batch_size, device=dev)
    (coarse,) = run_generation(ddpm_cfg, phase="test", num_trials=1, **gen_kw)
    trials = run_generation(ddpm_cfg, phase="test_trainset", num_trials=1,
                            augment_data_during_generation=True, **gen_kw)
    if trainset_trials > 1:
        trials += run_generation(ddpm_cfg, phase="test_trainset",
                                 num_trials=trainset_trials - 1,
                                 augment_data_during_generation=True, **gen_kw)
    gen_rel = os.path.join("generated_samples", local_experiment_path(ddpm_cfg),
                           f"ckpt_{res['n_iter']}")
    done("coarse_generation", t, f"test-set coarse CD-t {coarse.avg_cd:.6f}; "
                                 f"trainset trials generated -> {gen_rel}")

    # ---- 4. refinement (+ upsample x2) training on the generated h5 ---------
    t = time.time()
    refine_cfg["mvp_dataset_config"]["generated_sample_path"] = gen_rel
    rres = train(refine_cfg, max_steps=steps_refine, device=dev, **routes)
    done("refine_train", t, f"refine net trained {steps_refine} steps, final CD loss "
                            f"{rres['final_loss']:.6f}")

    # ---- 5. refined eval on the test set, from the checkpoint ---------------
    t = time.time()
    (refined,) = run_generation(refine_cfg, phase="test", num_trials=1,
                                save_generated=False, keep_generated=True,
                                compute_emd=False, batch_size=batch_size, device=dev)
    done("refine_eval", t, f"refined CD-t {refined.avg_cd:.6f}")
    s = 2.0 * mc["scale"]
    gt = [make_dataset(cfg["mvp_dataset_config"], "test") for cfg in (ddpm_cfg, refine_cfg)]
    return dict(ddpm=res, refine=rres, coarse_result=coarse, trials=trials,
                refined_result=refined, num_train=len(make_dataset(mc, "train")),
                coarse_gt=np.stack([gt[0][i]["complete"] for i in range(len(gt[0]))]) / s,
                refined_gt=np.stack([gt[1][i]["complete"] for i in range(len(gt[1]))]) / s)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="Two-stage PDR demo on synthetic shapes")
    p.add_argument("--steps_ddpm", type=int, default=600)
    p.add_argument("--steps_refine", type=int, default=300)
    p.add_argument("--T", type=int, default=100)
    p.add_argument("--num_shapes", type=int, default=6)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--workdir", default=None,
                   help="checkpoints and generations (default: pdr_two_stage_demo "
                        "under the temporary directory)")
    p.add_argument("--out_dir", default=None, help="the summary (default: --workdir)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    return run_demo(steps_ddpm=args.steps_ddpm, steps_refine=args.steps_refine, T=args.T,
                    num_shapes=args.num_shapes, batch_size=args.batch_size,
                    workdir=args.workdir, out_dir=args.out_dir, device=args.device)


if __name__ == "__main__":
    main()
