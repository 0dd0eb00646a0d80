"""The training loop: config in, checkpoints, eval results and logs out.

Counterpart of the JAX package's ``train/loop.py`` for one process and one
device.  ``train(config, ...)`` builds the model on the device (the GPU
unless the caller asks for ``"cpu"``), resumes from the newest checkpoint,
runs the DDPM completion step or the refine / denoise step over shuffled
batches, ramps the refine output scale, saves checkpoints at the configured
cadence, evaluates in the loop through ``sample/evaluate.py`` and keeps the
best checkpoint.

Not ported yet, and raising when asked for: the h5-backed ``MVPDataset``
(``make_dataset`` builds only the in-memory synthetic dataset described by
``mvp_dataset_config["synthetic"]``; pass ``dataset_override`` otherwise),
multi-device and multi-process training with its gather of eval results
across processes, the neighbour statistics, the non-PointNet++ backbones,
and training from a config file (the config loader comes with the CLIs).
"""

from __future__ import annotations

import os
import pickle
import shutil
import time
from typing import Optional

import numpy as np
import torch

from ..data import iterate_batches, synthetic_dataset
from ..diffusion import calc_diffusion_hyperparams, make_fast_sampling_plan
from ..models import PointNet2CloudCondition
from ..sample import evaluate, make_coarse_sampler, make_refiner
from ..utils.device import DeviceLike, resolve_device
from ..utils.logging import TensorBoardLogger
from ..utils.meters import AverageMeter
from .checkpoints import maybe_resume, save_checkpoint
from .scheduler import QuantityScheduler
from .step import create_train_state, make_completion_train_step, make_refine_train_step


def local_experiment_path(config: dict) -> str:
    """Experiment directory naming, as the JAX package names it."""
    dc = config["diffusion_config"]
    pc = config["pointnet_config"]
    path = f"T{dc['T']}_betaT{dc['beta_T']}_{pc['model_name']}"
    if config["train_config"].get("task") == "refine_completion":
        refine = config.get("refine_config", {})
        exp = refine.get("exp_name", "refine")
        head, tail = os.path.split(exp)
        path = os.path.join(path, head, f"refine_exp_{tail}")
    return path


def build_model(pointnet_config: dict, device: DeviceLike = None, seed: int = 0):
    network_type = pointnet_config.get("network_type", "pointnet++")
    if network_type == "pointnet++":
        return PointNet2CloudCondition.from_config(pointnet_config, device=device, seed=seed)
    if network_type in ("pointwise_net", "pvd"):
        raise NotImplementedError(f"network_type {network_type!r} is not ported yet")
    raise ValueError(network_type)


def make_dataset(trainset_config: dict, phase="train"):
    """The dataset of a phase.  Only the in-memory synthetic dataset is
    built here: ``trainset_config["synthetic"]`` holds the arguments of
    ``data.synthetic_dataset`` (the test phases draw from ``seed + 1``).  The
    h5-backed MVP dataset is not ported yet."""
    if isinstance(phase, bool):
        phase = "train" if phase else "test"
    assert phase in ("train", "val", "test", "test_trainset"), phase
    spec = trainset_config.get("synthetic")
    if spec is None:
        raise NotImplementedError(
            "the h5-backed MVP dataset is not ported yet: pass dataset_override or "
            "describe an in-memory dataset under mvp_dataset_config['synthetic']")
    spec = dict(spec)
    if phase in ("val", "test"):
        spec["seed"] = int(spec.get("seed", 0)) + 1
    return synthetic_dataset(**spec)


def make_eval_sampler(model, schedule, diffusion_config: dict, num_points: int,
                      eval_T: int):
    """Sampler for the in-loop eval.  ``eval_sampling_steps`` (eval_T) > 0
    runs a FastDPM VAR plan of that length (var / quadratic / kappa 0.5)
    instead of the full ancestral schedule.  Returns (sampler_fn,
    steps_per_sample)."""
    fast_plan = None
    if 0 < eval_T < schedule.T:
        fast_plan = make_fast_sampling_plan(
            schedule, diffusion_config["T"], diffusion_config["beta_0"],
            diffusion_config["beta_T"], length=eval_T, sampling_method="var",
            noise_schedule="quadratic", kappa=0.5,
        )
    sampler = make_coarse_sampler(model, schedule, num_points=num_points,
                                  fast_plan=fast_plan)
    n_steps = int(fast_plan.tau.shape[0]) if fast_plan is not None else int(schedule.T)
    return sampler, n_steps


def _to_device(batch: dict, key: str, device, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.asarray(batch[key])).to(device=device, dtype=dtype)


def train(config: dict, *, max_steps: Optional[int] = None, device: DeviceLike = None,
          dataset_override=None, eval_dataset_override=None,
          trainset_eval_dataset_override=None, fused_gather: bool = False,
          fused_sa: bool = False, mesh=None) -> dict:
    """Run training per the config dict.  ``max_steps`` truncates for smoke
    runs; dataset overrides inject in-memory data; ``fused_gather`` /
    ``fused_sa`` turn on the network's fused training routes (off by
    default).  ``train_config["shuffle_seed"]`` makes the batch order of
    epoch e a function of ``shuffle_seed + e``, so a resumed run repeats
    it; without it every epoch shuffles from fresh entropy."""
    if mesh is not None:
        raise NotImplementedError("multi-device training is not ported yet")
    train_config = config["train_config"]
    pointnet_config = config["pointnet_config"]
    diffusion_config = config["diffusion_config"]
    trainset_config = config.get("mvp_dataset_config", config.get("dataset_config", {}))
    refine_config = config.get("refine_config", {})
    task = train_config.get("task", "completion")
    if pointnet_config.get("record_neighbor_stats", False):
        raise NotImplementedError("record_neighbor_stats is not ported yet")

    dev = resolve_device(device)
    root = train_config.get("root_directory", "exp")
    local_path = local_experiment_path(config)
    output_directory = os.path.join(
        root, local_path, train_config.get("output_directory", "logs/checkpoint"))
    os.makedirs(output_directory, exist_ok=True)
    tb = TensorBoardLogger(os.path.join(
        root, local_path, train_config.get("tensorboard_directory", "logs/tb")))

    schedule = calc_diffusion_hyperparams(
        diffusion_config["T"], diffusion_config["beta_0"], diffusion_config["beta_T"])
    model = build_model(pointnet_config, device=dev, seed=0)

    dataset = dataset_override or make_dataset(trainset_config, "train")
    batch_size = trainset_config.get("batch_size", 32)
    loader_len = max(1, len(dataset) // batch_size)
    n_iters = int(loader_len * train_config.get("n_epochs", 1))
    if max_steps is not None:
        n_iters = min(n_iters, max_steps)
    iters_per_ckpt = int(loader_len * train_config.get("epochs_per_ckpt", 1))
    iters_per_logging = train_config.get("iters_per_logging", 50)
    shuffle_seed = train_config.get("shuffle_seed")

    state = create_train_state(model, seed=1,
                               learning_rate=train_config.get("learning_rate", 2e-4))
    restored, ckpt_iter, prev_secs = maybe_resume(
        output_directory, train_config.get("ckpt_iter", "max"), state)
    if restored is not None:
        state = restored
    n_iter = ckpt_iter + 1
    time0 = time.time() - prev_secs

    scale = trainset_config.get("scale", 1)
    upsample = int(pointnet_config.get("point_upsample_factor", 1))
    include_center = bool(
        pointnet_config.get("include_displacement_center_to_final_output", False))
    routes = dict(fused_gather=fused_gather, fused_sa=fused_sa)
    if task == "completion":
        step_fn = make_completion_train_step(model, schedule, **routes)
    else:
        step_fn = make_refine_train_step(
            model, scale=scale, cd_loss_type=refine_config.get("cd_loss_type", "cd_t"),
            point_upsample_factor=upsample, include_displacement_center=include_center,
            intermediate_loss_weight=(
                pointnet_config.get("intermediate_refined_X_loss_weight", 0.0)
                if upsample > 1 else 0.0),
            task=task, **routes,
        )

    osf_scheduler = None
    output_scale_factor = refine_config.get("output_scale_factor", 0.001)
    if task == "refine_completion" and refine_config.get(
            "use_output_scale_factor_schedule", False):
        s = refine_config["output_scale_factor_schedule"]
        osf_scheduler = QuantityScheduler(
            s["init_epoch"], s["final_epoch"], s["init_value"],
            refine_config["output_scale_factor"], loader_len)

    def osf_at(it: int) -> float:
        return osf_scheduler.get_quantity(it) if osf_scheduler is not None \
            else output_scale_factor

    # ---- eval-in-loop setup ----------------------------------------------
    eval_per_ckpt = int(train_config.get("eval_per_ckpt", 1))
    eval_start_iter = train_config.get("eval_start_epoch", 0) * loader_len - 1
    num_samples_tested = trainset_config.get("num_samples_tested", 0)
    compute_emd = bool(train_config.get("compute_emd", True))
    only_best = bool(train_config.get("only_save_the_best_model", False))
    if task == "completion" and only_best:
        raise ValueError("To train the diffusion model, we should save every checkpoint")
    eval_dir = os.path.join(root, local_path, "eval_result")
    eval_T = int(train_config.get("eval_sampling_steps", 0))  # 0 = full T
    test_trainset_during_eval = bool(trainset_config.get("test_trainset_during_eval", False))

    def run_eval(n_iter_now: int, osf_now: float):
        """Evaluate the test split (and optionally the train split) at a
        checkpoint and write the per-checkpoint metric pickle."""
        bs = trainset_config.get("eval_batch_size", 32)
        if task == "completion":
            sampler, _ = make_eval_sampler(
                model, schedule, diffusion_config,
                num_points=trainset_config.get("npoints", 2048), eval_T=eval_T)
            gen = torch.Generator(device=dev)
            gen.manual_seed(4242 + n_iter_now)

            def gen_fn(batch):
                return sampler(_to_device(batch, "partial", dev),
                               _to_device(batch, "label", dev, torch.int64), generator=gen)
        else:
            refiner = make_refiner(model, upsample, include_center)

            def gen_fn(batch):
                coarse = batch.get("generated", batch["complete"])
                return refiner(torch.as_tensor(np.asarray(coarse, np.float32)),
                               _to_device(batch, "partial", dev),
                               _to_device(batch, "label", dev, torch.int64), osf_now)

        def eval_split(split_phase: str, tag: str):
            override = (eval_dataset_override if split_phase == "test"
                        else trainset_eval_dataset_override)
            eval_ds = override if override is not None else make_dataset(
                trainset_config, split_phase)
            res = evaluate(gen_fn, iterate_batches(eval_ds, bs, shuffle=False), scale=scale,
                           compute_emd=compute_emd, print_every=10 ** 9)
            os.makedirs(eval_dir, exist_ok=True)
            with open(os.path.join(
                    eval_dir, f"eval_result_ckpt_{n_iter_now}_rank_0{tag}.pkl"), "wb") as f:
                pickle.dump({"avg_cd": res.avg_cd, "avg_emd": res.avg_emd,
                             **{k: np.asarray(v) for k, v in res.metrics.items()}}, f)
            return (float(np.mean(res.metrics["cd_distance"])),
                    float(np.mean(res.metrics["emd_distance"])))

        avg_cd, avg_emd = eval_split("test", "")
        tb.add_scalar("CD-Loss", avg_cd, n_iter_now)
        tb.add_scalar("EMD-Loss", avg_emd, n_iter_now)
        if test_trainset_during_eval:
            tr_cd, tr_emd = eval_split("test_trainset", "_trainset")
            tb.add_scalar("Trainset CD-Loss", tr_cd, n_iter_now)
            tb.add_scalar("Trainset EMD-Loss", tr_emd, n_iter_now)
            print(f"eval @ iter {n_iter_now}: Trainset CD {tr_cd:.8f} EMD {tr_emd:.8f}",
                  flush=True)
        print(f"eval @ iter {n_iter_now}: CD {avg_cd:.8f} EMD {avg_emd:.8f}", flush=True)
        return avg_cd, avg_emd

    loss_meter = AverageMeter()
    losses = []
    eval_records = {"iter": [], "avg_cd": [], "avg_emd": []}
    best_cd = None
    last_saved = None
    last_saved_best = None
    num_ckpts = 0

    while n_iter < n_iters:
        epoch = n_iter // loader_len
        seed = None if shuffle_seed is None else int(shuffle_seed) + epoch
        for batch in iterate_batches(dataset, batch_size, shuffle=True, drop_last=True,
                                     seed=seed):
            x0 = _to_device(batch, "complete", dev)
            condition = _to_device(batch, "partial", dev)
            label = _to_device(batch, "label", dev, torch.int64)
            if task == "completion":
                state, loss = step_fn(state, x0, condition, label)
            else:
                generated = torch.as_tensor(np.asarray(
                    batch.get("generated", batch["complete"]), np.float32)).to(dev)
                state, loss = step_fn(state, x0, condition, label, generated,
                                      osf_at(n_iter))
            loss_val = float(loss)
            loss_meter.update(loss_val)
            losses.append(loss_val)

            if n_iter % iters_per_logging == 0:
                print(f"iteration: {n_iter} \tloss: {loss_val:.6f}", flush=True)
                tb.add_scalar("Log-Train-Loss", float(np.log(max(loss_val, 1e-12))), n_iter)

            if n_iter > 0 and (n_iter + 1) % iters_per_ckpt == 0:
                num_ckpts += 1
                if last_saved is not None and only_best:
                    shutil.rmtree(last_saved, ignore_errors=True)
                last_saved = save_checkpoint(
                    output_directory, n_iter, state,
                    training_time_seconds=time.time() - time0)
                print(f"checkpoint saved at iteration {n_iter}", flush=True)

                if (num_samples_tested > 0 and n_iter >= eval_start_iter
                        and num_ckpts % eval_per_ckpt == 0):
                    avg_cd, avg_emd = run_eval(n_iter, osf_at(n_iter))
                    eval_records["iter"].append(n_iter)
                    eval_records["avg_cd"].append(avg_cd)
                    eval_records["avg_emd"].append(avg_emd)
                    with open(os.path.join(eval_dir, "gathered_eval_result.pkl"), "wb") as f:
                        pickle.dump(eval_records, f)
                    if only_best and (best_cd is None or avg_cd <= best_cd):
                        if last_saved_best is not None:
                            shutil.rmtree(last_saved_best, ignore_errors=True)
                        best_cd = avg_cd
                        best_dir = os.path.join(
                            output_directory, f"pointnet_ckpt_{n_iter}_best_cd")
                        shutil.copytree(last_saved, best_dir)
                        last_saved_best = best_dir
                    # close to convergence: save and evaluate more often
                    if (task == "refine_completion"
                            and refine_config.get(
                                "decrease_epochs_per_ckpt_for_fine_tuning", False)
                            and avg_cd <= refine_config.get("cd_loss_thred", 0.0)):
                        iters_per_ckpt = int(
                            loader_len * refine_config["epochs_per_ckpt_fine_tune"])

            n_iter += 1
            if n_iter >= n_iters:
                break

    save_checkpoint(output_directory, n_iter, state,
                    training_time_seconds=time.time() - time0)
    tb.close()
    return {
        "state": state,
        "model": model,
        "schedule": schedule,
        "output_directory": output_directory,
        "final_loss": loss_meter.avg,
        "losses": losses,
        "n_iter": n_iter,
        "eval_records": eval_records,
        "best_cd": best_cd,
    }

