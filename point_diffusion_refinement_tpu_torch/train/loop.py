"""The training loop: config in, checkpoints, eval results and logs out.

Counterpart of the JAX package's ``train/loop.py``.  ``train(config, ...)``
builds the model on the device (the GPU unless the caller asks for
``"cpu"``), resumes from the newest checkpoint, runs the DDPM completion
step or the refine / denoise step over shuffled batches of the MVP dataset
(``make_dataset``), ramps the refine output scale, saves checkpoints at the
configured cadence, evaluates a random subset of ``num_samples_tested``
clouds in the loop through ``sample/evaluate.py`` and keeps the best
checkpoint.  ``train_from_file``
reads the config from a JSON file.

The step is compiled, as the JAX loop jits its step: on the card each
optimizer step replays one captured CUDA graph (``train/step.py``,
``compiled=True``), captured on the second step after the resume; the
refine output scale is a device tensor the graph reads, so a ramp replays
the same graph.  On the CPU the same step runs eagerly.  Over a process
group the step is compiled too, the gradients' reduction over the mesh
and the loss's mean inside the graph (``jit_step_for_mesh``), but for
processes that share a card over gloo, which step eagerly
(``mesh_step_compiled``); ``train()`` prints which.

``build_model`` builds any of the JAX package's three networks:
``pointnet++`` (the default), ``pvd`` (PVCNN2) and ``pointwise_net``, the
last two from ``network_args``.  With ``record_neighbor_stats`` (PointNet++
only) the loop prints the configuration's neighbour-count report once on
the first batch, feeds every step's histograms to a
``NeighborStatsAccumulator``, reports it at each checkpoint and returns it.
As in the JAX package, the in-loop eval of the completion task needs the
PointNet++ network (``make_coarse_sampler`` raises for another one).

With ``mesh=`` (``parallel.make_mesh()`` in each of the processes of an
initialised process group) it trains over the processes, one a device:
each process takes its rank's shard of the dataset, seeds its draws with
``rank + 1`` and steps through ``jit_step_for_mesh``, data-parallel or,
on a mesh with a ``model`` axis, with its large tensors and their Adam
moments stored as slices; the in-loop eval
holds the parameters whole (``parallel.full_parameters``), writes a pickle a
rank, gathers the metrics over the processes and broadcasts rank 0's test
CD, so every rank takes the same best-checkpoint decision; every rank
saves a checkpoint (a sharded model is gathered) and rank 0 alone writes it
and the scalar log.
"""

from __future__ import annotations

import os
import pickle
import random
import shutil
import time
from typing import Optional

import numpy as np
import torch

from ..cli.eval_results import gather_eval_results, save_eval_result
from ..config.loader import load_config
from ..data import ArrayDataset, MVPDataset, MVPDatasetConfig, iterate_batches, synthetic_dataset
from ..diffusion import calc_diffusion_hyperparams, make_fast_sampling_plan
from ..models import PointNet2CloudCondition, PointwiseNet, PVCNN2Completion
from ..parallel.mesh import Mesh, full_parameters, shard_dataset
from ..parallel.multihost import all_gather_host_arrays, broadcast_scalar
from ..sample import evaluate, make_coarse_sampler, make_refiner
from ..utils.device import DeviceLike, resolve_device
from ..utils.graphs import CapturedFunction
from ..utils.logging import TensorBoardLogger
from ..utils.meters import AverageMeter
from ..utils.neighbor_stats import NeighborStatsAccumulator, model_neighbor_stats
from .checkpoints import maybe_resume, save_checkpoint
from .scheduler import QuantityScheduler
from .step import (
    create_train_state,
    jit_step_for_mesh,
    make_completion_train_step,
    make_refine_train_step,
    mesh_step_compiled,
)


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


def build_model(pointnet_config: dict, device: DeviceLike = None, seed: Optional[int] = 0,
                condition_features: Optional[int] = None):
    """The network of ``pointnet_config["network_type"]`` on ``device``,
    with weights drawn from ``seed`` when it is not None.  The pointwise
    network's global encoder reads the condition's channel count,
    ``condition_features``, which Flax takes from the example batch the JAX
    package initialises with."""
    network_type = pointnet_config.get("network_type", "pointnet++")
    if network_type == "pointnet++":
        return PointNet2CloudCondition.from_config(pointnet_config, device=device, seed=seed)
    args = dict(pointnet_config.get("network_args", {}))
    if network_type == "pointwise_net":
        if condition_features is None:
            raise ValueError("a pointwise_net network needs condition_features, the "
                             "condition cloud's channel count")
        model = PointwiseNet(condition_features=int(condition_features), **args)
    elif network_type == "pvd":
        model = PVCNN2Completion(**args)
    else:
        raise ValueError(network_type)
    dev = resolve_device(device)
    if seed is not None:
        g = torch.Generator()
        g.manual_seed(int(seed))
        model.init_weights(g)
    return model.to(dev).eval()


def make_dataset(trainset_config: dict, phase="train", rank: int = 0, world: int = 1,
                 eval_subset: Optional[int] = None):
    """The dataset of a phase.

    phase: 'train' (train split, augmented, padded last rank), 'test' / 'val'
    (test split, not augmented), or 'test_trainset' (the train split, not
    augmented unless the config sets ``augment_data_during_generation``);
    True / False stand for 'train' / 'test'.  ``eval_subset`` draws that many
    items at random.

    The h5 ``MVPDataset`` under ``data_dir``, or, where the config holds a
    ``synthetic`` entry, the in-memory dataset of ``data.synthetic_dataset``
    with those arguments (the test phases draw from ``seed + 1``; it is
    never augmented, and with ``return_augmentation_params`` its batches
    carry the identity transform; at ``world`` > 1 it is sharded as the h5
    dataset is, the train split padded to equal shards).
    """
    if isinstance(phase, bool):
        phase = "train" if phase else "test"
    assert phase in ("train", "val", "test", "test_trainset"), phase
    train = phase == "train"
    train_split = train or phase == "test_trainset"
    spec = trainset_config.get("synthetic")
    if spec is not None:
        return _synthetic(dict(spec), train_split, eval_subset,
                          trainset_config.get("return_augmentation_params", False),
                          Mesh(rank, world, torch.device("cpu")), pad=train)
    aug = trainset_config.get("augmentation") if train else None
    if not train and trainset_config.get("augment_data_during_generation", False):
        aug = trainset_config.get("augmentation")
    random_trials = trainset_config.get("randomly_select_generated_samples", False)
    return MVPDataset(MVPDatasetConfig(
        data_dir=trainset_config["data_dir"],
        train=train_split,
        npoints=trainset_config.get("npoints", 2048),
        novel_input=trainset_config.get("novel_input", True),
        novel_input_only=trainset_config.get("novel_input_only", False),
        scale=trainset_config.get("scale", 1),
        rank=rank,
        world_size=world,
        augmentation=aug if isinstance(aug, dict) else None,
        return_augmentation_params=trainset_config.get("return_augmentation_params", False),
        random_subsample=eval_subset is not None,
        num_samples=eval_subset or 0,
        include_generated_samples=trainset_config.get("include_generated_samples", False),
        generated_sample_path=trainset_config.get("generated_sample_path"),
        # random trials on the train split only
        randomly_select_generated_samples=random_trials and train_split,
        use_mirrored_partial_input=trainset_config.get("use_mirrored_partial_input", False),
        number_partial_points=trainset_config.get("number_partial_points", 2048),
        load_pre_computed_XT=trainset_config.get("load_pre_computed_XT", False),
        T_step=trainset_config.get("T_step", 100),
        XT_folder=trainset_config.get("XT_folder"),
        append_samples_to_last_rank=train,  # eval: no padding
    ))


def _synthetic(spec: dict, train_split: bool, eval_subset: Optional[int],
               with_identity_transform: bool, mesh: Mesh, pad: bool) -> ArrayDataset:
    """The synthetic branch of ``make_dataset``: the rank's shard, then the
    subset drawn from the spec's seed, so every build of a phase takes the
    same items."""
    if not train_split:
        spec["seed"] = int(spec.get("seed", 0)) + 1
    ds = shard_dataset(synthetic_dataset(**spec), mesh, pad)
    arrays = ds.arrays
    if eval_subset is not None and eval_subset < len(ds):
        idx = np.array(random.Random(spec.get("seed")).sample(range(len(ds)), eval_subset))
        arrays = {k: v[idx] for k, v in arrays.items()}
    if with_identity_transform:
        n = len(arrays["label"])
        arrays["M_inv"] = np.broadcast_to(np.eye(3, dtype=np.float32), (n, 3, 3)).copy()
        arrays["translation"] = np.zeros((n, 1, 3), np.float32)
    return ArrayDataset(**arrays)


def make_eval_sampler(model, schedule, diffusion_config: dict, num_points: int,
                      eval_T: int):
    """Sampler for the in-loop eval.  ``eval_sampling_steps`` (eval_T) > 0
    runs a FastDPM VAR plan of that length (var / quadratic / kappa 0.5)
    instead of the full ancestral schedule.  The sampler replays a captured
    reverse step (``segment_size`` of ``make_coarse_sampler``; its
    ``graphs`` hold it).  Returns (sampler_fn, steps_per_sample)."""
    fast_plan = None
    if 0 < eval_T < schedule.T:
        fast_plan = make_fast_sampling_plan(
            schedule, diffusion_config["T"], diffusion_config["beta_0"],
            diffusion_config["beta_T"], length=eval_T, sampling_method="var",
            noise_schedule="quadratic", kappa=0.5,
        )
    n_steps = int(fast_plan.tau.shape[0]) if fast_plan is not None else int(schedule.T)
    # compiled as in the JAX package: long ancestral schedules in segments of
    # 200 steps, short or FastDPM ones as one program
    seg = 200 if (fast_plan is None and schedule.T > 200) else n_steps
    sampler = make_coarse_sampler(model, schedule, num_points=num_points,
                                  fast_plan=fast_plan, segment_size=seg)
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
    it; without it every epoch shuffles from fresh entropy.  The result's
    ``step_seconds`` hold each step's host time from the assembly of its
    batch to its loss on the host (checkpoints and evals excluded), and
    ``batch_seconds`` the part of it up to the batch on the device.

    ``mesh`` (``parallel.make_mesh()``) trains over the processes of the
    initialised process group on ``mesh.device``, which replaces
    ``device``; the dataset overrides are sharded by rank like the h5
    dataset, over all the processes whatever the mesh's shape.  On a mesh
    with a ``model`` axis the returned model and state hold this rank's
    slices (``parallel.full_state_dict`` gathers them).  Without a process
    group it is the one-process run."""
    train_config = config["train_config"]
    pointnet_config = config["pointnet_config"]
    diffusion_config = config["diffusion_config"]
    trainset_config = config.get("mvp_dataset_config", config.get("dataset_config", {}))
    refine_config = config.get("refine_config", {})
    task = train_config.get("task", "completion")
    network_type = pointnet_config.get("network_type", "pointnet++")
    record_stats = bool(pointnet_config.get("record_neighbor_stats", False)
                        and network_type == "pointnet++")

    dev = mesh.device if mesh is not None else resolve_device(device)
    rank, world = (mesh.rank, mesh.world) if mesh is not None else (0, 1)
    root = train_config.get("root_directory", "exp")
    local_path = local_experiment_path(config)
    output_directory = os.path.join(
        root, local_path, train_config.get("output_directory", "logs/checkpoint"))
    os.makedirs(output_directory, exist_ok=True)
    tb = TensorBoardLogger(os.path.join(
        root, local_path, train_config.get("tensorboard_directory", "logs/tb"))) \
        if rank == 0 else _NoLogger()

    schedule = calc_diffusion_hyperparams(
        diffusion_config["T"], diffusion_config["beta_0"], diffusion_config["beta_T"])

    def train_split():
        if dataset_override is not None:
            return shard_dataset(dataset_override, mesh, pad=True)
        return make_dataset(trainset_config, "train", rank, world)

    dataset = train_split()
    batch_size = trainset_config.get("batch_size", 32)
    # the first batch, where the network or the statistics read it
    example = None
    if network_type == "pointwise_net" or record_stats:
        example = next(iterate_batches(dataset, batch_size, shuffle=False))
    model = build_model(
        pointnet_config, device=dev, seed=0,
        condition_features=(np.asarray(example["partial"]).shape[-1]
                            if network_type == "pointwise_net" else None))
    stats_acc = None
    if record_stats:
        # a one-shot report of the configuration's radius ladders on the
        # first batch, then every step's histograms, reported at each
        # checkpoint
        net_in = (example.get("generated", example["complete"])
                  if task == "refine_completion" else example["complete"])
        model_neighbor_stats(pointnet_config,
                             torch.as_tensor(np.asarray(net_in, np.float32)).to(dev),
                             _to_device(example, "partial", dev))
        stats_acc = NeighborStatsAccumulator()
    loader_len = max(1, len(dataset) // batch_size)
    n_iters = int(loader_len * train_config.get("n_epochs", 1))
    if max_steps is not None:
        n_iters = min(n_iters, max_steps)
    iters_per_ckpt = int(loader_len * train_config.get("epochs_per_ckpt", 1))
    iters_per_logging = train_config.get("iters_per_logging", 50)
    shuffle_seed = train_config.get("shuffle_seed")

    state = create_train_state(model, seed=rank + 1,
                               learning_rate=train_config.get("learning_rate", 2e-4))
    restored, ckpt_iter, prev_secs = maybe_resume(
        output_directory, train_config.get("ckpt_iter", "max"), state)
    if restored is not None:
        state = restored
        if world > 1:  # rank 0 saved its generator: the others draw anew
            state.generator.manual_seed((rank + 1) * 1_000_003 + ckpt_iter)
    n_iter = ckpt_iter + 1
    time0 = time.time() - prev_secs

    scale = trainset_config.get("scale", 1)
    upsample = int(pointnet_config.get("point_upsample_factor", 1))
    include_center = bool(
        pointnet_config.get("include_displacement_center_to_final_output", False))
    routes = dict(fused_gather=fused_gather, fused_sa=fused_sa, record_stats=record_stats)
    if task == "completion":
        make_step, step_args = make_completion_train_step, dict(schedule=schedule, **routes)
    else:
        make_step, step_args = make_refine_train_step, dict(
            scale=scale, cd_loss_type=refine_config.get("cd_loss_type", "cd_t"),
            point_upsample_factor=upsample, include_displacement_center=include_center,
            intermediate_loss_weight=(
                pointnet_config.get("intermediate_refined_X_loss_weight", 0.0)
                if upsample > 1 else 0.0),
            task=task, **routes,
        )
    if mesh is not None:
        compiled = mesh_step_compiled(mesh)
        if rank == 0:
            print(f"mesh step over {mesh.world} processes {mesh.shape}: "
                  + ("compiled" if compiled else "eager (gloo on CUDA tensors: a CUDA graph "
                     "cannot capture its collectives)"), flush=True)
        step_fn, state = jit_step_for_mesh(make_step, mesh, state, compiled=compiled,
                                           **step_args)
    else:
        step_fn = make_step(model, compiled=True, **step_args)

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

    # the step's output scale: one device buffer, refilled each step
    osf_buf = torch.zeros((), dtype=torch.float32, device=dev)

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
            graphs = sampler.graphs
        else:
            # compiled, as the JAX loop jits its refiner
            refiner = graphs = CapturedFunction(make_refiner(model, upsample, include_center))

            def gen_fn(batch):
                coarse = batch.get("generated", batch["complete"])
                return refiner(torch.as_tensor(np.asarray(coarse, np.float32)).to(dev),
                               _to_device(batch, "partial", dev),
                               _to_device(batch, "label", dev, torch.int64), osf_now)

        def eval_split(split_phase: str, tag: str):
            override = (eval_dataset_override if split_phase == "test"
                        else trainset_eval_dataset_override)
            # num_samples_tested in all, split across the processes
            if override is not None:
                eval_ds = shard_dataset(override, mesh, pad=False)
            else:
                eval_ds = make_dataset(trainset_config, split_phase, rank, world,
                                       eval_subset=max(1, num_samples_tested // world))
            res = evaluate(gen_fn, iterate_batches(eval_ds, bs, shuffle=False), scale=scale,
                           compute_emd=compute_emd, print_every=10 ** 9)
            os.makedirs(eval_dir, exist_ok=True)
            with open(os.path.join(
                    eval_dir, f"eval_result_ckpt_{n_iter_now}_rank_{rank}{tag}.pkl"),
                    "wb") as f:
                pickle.dump({"avg_cd": res.avg_cd, "avg_emd": res.avg_emd,
                             **{k: np.asarray(v) for k, v in res.metrics.items()}}, f)
            metrics = res.metrics
            if world > 1:
                metrics = {k: all_gather_host_arrays(v) for k, v in metrics.items()}
            return (float(np.mean(metrics["cd_distance"])),
                    float(np.mean(metrics["emd_distance"])), metrics)

        # the graphs are captured under the caller's full_parameters scope
        with graphs:
            avg_cd, avg_emd, metrics = eval_split("test", "")
            tb.add_scalar("CD-Loss", avg_cd, n_iter_now)
            tb.add_scalar("EMD-Loss", avg_emd, n_iter_now)
            if rank == 0:
                # one pickle per iteration, gathered from disk: a resumed run
                # keeps the evaluations from before the resume
                save_eval_result(eval_dir, n_iter_now, avg_cd, avg_emd, metrics)
                gather_eval_results(eval_dir)
            if test_trainset_during_eval:
                tr_cd, tr_emd, _ = eval_split("test_trainset", "_trainset")
                tb.add_scalar("Trainset CD-Loss", tr_cd, n_iter_now)
                tb.add_scalar("Trainset EMD-Loss", tr_emd, n_iter_now)
                print(f"eval @ iter {n_iter_now}: Trainset CD {tr_cd:.8f} EMD {tr_emd:.8f}",
                      flush=True)
            # rank 0's gathered value decides on every rank
            avg_cd = broadcast_scalar(avg_cd)
            print(f"eval @ iter {n_iter_now}: CD {avg_cd:.8f} EMD {avg_emd:.8f}", flush=True)
            return avg_cd, avg_emd

    loss_meter = AverageMeter()
    losses = []
    eval_records = {"iter": [], "avg_cd": [], "avg_emd": []}
    best_cd = None
    last_saved = None
    last_saved_best = None
    num_ckpts = 0

    step_seconds, batch_seconds = [], []
    while n_iter < n_iters:
        epoch = n_iter // loader_len
        seed = None if shuffle_seed is None else int(shuffle_seed) + epoch
        if trainset_config.get("randomly_select_generated_samples", False):
            # another random trial directory of generated samples each epoch
            dataset = train_split()
        t_batch = time.perf_counter()
        for batch in iterate_batches(dataset, batch_size, shuffle=True, drop_last=True,
                                     seed=seed):
            x0 = _to_device(batch, "complete", dev)
            condition = _to_device(batch, "partial", dev)
            label = _to_device(batch, "label", dev, torch.int64)
            if task == "completion":
                batch_seconds.append(time.perf_counter() - t_batch)
                out = step_fn(state, x0, condition, label)
            else:
                generated = torch.as_tensor(np.asarray(
                    batch.get("generated", batch["complete"]), np.float32)).to(dev)
                batch_seconds.append(time.perf_counter() - t_batch)
                out = step_fn(state, x0, condition, label, generated,
                              osf_buf.fill_(osf_at(n_iter)))
            if record_stats:
                state, loss, step_stats = out
                stats_acc.update(step_stats)
            else:
                state, loss = out
            loss_val = float(loss)
            step_seconds.append(time.perf_counter() - t_batch)
            loss_meter.update(loss_val)
            losses.append(loss_val)

            if n_iter % iters_per_logging == 0:
                print(f"iteration: {n_iter} \tloss: {loss_val:.6f}", flush=True)
                tb.add_scalar("Log-Train-Loss", float(np.log(max(loss_val, 1e-12))), n_iter)

            if n_iter > 0 and (n_iter + 1) % iters_per_ckpt == 0:
                num_ckpts += 1
                if rank == 0 and last_saved is not None and only_best:
                    shutil.rmtree(last_saved, ignore_errors=True)
                last_saved = save_checkpoint(
                    output_directory, n_iter, state,
                    training_time_seconds=time.time() - time0)
                if rank == 0:
                    print(f"checkpoint saved at iteration {n_iter}", flush=True)
                    if stats_acc is not None and stats_acc.forwards:
                        stats_acc.report()

                if (num_samples_tested > 0 and n_iter >= eval_start_iter
                        and num_ckpts % eval_per_ckpt == 0):
                    with full_parameters(model):
                        avg_cd, avg_emd = run_eval(n_iter, osf_at(n_iter))
                    eval_records["iter"].append(n_iter)
                    eval_records["avg_cd"].append(avg_cd)
                    eval_records["avg_emd"].append(avg_emd)
                    if only_best and rank == 0 and (best_cd is None or avg_cd <= best_cd):
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
            t_batch = time.perf_counter()

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
        "step_seconds": step_seconds,
        "batch_seconds": batch_seconds,
        "n_iter": n_iter,
        "eval_records": eval_records,
        "best_cd": best_cd,
        "neighbor_stats": stats_acc,
    }


class _NoLogger:
    """The scalar log of a rank other than 0: rank 0 writes it."""

    def add_scalar(self, *args, **kwargs):
        pass

    def close(self):
        pass


def train_from_file(config_path: str, **kw) -> dict:
    """``train`` on the JSON config at ``config_path`` (``load_config``)."""
    return train(load_config(config_path), **kw)
