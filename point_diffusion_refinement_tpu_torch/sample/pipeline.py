"""The generation pipeline: checkpoint discovery, the save-dir taxonomy, and
multi-trial (optionally augmented) generation.

Counterpart of the JAX package's ``sample/pipeline.py``.  ``run_generation``
restores a checkpoint (or takes the state handed in), builds the dataset of
a phase, and per trial generates every cloud (the reverse process for the
DDPM, one refine forward a batch for the refinement task), evaluates it and
writes the clouds (where ``h5py`` imports) and ``eval_result.pkl`` under
``generation_save_dir``, the layout the refine config's
``generated_sample_path`` reads back.  Generation runs compiled, as the
JAX package's jitted programs do: the ancestral sampler as a captured CUDA
graph of one reverse step replayed in chunks of ``segment_size`` steps
(200 by default, as there), FastDPM and the refiner as captured whole
programs (``utils/graphs.py``).  With ``mesh=`` each process of the
process group generates its rank's shard of the phase into
``<save_dir>/rank_<i>``; the metrics are gathered over the processes, so
every rank returns the same averages, and after a barrier rank 0 merges the
rank directories (``gather_generated_results``).
"""

from __future__ import annotations

import os
import pickle
import shutil
from typing import Optional

import numpy as np
import torch

from ..config.loader import load_config
from ..diffusion import calc_diffusion_hyperparams, make_fast_sampling_plan
from ..models.pointwise_net import PointwiseNet
from ..parallel.mesh import full_parameters, shard_dataset
from ..parallel.multihost import all_gather_host_arrays, barrier
from ..train.checkpoints import CKPT_PREFIX, STATE_FILE, find_max_epoch, maybe_resume
from ..train.step import TrainState, create_train_state
from ..utils.device import DeviceLike, resolve_device
from ..utils.graphs import CapturedFunction
from .evaluate import evaluate
from .generate import make_coarse_sampler, make_refiner


def generation_save_dir(
    config: dict,
    ckpt_iter: int,
    *,
    fast_sampling: bool = False,
    fast_sampling_config: Optional[dict] = None,
    trial_index: Optional[int] = None,
    phase: str = "test",
    base_dir: Optional[str] = None,
) -> str:
    """<data>/generated_samples/<local_path>/ckpt_<it>[/fast_sampling/<cfg>]
    [/trial_<i>]/<train|test>."""
    from ..train.loop import local_experiment_path  # train.loop imports sample

    ts = config.get("mvp_dataset_config", {})
    base = base_dir or os.path.join(ts.get("data_dir", "data"), "generated_samples")
    save_dir = os.path.join(base, local_experiment_path(config), f"ckpt_{ckpt_iter}")
    if fast_sampling:
        cfg = fast_sampling_config or {}
        tag = "fast_sampling_config" + "".join(f"_{k}_{v}" for k, v in cfg.items())
        save_dir = os.path.join(save_dir, "fast_sampling", tag)
    if trial_index is not None:
        save_dir = os.path.join(save_dir, f"trial_{trial_index}")
    sub = {"test": "test", "test_trainset": "train"}[phase]
    return os.path.join(save_dir, sub)


def _restore(config: dict, ckpt_iter, dev: torch.device):
    """(model, iteration) of the checkpoint ``ckpt_iter`` ('max', 'best' or an
    int) under the experiment's checkpoint directory."""
    from ..train.loop import build_model, local_experiment_path

    train_config = config["train_config"]
    root = train_config.get("root_directory", "exp")
    # gen_config.ckpt_path overrides where training wrote its checkpoints
    gen_ckpt = config.get("gen_config", {}).get(
        "ckpt_path", train_config.get("output_directory", "logs/checkpoint"))
    ckpt_dir = os.path.join(root, local_experiment_path(config), gen_ckpt)
    it = find_max_epoch(ckpt_dir, ckpt_iter) if ckpt_iter in ("max", "best") else int(ckpt_iter)
    if it < 0:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    cond_w = None
    if config["pointnet_config"].get("network_type") == "pointwise_net":
        # the condition width its global encoder was built for (the JAX
        # pipeline initialises from a batch of the dataset)
        blob = torch.load(os.path.join(ckpt_dir, f"{CKPT_PREFIX}_{it}", STATE_FILE),
                          map_location="cpu", weights_only=True)
        cond_w = blob["model_state_dict"][PointwiseNet.CONDITION_WEIGHT].shape[1]
    model = build_model(config["pointnet_config"], device=dev, seed=0,
                        condition_features=cond_w)
    state, _, _ = maybe_resume(ckpt_dir, it, create_train_state(model))
    if state is None:
        raise FileNotFoundError(f"checkpoint {it} under {ckpt_dir}")
    return state.model, it


def run_generation(
    config: dict,
    *,
    phase: str = "test",
    ckpt_iter="max",
    fast_sampling: bool = False,
    fast_sampling_config: Optional[dict] = None,
    num_trials: int = 1,
    augment_data_during_generation: bool = False,
    num_samples_tested: Optional[int] = None,
    save_generated: bool = True,
    keep_generated: bool = False,
    state_override=None,
    dataset_override=None,
    base_save_dir: Optional[str] = None,
    batch_size: Optional[int] = None,
    t_slices=None,
    compute_emd: bool = True,
    use_a_precomputed_XT: bool = False,
    T_step: int = 100,
    XT_folder: Optional[str] = None,
    segment_size: Optional[int] = 200,
    mesh=None,
    device: DeviceLike = None,
    fused_attention: bool = False,
    fused_knn: bool = False,
    packed: bool = False,
):
    """Generate (and evaluate) the clouds of a phase ('test' or
    'test_trainset'), once per trial; returns one ``EvalResult`` a trial.

    ``state_override`` (a ``TrainState`` or the model itself) replaces the
    checkpoint; its outputs go under ``ckpt_0``.  Trial i draws its noise from a
    generator on the device seeded ``1000 + i``.  ``fused_attention``,
    ``fused_knn`` and ``packed`` turn on the opt-in inference routes of the
    sampler and the refiner (all off by default).  The results hold the
    generated clouds where they are saved or ``keep_generated`` is set.

    On the card generation runs as captured CUDA graphs: the ancestral
    reverse step replayed in chunks of ``segment_size`` steps (None: the
    whole schedule in one chunk, as the JAX package jits it whole), the
    FastDPM step over the whole plan, the refiner's whole forward.  The
    graphs are captured inside the scope that holds the parameters whole
    and released at its end.  The clouds are those of eager generation.

    ``mesh`` (``parallel.make_mesh()``) generates on ``mesh.device``, which
    replaces ``device``; each of the mesh's ``world`` processes, whatever
    its shape (data x model), takes its rank's contiguous shard of the
    phase, ceil(n / world) rows a rank in rank order (a ``dataset_override``
    is split by the same rule), and at world > 1 saves under ``rank_<i>``
    and returns the metrics of every rank.  The parameters are held whole
    on every rank: a ``state_override`` sharded over the mesh's ``model``
    axis is gathered for the duration, and a checkpoint is read whole.  So
    the merged clouds are the ones one process writes.
    """
    from ..data import iterate_batches
    from ..train.loop import make_dataset  # train.loop imports sample

    dev = mesh.device if mesh is not None else resolve_device(device)
    rank, world = (mesh.rank, mesh.world) if mesh is not None else (0, 1)
    pointnet_config = config["pointnet_config"]
    dc = config["diffusion_config"]
    ts_cfg = config.get("mvp_dataset_config", {})
    schedule = calc_diffusion_hyperparams(dc["T"], dc["beta_0"], dc["beta_T"])
    # the refinement task generates with one forward + point_upsample a batch
    refine_task = config["train_config"].get("task", "completion") == "refine_completion"
    output_scale_factor = config.get("refine_config", {}).get("output_scale_factor", 0.001)
    routes = dict(fused_attention=fused_attention, fused_knn=fused_knn, packed=packed)

    if state_override is not None:
        model = state_override.model if isinstance(state_override, TrainState) else state_override
        it = 0
        if next(model.parameters()).device.type != dev.type:
            raise ValueError(f"state_override lies on {next(model.parameters()).device}, "
                             f"not on {dev}")
    else:
        model, it = _restore(config, ckpt_iter, dev)

    plan = None
    if fast_sampling:
        fs = dict(fast_sampling_config or {})
        plan = make_fast_sampling_plan(
            schedule, dc["T"], dc["beta_0"], dc["beta_T"],
            length=fs.get("length", 50),
            sampling_method=fs.get("sampling_method", "var"),
            noise_schedule=fs.get("schedule", "quadratic"),
            kappa=fs.get("kappa", 0.5),
        )

    if refine_task:
        # the counterpart of the JAX package's jax.jit(make_refiner(...))
        refiner = CapturedFunction(make_refiner(
            model, int(pointnet_config.get("point_upsample_factor", 1)),
            bool(pointnet_config.get("include_displacement_center_to_final_output", False)),
            **routes))
        graphs = refiner
    else:
        # FastDPM plans are short: their whole plan is one chunk
        seg = plan.S if plan is not None else (segment_size or schedule.T)
        sampler = make_coarse_sampler(
            model, schedule, num_points=ts_cfg.get("npoints", 2048), fast_plan=plan,
            t_slices=t_slices, warm_start_step=T_step if use_a_precomputed_XT else None,
            segment_size=seg, **routes)
        graphs = sampler.graphs

    def tensor(batch, key, dtype=torch.float32):
        return torch.as_tensor(np.asarray(batch[key])).to(device=dev, dtype=dtype)

    scale = ts_cfg.get("scale", 1)
    bs = batch_size or ts_cfg.get("eval_batch_size", 32)
    results = []
    # generation holds the parameters whole: a model sharded over the mesh's
    # model axis is gathered for the trials (a collective of its model row)
    # (the graphs, captured in this scope, are released at its end)
    with full_parameters(model), graphs:
        for trial in range(num_trials):
            if dataset_override is not None:
                dataset = shard_dataset(dataset_override, mesh, pad=False)
            else:
                ds_cfg = dict(ts_cfg)
                if augment_data_during_generation:
                    # augment, and hand back M_inv / translation to undo it
                    ds_cfg["return_augmentation_params"] = True
                    ds_cfg["augment_data_during_generation"] = True
                if use_a_precomputed_XT:
                    ds_cfg["load_pre_computed_XT"] = True
                    ds_cfg["T_step"] = T_step
                    if XT_folder is not None:
                        ds_cfg["XT_folder"] = XT_folder
                dataset = make_dataset(ds_cfg, phase, rank, world, eval_subset=num_samples_tested)

            if refine_task:
                def gen_fn(batch):
                    coarse = batch["generated"] if "generated" in batch else batch["complete"]
                    return refiner(torch.as_tensor(np.asarray(coarse, np.float32)).to(dev),
                                   tensor(batch, "partial"), tensor(batch, "label", torch.int64),
                                   output_scale_factor)
            else:
                gen = torch.Generator(device=dev)
                gen.manual_seed(1000 + trial)

                def gen_fn(batch):
                    XT = tensor(batch, "XT") if use_a_precomputed_XT and "XT" in batch else None
                    return sampler(tensor(batch, "partial"), tensor(batch, "label", torch.int64),
                                   generator=gen, XT=XT)

            save_dir = None
            if save_generated:
                save_dir = generation_save_dir(
                    config, it, fast_sampling=fast_sampling,
                    fast_sampling_config=fast_sampling_config,
                    trial_index=trial + 1 if num_trials > 1 else None,
                    phase=phase, base_dir=base_save_dir)
                if world > 1:
                    save_dir = os.path.join(save_dir, f"rank_{rank}")
                os.makedirs(save_dir, exist_ok=True)
            res = evaluate(
                gen_fn, iterate_batches(dataset, bs, shuffle=False), scale=scale,
                save_generated_samples=save_generated, save_dir=save_dir,
                keep_generated=keep_generated,
                unaugment_results=augment_data_during_generation, compute_emd=compute_emd)
            if save_dir is not None:
                with open(os.path.join(save_dir, "eval_result.pkl"), "wb") as f:
                    pickle.dump({"avg_cd": res.avg_cd, "avg_emd": res.avg_emd,
                                 "metrics": res.metrics, "labels": res.labels}, f)
            if world > 1:
                # every rank holds its shard's metrics: gather them, so the
                # averages (and any decision taken on them) agree on all ranks
                res.metrics = {k: all_gather_host_arrays(v) for k, v in res.metrics.items()}
                res.labels = all_gather_host_arrays(res.labels)
                res.avg_cd = float(np.mean(res.metrics["cd_distance"]))
                res.avg_emd = float(np.mean(res.metrics["emd_distance"]))
                if save_dir is not None:
                    barrier("pdr_generation_trial")
                    if rank == 0:
                        gather_generated_results(os.path.dirname(save_dir), world)
            results.append(res)
            print(f"trial {trial}: avg CD {res.avg_cd:.8f} avg EMD {res.avg_emd:.8f} "
                  f"({res.total_generation_time:.1f}s generation)", flush=True)
    return results


def gather_generated_results(parent_dir: str, world_size: int,
                             delete_rank_dirs: bool = False) -> Optional[str]:
    """Merge per-rank generation outputs ``rank_{i}/*.h5`` into
    ``parent_dir``: the h5 ``data`` arrays concatenated rank-ascending (the
    dataset's rank sharding order) and the per-rank ``eval_result.pkl``
    merged.  Returns the merged h5 path, or None when ``h5py`` does not
    import or a rank's directory or file is missing."""
    try:
        import h5py
    except ImportError:  # pragma: no cover
        return None
    rank_dirs = [os.path.join(parent_dir, f"rank_{i}") for i in range(world_size)]
    if not all(os.path.isdir(d) for d in rank_dirs):
        return None
    merged_path = None
    for name in sorted(f for f in os.listdir(rank_dirs[0]) if f.endswith(".h5")):
        chunks = []
        for d in rank_dirs:
            p = os.path.join(d, name)
            if not os.path.exists(p):
                return None
            with h5py.File(p, "r") as f:
                chunks.append(np.array(f["data"]))
        merged_path = os.path.join(parent_dir, name)
        with h5py.File(merged_path, "w") as f:
            f.create_dataset("data", data=np.concatenate(chunks, axis=0))
    pkls = [os.path.join(d, "eval_result.pkl") for d in rank_dirs]
    if all(os.path.exists(p) for p in pkls):
        payloads = []
        for p in pkls:
            with open(p, "rb") as f:
                payloads.append(pickle.load(f))
        metrics = {k: np.concatenate([pl["metrics"][k] for pl in payloads])
                   for k in payloads[0]["metrics"]}
        with open(os.path.join(parent_dir, "eval_result.pkl"), "wb") as f:
            pickle.dump({
                "avg_cd": float(np.mean(metrics["cd_distance"])),
                "avg_emd": float(np.mean(metrics["emd_distance"])),
                "metrics": metrics,
                "labels": np.concatenate([pl["labels"] for pl in payloads]),
            }, f)
    if delete_rank_dirs:
        for d in rank_dirs:
            shutil.rmtree(d, ignore_errors=True)
    return merged_path


def run_generation_from_file(config_path: str, **kw):
    """``run_generation`` on the JSON config at ``config_path``."""
    return run_generation(load_config(config_path), **kw)
