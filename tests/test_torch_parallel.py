"""Multi-process training and generation on ``torch.distributed``.

``pad_batch_rows`` and the ragged gather (the collective injected) against
the JAX package's functions.  Then one spawn of two processes on gloo (the
CPU backend), whose results the tests below read:

- the ragged ``all_gather_host_arrays`` of ``tests/test_multihost_smoke.py``
  (5 rows on rank 0, 3 on rank 1), ``broadcast_scalar`` and ``barrier``;
- two DDPM steps through ``jit_step_for_mesh(compiled=False)``, the eager
  DDP step (``tests/test_torch_mesh_graph.py`` holds the compiled one), at
  tiny widths, each rank taking half of a batch of 4 and the draws (t, z)
  of its rows.  DDP
  averages the two halves' gradients, which is the whole batch's mean-loss
  gradient, so the first step equals a single-process step on the whole
  batch up to float32 summation order (rtol 1e-5): the loss, and the
  gradient of all parameters as one vector in relative L2 norm.  Single
  elements are not held: a tensor whose gradient is zero but for float32
  noise (a bias ahead of a GroupNorm, a softmax's shift: up to 2e-6 here)
  differs by 100% of itself, and batched products of 4 rows against two of
  2 sum in another order (1.2e-5 of a tensor's largest entry found).  The
  parameters after Adam are not held against the
  whole batch: Adam's first update, lr * g / (|g| + eps) an element,
  divides each element by its own size, so an element near float32 noise
  turns its rounding into up to 2 lr.  Both steps are held instead (rtol
  1e-5, every tensor, losses and parameters) against one process that runs
  the two halves itself and averages their gradients, which is what DDP
  computes; this holds DDP's second iteration too;
- ``run_generation(mesh=)`` of the (deterministic) refine task over 5
  in-memory clouds: 3 on rank 0 and 2 on rank 1, under ``rank_0`` /
  ``rank_1``, whose rank-0 merge must equal the one-process run's output
  (``tests/test_torch_refine.py``'s float32 tolerance: the batches differ);
- ``train(mesh=)`` with an in-loop eval: a pickle a rank, one gathered
  result, the broadcast CD equal on both ranks, parameters equal on both
  ranks, checkpoints from rank 0.
"""

import os
import pickle
import socket

import h5py
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from point_diffusion_refinement_tpu_torch.config import tiny_pointnet_config
from point_diffusion_refinement_tpu_torch.data import ArrayDataset, synthetic_dataset
from point_diffusion_refinement_tpu_torch.diffusion import calc_diffusion_hyperparams
from point_diffusion_refinement_tpu_torch.models import PointNet2CloudCondition
from point_diffusion_refinement_tpu_torch.parallel import (
    Mesh,
    all_gather_host_arrays,
    barrier,
    broadcast_scalar,
    initialize_distributed,
    make_mesh,
    mesh_from_environment,
    pad_batch_rows,
    shard_batch,
    shard_rows,
)
from point_diffusion_refinement_tpu_torch.parallel.multihost import _gather_ragged
from point_diffusion_refinement_tpu_torch.sample.pipeline import run_generation
from point_diffusion_refinement_tpu_torch.train import (
    create_train_state,
    jit_step_for_mesh,
    make_completion_loss,
    make_completion_train_step,
)
from point_diffusion_refinement_tpu_torch.train.loop import train
from torch_threads import one_torch_thread  # noqa: F401

STEP_TOL = dict(rtol=1e-5, atol=1e-7)
F32_TOL = dict(rtol=1e-4, atol=2e-5)  # tests/test_torch_refine.py's
B, N, M, T = 4, 48, 48, 8
N_GEN, F = 5, 2  # clouds generated, upsampling of the refine task


def _model(include_t=True, seed=0):
    cfg = {**tiny_pointnet_config(include_t=include_t), "compute_dtype": "float32"}
    if not include_t:
        cfg.update(point_upsample_factor=F, include_displacement_center_to_final_output=False)
    return PointNet2CloudCondition.from_config(cfg, device="cpu", seed=seed), cfg


def _step_batches():
    """Two global batches with their draws, from numpy."""
    rng = np.random.default_rng(7)
    data = synthetic_dataset(2 * B, N, 32, seed=3, mirror_to=M).arrays
    out = []
    for k in range(2):
        sl = slice(k * B, (k + 1) * B)
        out.append((data["complete"][sl], data["partial"][sl], data["label"][sl],
                    rng.integers(0, T, B), rng.standard_normal((B, N, 3)).astype(np.float32)))
    return out


def _params(model):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def _gen_data():
    rng = np.random.default_rng(11)
    return ArrayDataset(
        complete=rng.uniform(-0.5, 0.5, (N_GEN, N * F, 3)).astype(np.float32),
        partial=np.concatenate([rng.uniform(-0.5, 0.5, (N_GEN, M, 3)),
                                rng.integers(0, 2, (N_GEN, M, 1)) * 2.0 - 1.0],
                               axis=-1).astype(np.float32),
        label=rng.integers(0, 16, N_GEN),
        generated=rng.uniform(-0.5, 0.5, (N_GEN, N, 3)).astype(np.float32))


def _gen_config(base):
    _, pc = _model(include_t=False)
    return {"diffusion_config": {"T": T, "beta_0": 1e-4, "beta_T": 0.02},
            "pointnet_config": {**pc, "model_name": "tiny"},
            "train_config": {"task": "refine_completion", "root_directory": base},
            "mvp_dataset_config": {"npoints": N * F, "scale": 1, "eval_batch_size": 4},
            "refine_config": {"exp_name": "r", "output_scale_factor": 0.001}}


def _generate(base, mesh):
    model, _ = _model(include_t=False, seed=21)
    (res,) = run_generation(_gen_config(base), state_override=model,
                            dataset_override=_gen_data(), base_save_dir=base,
                            compute_emd=False, device="cpu", mesh=mesh)
    return res


def _train_config(root):
    return {"diffusion_config": {"T": T, "beta_0": 1e-4, "beta_T": 0.02},
            "pointnet_config": {**tiny_pointnet_config(), "model_name": "tiny"},
            "train_config": {"task": "completion", "root_directory": root, "n_epochs": 1,
                             "epochs_per_ckpt": 1, "iters_per_logging": 1,
                             "shuffle_seed": 0, "compute_emd": False},
            "mvp_dataset_config": {"batch_size": 2, "eval_batch_size": 2,
                                   "num_samples_tested": 4, "npoints": N}}


def _worker(rank, port, out):
    torch.set_num_threads(1)
    initialize_distributed(backend="gloo", init_method=f"tcp://127.0.0.1:{port}",
                           world_size=2, rank=rank)
    try:
        res = {}
        n = 5 if rank == 0 else 3
        res["gathered"] = all_gather_host_arrays(
            (np.arange(n * 2, dtype=np.float32) + 100 * rank).reshape(n, 2))
        res["gathered_0d"] = all_gather_host_arrays(np.float32(rank))
        res["broadcast"] = broadcast_scalar(rank + 1.5)
        barrier()
        mesh = make_mesh(device="cpu")
        res["mesh"] = (mesh.rank, mesh.world, mesh.shape, mesh.distributed)

        model, _ = _model()
        state = create_train_state(model, seed=rank + 1)
        step, state = jit_step_for_mesh(
            make_completion_train_step, mesh, state,
            schedule=calc_diffusion_hyperparams(T, 1e-4, 0.02), fused_gather=True,
            fused_sa=True, compiled=False)
        res["losses"], res["params"] = [], []
        for batch in _step_batches():
            x0, cond, label, t, z = map(torch.as_tensor, shard_batch(batch, mesh))
            state, loss = step(state, x0, cond, label, t=t, z=z)
            res["losses"].append(float(loss))
            res["params"].append(_params(model))
            if len(res["losses"]) == 1:
                res["grads"] = {k: p.grad.numpy().copy() for k, p in model.named_parameters()}

        gen = _generate(os.path.join(out, "gen"), mesh)
        res["gen_metrics"] = gen.metrics

        data = synthetic_dataset(8, N, 32, seed=5, mirror_to=M)
        evald = synthetic_dataset(4, N, 32, seed=6, mirror_to=M)
        tr = train(_train_config(os.path.join(out, "train")), max_steps=2, mesh=mesh,
                   dataset_override=data, eval_dataset_override=evald)
        res["train"] = {"losses": tr["losses"], "eval": tr["eval_records"],
                        "n_iter": tr["n_iter"],
                        "params": {k: v.numpy().copy() for k, v in
                                   tr["model"].state_dict().items()}}
        with open(os.path.join(out, f"rank_{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("world2"))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.spawn(_worker, args=(port, out), nprocs=2, join=True)
    res = []
    for r in range(2):
        with open(os.path.join(out, f"rank_{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    return out, res


def test_pad_batch_rows_matches_jax():
    from point_diffusion_refinement_tpu.parallel.mesh import pad_batch_rows as j_pad

    a = np.arange(14, dtype=np.float32).reshape(7, 2)
    for m in (1, 2, 3, 4, 7, 8):
        np.testing.assert_array_equal(pad_batch_rows(a, m), j_pad(a, m))


def test_gather_ragged_matches_jax():
    from point_diffusion_refinement_tpu.parallel.multihost import _gather_ragged as j_gather

    shards = [np.full((n, 3), i, np.float32) for i, n in enumerate((4, 2, 3))]

    def fake(me):
        """Process ``me``'s view of an all-gather over the three shards."""
        def allgather(x):
            if x.shape == (1,):
                return np.stack([np.asarray([len(s)]) for s in shards])
            return np.stack([np.concatenate([s, np.zeros((x.shape[0] - len(s), 3),
                                                         np.float32)]) for s in shards])
        return allgather

    for me, x in enumerate(shards):
        got = _gather_ragged(x, fake(me))
        np.testing.assert_array_equal(got, j_gather(x, fake(me)))
        np.testing.assert_array_equal(got, np.concatenate(shards))


def test_shard_rows_and_one_process_mesh():
    for n, world in ((5, 2), (8, 2), (7, 3), (2, 4)):
        held = [shard_rows(n, Mesh(r, world, torch.device("cpu")), pad=False)
                for r in range(world)]
        np.testing.assert_array_equal(np.concatenate(held), np.arange(n))
        padded = [shard_rows(n, Mesh(r, world, torch.device("cpu")), pad=True)
                  for r in range(world)]
        assert len({len(p) for p in padded}) == 1
    mesh = make_mesh(device="cpu")
    assert (mesh.rank, mesh.world, mesh.distributed) == (0, 1, False)
    assert all_gather_host_arrays(np.ones(3)).shape == (3,)
    assert broadcast_scalar(2.5) == 2.5
    with pytest.raises(ValueError):
        make_mesh(model_parallel=2, device="cpu")
    with pytest.raises(ValueError):
        make_mesh(n_devices=2, device="cpu")
    with pytest.raises(ValueError):
        shard_batch(np.zeros((3, 1)), Mesh(0, 2, torch.device("cpu")))


def test_collectives(world2):
    _, res = world2
    expected = np.concatenate([np.arange(10, dtype=np.float32).reshape(5, 2),
                               (np.arange(6, dtype=np.float32) + 100).reshape(3, 2)])
    for r in res:
        np.testing.assert_array_equal(r["gathered"], expected)
        np.testing.assert_array_equal(r["gathered_0d"], [0.0, 1.0])
        assert r["broadcast"] == 1.5
    assert [r["mesh"] for r in res] == [(0, 2, {"data": 2, "model": 1}, True),
                                        (1, 2, {"data": 2, "model": 1}, True)]


def test_ddp_step_equals_one_process_step(world2):
    _, res = world2
    model, _ = _model()
    state = create_train_state(model, seed=1)
    step = make_completion_train_step(model, calc_diffusion_hyperparams(T, 1e-4, 0.02),
                                      fused_gather=True, fused_sa=True)
    x0, cond, label, t, z = map(torch.as_tensor, _step_batches()[0])
    state, loss = step(state, x0, cond, label, t=t, z=z)
    grads = {k: p.grad.numpy() for k, p in model.named_parameters()}
    flat = np.concatenate([g.ravel() for g in grads.values()])
    for r in res:
        np.testing.assert_allclose(r["losses"][0], float(loss), **STEP_TOL)
        got = np.concatenate([r["grads"][k].ravel() for k in grads])
        rel = np.linalg.norm(got - flat) / np.linalg.norm(flat)
        assert rel <= STEP_TOL["rtol"], rel


def test_ddp_steps_equal_emulated_data_parallel(world2):
    _, res = world2
    model, _ = _model()
    state = create_train_state(model, seed=1)
    loss_fn = make_completion_loss(model, calc_diffusion_hyperparams(T, 1e-4, 0.02),
                                   fused_gather=True, fused_sa=True)
    named = dict(model.named_parameters())
    for k, batch in enumerate(_step_batches()):
        halves = [shard_batch(batch, Mesh(r, 2, torch.device("cpu"))) for r in range(2)]
        losses, grads = [], []
        for x0, cond, label, t, z in (map(torch.as_tensor, h) for h in halves):
            loss = loss_fn(x0, cond, label, t, z)
            losses.append(float(loss.detach()))
            grads.append(torch.autograd.grad(loss, list(named.values())))
        for p, g0, g1 in zip(named.values(), *grads):
            p.grad = g0 / 2 + g1 / 2
        state.optimizer.step()
        for r in res:
            np.testing.assert_allclose(r["losses"][k], np.mean(losses), **STEP_TOL)
            for name, v in _params(model).items():
                np.testing.assert_allclose(r["params"][k][name], v, **STEP_TOL, err_msg=name)


def test_generation_rank_dirs_merge_to_one_process_output(world2, tmp_path):
    out, res = world2
    leaf = os.path.join("T8_betaT0.02_tiny", "refine_exp_r", "ckpt_0", "test")
    name = f"mvp_generated_data_{N * F}pts.h5"
    gen = os.path.join(out, "gen", leaf)
    lengths = []
    for r in range(2):
        with h5py.File(os.path.join(gen, f"rank_{r}", name), "r") as f:
            lengths.append(f["data"].shape[0])
    assert lengths == [3, 2]
    one = _generate(str(tmp_path), None)
    with h5py.File(os.path.join(gen, name), "r") as f:
        merged = np.array(f["data"])
    with h5py.File(os.path.join(tmp_path, leaf, name), "r") as f:
        np.testing.assert_allclose(merged, np.array(f["data"]), **F32_TOL)
    with open(os.path.join(gen, "eval_result.pkl"), "rb") as f:
        merged_pkl = pickle.load(f)
    for k, v in one.metrics.items():
        np.testing.assert_allclose(merged_pkl["metrics"][k], v, **F32_TOL, err_msg=k)
        for r in res:  # gathered over the processes: every rank has all five
            np.testing.assert_allclose(r["gen_metrics"][k], v, **F32_TOL, err_msg=k)


def test_train_with_mesh(world2):
    out, res = world2
    a, b = res[0]["train"], res[1]["train"]
    assert a["n_iter"] == b["n_iter"] == 2
    assert a["eval"]["iter"] == b["eval"]["iter"] == [1]
    assert a["eval"]["avg_cd"] == b["eval"]["avg_cd"]  # rank 0's, broadcast
    assert np.isfinite(a["losses"]).all() and np.isfinite(b["losses"]).all()
    for k, v in a["params"].items():
        np.testing.assert_array_equal(b["params"][k], v, err_msg=k)
    exp = os.path.join(out, "train", "T8_betaT0.02_tiny")
    evald = os.path.join(exp, "eval_result")
    for r in range(2):
        with open(os.path.join(evald, f"eval_result_ckpt_1_rank_{r}.pkl"), "rb") as f:
            assert len(pickle.load(f)["cd_distance"]) == 2  # the rank's half
    with open(os.path.join(evald, "gathered_eval_result.pkl"), "rb") as f:
        gathered = pickle.load(f)
    assert gathered["iter"] == [1]
    np.testing.assert_allclose(gathered["avg_cd"], a["eval"]["avg_cd"])
    assert sorted(os.listdir(os.path.join(exp, "logs", "checkpoint"))) == [
        "pointnet_ckpt_1", "pointnet_ckpt_2"]


def test_mesh_from_environment(monkeypatch):
    """The CLIs' entry under torchrun: no WORLD_SIZE, one process; with
    torchrun's environment, a gloo group of the given world on the CPU."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert mesh_from_environment("cpu") is None
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in dict(WORLD_SIZE="1", RANK="0", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    try:
        mesh = mesh_from_environment("cpu")
        assert (mesh.rank, mesh.world, mesh.distributed) == (0, 1, True)
        assert torch.distributed.get_backend() == "gloo"
    finally:
        torch.distributed.destroy_process_group()
