"""The mesh's ``model`` axis: parameter sharding against the JAX package and
against one process.

(1) The rule.  On the tiny, a widened tiny and the full config, the tensors
the port's ``param_sharding_rule`` shards are, by state-dict name and torch
dimension, the leaves the JAX package's rule puts on ``P(..., "model")``
(``jax.eval_shape`` of ``model.init``, names mapped through
``utils/weights.py``: a ``kernel`` becomes a ``weight`` whose output
dimension is dim 0).  The full config shards 104 of its 837 tensors, 83.2%
of the parameters.

Then one spawn of two gloo processes on a (1, 2) mesh, whose results the
tests below read.  The config is the tiny one widened (``t_dim`` 32,
``class_condition_dim`` 128) so that four tensors, one of them the class
embedding along its last dimension, reach the rule's 128, in float32:

(2) two DDPM steps through ``jit_step_for_mesh``, each rank taking half of
a batch of 4 and the draws of its rows.  Held against one process that runs
the two halves itself and averages their gradients, as
``tests/test_torch_parallel.py`` does (rtol 1e-5, every tensor): the losses,
the gathered parameters and the gathered Adam moments after each step.  The
first loss is also held against the JAX package's ``jit_step_for_mesh`` on
``make_mesh(4, model_parallel=2)`` at the same weights and the JAX step's
own t / z draws (rtol 2e-5, ``tests/test_torch_train.py``'s: float32 on
both sides, summation order only).  Each rank stores its slices of the
sharded tensors and of their moments, and the replicated tensors whole;
(3) the checkpoint the sharded run saves (rank 0 writes) loads into one
process and equals the gathered state, and a one-process checkpoint loaded
under the mesh is sliced and gathers back to itself; ``train(mesh=)`` with
an in-loop eval saves checkpoints that load in one process;
(4) ``run_generation(mesh=)`` of the refine task with a sharded model
merges to the one-process output (``tests/test_torch_refine.py``'s float32
tolerance: the batches differ) and leaves the model's slices in place.
"""

import os
import pickle
import socket

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from point_diffusion_refinement_tpu.config import DEFAULT_POINTNET_CONFIG, tiny_pointnet_config
from point_diffusion_refinement_tpu.diffusion import calc_diffusion_hyperparams as jax_schedule
from point_diffusion_refinement_tpu.models import PointNet2CloudCondition as JaxModel
from point_diffusion_refinement_tpu.parallel import mesh as jmesh
from point_diffusion_refinement_tpu.train import step as jstep
from point_diffusion_refinement_tpu_torch.data import ArrayDataset, synthetic_dataset
from point_diffusion_refinement_tpu_torch.diffusion import calc_diffusion_hyperparams
from point_diffusion_refinement_tpu_torch.models import PointNet2CloudCondition
from point_diffusion_refinement_tpu_torch.parallel import (
    Mesh,
    full_optimizer_state_dict,
    full_state_dict,
    initialize_distributed,
    make_mesh,
    param_sharding_rule,
    shard_batch,
    shard_params,
)
from point_diffusion_refinement_tpu_torch.sample.pipeline import run_generation
from point_diffusion_refinement_tpu_torch.train import (
    create_train_state,
    jit_step_for_mesh,
    load_checkpoint,
    make_completion_loss,
    make_completion_train_step,
    save_checkpoint,
)
from point_diffusion_refinement_tpu_torch.train.loop import train
from point_diffusion_refinement_tpu_torch.utils.weights import state_dict_to_flax
from torch_threads import one_torch_thread  # noqa: F401

STEP_TOL = dict(rtol=1e-5, atol=1e-7)
LOSS_RTOL = 2e-5
F32_TOL = dict(rtol=1e-4, atol=2e-5)
B, N, M, T = 4, 48, 48, 8
N_GEN, F = 5, 2
WIDE = dict(t_dim=32, class_condition_dim=128)
CONFIGS = {
    "tiny": lambda: tiny_pointnet_config(),
    "wide": lambda: {**tiny_pointnet_config(), **WIDE},
    "full": lambda: dict(DEFAULT_POINTNET_CONFIG),
}
WIDE_SHARDED = {"class_emb.embedding": 1, "fc_t1.weight": 0, "fc_t2.weight": 0,
                "head_mid.weight": 0}


def _cfg(include_t=True):
    cfg = {**tiny_pointnet_config(include_t=include_t, levels=1), **WIDE, "compute_dtype": "float32"}
    if not include_t:
        cfg.update(point_upsample_factor=F, include_displacement_center_to_final_output=False)
    return cfg


def _model(include_t=True, seed=0):
    return PointNet2CloudCondition.from_config(_cfg(include_t), device="cpu", seed=seed)


def _step_batches():
    """Two global batches with numpy draws (the first batch's draws are
    replaced by the JAX step's own)."""
    rng = np.random.default_rng(7)
    data = synthetic_dataset(2 * B, N, 32, seed=3, mirror_to=M).arrays
    out = []
    for k in range(2):
        sl = slice(k * B, (k + 1) * B)
        out.append([data["complete"][sl], data["partial"][sl], data["label"][sl],
                    rng.integers(0, T, B), rng.standard_normal((B, N, 3)).astype(np.float32)])
    return out


def _numpy(sd):
    return {k: v.detach().numpy().copy() for k, v in sd.items()}


def _moments(osd, names):
    """{name: (exp_avg, exp_avg_sq)} of an Adam state dict."""
    return {names[i]: (s["exp_avg"].numpy().copy(), s["exp_avg_sq"].numpy().copy())
            for i, s in osd["state"].items()}


def _gen_data():
    rng = np.random.default_rng(11)
    return ArrayDataset(
        complete=rng.uniform(-0.5, 0.5, (N_GEN, N * F, 3)).astype(np.float32),
        partial=np.concatenate([rng.uniform(-0.5, 0.5, (N_GEN, M, 3)),
                                rng.integers(0, 2, (N_GEN, M, 1)) * 2.0 - 1.0],
                               axis=-1).astype(np.float32),
        label=rng.integers(0, 16, N_GEN),
        generated=rng.uniform(-0.5, 0.5, (N_GEN, N, 3)).astype(np.float32))


def _generate(base, mesh, model):
    cfg = {"diffusion_config": {"T": T, "beta_0": 1e-4, "beta_T": 0.02},
           "pointnet_config": {**_cfg(False), "model_name": "tiny"},
           "train_config": {"task": "refine_completion", "root_directory": base},
           "mvp_dataset_config": {"npoints": N * F, "scale": 1, "eval_batch_size": 4},
           "refine_config": {"exp_name": "r", "output_scale_factor": 0.001}}
    (res,) = run_generation(cfg, state_override=model, dataset_override=_gen_data(),
                            base_save_dir=base, compute_emd=False, device="cpu", mesh=mesh)
    return res


def _train_config(root):
    return {"diffusion_config": {"T": T, "beta_0": 1e-4, "beta_T": 0.02},
            "pointnet_config": {**_cfg(), "model_name": "tiny"},
            "train_config": {"task": "completion", "root_directory": root, "n_epochs": 1,
                             "epochs_per_ckpt": 1, "iters_per_logging": 1,
                             "shuffle_seed": 0, "compute_emd": False},
            "mvp_dataset_config": {"batch_size": 2, "eval_batch_size": 2,
                                   "num_samples_tested": 4, "npoints": N}}


def _names(model):
    return [n for n, _ in model.named_parameters()]


def _worker(rank, port, out, batches):
    torch.set_num_threads(1)
    initialize_distributed(backend="gloo", init_method=f"tcp://127.0.0.1:{port}",
                           world_size=2, rank=rank)
    try:
        res = {}
        mesh = make_mesh(model_parallel=2, device="cpu")
        res["mesh"] = (mesh.rank, mesh.world, mesh.shape, mesh.model_index)
        model = _model()
        names = _names(model)
        state = create_train_state(model, seed=rank + 1)
        step, state = jit_step_for_mesh(
            make_completion_train_step, mesh, state,
            schedule=calc_diffusion_hyperparams(T, 1e-4, 0.02), fused_gather=True,
            fused_sa=True)
        res["losses"], res["params"], res["moments"] = [], [], []
        for batch in batches:
            x0, cond, label, t, z = map(torch.as_tensor, shard_batch(tuple(batch), mesh))
            state, loss = step(state, x0, cond, label, t=t, z=z)
            res["losses"].append(float(loss))
            res["params"].append(_numpy(full_state_dict(model)))
            res["moments"].append(_moments(full_optimizer_state_dict(model, state.optimizer),
                                           names))
        res["stored"] = {n: tuple(p.shape) for n, p in model.named_parameters()}
        res["stored_moments"] = {names[i]: tuple(s["exp_avg"].shape)
                                 for i, s in state.optimizer.state_dict()["state"].items()}
        res["local_slice"] = _numpy(dict(model.named_parameters()))
        save_checkpoint(os.path.join(out, "ckpt"), 2, state)

        # a one-process checkpoint, resumed under the mesh
        load_checkpoint(os.path.join(out, "one"), 1, state)
        res["resumed"] = _numpy(full_state_dict(model))
        res["resumed_moments"] = _moments(full_optimizer_state_dict(model, state.optimizer),
                                          names)

        gen_model = _model(include_t=False, seed=21)
        res["gen_sharded"] = sorted(shard_params(gen_model, mesh))
        before = {n: tuple(p.shape) for n, p in gen_model.named_parameters()}
        gen = _generate(os.path.join(out, "gen"), mesh, gen_model)
        res["gen_metrics"] = gen.metrics
        res["gen_shapes_kept"] = before == {n: tuple(p.shape)
                                            for n, p in gen_model.named_parameters()}

        data = synthetic_dataset(8, N, 32, seed=5, mirror_to=M)
        evald = synthetic_dataset(4, N, 32, seed=6, mirror_to=M)
        tr = train(_train_config(os.path.join(out, "train")), max_steps=2, mesh=mesh,
                   dataset_override=data, eval_dataset_override=evald)
        res["train"] = {"losses": tr["losses"], "eval": tr["eval_records"],
                        "n_iter": tr["n_iter"], "params": _numpy(full_state_dict(tr["model"]))}
        with open(os.path.join(out, f"rank_{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        torch.distributed.destroy_process_group()


def _jax_draws():
    """The t / z draws of the JAX step below, rebuilt from its key:
    rng -> (rng, rng_step) -> (rng_t, rng_z)."""
    _, rng_step = jax.random.split(jax.random.key(3))
    rng_t, rng_z = jax.random.split(rng_step)
    return (np.array(jax.random.randint(rng_t, (B,), 0, T)),
            np.array(jax.random.normal(rng_z, (B, N, 3), dtype=jnp.float32)))


def _jax_first_loss(batch):
    """The JAX package's sharded DDPM step on make_mesh(4, model_parallel=2)
    at the port's seed-0 weights and key 3: its loss."""
    state, tx = jstep.create_train_state(state_dict_to_flax(_model().state_dict()),
                                         jax.random.key(3))
    step = jstep.make_completion_train_step(JaxModel.from_config(_cfg()),
                                            jax_schedule(T, 1e-4, 0.02), tx)
    mesh = jmesh.make_mesh(4, model_parallel=2)
    jitted, state = jstep.jit_step_for_mesh(step, mesh, state, n_array_args=3)
    x0, cond, label = batch[:3]
    _, loss = jitted(state, *jmesh.shard_batch(
        (jnp.asarray(x0), jnp.asarray(cond), jnp.asarray(label, jnp.int32)), mesh))
    return float(loss)


@pytest.fixture(scope="module")
def model_axis(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("model_axis"))
    batches = _step_batches()
    batches[0][3:] = _jax_draws()
    # a one-process checkpoint after one step, with other weights
    one = _model(seed=1)
    state = create_train_state(one, seed=1)
    step = make_completion_train_step(one, calc_diffusion_hyperparams(T, 1e-4, 0.02))
    step(state, *map(torch.as_tensor, batches[1][:3]))
    save_checkpoint(os.path.join(out, "one"), 1, state)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = mp.spawn(_worker, args=(port, out, batches), nprocs=2, join=False)
    jax_loss = _jax_first_loss(batches[0])  # compiles while the processes run
    while not procs.join():
        pass
    res = []
    for r in range(2):
        with open(os.path.join(out, f"rank_{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    return dict(out=out, res=res, batches=batches, jax_loss=jax_loss,
                one=(_numpy(one.state_dict()), _moments(state.optimizer.state_dict(),
                                                         _names(one))))


@pytest.fixture(scope="module")
def jax_shapes():
    """Each config's Flax parameter shapes (``jax.eval_shape``, no compute)."""
    out = {}
    for name, make in CONFIGS.items():
        cfg = make()
        n = 2048 if name == "full" else N
        args = (jnp.zeros((1, n, 3)), jnp.zeros((1, n, 4)), jnp.zeros((1,)),
                jnp.zeros((1,), jnp.int32))
        out[name] = jax.eval_shape(JaxModel.from_config(cfg).init, jax.random.key(0), *args)
    return out


def _jax_sharded(shapes, m):
    """{port name: torch dim} of the leaves JAX's rule puts on the model axis."""
    rule = jmesh.param_sharding_rule(jmesh.make_mesh(min(8, 2 * m), model_parallel=m))
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        spec = tuple(rule(leaf).spec)
        if "model" not in spec:
            continue
        assert spec.index("model") == len(leaf.shape) - 1
        keys = [p.key for p in path][1:]  # drop the "params" collection
        if keys[-1] == "kernel":
            out[".".join(keys[:-1] + ["weight"])] = 0
        else:
            out[".".join(keys)] = len(leaf.shape) - 1
    return out


@pytest.mark.parametrize("m", [2, 4, 8])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_rule_matches_jax(jax_shapes, config, m):
    model = PointNet2CloudCondition.from_config(CONFIGS[config](), device="cpu", seed=None)
    rule = param_sharding_rule(Mesh(0, 2 * m, torch.device("cpu"), m))
    port = {}
    for name, p in model.named_parameters():
        dim = rule(name, tuple(p.shape))
        if dim is not None:
            port[name] = dim
    assert port == _jax_sharded(jax_shapes[config], m)
    if config == "full":
        params = dict(model.named_parameters())
        share = sum(params[n].numel() for n in port) / sum(p.numel() for p in params.values())
        assert (len(port), len(params), round(share, 3)) == (104, 837, 0.832)
    if config == "wide" and m == 2:
        assert port == WIDE_SHARDED


def test_make_mesh_layout(model_axis):
    res = model_axis["res"]
    assert [r["mesh"] for r in res] == [(0, 2, {"data": 1, "model": 2}, 0),
                                        (1, 2, {"data": 1, "model": 2}, 1)]
    with pytest.raises(ValueError):  # one process does not divide into rows of 2
        make_mesh(model_parallel=2, device="cpu")


def test_each_rank_stores_its_slices(model_axis):
    res = model_axis["res"]
    whole = {n: tuple(p.shape) for n, p in _model().named_parameters()}
    for rank, r in enumerate(res):
        for name, shape in whole.items():
            want = list(shape)
            if name in WIDE_SHARDED:
                want[WIDE_SHARDED[name]] //= 2
            assert r["stored"][name] == tuple(want), name
            assert r["stored_moments"][name] == tuple(want), name
        # the rank's slice is its half of the gathered tensor
        for name, dim in WIDE_SHARDED.items():
            full = res[0]["params"][1][name]
            half = np.split(full, 2, axis=dim)[rank]
            np.testing.assert_array_equal(r["local_slice"][name], half, err_msg=name)


def test_sharded_steps_equal_emulated_data_parallel(model_axis):
    res = model_axis["res"]
    model = _model()
    names = _names(model)
    state = create_train_state(model, seed=1)
    loss_fn = make_completion_loss(model, calc_diffusion_hyperparams(T, 1e-4, 0.02),
                                   fused_gather=True, fused_sa=True)
    params = dict(model.named_parameters())
    for k, batch in enumerate(model_axis["batches"]):
        halves = [shard_batch(tuple(batch), Mesh(r, 2, torch.device("cpu"))) for r in range(2)]
        losses, grads = [], []
        for x0, cond, label, t, z in (map(torch.as_tensor, h) for h in halves):
            loss = loss_fn(x0, cond, label, t, z)
            losses.append(float(loss.detach()))
            grads.append(torch.autograd.grad(loss, list(params.values())))
        for p, g0, g1 in zip(params.values(), *grads):
            p.grad = g0 / 2 + g1 / 2
        state.optimizer.step()
        moments = _moments(state.optimizer.state_dict(), names)
        for r in res:
            np.testing.assert_allclose(r["losses"][k], np.mean(losses), **STEP_TOL)
            for name, v in _numpy(model.state_dict()).items():
                np.testing.assert_allclose(r["params"][k][name], v, **STEP_TOL, err_msg=name)
            for name, (avg, sq) in moments.items():
                np.testing.assert_allclose(r["moments"][k][name][0], avg, **STEP_TOL,
                                           err_msg=name)
                np.testing.assert_allclose(r["moments"][k][name][1], sq, **STEP_TOL,
                                           err_msg=name)


def test_first_loss_matches_jax_mesh_step(model_axis):
    for r in model_axis["res"]:
        np.testing.assert_allclose(r["losses"][0], model_axis["jax_loss"], rtol=LOSS_RTOL)


def test_sharded_checkpoint_loads_in_one_process(model_axis):
    res = model_axis["res"]
    model = _model(seed=5)
    state = create_train_state(model, seed=0)
    load_checkpoint(os.path.join(model_axis["out"], "ckpt"), 2, state)
    for name, v in _numpy(model.state_dict()).items():
        np.testing.assert_array_equal(v, res[0]["params"][1][name], err_msg=name)
    for name, (avg, sq) in _moments(state.optimizer.state_dict(), _names(model)).items():
        np.testing.assert_array_equal(avg, res[0]["moments"][1][name][0], err_msg=name)
        np.testing.assert_array_equal(sq, res[0]["moments"][1][name][1], err_msg=name)


def test_one_process_checkpoint_resumes_under_the_mesh(model_axis):
    params, moments = model_axis["one"]
    for r in model_axis["res"]:
        for name, v in params.items():
            np.testing.assert_array_equal(r["resumed"][name], v, err_msg=name)
        for name, (avg, sq) in moments.items():
            np.testing.assert_array_equal(r["resumed_moments"][name][0], avg, err_msg=name)
            np.testing.assert_array_equal(r["resumed_moments"][name][1], sq, err_msg=name)


def test_generation_with_sharded_model_merges_to_one_process_output(model_axis, tmp_path):
    out, res = model_axis["out"], model_axis["res"]
    assert res[0]["gen_sharded"] == ["class_emb.embedding", "head_mid.weight"]
    assert all(r["gen_shapes_kept"] for r in res)
    one = _generate(str(tmp_path), None, _model(include_t=False, seed=21))
    leaf = os.path.join("T8_betaT0.02_tiny", "refine_exp_r", "ckpt_0", "test")
    name = f"mvp_generated_data_{N * F}pts.h5"
    with h5py.File(os.path.join(out, "gen", leaf, name), "r") as f:
        merged = np.array(f["data"])
    with h5py.File(os.path.join(tmp_path, leaf, name), "r") as f:
        np.testing.assert_allclose(merged, np.array(f["data"]), **F32_TOL)
    for k, v in one.metrics.items():
        for r in res:
            np.testing.assert_allclose(r["gen_metrics"][k], v, **F32_TOL, err_msg=k)


def test_train_with_model_axis(model_axis):
    out, res = model_axis["out"], model_axis["res"]
    a, b = res[0]["train"], res[1]["train"]
    assert a["n_iter"] == b["n_iter"] == 2
    assert a["eval"]["iter"] == b["eval"]["iter"] == [1]
    assert a["eval"]["avg_cd"] == b["eval"]["avg_cd"]
    assert np.isfinite(a["losses"]).all() and np.isfinite(b["losses"]).all()
    for k, v in a["params"].items():
        np.testing.assert_array_equal(b["params"][k], v, err_msg=k)
    ckpt = os.path.join(out, "train", "T8_betaT0.02_tiny", "logs", "checkpoint")
    assert sorted(os.listdir(ckpt)) == ["pointnet_ckpt_1", "pointnet_ckpt_2"]
    model = _model(seed=5)
    load_checkpoint(ckpt, 2, create_train_state(model))
    for k, v in _numpy(model.state_dict()).items():
        np.testing.assert_array_equal(v, a["params"][k], err_msg=k)


def _worker_2x2(rank, port, out, batches):
    torch.set_num_threads(1)
    initialize_distributed(backend="gloo", init_method=f"tcp://127.0.0.1:{port}",
                           world_size=4, rank=rank)
    try:
        mesh = make_mesh(model_parallel=2, device="cpu")
        model = _model()
        names = _names(model)
        step, state = jit_step_for_mesh(
            make_completion_train_step, mesh, create_train_state(model, seed=rank + 1),
            schedule=calc_diffusion_hyperparams(T, 1e-4, 0.02))
        res = {"mesh": (mesh.shape, mesh.model_index), "losses": [], "params": [],
               "moments": []}
        for batch in batches:
            x0, cond, label, t, z = map(torch.as_tensor, shard_batch(tuple(batch), mesh))
            state, loss = step(state, x0, cond, label, t=t, z=z)
            res["losses"].append(float(loss))
            res["params"].append(_numpy(full_state_dict(model)))
            res["moments"].append(_moments(full_optimizer_state_dict(model, state.optimizer),
                                           names))
        with open(os.path.join(out, f"rank_{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.slow
def test_2x2_mesh_steps_equal_emulated_data_parallel(tmp_path):
    """Four processes on a (2, 2) mesh, a row of the batch each: the slices'
    gradients are summed over the data column too.  Held against one process
    that sums the four rows' gradients as the mesh does, a model row's
    first: after the first step every tensor (rtol 1e-5), parameters and
    moments.  After the second, the loss (rtol 1e-5) and all parameters as
    one vector in relative L2 (1e-4): gloo's all-reduce of the replicated
    gradients over four ranks sums in an order of its own, and Adam divides
    each element by its own gradient's size, so an element at float32 noise
    (a bias ahead of a GroupNorm) turns that rounding into up to 2 lr; the
    second step read 2.3e-5, and the step moved the parameters by 1.4e-3."""
    batches = _step_batches()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.spawn(_worker_2x2, args=(port, str(tmp_path), batches), nprocs=4, join=True)
    res = []
    for r in range(4):
        with open(os.path.join(tmp_path, f"rank_{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    assert [r["mesh"] for r in res] == [({"data": 2, "model": 2}, r % 2) for r in range(4)]
    model = _model()
    names = _names(model)
    state = create_train_state(model, seed=1)
    loss_fn = make_completion_loss(model, calc_diffusion_hyperparams(T, 1e-4, 0.02))
    params = dict(model.named_parameters())
    for k, batch in enumerate(batches):
        losses, grads = [], []
        for r in range(4):
            x0, cond, label, t, z = map(torch.as_tensor, shard_batch(
                tuple(batch), Mesh(r, 4, torch.device("cpu"))))
            loss = loss_fn(x0, cond, label, t, z)
            losses.append(float(loss.detach()))
            grads.append(torch.autograd.grad(loss, list(params.values())))
        for p, g0, g1, g2, g3 in zip(params.values(), *grads):
            p.grad = ((g0 + g1) + (g2 + g3)) / 4  # a model row's sum, then the column's
        state.optimizer.step()
        moments = _moments(state.optimizer.state_dict(), names)
        for r in res:
            np.testing.assert_allclose(r["losses"][k], np.mean(losses), **STEP_TOL)
            if k == 1:
                want = _numpy(model.state_dict())
                got = np.concatenate([r["params"][k][n].ravel() for n in want])
                ref = np.concatenate([v.ravel() for v in want.values()])
                assert np.linalg.norm(got - ref) <= 1e-4 * np.linalg.norm(ref)
                continue
            for name, v in _numpy(model.state_dict()).items():
                np.testing.assert_allclose(r["params"][k][name], v, **STEP_TOL, err_msg=name)
            for name, (avg, sq) in moments.items():
                np.testing.assert_allclose(r["moments"][k][name][0], avg, **STEP_TOL,
                                           err_msg=name)
                np.testing.assert_allclose(r["moments"][k][name][1], sq, **STEP_TOL,
                                           err_msg=name)
