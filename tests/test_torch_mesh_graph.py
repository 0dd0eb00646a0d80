"""The training step over a process group as one compiled update: forward,
loss, ``backward()``, the gradients' reduction over the mesh, the fused
capturable Adam and the loss's mean over the processes
(``jit_step_for_mesh(compiled=True)``; on the card one captured CUDA graph,
on the CPU the same update run eagerly).

One spawn of two gloo processes, at the widened tiny config of
``tests/test_torch_mesh_model.py`` (``t_dim`` 32, ``class_condition_dim``
128: four tensors reach the model axis's 128) in float32, each rank taking
half of a batch of 4 and the draws of its rows, both fused training routes
on.  Two DDPM steps and two x2 refine steps (output scale 0.01, then
0.005), each from the seed-0 weights:

(1) on a (2, 1) mesh, the compiled step against the eager DDP step
(``compiled=False``) and against one process that averages the two halves'
gradients, as ``tests/test_torch_parallel.py`` does: the losses, the
parameters and the Adam moments after each step, every tensor at rtol 1e-5;
(2) the first DDPM loss on the (2, 1) mesh against the JAX package's
``jit_step_for_mesh`` on ``make_mesh(2, 1)`` at the same weights and the
JAX step's own t / z draws (rtol 2e-5, ``tests/test_torch_mesh_model.py``'s
bound: float32 on both sides, summation order only);
(3) on a (1, 2) mesh, the compiled step against the eager sharded step and
one process, alike;
(4) the returned loss is the processes' mean: equal on both ranks, the mean
of the two halves' losses, which differ;
(5) the sharded state's rebuilt Adam stays fused and capturable with its
step counts on the parameters' device;
(6) the rule of ``mesh_step_compiled``: over gloo, CUDA tensors step
eagerly by default and ``compiled=True`` raises a ``ValueError`` that
names NCCL; CPU tensors take the compiled step.

The tests marked ``cuda`` run the compiled step on the card over NCCL at
world 1 (``tcp://127.0.0.1``, a free port).  The JAX package is imported
inside the functions that need it, so on a GPU machine without JAX they
run alone:

    python -m pytest --noconftest -m cuda tests/test_torch_mesh_graph.py
"""

import os
import pickle
import socket

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from point_diffusion_refinement_tpu_torch.config import tiny_pointnet_config
from point_diffusion_refinement_tpu_torch.data import synthetic_dataset
from point_diffusion_refinement_tpu_torch.diffusion import calc_diffusion_hyperparams
from point_diffusion_refinement_tpu_torch.models import PointNet2CloudCondition
from point_diffusion_refinement_tpu_torch.parallel import (
    Mesh,
    full_optimizer_state_dict,
    full_state_dict,
    initialize_distributed,
    make_mesh,
    shard_batch,
)
from point_diffusion_refinement_tpu_torch.train import (
    create_train_state,
    jit_step_for_mesh,
    make_completion_loss,
    make_completion_train_step,
    make_refine_loss,
    make_refine_train_step,
    mesh_step_compiled,
)
from point_diffusion_refinement_tpu_torch.utils.weights import state_dict_to_flax
from torch_threads import one_torch_thread  # noqa: F401

STEP_TOL = dict(rtol=1e-5, atol=1e-7)
LOSS_RTOL = 2e-5
B, N, M, T, F = 4, 48, 48, 8, 2
LR = 2e-4
OSF = (0.01, 0.005)  # the refine steps' output scales
WIDE = dict(t_dim=32, class_condition_dim=128)
TASKS = ("ddpm", "refine")
AXES = {"data": 1, "model": 2}  # the mesh's model_parallel


def _cfg(task: str) -> dict:
    include_t = task == "ddpm"
    cfg = {**tiny_pointnet_config(include_t=include_t, levels=1), **WIDE,
           "compute_dtype": "float32"}
    if not include_t:
        cfg.update(point_upsample_factor=F, include_displacement_center_to_final_output=False)
    return cfg


def _model(task: str, device="cpu", seed=0):
    return PointNet2CloudCondition.from_config(_cfg(task), device=device, seed=seed)


def _schedule():
    return calc_diffusion_hyperparams(T, 1e-4, 0.02)


REFINE_OPTS = dict(scale=1.0, cd_loss_type="cd_t", point_upsample_factor=F,
                   include_displacement_center=False, intermediate_loss_weight=1.0)


def _maker(task: str):
    """(step maker, its keywords) of a task, both fused routes on."""
    routes = dict(fused_gather=True, fused_sa=True)
    if task == "ddpm":
        return make_completion_train_step, dict(schedule=_schedule(), **routes)
    return make_refine_train_step, dict(**REFINE_OPTS, **routes)


def _loss_fn(task: str, model):
    routes = dict(fused_gather=True, fused_sa=True)
    if task == "ddpm":
        return make_completion_loss(model, _schedule().to(next(model.parameters()).device),
                                    **routes)
    return make_refine_loss(model, **REFINE_OPTS, **routes)


def _batches(task: str):
    """Two global batches of a task, with their draws (DDPM: t, z; refine:
    the output scale), from numpy."""
    rng = np.random.default_rng(7 if task == "ddpm" else 8)
    data = synthetic_dataset(2 * B, N, 32, seed=3, mirror_to=M).arrays
    out = []
    for k in range(2):
        sl = slice(k * B, (k + 1) * B)
        if task == "ddpm":
            out.append([data["complete"][sl], data["partial"][sl], data["label"][sl],
                        rng.integers(0, T, B), rng.standard_normal((B, N, 3)).astype(np.float32)])
        else:
            gt = rng.uniform(-0.5, 0.5, (B, N * F, 3)).astype(np.float32)
            out.append([gt, data["partial"][sl], data["label"][sl],
                        (gt[:, ::F] + 0.02 * rng.standard_normal((B, N, 3))).astype(np.float32),
                        OSF[k]])
    return out


def _rows(batch, mesh):
    """A rank's rows of a global batch (the output scale is everyone's)."""
    arrays = [a for a in batch if isinstance(a, np.ndarray)]
    rows = list(map(torch.as_tensor, shard_batch(tuple(arrays), mesh)))
    return rows + [a for a in batch if not isinstance(a, np.ndarray)]


def _call(task: str, step, state, args):
    if task == "ddpm":
        x0, cond, label, t, z = args
        return step(state, x0, cond, label, t=t, z=z)
    return step(state, *args)


def _numpy(sd):
    return {k: v.detach().numpy().copy() for k, v in sd.items()}


def _moments(osd, names):
    """{name: (exp_avg, exp_avg_sq)} of an Adam state dict."""
    return {names[i]: (s["exp_avg"].numpy().copy(), s["exp_avg_sq"].numpy().copy())
            for i, s in osd["state"].items()}


def _names(model):
    return [n for n, _ in model.named_parameters()]


def _mesh_run(task: str, mesh, compiled: bool, batches, rank: int) -> dict:
    model = _model(task)
    names = _names(model)
    make_step, kw = _maker(task)
    step, state = jit_step_for_mesh(make_step, mesh, create_train_state(model, seed=rank + 1),
                                    compiled=compiled, **kw)
    out = {"losses": [], "params": [], "moments": [],
           "graphs": None if step.graphs is None else step.graphs.num_graphs}
    for batch in batches:
        state, loss = _call(task, step, state, _rows(batch, mesh))
        out["losses"].append(float(loss))
        out["params"].append(_numpy(full_state_dict(model)))
        out["moments"].append(_moments(full_optimizer_state_dict(model, state.optimizer), names))
    out["groups"] = [(g["fused"], g["capturable"], bool(g["foreach"]))
                     for g in state.optimizer.param_groups]
    out["steps_on_device"] = all(
        s["step"].dtype == torch.float32 and s["step"].device == p.device
        and float(s["step"]) == len(batches) for p, s in state.optimizer.state.items())
    return out


def _worker(rank, port, out, batches):
    torch.set_num_threads(1)
    initialize_distributed(backend="gloo", init_method=f"tcp://127.0.0.1:{port}",
                           world_size=2, rank=rank)
    try:
        res = {}
        meshes = {axis: make_mesh(model_parallel=m, device="cpu") for axis, m in AXES.items()}
        res["shapes"] = {axis: mesh.shape for axis, mesh in meshes.items()}
        for axis, mesh in meshes.items():
            for compiled in (True, False):
                for task in TASKS:
                    res[axis, compiled, task] = _mesh_run(task, mesh, compiled, batches[task],
                                                          rank)
        # the rule, read on a mesh of this gloo group whose device is a card
        on_card = Mesh(rank, 2, torch.device("cuda", 0))
        res["cpu_compiled"] = mesh_step_compiled(meshes["data"])
        res["gloo_cuda_default"] = mesh_step_compiled(on_card)
        try:
            mesh_step_compiled(on_card, compiled=True)
            res["gloo_cuda_compiled"] = None
        except ValueError as e:
            res["gloo_cuda_compiled"] = str(e)
        with open(os.path.join(out, f"rank_{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        torch.distributed.destroy_process_group()


def _jax_draws():
    """The t / z draws of the JAX step below, rebuilt from its key:
    rng -> (rng, rng_step) -> (rng_t, rng_z)."""
    import jax
    import jax.numpy as jnp

    _, rng_step = jax.random.split(jax.random.key(3))
    rng_t, rng_z = jax.random.split(rng_step)
    return (np.array(jax.random.randint(rng_t, (B,), 0, T)),
            np.array(jax.random.normal(rng_z, (B, N, 3), dtype=jnp.float32)))


def _jax_first_loss(batch):
    """The JAX package's DDPM step jitted on make_mesh(2, model_parallel=1)
    at the port's seed-0 weights and key 3: its loss."""
    import jax
    import jax.numpy as jnp

    from point_diffusion_refinement_tpu.diffusion import calc_diffusion_hyperparams as jax_schedule
    from point_diffusion_refinement_tpu.models import PointNet2CloudCondition as JaxModel
    from point_diffusion_refinement_tpu.parallel import mesh as jmesh
    from point_diffusion_refinement_tpu.train import step as jstep

    state, tx = jstep.create_train_state(state_dict_to_flax(_model("ddpm").state_dict()),
                                         jax.random.key(3))
    step = jstep.make_completion_train_step(JaxModel.from_config(_cfg("ddpm")),
                                            jax_schedule(T, 1e-4, 0.02), tx)
    mesh = jmesh.make_mesh(2, model_parallel=1)
    jitted, state = jstep.jit_step_for_mesh(step, mesh, state, n_array_args=3)
    x0, cond, label = batch[:3]
    _, loss = jitted(state, *jmesh.shard_batch(
        (jnp.asarray(x0), jnp.asarray(cond), jnp.asarray(label, jnp.int32)), mesh))
    return float(loss)


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mesh_graph"))
    batches = {task: _batches(task) for task in TASKS}
    batches["ddpm"][0][3:] = _jax_draws()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = mp.spawn(_worker, args=(port, out, batches), nprocs=2, join=False)
    jax_loss = _jax_first_loss(batches["ddpm"][0])  # compiles while the processes run
    while not procs.join():
        pass
    res = []
    for r in range(2):
        with open(os.path.join(out, f"rank_{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    return dict(res=res, batches=batches, jax_loss=jax_loss)


def _one_process(task: str, batches):
    """One process that runs the two ranks' halves itself and averages their
    gradients: the losses of the halves, the parameters and the moments
    after each step."""
    model = _model(task)
    names = _names(model)
    state = create_train_state(model, seed=1)
    loss_fn = _loss_fn(task, model)
    params = dict(model.named_parameters())
    out = {"halves": [], "params": [], "moments": []}
    for batch in batches:
        losses, grads = [], []
        for r in range(2):
            args = _rows(batch, Mesh(r, 2, torch.device("cpu")))
            if task == "refine":
                args[4] = torch.as_tensor(args[4], dtype=torch.float32)
            loss = loss_fn(*args)
            losses.append(float(loss.detach()))
            grads.append(torch.autograd.grad(loss, list(params.values())))
        for p, g0, g1 in zip(params.values(), *grads):
            p.grad = g0 / 2 + g1 / 2
        state.optimizer.step()
        out["halves"].append(losses)
        out["params"].append(_numpy(model.state_dict()))
        out["moments"].append(_moments(state.optimizer.state_dict(), names))
    return out


def _assert_runs_close(got: dict, want: dict, what: str):
    """Losses, parameters and moments after each step, every tensor."""
    for k in range(len(want["params"])):
        if "losses" in want:
            np.testing.assert_allclose(got["losses"][k], want["losses"][k], **STEP_TOL,
                                       err_msg=what)
        else:
            np.testing.assert_allclose(got["losses"][k], np.mean(want["halves"][k]),
                                       **STEP_TOL, err_msg=what)
        for name, v in want["params"][k].items():
            np.testing.assert_allclose(got["params"][k][name], v, **STEP_TOL,
                                       err_msg=f"{what}: {name}")
        for name, (avg, sq) in want["moments"][k].items():
            np.testing.assert_allclose(got["moments"][k][name][0], avg, **STEP_TOL,
                                       err_msg=f"{what}: {name}")
            np.testing.assert_allclose(got["moments"][k][name][1], sq, **STEP_TOL,
                                       err_msg=f"{what}: {name}")


def test_mesh_shapes(meshes):
    for r in meshes["res"]:
        assert r["shapes"] == {"data": {"data": 2, "model": 1}, "model": {"data": 1, "model": 2}}


@pytest.mark.parametrize("task", TASKS)
def test_data_axis_compiled_equals_ddp(meshes, task):
    for r in meshes["res"]:
        got, ddp = r["data", True, task], r["data", False, task]
        assert got["graphs"] == 0 and ddp["graphs"] is None  # CPU: the update runs eagerly
        _assert_runs_close(got, ddp, f"(2, 1) compiled vs DDP, {task}")


@pytest.mark.parametrize("task", TASKS)
@pytest.mark.parametrize("axis", sorted(AXES))
def test_compiled_equals_one_process(meshes, task, axis):
    want = _one_process(task, meshes["batches"][task])
    for r in meshes["res"]:
        _assert_runs_close(r[axis, True, task], want, f"{axis} axis compiled, {task}")


@pytest.mark.parametrize("task", TASKS)
def test_model_axis_compiled_equals_eager(meshes, task):
    for r in meshes["res"]:
        got, eager = r["model", True, task], r["model", False, task]
        assert got["graphs"] == 0 and eager["graphs"] is None
        _assert_runs_close(got, eager, f"(1, 2) compiled vs eager, {task}")


def test_first_loss_matches_jax_mesh_step(meshes):
    for r in meshes["res"]:
        np.testing.assert_allclose(r["data", True, "ddpm"]["losses"][0], meshes["jax_loss"],
                                   rtol=LOSS_RTOL)


@pytest.mark.parametrize("task", TASKS)
def test_returned_loss_is_the_processes_mean(meshes, task):
    halves = _one_process(task, meshes["batches"][task])["halves"]
    a, b = meshes["res"]
    for axis in AXES:
        got = a[axis, True, task]["losses"]
        assert got == b[axis, True, task]["losses"]
        for k, (l0, l1) in enumerate(halves):
            assert abs(l0 - l1) > 1e-3 * abs(l0)  # the halves' own losses differ
            np.testing.assert_allclose(got[k], (l0 + l1) / 2, **STEP_TOL)


def test_sharded_state_keeps_the_fused_capturable_adam(meshes):
    for r in meshes["res"]:
        for key in [k for k in r if isinstance(k, tuple)]:
            assert all(g == (True, True, False) for g in r[key]["groups"]), key
            assert r[key]["steps_on_device"], key


def test_which_mesh_step_is_compiled(meshes):
    for r in meshes["res"]:
        assert r["cpu_compiled"] is True
        assert r["gloo_cuda_default"] is False
        assert r["gloo_cuda_compiled"] is not None and "NCCL" in r["gloo_cuda_compiled"]
    assert mesh_step_compiled(make_mesh(device="cpu"))  # no process group
    assert not mesh_step_compiled(make_mesh(device="cpu"), compiled=False)


# ---- on the card ----------------------------------------------------------
STEPS = 3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    yield torch.device("cuda")


def _group(backend: str):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    initialize_distributed(backend=backend, init_method=f"tcp://127.0.0.1:{port}",
                           world_size=1, rank=0)


def _card_inputs(dev):
    x0, cond, label, _, _ = _batches("ddpm")[1]
    gen = torch.Generator(device=dev).manual_seed(5)
    draws = [(torch.randint(0, T, (B,), generator=gen, device=dev),
              torch.randn((B, N, 3), generator=gen, device=dev)) for _ in range(STEPS)]
    return [torch.as_tensor(a).to(dev) for a in (x0, cond, label)], draws


def _card_steps(step, state, dev, loss_fn=None):
    """The STEPS losses, and whether each equals ``loss_fn``'s eager
    forward (no autograd) of the state and inputs its step starts from."""
    (x0, cond, label), draws = _card_inputs(dev)
    losses, equal = [], []
    for t, z in draws:
        if loss_fn is not None:
            with torch.no_grad():
                ref = loss_fn(x0, cond, label, t, z)
        losses.append(step(state, x0, cond, label, t=t, z=z)[1])
        if loss_fn is not None:
            equal.append(bool(torch.equal(losses[-1], ref)))
    torch.cuda.synchronize()
    return losses, equal


@pytest.mark.cuda
def test_world1_nccl_mesh_step_equals_one_process_compiled_on_card(dev):
    """At world 1 over NCCL the compiled mesh step's reduction is a sum over
    one rank and a division by 1: from one state and the same draws its
    first loss equals the one-process compiled step's bit for bit (the
    forward has no atomics), each of its STEPS losses equals an eager
    forward of the state that step starts from, and after STEPS steps every
    parameter is within 2 * lr * steps of the one-process run's (two runs
    may take two trajectories, eager ones too: the backward's float32
    atomics, kernel B, add in an order of their own)."""
    make_step, kw = _maker("ddpm")
    one = _model("ddpm", dev)
    ref, _ = _card_steps(make_step(one, compiled=True, **kw), create_train_state(one, seed=1),
                         dev)
    _group("nccl")
    try:
        model = _model("ddpm", dev)
        step, state = jit_step_for_mesh(make_step, make_mesh(), create_train_state(model, seed=1),
                                        **kw)
        got, equal = _card_steps(step, state, dev, _loss_fn("ddpm", model))
        assert step.graphs is not None and step.graphs.num_graphs == 1
    finally:
        torch.distributed.destroy_process_group()
    assert torch.equal(got[0], ref[0])
    assert equal == [True] * STEPS
    for p, q in zip(model.parameters(), one.parameters()):
        assert float((p.detach() - q.detach()).abs().max()) <= 2 * LR * STEPS


@pytest.mark.cuda
def test_mesh_step_holds_one_graph_on_card(dev):
    """Warm-up, capture and a replay: one graph, whose replay launches the
    training kernels, and finite losses."""
    _group("nccl")
    try:
        model = _model("ddpm", dev)
        make_step, kw = _maker("ddpm")
        step, state = jit_step_for_mesh(make_step, make_mesh(), create_train_state(model), **kw)
        losses, _ = _card_steps(step, state, dev)
        assert step.graphs.num_graphs == 1
        launches = step.graphs.stats()[0]["launches"]
        assert launches["group_scatter_ordered"] > 0 and launches["ball_query_group"] > 0
        assert all(bool(torch.isfinite(v)) for v in losses)
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.cuda
def test_compiled_on_gloo_with_cuda_tensors_raises_on_card(dev):
    """gloo's collectives cannot be captured: ``compiled=True`` raises, and
    by default the step is eager."""
    _group("gloo")
    try:
        make_step, kw = _maker("ddpm")
        model = _model("ddpm", dev)
        mesh = make_mesh()
        with pytest.raises(ValueError, match="NCCL"):
            jit_step_for_mesh(make_step, mesh, create_train_state(model), compiled=True, **kw)
        step, state = jit_step_for_mesh(make_step, mesh, create_train_state(model), **kw)
        assert step.graphs is None
        assert all(bool(torch.isfinite(v)) for v in _card_steps(step, state, dev)[0])
    finally:
        torch.distributed.destroy_process_group()
