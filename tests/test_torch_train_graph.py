"""The port's training step as the JAX package jits it: the draws made
eagerly, the update (loss, ``backward()``, Adam) a function of tensors that
``compiled=True`` captures as a CUDA graph.

Against the JAX package: three steps of the port's step, each beside its
real jitted train step (``train/step.py``) with ``optax.adam`` taken from
the same parameters, moments and key, whose draws, re-derived from the key
as the JAX step splits it, the port's step is fed
(``tests/test_torch_train.py`` does the same for one step).  Cases: DDPM,
refine x2 with the intermediate loss under a ramping output scale (a
device tensor refilled each step, as ``train()`` feeds it), and denoise.
Tolerances: ``test_steps_match_jax_jitted_step`` says which and why.

On the CPU ``compiled=True`` runs the update eagerly, so it equals
``compiled=False`` bit for bit.  A resume keeps the fused, capturable
optimizer (also from a checkpoint of the unfused Adam of earlier trees)
and refills its tensors in place.  The tests marked ``cuda`` capture the
step on the card: one graph across an output-scale ramp, and graphed
against eager from one state and the same draws.  The JAX package is
imported inside the fixtures that need it, so on a GPU machine without JAX
they run alone:

    python -m pytest --noconftest -m cuda tests/test_torch_train_graph.py
"""

import copy
import warnings

import numpy as np
import pytest
import torch

from point_diffusion_refinement_tpu_torch import train as ptrain
from point_diffusion_refinement_tpu_torch.config import tiny_pointnet_config
from point_diffusion_refinement_tpu_torch.diffusion import calc_diffusion_hyperparams
from point_diffusion_refinement_tpu_torch.models import PointNet2CloudCondition
from point_diffusion_refinement_tpu_torch.parallel import make_mesh
from point_diffusion_refinement_tpu_torch.utils.weights import (
    adam_state_to_flax,
    flax_to_state_dict,
    load_optimizer_state,
    state_dict_to_flax,
)
from torch_threads import one_torch_thread  # noqa: F401

LOSS_RTOL = 2e-5  # tests/test_torch_train.py
LR = 2e-4
STEPS = 3
T = 50
B, N, M = 2, 64, 96
NOISE = 0.02
GRAPH_GRAD_REL_TOL = 1e-3  # chip_smoke.py: replayed against eager gradients
LOSS_TRAJ_RTOL = 1e-4  # chip_smoke.py: the losses of the steps each way
# the refine case's output scale: 1.0 -> 0.001 over two "epochs" of one step
OSF_RAMP = ptrain.QuantityScheduler(0, 2, 1.0, 0.001, 1)
CASES = {
    "ddpm": dict(task="completion"),
    "refine_x2": dict(task="refine_completion", factor=2, cd="cd_t", inter=0.5),
    "denoise": dict(task="denoise", factor=1, cd="cd_p", inter=0.0),
}


def _cfg(case: str) -> dict:
    c = CASES[case]
    if c["task"] == "completion":
        return tiny_pointnet_config()
    cfg = tiny_pointnet_config(include_t=False)
    cfg["point_upsample_factor"] = c["factor"]
    cfg["include_displacement_center_to_final_output"] = False
    return cfg


def _refine_opts(case: str) -> dict:
    c = CASES[case]
    return dict(scale=1.0, cd_loss_type=c["cd"], point_upsample_factor=c["factor"],
                include_displacement_center=False, intermediate_loss_weight=c["inter"],
                task=c["task"])


def _osf(case: str, i: int) -> float:
    return OSF_RAMP.get_quantity(i) if case == "refine_x2" else 0.37


def _model(case: str, device="cpu", **overrides):
    """The tiny network of ``case`` with its GroupNorm scales and biases
    drawn away from 1 and 0, so every parameter has a gradient."""
    model = PointNet2CloudCondition.from_config({**_cfg(case), **overrides}, device=device,
                                                seed=3)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("scale"):
                p.copy_(1.0 + 0.2 * torch.randn(p.shape, generator=g))
            elif name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
    return model


def _batch(i: int, device="cpu"):
    """Step i's (x0, condition, label, coarse), from seed 20 + i."""
    rng = np.random.default_rng(20 + i)
    x0 = rng.uniform(-0.5, 0.5, (B, N, 3)).astype(np.float32)
    cond = np.concatenate(
        [rng.uniform(-0.5, 0.5, (B, M, 3)), rng.integers(0, 2, (B, M, 1)) * 2.0 - 1.0],
        axis=-1).astype(np.float32)
    label = rng.integers(0, 16, (B,)).astype(np.int64)
    coarse = (x0 + 0.05 * rng.standard_normal(x0.shape)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (x0, cond, label, coarse))


def _step_maker(case: str, model, **kw):
    if CASES[case]["task"] == "completion":
        return ptrain.make_completion_train_step(
            model, calc_diffusion_hyperparams(T, 1e-4, 0.02), **kw)
    return ptrain.make_refine_train_step(model, noise_magnitude=NOISE, **_refine_opts(case),
                                         **kw)


def _run(case: str, step, state, draws=None, device="cpu"):
    """STEPS steps of ``step`` on the batches of ``_batch``; the refine
    output scale through one device buffer; ``draws[i]`` (t / z, or noise)
    fed where given, else drawn by the step.  Returns the losses (and the
    stats where the step records them)."""
    osf = torch.zeros((), dtype=torch.float32, device=device)
    outs = []
    for i in range(STEPS):
        x0, cond, label, coarse = _batch(i, device)
        d = {} if draws is None else {k: v.to(device) for k, v in draws[i].items()}
        if CASES[case]["task"] == "completion":
            out = step(state, x0, cond, label, **d)
        else:
            out = step(state, x0, cond, label, coarse, osf.fill_(_osf(case, i)), **d)
        outs.append(out[1:])
    return outs


@pytest.fixture(scope="module", params=sorted(CASES))
def jax_step(request):
    """The JAX package's jitted train step of a case with ``optax.adam``
    (one compile a case), as step(params, mu, nu, count, key, i) -> (loss,
    params, mu, nu, rng, draws): one step from the given parameters and
    Adam state (trees of numpy arrays, copied), with the draws it made
    re-derived from ``key``.  ``step.adam(params, mu, nu, count, grads)``
    is optax's Adam update alone: (params, mu, nu)."""
    import jax
    import jax.numpy as jnp
    import optax

    from point_diffusion_refinement_tpu.diffusion import calc_diffusion_hyperparams as jsched
    from point_diffusion_refinement_tpu.models import PointNet2CloudCondition as JaxModel
    from point_diffusion_refinement_tpu.train import step as jstep

    case = request.param
    ddpm = CASES[case]["task"] == "completion"
    jm = JaxModel.from_config(_cfg(case))
    tx = optax.adam(LR)
    if ddpm:
        fn = jax.jit(jstep.make_completion_train_step(jm, jsched(T, 1e-4, 0.02), tx))
    else:
        fn = jax.jit(jstep.make_refine_train_step(jm, tx, noise_magnitude=NOISE,
                                                  **_refine_opts(case)))
    update = jax.jit(tx.update)
    as_jax = lambda tree: jax.tree_util.tree_map(jnp.array, tree)  # noqa: E731
    as_np = lambda tree: jax.tree_util.tree_map(np.array, tree)  # noqa: E731

    def opt_state(params, mu, nu, count):
        st = tx.init(params)
        return (st[0]._replace(count=jnp.asarray(count, jnp.int32), mu=as_jax(mu),
                               nu=as_jax(nu)),) + st[1:]

    def step(params, mu, nu, count, key, i):
        params = as_jax(params)
        state = jstep.TrainState(step=jnp.asarray(i, jnp.int32), params=params,
                                 opt_state=opt_state(params, mu, nu, count), rng=key)
        x0, cond, label, coarse = (jnp.asarray(t.numpy()) for t in _batch(i))
        # the step's own split: rng -> (rng, rng_step) [-> (rng_t, rng_z)]
        _, rng_step = jax.random.split(key)
        if ddpm:
            rng_t, rng_z = jax.random.split(rng_step)
            draws = dict(t=np.asarray(jax.random.randint(rng_t, (B,), 0, T)),
                         z=np.asarray(jax.random.normal(rng_z, x0.shape, jnp.float32)))
            state, loss = fn(state, x0, cond, label.astype(jnp.int32))
        else:
            draws = dict(noise=NOISE * np.asarray(
                jax.random.normal(rng_step, x0.shape, jnp.float32)))
            state, loss = fn(state, x0, cond, label.astype(jnp.int32), coarse,
                             jnp.float32(_osf(case, i)))
        adam = state.opt_state[0]
        return (float(loss), as_np(state.params), as_np(adam.mu), as_np(adam.nu), state.rng,
                {k: torch.from_numpy(np.array(v)) for k, v in draws.items()})

    def adam(params, mu, nu, count, grads):
        params = as_jax(params)
        updates, st = update(as_jax(grads), opt_state(params, mu, nu, count), params)
        return (as_np(optax.apply_updates(params, updates)), as_np(st[0].mu),
                as_np(st[0].nu))

    step.case = case
    step.key = jax.random.key(7)
    step.adam = adam
    return step


def _tree_rel_l2(got: dict, want: dict) -> float:
    sq = lambda t: float(t.double().pow(2).sum())  # noqa: E731
    return (sum(sq(got[k] - want[k]) for k in want) / sum(sq(w) for w in want.values())) ** 0.5


def _assert_close(got: dict, want: dict, rtol: float, atol: float):
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=rtol, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("compiled", [False, True])
def test_steps_match_jax_jitted_step(jax_step, compiled):
    """STEPS steps of the port's step, each beside the JAX step taken from
    the same parameters, Adam moments and key, whose draws the port is fed.
    After each step: the loss within 2e-5 and every parameter within 2 * lr
    of JAX's (tests/test_torch_train.py's one-step bounds); the gradients
    within 2e-2 of JAX's in the tree's l2 norm; and the parameters and
    moments equal to optax's Adam on the port's own gradients within
    ``test_adam_steps_match_optax``'s 1e-6 / 1e-5.

    The gradients are held to the whole tree's norm, not tensor by tensor:
    after an Adam step the attention pools of the tiny network are so
    ill-conditioned that JAX's own gradients move beyond
    ``tests/test_torch_train.py``'s per-tensor floor when its parameters
    move by one ulp, and the port's float32 sums round differently.  2e-2
    is the bound ``chip_smoke.py`` holds the fused routes' gradients to
    against the unfused ones.  Run freely for three steps
    the two trajectories part wherever Adam turned float32 noise into a
    step of lr, so each JAX step starts from the port's state."""
    case = jax_step.case
    model = _model(case)
    state = ptrain.create_train_state(model, seed=0, learning_rate=LR)
    step = _step_maker(case, model, compiled=compiled)
    osf = torch.zeros((), dtype=torch.float32)
    key = jax_step.key
    for i in range(STEPS):
        # copies: the trees view the tensors that the step updates in place
        params = copy.deepcopy(state_dict_to_flax(model.state_dict()))
        mu, nu, count = copy.deepcopy(adam_state_to_flax(model, state.optimizer))
        assert count == i
        want_loss, want_params, want_mu, _, key, draws = jax_step(params, mu, nu, count, key, i)
        x0, cond, label, coarse = _batch(i)
        if CASES[case]["task"] == "completion":
            _, loss = step(state, x0, cond, label, t=draws["t"].long(), z=draws["z"])
        else:
            _, loss = step(state, x0, cond, label, coarse, osf.fill_(_osf(case, i)),
                           noise=draws["noise"])
        np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
        got = {n: p.detach() for n, p in model.named_parameters()}
        ref = flax_to_state_dict(want_params)
        assert max(float((got[n] - ref[n]).abs().max()) for n in ref) <= 2 * LR

        # JAX's gradients from its first moment: mu = b1 * mu_before + (1 - b1) * g
        before = flax_to_state_dict(mu)
        g_jax = {n: (m - 0.9 * before[n]) / 0.1 for n, m in flax_to_state_dict(want_mu).items()}
        grads = {n: p.grad for n, p in model.named_parameters()}
        assert _tree_rel_l2(grads, g_jax) <= 2e-2

        adam_params, adam_mu, adam_nu = jax_step.adam(params, mu, nu, count,
                                                      state_dict_to_flax(grads))
        _assert_close(got, flax_to_state_dict(adam_params), 1e-6, 1e-7)
        mu, nu, _ = adam_state_to_flax(model, state.optimizer)
        _assert_close(flax_to_state_dict(mu), flax_to_state_dict(adam_mu), 1e-5, 1e-9)
        _assert_close(flax_to_state_dict(nu), flax_to_state_dict(adam_nu), 1e-5, 1e-9)
    assert state.step == STEPS


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("routes", [False, True])
def test_compiled_equals_eager_on_cpu(case, routes):
    """``compiled=True`` on CPU tensors is the eager update: the same
    losses, neighbour statistics and parameters, bit for bit, with the
    step's own draws from the generator."""
    runs = []
    for compiled in (False, True):
        model = _model(case, record_neighbor_stats=True)
        state = ptrain.create_train_state(model, seed=5, learning_rate=LR)
        step = _step_maker(case, model, compiled=compiled, record_stats=True,
                           fused_gather=routes, fused_sa=routes)
        assert (step.graphs is not None) == compiled
        runs.append((_run(case, step, state), model))
    (eager, m_e), (graphed, m_g) = runs
    for (loss_e, stats_e), (loss_g, stats_g) in zip(eager, graphed):
        assert torch.equal(loss_e, loss_g)
        assert stats_e.keys() == stats_g.keys() and len(stats_e) > 0
        assert all(torch.equal(stats_e[k], stats_g[k]) for k in stats_e)
    for a, b in zip(m_e.parameters(), m_g.parameters()):
        assert torch.equal(a, b)


def test_optimizer_is_fused_and_capturable():
    state = ptrain.create_train_state(_model("ddpm"))
    group = state.optimizer.param_groups[0]
    assert group["fused"] and group["capturable"] and not group["foreach"]


def test_mesh_of_one_process_steps_compiled():
    """``jit_step_for_mesh`` without a process group returns the compiled
    step, as the JAX package jits a one-device mesh."""
    model = _model("ddpm")
    state = ptrain.create_train_state(model)
    mesh = make_mesh(device="cpu")
    assert not mesh.distributed
    sched = calc_diffusion_hyperparams(T, 1e-4, 0.02)
    step, same = ptrain.jit_step_for_mesh(ptrain.make_completion_train_step, mesh, state,
                                          schedule=sched)
    assert same is state and step.graphs is not None and step.graphs.num_graphs == 0


def _unfused_state(model, seed):
    """A train state with the per-tensor Adam that the port built before
    its step was compiled: its checkpoints hold groups without ``fused``
    and a step count on the host."""
    state = ptrain.create_train_state(model, seed=seed, learning_rate=LR)
    state.optimizer = torch.optim.Adam(model.parameters(), lr=LR, betas=(0.9, 0.999),
                                       eps=1e-8, weight_decay=0.0)
    return state


@pytest.mark.parametrize("writer", ["fused", "unfused"])
def test_resume_keeps_the_fused_optimizer(tmp_path, writer):
    """Two compiled steps, a checkpoint, a third step; a fresh state that
    has stepped once resumes from the checkpoint: its optimizer stays
    fused and capturable with every step count on the parameters' device,
    its moments stay at their addresses, and its third step equals the
    uninterrupted one (bit for bit from its own checkpoint; within
    test_torch_train.py's Adam tolerance of 1e-6 from the unfused Adam's,
    whose two steps round differently)."""
    case = "ddpm"
    path = str(tmp_path / "ckpt")
    model = _model(case)
    state = (ptrain.create_train_state(model, seed=1, learning_rate=LR) if writer == "fused"
             else _unfused_state(model, 1))
    step = _step_maker(case, model, compiled=True)
    x0, cond, label, _ = _batch(0)
    for _ in range(2):
        step(state, x0, cond, label)
    ptrain.save_checkpoint(path, 1, state)
    _, want = step(state, x0, cond, label)

    other = _model(case)
    o_state = ptrain.create_train_state(other, seed=9, learning_rate=LR)
    o_step = _step_maker(case, other, compiled=True)
    o_step(o_state, x0, cond, label)  # moments exist, as after a capture
    where = {id(p): {k: v.data_ptr() for k, v in s.items()}
             for p, s in o_state.optimizer.state.items()}
    restored, it, _ = ptrain.maybe_resume(path, "max", o_state)
    assert restored is o_state and it == 1 and o_state.step == 2
    for group in o_state.optimizer.param_groups:
        assert group["fused"] and group["capturable"] and not group["foreach"]
    for p, s in o_state.optimizer.state.items():
        assert s["step"].device == p.device and s["step"].dtype == torch.float32
        assert {k: v.data_ptr() for k, v in s.items()} == where[id(p)]
    _, got = o_step(o_state, x0, cond, label)
    if writer == "fused":
        assert torch.equal(got, want)
        for a, b in zip(model.parameters(), other.parameters()):
            assert torch.equal(a, b)
    else:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
        for a, b in zip(model.parameters(), other.parameters()):
            np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                       rtol=1e-6, atol=1e-7)


# ---- on the card ----------------------------------------------------------
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    yield torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_one_graph_across_an_output_scale_ramp_on_card(dev, case):
    """Warm-up, then STEPS - 1 replays of one graph, the refine output
    scale ramping 1.0 -> 0.001 in its device buffer; every kernel the eager
    step launches, the replay launches."""
    from point_diffusion_refinement_tpu_torch import ops

    model = _model(case, dev)
    state = ptrain.create_train_state(model, seed=1, learning_rate=LR)
    step = _step_maker(case, model, compiled=True, fused_gather=True, fused_sa=True)
    ops.reset_launch_counts()
    outs = _run(case, step, state, device=dev)
    torch.cuda.synchronize()
    assert step.graphs.num_graphs == 1
    launches = step.graphs.stats()[0]["launches"]
    assert launches["group_scatter_add"] > 0 and launches["ball_query_group"] > 0
    counts = ops.launch_counts()
    assert counts == {k: launches.get(k, 0) * STEPS for k in counts}
    assert all(bool(torch.isfinite(o[0])) for o in outs)


def _snapshot(state):
    return ([p.detach().clone() for p in state.model.parameters()],
            copy.deepcopy(state.optimizer.state_dict()))


def _adam_matches(state, before):
    """chip_smoke.py's ``adam_check``: one eager step of the state's Adam
    from ``before`` on copies of the parameters with the gradients in
    ``.grad`` equals the state's parameters and moments now, bit for bit;
    and every step count advanced by one."""
    params, osd = before
    live = list(state.model.parameters())
    copies = [p0.clone() for p0 in params]
    for c, p in zip(copies, live):
        c.grad = p.grad.detach().clone()
    opt = type(state.optimizer)(copies, **state.optimizer.defaults)
    opt.load_state_dict(copy.deepcopy(osd))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        opt.step()
    for i, (p, c) in enumerate(zip(live, copies)):
        s1, sc = state.optimizer.state[p], opt.state[c]
        assert torch.equal(p, c)
        assert all(torch.equal(s1[k], sc[k]) for k in ("exp_avg", "exp_avg_sq"))
        assert float(s1["step"]) == float(osd["state"][i]["step"]) + 1


def _restore(state, snap):
    params, osd = snap
    with torch.no_grad():
        for p, v in zip(state.model.parameters(), params):
            p.copy_(v)
    load_optimizer_state(state.optimizer, copy.deepcopy(osd))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_graphed_step_against_eager_on_card(dev, case):
    """From one state (after an eager step, so the moments exist) and the
    same draws: the replay's first loss equals the eager step's bit for
    bit, the gradients agree within 1e-3 of their norm and every entry
    within 1e-3 of the tree's largest (``chip_smoke.py``'s bound: float32
    sums in another order; a bias before a GroupNorm has a gradient that is
    rounding noise on both sides, so its own norm is no scale); the
    captured Adam's update at the first replay and at the last equals an
    eager step of the same Adam on that replay's own gradients bit for bit,
    and every step count advanced by one each replay; the STEPS losses agree within 1e-4 and,
    after them, every parameter within 2 * lr * steps; the launch counts
    are equal."""
    from point_diffusion_refinement_tpu_torch import ops

    model = _model(case, dev)
    state = ptrain.create_train_state(model, seed=1, learning_rate=LR)
    eager = _step_maker(case, model, fused_gather=True, fused_sa=True)
    eager(state, *_batch(5, dev)[:3], *(() if case == "ddpm" else (_batch(5, dev)[3], 0.5)))
    start = _snapshot(state)
    gen = torch.Generator(device=dev).manual_seed(11)
    x0 = _batch(0, dev)[0]
    draws = [dict(t=torch.randint(0, T, (B,), generator=gen, device=dev),
                  z=torch.randn(x0.shape, generator=gen, device=dev))
             if case == "ddpm" else
             dict(noise=NOISE * torch.randn(x0.shape, generator=gen, device=dev))
             for _ in range(STEPS)]

    def run(step):
        ops.reset_launch_counts()
        losses = [out[0] for out in _run(case, step, state, draws, dev)]
        torch.cuda.synchronize()
        return losses, ops.launch_counts()

    def first_grads(step):
        _restore(state, start)
        _run_one(case, step, state, draws[0], dev)
        torch.cuda.synchronize()
        _adam_matches(state, start)
        return {n: p.grad.clone() for n, p in model.named_parameters()}

    ref_grads = first_grads(eager)
    _restore(state, start)
    ref_losses, ref_counts = run(eager)
    ref_params = [p.detach().clone() for p in model.parameters()]

    compiled = _step_maker(case, model, compiled=True, fused_gather=True, fused_sa=True)
    _restore(state, start)
    _run_one(case, compiled, state, draws[0], dev)  # the warm-up: an eager step
    got_grads = first_grads(compiled)  # capture, and the first replay
    assert compiled.graphs.num_graphs == 1
    _restore(state, start)
    got_losses, got_counts = run(compiled)
    assert torch.equal(got_losses[0], ref_losses[0])
    np.testing.assert_allclose([float(v) for v in got_losses],
                               [float(v) for v in ref_losses], rtol=LOSS_TRAJ_RTOL)
    steps_at_start = float(start[1]["state"][0]["step"])
    assert all(float(s["step"]) == steps_at_start + STEPS
               for s in state.optimizer.state.values())
    assert got_counts == ref_counts
    # the last replay's Adam, from the state before it
    before = _snapshot(state)
    _run_one(case, compiled, state, draws[0], dev)
    torch.cuda.synchronize()
    _adam_matches(state, before)
    top = max(float(g.abs().max()) for g in ref_grads.values())
    for name, g in ref_grads.items():
        assert float((got_grads[name] - g).abs().max()) <= GRAPH_GRAD_REL_TOL * top, name
    sq = lambda a: float(a.double().pow(2).sum())  # noqa: E731
    diff = sum(sq(got_grads[n] - g) for n, g in ref_grads.items())
    assert diff <= GRAPH_GRAD_REL_TOL ** 2 * sum(sq(g) for g in ref_grads.values())
    for p, q in zip(model.parameters(), ref_params):
        assert float((p.detach() - q).abs().max()) <= 2 * LR * STEPS


def _run_one(case, step, state, draw, device):
    x0, cond, label, coarse = _batch(0, device)
    if case == "ddpm":
        return step(state, x0, cond, label, **draw)
    return step(state, x0, cond, label, coarse, _osf(case, 0), **draw)
