"""The port's training steps against the JAX package's, on
``tiny_pointnet_config`` in float32 with the same weights.

The JAX side is the real train step (``train/step.py``) run with a gradient
tap in place of the optimizer: its ``update`` stores the gradients in the
optimizer state and changes no parameter, so one call gives JAX's own loss
and ``jax.grad``.  The draws (t and z of the DDPM step, the noise of the
denoise task) are re-derived from the step's key exactly as the step splits
it, and fed to the port's pure loss functions.

Tolerances: float32 on both sides; losses differ by summation order only
(rtol 2e-5).  A gradient tensor is compared relative to its own largest
entry (2e-3) plus a floor of 3e-5 of the largest gradient of the tree:
GroupNorm and softmax backward sum in different orders, a gradient that is
a cancelling sum (the class embedding's) is float32 noise on both sides, and
the chamfer argmin picks the same neighbours on both sides.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from point_diffusion_refinement_tpu.config import tiny_pointnet_config
from point_diffusion_refinement_tpu.diffusion import calc_diffusion_hyperparams as jax_schedule
from point_diffusion_refinement_tpu.models import PointNet2CloudCondition as JaxModel
from point_diffusion_refinement_tpu.train import step as jstep
from point_diffusion_refinement_tpu.train.scheduler import QuantityScheduler as JaxScheduler
from point_diffusion_refinement_tpu_torch import train as ptrain
from point_diffusion_refinement_tpu_torch.data import synthetic_dataset
from point_diffusion_refinement_tpu_torch.diffusion import calc_diffusion_hyperparams, q_sample
from point_diffusion_refinement_tpu_torch.models import PointNet2CloudCondition
from point_diffusion_refinement_tpu_torch.parallel import make_mesh
from point_diffusion_refinement_tpu_torch.train.loop import train
from point_diffusion_refinement_tpu_torch.utils.weights import (
    adam_state_to_flax,
    flax_to_state_dict,
    load_adam_state,
    state_dict_to_flax,
)
from torch_threads import one_torch_thread  # noqa: F401

LOSS_RTOL = 2e-5
GRAD_TOL = 2e-3  # of each gradient tensor's largest entry
GRAD_FLOOR = 3e-5  # of the largest gradient entry of the whole tree
T = 50
# the optimizer the JAX package's create_train_state builds, at lr 2e-4; one
# jitted update for the module (a compile of the whole tree each)
ADAM = optax.adam(2e-4)
ADAM_UPDATE = jax.jit(ADAM.update)


def _randomize(model, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("scale"):
                p.copy_(1.0 + 0.2 * torch.randn(p.shape, generator=g))
            elif name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
    return model


def _inputs(B, N, M, seed):
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-0.5, 0.5, (B, N, 3)).astype(np.float32)
    cond = np.concatenate(
        [rng.uniform(-0.5, 0.5, (B, M, 3)), rng.integers(0, 2, (B, M, 1)) * 2.0 - 1.0],
        axis=-1).astype(np.float32)
    label = rng.integers(0, 16, (B,)).astype(np.int32)
    coarse = (x0 + 0.05 * rng.standard_normal(x0.shape)).astype(np.float32)
    return x0, cond, label, coarse


def _pair(cfg, seed):
    port = _randomize(PointNet2CloudCondition.from_config(cfg, device="cpu", seed=seed), seed)
    return port, JaxModel.from_config(cfg), state_dict_to_flax(port.state_dict())


def _grad_tap():
    """An optax transformation that keeps the gradients as its state and
    updates nothing."""
    zeros = lambda tree: jax.tree_util.tree_map(jnp.zeros_like, tree)
    return optax.GradientTransformation(zeros, lambda g, s, p=None: (zeros(g), g))


def _jax_state(params, key, tx):
    return jstep.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                            opt_state=tx.init(params), rng=key)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _check_grads(port, jax_grads):
    ref = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jax_grads))
    named = dict(port.named_parameters())
    assert set(ref) == set(named)
    top = max(float(r.abs().max()) for r in ref.values())
    assert top > 1e-4
    for name, p in named.items():
        assert p.grad is not None, name
        scale = float(ref[name].abs().max())
        err = float((p.grad - ref[name]).abs().max())
        if os.environ.get("PDR_TEST_VERBOSE"):
            print(f"{name:70s} scale={scale:.3g} err/scale={err / max(scale, 1e-30):.3g}")
        # a tensor whose whole gradient is float32 noise (a cancelling sum)
        # is held to the noise floor of the largest gradient instead
        assert err <= GRAD_TOL * scale + GRAD_FLOOR * top, (name, err, scale)


def test_q_sample_matches():
    from point_diffusion_refinement_tpu.diffusion.ddpm import q_sample as jq

    rng = np.random.default_rng(0)
    x0 = rng.standard_normal((3, 20, 3)).astype(np.float32)
    z = rng.standard_normal((3, 20, 3)).astype(np.float32)
    t = np.array([0, 17, T - 1])
    ref = jq(jnp.asarray(x0), jnp.asarray(t), jnp.asarray(z), jax_schedule(T, 1e-4, 0.02))
    out = q_sample(_t(x0), _t(t), _t(z), calc_diffusion_hyperparams(T, 1e-4, 0.02))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def ddpm_jax():
    """The JAX DDPM train step with a gradient tap, compiled and run once for
    the module: its loss, its gradients, and its own t / z draws, which the
    port's loss takes.  Port seed 0, inputs seed 1, key 7."""
    cfg = tiny_pointnet_config()
    _, jm, params = _pair(cfg, 0)
    x0, cond, label, _ = _inputs(2, 64, 96, 1)
    key = jax.random.key(7)
    tx = _grad_tap()
    step = jax.jit(jstep.make_completion_train_step(jm, jax_schedule(T, 1e-4, 0.02), tx))
    state, loss = step(_jax_state(params, key, tx), jnp.asarray(x0), jnp.asarray(cond),
                       jnp.asarray(label))
    # the step's own draws: rng -> (rng, rng_step) -> (rng_t, rng_z)
    _, rng_step = jax.random.split(key)
    rng_t, rng_z = jax.random.split(rng_step)
    t = np.asarray(jax.random.randint(rng_t, (2,), 0, T))
    z = np.asarray(jax.random.normal(rng_z, x0.shape, dtype=jnp.float32))
    return dict(cfg=cfg, params=params, inputs=(x0, cond, label), loss=float(loss),
                grads=state.opt_state, t=t, z=z)


def _ddpm_port_loss(ddpm_jax):
    """A fresh port model at the fixture's parameters and its DDPM loss at
    the fixture's inputs and draws (backward already taken)."""
    port = _randomize(PointNet2CloudCondition.from_config(ddpm_jax["cfg"], device="cpu",
                                                          seed=0), 0)
    x0, cond, label = ddpm_jax["inputs"]
    loss_fn = ptrain.make_completion_loss(port, calc_diffusion_hyperparams(T, 1e-4, 0.02))
    out = loss_fn(_t(x0), _t(cond), _t(label, torch.int64), _t(ddpm_jax["t"]),
                  _t(ddpm_jax["z"]))
    out.backward()
    return port, out


def test_ddpm_loss_and_gradients(ddpm_jax):
    """(a) the DDPM loss at JAX's own t / z draws, value and every
    parameter's gradient."""
    port, out = _ddpm_port_loss(ddpm_jax)
    np.testing.assert_allclose(float(out.detach()), ddpm_jax["loss"], rtol=LOSS_RTOL)
    assert float(out.detach()) > 0.1
    _check_grads(port, ddpm_jax["grads"])


REFINE_CASES = {
    "upsample_cd_t_intermediate": dict(
        factor=2, center=False, cd="cd_t", inter=0.5, task="refine_completion"),
    "plain_cd_p": dict(factor=1, center=False, cd="cd_p", inter=0.0, task="refine_completion"),
    "denoise_upsample_center": dict(
        factor=3, center=True, cd="cd_t", inter=1.0, task="denoise"),
}


@pytest.mark.parametrize("case", sorted(REFINE_CASES))
def test_refine_loss_and_gradients(case):
    """(b) the refine / denoise loss, value and gradients, with and without
    upsampling, cd_p / cd_t, the intermediate loss and the denoise task."""
    c = REFINE_CASES[case]
    cfg = tiny_pointnet_config(include_t=False)
    cfg["point_upsample_factor"] = c["factor"]
    cfg["include_displacement_center_to_final_output"] = c["center"]
    port, jm, params = _pair(cfg, 1)
    x_gt, cond, label, coarse = _inputs(2, 64, 96, 2)
    opts = dict(scale=1.0, cd_loss_type=c["cd"], point_upsample_factor=c["factor"],
                include_displacement_center=c["center"],
                intermediate_loss_weight=c["inter"], task=c["task"])
    key = jax.random.key(11)
    tx = _grad_tap()
    osf = 0.37
    step = jax.jit(jstep.make_refine_train_step(jm, tx, noise_magnitude=0.02, **opts))
    state, loss = step(_jax_state(params, key, tx), jnp.asarray(x_gt), jnp.asarray(cond),
                       jnp.asarray(label), jnp.asarray(coarse), jnp.float32(osf))
    noise = None
    if c["task"] == "denoise":
        _, rng_step = jax.random.split(key)
        noise = _t(0.02 * np.asarray(jax.random.normal(rng_step, x_gt.shape, jnp.float32)))

    loss_fn = ptrain.make_refine_loss(port, **opts)
    out = loss_fn(_t(x_gt), _t(cond), _t(label, torch.int64), _t(coarse), osf, noise)
    out.backward()
    np.testing.assert_allclose(float(out.detach()), float(loss), rtol=LOSS_RTOL)
    _check_grads(port, state.opt_state)


def _tree_like(tree, rng, positive=False):
    return jax.tree_util.tree_map(
        lambda a: (np.abs(rng.standard_normal(a.shape)) if positive
                   else rng.standard_normal(a.shape)).astype(np.float32) * 1e-2, tree)


@pytest.mark.parametrize("steps,optimizer", [
    pytest.param(1, "create_train_state", id="1"),
    pytest.param(3, "create_train_state", id="3"),
    pytest.param(1, "per_tensor", id="1-per_tensor"),
    pytest.param(3, "per_tensor", id="3-per_tensor"),
])
def test_adam_steps_match_optax(steps, optimizer):
    """(c) Adam from carried-across parameters and moments: the same
    gradients go to ``optax.adam`` and to the port's ``torch.optim.Adam``;
    1e-6 of the parameter scale (float32 rounding of the update only).  The
    optimizer is the one ``create_train_state`` builds (fused, capturable:
    its step count on the parameters' device), or the per-tensor Adam of
    earlier trees, whose checkpoints resume into it."""
    cfg = tiny_pointnet_config()
    port = PointNet2CloudCondition.from_config(cfg, device="cpu", seed=3)
    params = jax.tree_util.tree_map(jnp.asarray, state_dict_to_flax(port.state_dict()))
    rng = np.random.default_rng(4)
    mu, nu, count = _tree_like(params, rng), _tree_like(params, rng, True), 5
    opt_state = ADAM.init(params)
    opt_state = (opt_state[0]._replace(
        count=jnp.asarray(count, jnp.int32),
        mu=jax.tree_util.tree_map(jnp.asarray, mu),
        nu=jax.tree_util.tree_map(jnp.asarray, nu)),) + tuple(opt_state[1:])
    state = ptrain.create_train_state(port, seed=0, learning_rate=2e-4)
    if optimizer == "per_tensor":
        state.optimizer = torch.optim.Adam(port.parameters(), lr=2e-4, betas=(0.9, 0.999),
                                           eps=1e-8, weight_decay=0.0)
    else:
        group = state.optimizer.param_groups[0]
        assert group["fused"] and group["capturable"]
    load_adam_state(port, state.optimizer, mu, nu, count)
    for _ in range(steps):
        grads = _tree_like(params, rng)
        updates, opt_state = ADAM_UPDATE(jax.tree_util.tree_map(jnp.asarray, grads),
                                         opt_state, params)
        params = optax.apply_updates(params, updates)
        for name, g in flax_to_state_dict(grads).items():
            port.get_parameter(name).grad = g
        state.optimizer.step()
    ref = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params))
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), rtol=1e-6, atol=1e-7)
    mu2, nu2, count2 = adam_state_to_flax(port, state.optimizer)
    assert count2 == count + steps
    for got, want in ((mu2, opt_state[0].mu), (nu2, opt_state[0].nu)):
        a, b = flax_to_state_dict(got), flax_to_state_dict(
            jax.tree_util.tree_map(np.asarray, want))
        for name in a:
            np.testing.assert_allclose(a[name].numpy(), b[name].numpy(), rtol=1e-5, atol=1e-9)


def test_train_step_matches_jax_adam_step(ddpm_jax):
    """(c) one whole DDPM train step (loss, backward, Adam) from the same
    parameters.  The JAX side is its train step's own update, ``tx.update``
    with ``optax.adam`` and ``apply_updates``, on that step's gradients.
    Adam's first update is lr * sign(g) wherever |g| >> eps, so a parameter
    moves by at most lr = 2e-4 and two implementations agree to a fraction
    of that except where a gradient is within float32 noise of zero: 95% of
    all entries within 2e-6, every entry within 2 * lr."""
    params = jax.tree_util.tree_map(jnp.asarray, ddpm_jax["params"])
    grads = jax.tree_util.tree_map(jnp.asarray, ddpm_jax["grads"])
    updates, _ = ADAM_UPDATE(grads, ADAM.init(params), params)
    jparams = optax.apply_updates(params, updates)

    port, loss = _ddpm_port_loss(ddpm_jax)
    state = ptrain.create_train_state(port, seed=0, learning_rate=2e-4)
    state.optimizer.step()
    np.testing.assert_allclose(float(loss.detach()), ddpm_jax["loss"], rtol=LOSS_RTOL)
    ref = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jparams))
    diffs = torch.cat([(p.detach() - ref[n]).abs().reshape(-1)
                       for n, p in port.named_parameters()])
    assert float(diffs.max()) <= 4e-4
    assert float((diffs <= 2e-6).float().mean()) >= 0.95


def test_synthetic_data_augment_and_batches_match_jax_package(tmp_path):
    """The port's own copies of the jax-free data helpers give the arrays
    the JAX package's give, from the same seeds."""
    from point_diffusion_refinement_tpu import data as jdata
    from point_diffusion_refinement_tpu.data.augment import augment_cloud as jaugment
    from point_diffusion_refinement_tpu_torch import data as pdata

    for a, b in zip(jdata.make_synthetic_clouds(3, 40, 24, seed=5),
                    pdata.make_synthetic_clouds(3, 40, 24, seed=5)):
        np.testing.assert_array_equal(a, b)
    args = {"pc_augm_scale": 1.2, "pc_augm_rot": True, "pc_rot_scale": 90,
            "pc_augm_mirror_prob": 0.5, "translation_magnitude": 0.1}
    clouds = [np.random.default_rng(i).standard_normal((10, 3 + i)).astype(np.float32)
              for i in range(2)]
    (ja, jp), (pa, pp) = (fn(clouds, args, True, np.random.default_rng(9))
                          for fn in (jaugment, pdata.augment_cloud))
    for a, b in zip(ja + [jp["M_inv"], jp["translation"]], pa + [pp["M_inv"], pp["translation"]]):
        np.testing.assert_array_equal(a, b)
    ds = pdata.synthetic_dataset(10, npoints=40, partial_points=24, seed=5)
    assert len(ds) == 10 and ds[3]["partial"].shape == (24, 3)
    for kw in (dict(shuffle=False), dict(shuffle=True, seed=2, drop_last=True)):
        got = list(pdata.iterate_batches(ds, 4, **kw))
        want = list(jdata.iterate_batches(ds, 4, **kw))
        assert len(got) == len(want) == (2 if kw.get("drop_last") else 3)
        for g, w in zip(got, want):
            assert set(g) == {"complete", "partial", "label"}
            for k in g:
                np.testing.assert_array_equal(g[k], w[k])
    mirrored = pdata.synthetic_dataset(2, npoints=40, partial_points=24, mirror_to=30)
    assert mirrored[0]["partial"].shape == (30, 4)
    h5py = pytest.importorskip("h5py")
    d = pdata.write_mvp_style_h5(str(tmp_path / "mvp"), num_shapes=2, npoints=40,
                                 partial_points=24, seed=1)
    comp, part, labels = pdata.make_synthetic_clouds(2, 40, 24, seed=1)
    with h5py.File(os.path.join(d, "mvp_train_input.h5")) as f:
        np.testing.assert_array_equal(f["incomplete_pcds"][()], part)
        np.testing.assert_array_equal(f["labels"][()], labels)
    with h5py.File(os.path.join(d, "mvp_train_gt_40pts.h5")) as f:
        np.testing.assert_array_equal(f["complete_pcds"][()], comp)


def test_quantity_scheduler_matches():
    for args in ((0, 4, 1.0, 0.001, 7), (2, 2, 0.5, 0.25, 3), (1, 3, 0.0, 2.0, 5)):
        a, b = ptrain.QuantityScheduler(*args), JaxScheduler(*args)
        for it in (0, 1, 6, 7, 15, 28, 100):
            assert a.get_quantity(it) == b.get_quantity(it)


def test_optimizer_state_round_trip():
    """(g) optax moments -> torch.optim.Adam -> optax moments, and Dense
    kernels transposed on the way in."""
    port = PointNet2CloudCondition.from_config(tiny_pointnet_config(), device="cpu", seed=0)
    params = state_dict_to_flax(port.state_dict())
    rng = np.random.default_rng(1)
    mu, nu = _tree_like(params, rng), _tree_like(params, rng, True)
    state = ptrain.create_train_state(port)
    load_adam_state(port, state.optimizer, mu, nu, 9)
    w = port.fc_t1.weight
    np.testing.assert_array_equal(state.optimizer.state[w]["exp_avg"].numpy(),
                                  mu["params"]["fc_t1"]["kernel"].T)
    mu2, nu2, count = adam_state_to_flax(port, state.optimizer)
    assert count == 9
    for a, b in ((mu, mu2), (nu, nu2)):
        fa, fb = flax_to_state_dict(a), flax_to_state_dict(b)
        assert set(fa) == set(fb)
        for k in fa:
            np.testing.assert_array_equal(fa[k].numpy(), fb[k].numpy())
    with pytest.raises(KeyError):
        load_adam_state(port, state.optimizer, {"params": {}}, nu, 1)


def test_checkpoint_round_trip(tmp_path):
    """(g) save -> find_max_epoch -> resume restores parameters, moments,
    generator and step; the next step equals the uninterrupted one."""
    cfg = tiny_pointnet_config()
    x0, cond, label, _ = (_t(a) for a in _inputs(2, 64, 96, 3))
    label = label.to(torch.int64)
    sched = calc_diffusion_hyperparams(T, 1e-4, 0.02)

    def fresh():
        m = PointNet2CloudCondition.from_config(cfg, device="cpu", seed=0)
        return ptrain.create_train_state(m, seed=1), ptrain.make_completion_train_step(m, sched)

    state, step = fresh()
    step(state, x0, cond, label)
    step(state, x0, cond, label)
    path = str(tmp_path / "ckpt")
    assert ptrain.find_max_epoch(path) == -1 and ptrain.find_max_epoch(path, "all") == []
    ptrain.save_checkpoint(path, 1, state, training_time_seconds=12.5)
    ptrain.save_checkpoint(path, 0, state)
    os.makedirs(os.path.join(path, "pointnet_ckpt_7_best_cd"))
    assert os.path.isdir(os.path.join(path, "pointnet_ckpt_1"))
    assert ptrain.find_max_epoch(path) == 1 and ptrain.find_max_epoch(path, "all") == [1, 0]
    _, want = step(state, x0, cond, label)

    other, other_step = fresh()
    restored, it, secs = ptrain.maybe_resume(path, "max", other)
    assert restored is other and it == 1 and secs == 12.5 and other.step == 2
    _, got = other_step(other, x0, cond, label)
    assert float(got) == float(want)
    for a, b in zip(state.model.parameters(), other.model.parameters()):
        assert torch.equal(a, b)
    assert ptrain.maybe_resume(str(tmp_path / "none"), "max", other)[:2] == (None, -1)
    assert ptrain.maybe_resume(path, 5, other)[:2] == (None, -1)  # missing: fresh start


def test_find_best_epoch(tmp_path):
    import pickle

    path = tmp_path / "logs" / "checkpoint"
    os.makedirs(path)
    os.makedirs(tmp_path / "eval_result")
    with open(tmp_path / "eval_result" / "gathered_eval_result.pkl", "wb") as f:
        pickle.dump({"iter": [3, 7, 11], "avg_cd": [0.3, 0.1, 0.2], "avg_emd": [0, 0, 0]}, f)
    assert ptrain.find_max_epoch(str(path), "best") == 7
    with pytest.raises(ValueError):
        ptrain.find_max_epoch(str(path), "median")


def _config(task, root):
    pc = {**tiny_pointnet_config(include_t=task == "completion"), "model_name": "tiny"}
    if task != "completion":
        pc.update(point_upsample_factor=2, intermediate_refined_X_loss_weight=1.0,
                  include_displacement_center_to_final_output=False)
    return {
        "diffusion_config": {"T": 8, "beta_0": 1e-4, "beta_T": 0.02},
        "pointnet_config": pc,
        "train_config": {"task": task, "root_directory": root, "n_epochs": 3,
                         "epochs_per_ckpt": 1, "shuffle_seed": 3, "compute_emd": False,
                         "eval_sampling_steps": 2},
        "mvp_dataset_config": {"batch_size": 4, "npoints": 48, "num_samples_tested": 4,
                               "eval_batch_size": 4, "scale": 1},
        "refine_config": {"exp_name": "r", "output_scale_factor": 0.001,
                          "use_output_scale_factor_schedule": True,
                          "output_scale_factor_schedule": {
                              "init_epoch": 0, "final_epoch": 2, "init_value": 1.0}},
    }


@pytest.mark.parametrize("task", ["completion", "refine_completion", "denoise"])
@pytest.mark.parametrize("routes", [False, True])
def test_train_loop_and_resume(tmp_path, task, routes):
    """(h) ``train()`` on a tiny synthetic dataset: finite losses,
    checkpoints, eval records; a run stopped after two of three epochs and
    resumed gives the third epoch's losses exactly, and its gathered eval
    results hold the evaluations from before the resume too."""
    kw = dict(device="cpu", fused_gather=routes, fused_sa=routes)
    spec = dict(num_samples=8, npoints=48, partial_points=32, seed=0, mirror_to=48)
    if routes:  # datasets handed in
        ds = synthetic_dataset(**spec)
        kw.update(dataset_override=ds, eval_dataset_override=ds)

    def _cfg(root):  # or built by make_dataset from the config
        cfg = _config(task, root)
        if not routes:
            cfg["mvp_dataset_config"]["synthetic"] = spec
        return cfg

    full = train(_cfg(str(tmp_path / "a")), **kw)
    assert len(full["losses"]) == 6 and np.isfinite(full["losses"]).all()
    assert full["eval_records"]["iter"] == [1, 3, 5]
    assert np.isfinite(full["eval_records"]["avg_cd"]).all()
    assert ptrain.find_max_epoch(full["output_directory"], "all") == [6, 5, 3, 1]

    part = train(_cfg(str(tmp_path / "b")), max_steps=4, **kw)
    assert part["losses"] == full["losses"][:4]
    # not the end-of-run checkpoint: resume from the epoch boundary
    cfg = _cfg(str(tmp_path / "b"))
    cfg["train_config"]["ckpt_iter"] = 3
    rest = train(cfg, **kw)
    assert rest["losses"] == full["losses"][4:]
    assert rest["n_iter"] == 6
    assert rest["eval_records"]["iter"] == [5]  # this call's own evaluations
    eval_dir = os.path.join(rest["output_directory"], "..", "..", "eval_result")
    with open(os.path.join(eval_dir, "gathered_eval_result.pkl"), "rb") as f:
        gathered = pickle.load(f)
    assert gathered["iter"] == [1, 3, 5]
    np.testing.assert_array_equal(gathered["avg_cd"][:2], part["eval_records"]["avg_cd"])
    assert gathered["avg_cd"][2] == rest["eval_records"]["avg_cd"][0]
    assert ptrain.find_max_epoch(rest["output_directory"], "best") in (1, 3, 5)


def test_unported_options_raise(tmp_path):
    port = PointNet2CloudCondition.from_config(tiny_pointnet_config(), device="cpu", seed=0)
    sched = calc_diffusion_hyperparams(T, 1e-4, 0.02)
    # the neighbour statistics are ported (tests/test_torch_neighbor_stats.py):
    # the steps build; the multi-device step is ported (tests/test_torch_parallel.py,
    # and the mesh's model axis in tests/test_torch_mesh_model.py): one process
    # does not divide into model rows of 2
    assert callable(ptrain.make_completion_train_step(port, sched, record_stats=True))
    assert callable(ptrain.make_refine_train_step(port, record_stats=True))
    with pytest.raises(ValueError):
        make_mesh(model_parallel=2, device="cpu")
    cfg = _config("completion", str(tmp_path))
    cfg["mvp_dataset_config"]["data_dir"] = str(tmp_path / "no_data")
    with pytest.raises(FileNotFoundError):  # the h5 dataset is read, and is missing
        train(cfg, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):  # no card and no device="cpu"
            train(_config("completion", str(tmp_path)))
