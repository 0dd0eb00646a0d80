"""The port's pointwise baseline denoiser against the JAX package's
``models/pointwise_net.py``: the padded variance schedule,
``ConcatSquashLinear``, ``PointwiseNet`` at ((4, 8, 16), (16, 32)) with a
4-channel condition, and one DDPM completion train step (loss, gradients,
Adam update) against the JAX train step, with the port's seeded weights
carried into the Flax tree.  float32; summation order only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from point_diffusion_refinement_tpu.diffusion import calc_diffusion_hyperparams as jax_schedule
from point_diffusion_refinement_tpu.models import pointwise_net as jpw
from point_diffusion_refinement_tpu.train import step as jstep
from point_diffusion_refinement_tpu_torch import train as ptrain
from point_diffusion_refinement_tpu_torch.diffusion import calc_diffusion_hyperparams
from point_diffusion_refinement_tpu_torch.models import pointwise_net as ppw
from point_diffusion_refinement_tpu_torch.utils.weights import (
    flax_to_state_dict,
    state_dict_to_flax,
)
from torch_threads import one_torch_thread  # noqa: F401

ARCH = ((4, 8, 16), (16, 32))
OUT_RTOL = 1e-5  # of the output's largest magnitude
LOSS_RTOL = 2e-5
GRAD_RTOL = 1e-4  # of each gradient tensor's largest magnitude
T = 50


def _t(a):
    return torch.from_numpy(np.array(a))


def _flax(model):
    return jax.tree_util.tree_map(jnp.asarray, state_dict_to_flax(model.state_dict()))


def _port(seed):
    model = ppw.PointwiseNet(condition_features=4, pnet_global_feature_architecture=ARCH)
    model.init_weights(torch.Generator().manual_seed(seed))
    with torch.no_grad():  # biases away from their zero init
        g = torch.Generator().manual_seed(seed + 1)
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
    return model


def _inputs(seed, B=2, N=32, M=48):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, N, 3)).astype(np.float32)
    cond = np.concatenate([rng.uniform(-1, 1, (B, M, 3)),
                           rng.integers(0, 2, (B, M, 1)) * 2.0 - 1.0], -1).astype(np.float32)
    return x, cond


def test_variance_schedule():
    want = np.asarray(jpw.pointwise_variance_schedule(1000, 1e-4, 0.05))
    got = ppw.pointwise_variance_schedule(1000, 1e-4, 0.05).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == (1001,) and got[0] == 0.0


def test_concat_squash_linear():
    rng = np.random.default_rng(0)
    ctx = rng.standard_normal((2, 1, 7)).astype(np.float32)
    x = rng.standard_normal((2, 10, 5)).astype(np.float32)
    port = ppw.ConcatSquashLinear(5, 7, 6)
    ppw.PointwiseNet.init_weights(port, torch.Generator().manual_seed(1))
    want = jax.jit(jpw.ConcatSquashLinear(6).apply)(_flax(port), ctx, x)
    got = port(_t(ctx), _t(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                               atol=OUT_RTOL * float(np.abs(want).max()))


@pytest.mark.parametrize("ts", [[1, 999], [0, 1000], [3.7, 250.2]])
def test_pointwise_net_forward(ts):
    """Integer, boundary and fractional timesteps (truncated to integers),
    a 4-channel condition under the (4, 8, 16) first stage."""
    port = _port(2)
    x, cond = _inputs(3)
    ts = np.asarray(ts, np.float32)
    jm = jpw.PointwiseNet(pnet_global_feature_architecture=ARCH)
    want = np.asarray(jax.jit(jm.apply)(_flax(port), x, cond, ts))
    got = port(_t(x), _t(cond), _t(ts)).detach().numpy()
    assert got.shape == (2, 32, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=OUT_RTOL * float(np.abs(want).max()))


def test_default_architecture_takes_a_four_channel_condition():
    """The default (3, 128, 256) first stage with the mirrored partials' 4
    channels, as the JAX network takes them."""
    model = ppw.PointwiseNet(condition_features=4)
    x, cond = _inputs(4, N=16, M=24)
    assert model(_t(x), _t(cond)).shape == (2, 16, 3)


def test_completion_train_step_matches_jax():
    """One DDPM completion step from the same parameters: the JAX train
    step with optax Adam, and the port's loss at that step's own t / z
    draws followed by the port's Adam step.  Loss and gradients in
    float32 summation order; the updated parameters within a fraction of
    the learning rate (Adam's first update is lr * sign(g))."""
    port = _port(5)
    x0, cond = _inputs(6)
    x0 = 0.5 * x0
    label = np.zeros(2, np.int32)
    jm = jpw.PointwiseNet(pnet_global_feature_architecture=ARCH)
    params = _flax(port)
    key = jax.random.key(9)
    tx = optax.adam(2e-4)
    state = jstep.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                             opt_state=tx.init(params), rng=key)
    step = jax.jit(jstep.make_completion_train_step(jm, jax_schedule(T, 1e-4, 0.02), tx))
    state, loss = step(state, jnp.asarray(x0), jnp.asarray(cond), jnp.asarray(label))
    _, rng_step = jax.random.split(key)
    rng_t, rng_z = jax.random.split(rng_step)
    t = np.asarray(jax.random.randint(rng_t, (2,), 0, T))
    z = np.asarray(jax.random.normal(rng_z, x0.shape, dtype=jnp.float32))
    x_t = _q_sample_jax(x0, t, z)
    grads = jax.jit(jax.grad(lambda p: jnp.mean(jnp.square(
        jm.apply(p, x_t, cond, jnp.asarray(t, jnp.float32)) - z))))(params)

    tstate = ptrain.create_train_state(port, seed=0, learning_rate=2e-4)
    out = ptrain.make_completion_loss(port, calc_diffusion_hyperparams(T, 1e-4, 0.02))(
        _t(x0), _t(cond), _t(label).long(), _t(t), _t(z))
    tstate.optimizer.zero_grad()
    out.backward()
    np.testing.assert_allclose(float(out.detach()), float(loss), rtol=LOSS_RTOL)
    ref = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, grads))
    for name, p in port.named_parameters():
        scale = float(ref[name].abs().max())
        assert float((p.grad - ref[name]).abs().max()) <= GRAD_RTOL * scale + 1e-12, name
    tstate.optimizer.step()
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, state.params))
    diffs = torch.cat([(p.detach() - want[n]).abs().reshape(-1)
                       for n, p in port.named_parameters()])
    assert float(diffs.max()) <= 4e-4
    assert float((diffs <= 2e-6).float().mean()) >= 0.95


def _q_sample_jax(x0, t, z):
    from point_diffusion_refinement_tpu.diffusion.ddpm import q_sample

    return q_sample(jnp.asarray(x0), jnp.asarray(t), jnp.asarray(z), jax_schedule(T, 1e-4, 0.02))
