"""DDPM coarse generation: the port's ``ddpm.sampling`` and
``make_coarse_sampler`` against the JAX package's, fed the same x_T and
per-step noise, 
JAX draws its noise from key splits (``diffusion/ddpm.py``: one split into
an init key and a loop key, then one split per step); the tests regenerate
that stream with ``jax.random`` as numpy arrays and hand it to the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from point_diffusion_refinement_tpu import diffusion as j_diff
from point_diffusion_refinement_tpu.config import tiny_pointnet_config
from point_diffusion_refinement_tpu.models import PointNet2CloudCondition as JaxModel
from point_diffusion_refinement_tpu.sample import generate as j_gen
from point_diffusion_refinement_tpu_torch.diffusion import calc_diffusion_hyperparams, ddpm
from point_diffusion_refinement_tpu_torch.models import PointNet2CloudCondition
from point_diffusion_refinement_tpu_torch.sample import make_coarse_sampler, unaugment
from point_diffusion_refinement_tpu_torch.utils.weights import state_dict_to_flax
from torch_threads import one_torch_thread  # noqa: F401

# float32 throughout: the per-step update rounds alike on both sides, the
# denoiser differs by summation order only
F32_TOL = dict(rtol=1e-4, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _f(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def jax_noise_stream(key, shape, T):
    """x_T and the (T, *shape) per-step noise that ``ddpm.sampling`` draws
    from ``key`` (t = T-1 .. 0)."""
    rng_init, rng = jax.random.split(key)
    x_T = jax.random.normal(rng_init, shape, dtype=jnp.float32)
    zs = []
    for _ in range(T):
        rng, rng_z = jax.random.split(rng)
        zs.append(jax.random.normal(rng_z, shape, dtype=jnp.float32))
    return np.asarray(x_T), np.stack([np.asarray(z) for z in zs])


def test_schedule_and_t_embedding():
    from point_diffusion_refinement_tpu_torch.diffusion import calc_t_emb

    js = j_diff.calc_diffusion_hyperparams(50, 1e-4, 0.02)
    ts = calc_diffusion_hyperparams(50, 1e-4, 0.02)
    for name in ("beta", "alpha", "alpha_bar", "sigma"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), _f(getattr(js, name)))
    steps = np.array([0.0, 3.0, 49.0, 17.5], np.float32)
    np.testing.assert_allclose(calc_t_emb(_t(steps), 16).numpy(),
                               _f(j_diff.calc_t_emb(jnp.asarray(steps), 16)),
                               rtol=1e-5, atol=2e-5)


def test_ddpm_sampling_shared_noise():
    T, shape = 6, (2, 32, 3)
    js = j_diff.calc_diffusion_hyperparams(T, 1e-4, 0.05)

    def j_eps(x, ts):
        return 0.3 * x + 0.01 * ts[:, None, None]

    key = jax.random.key(4)
    ref = _f(j_diff.ddpm.sampling(key, j_eps, shape, js))
    x_T, noise = jax_noise_stream(key, shape, T)
    out = ddpm.sampling(lambda x, ts: 0.3 * x + 0.01 * ts[:, None, None], shape,
                        calc_diffusion_hyperparams(T, 1e-4, 0.05), device="cpu",
                        x_T=_t(x_T), noise=_t(noise))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_make_coarse_sampler_matches_jax():
    cfg = tiny_pointnet_config()
    port = PointNet2CloudCondition.from_config(cfg, device="cpu", seed=5)
    jm = JaxModel.from_config(cfg)
    params = state_dict_to_flax(port.state_dict())
    rng = np.random.default_rng(6)
    B, N, M, T = 2, 64, 96, 4
    cond = np.concatenate([rng.uniform(-0.5, 0.5, (B, M, 3)), np.ones((B, M, 1))],
                          -1).astype(np.float32)
    label = np.array([3, 9], np.int32)
    key = jax.random.key(7)
    j_sampler = j_gen.make_coarse_sampler(jm, j_diff.calc_diffusion_hyperparams(T, 1e-4, 0.02), N)
    ref = _f(jax.jit(j_sampler)(params, key, jnp.asarray(cond), jnp.asarray(label)))
    x_T, noise = jax_noise_stream(key, (B, N, 3), T)
    sampler = make_coarse_sampler(port, calc_diffusion_hyperparams(T, 1e-4, 0.02), N)
    out = sampler(_t(cond), _t(label), x_T=_t(x_T), noise=_t(noise))
    assert out.shape == (B, N, 3) and torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), ref, **F32_TOL)


def test_unaugment_matches_jax():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 50, 3)).astype(np.float32)
    M_inv = rng.normal(size=(2, 3, 3)).astype(np.float32)
    tr = rng.normal(size=(2, 1, 3)).astype(np.float32)
    ref = _f(j_gen.unaugment(jnp.asarray(x), jnp.asarray(M_inv), jnp.asarray(tr)))
    np.testing.assert_allclose(unaugment(_t(x), _t(M_inv), _t(tr)).numpy(), ref,
                               rtol=1e-5, atol=1e-6)
