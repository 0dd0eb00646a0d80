"""FastDPM and the DDPM extras: the port against the JAX package.

The host-side plan is the same float64 numpy math on both sides, so its
float32 tensors must equal JAX's exactly.  The samplers are fed the noise
stream that the JAX sampler draws from its key (one split into an init key
and a loop key, then one split per step), regenerated with ``jax.random``
as numpy arrays.  float32 throughout: the per-step updates round alike on
both sides; the denoiser differs by summation order only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_diffusion_refinement_tpu import diffusion as j_diff
from point_diffusion_refinement_tpu.config import tiny_pointnet_config
from point_diffusion_refinement_tpu.models import PointNet2CloudCondition as JaxModel
from point_diffusion_refinement_tpu.sample import generate as j_gen
from point_diffusion_refinement_tpu_torch.diffusion import (
    calc_diffusion_hyperparams,
    calc_t_emb,
    ddpm,
    fast_sampling,
    fastdpm,
    make_fast_sampling_plan,
)
from point_diffusion_refinement_tpu_torch.models import PointNet2CloudCondition
from point_diffusion_refinement_tpu_torch.sample import make_coarse_sampler
from point_diffusion_refinement_tpu_torch.utils.weights import state_dict_to_flax
from torch_threads import one_torch_thread  # noqa: F401

F32_TOL = dict(rtol=1e-4, atol=2e-5)  # a tiny network, float32, summation order
LOOP_TOL = dict(rtol=1e-5, atol=1e-6)  # elementwise updates only


def _t(a):
    return torch.from_numpy(np.array(a))


def _f(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def jax_noise_stream(key, shape, steps):
    """The starting draw and the (steps, *shape) per-step noise that the
    JAX samplers draw from ``key``."""
    rng_init, rng = jax.random.split(key)
    x0 = jax.random.normal(rng_init, shape, dtype=jnp.float32)
    zs = []
    for _ in range(steps):
        rng, rng_z = jax.random.split(rng)
        zs.append(jax.random.normal(rng_z, shape, dtype=jnp.float32))
    return np.asarray(x0), np.stack([np.asarray(z) for z in zs])


def _eps(x, ts):
    return 0.3 * x + 0.01 * ts[:, None, None]


class TestPlan:
    @pytest.mark.parametrize("method", ["var", "step"])
    @pytest.mark.parametrize("noise_schedule", ["linear", "quadratic"])
    def test_plan_matches_jax(self, method, noise_schedule):
        T, b0, bT = 1000, 1e-4, 0.02
        js = j_diff.calc_diffusion_hyperparams(T, b0, bT)
        jp = j_diff.make_fast_sampling_plan(js, T, b0, bT, length=50, sampling_method=method,
                                            noise_schedule=noise_schedule, kappa=0.5)
        tp = make_fast_sampling_plan(calc_diffusion_hyperparams(T, b0, bT), T, b0, bT,
                                     length=50, sampling_method=method,
                                     noise_schedule=noise_schedule, kappa=0.5)
        assert tp.S == 50
        for name in ("tau", "scale", "c", "sigma"):
            got = getattr(tp, name)
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), _f(getattr(jp, name)), err_msg=name)

    def test_host_helpers_match_jax(self):
        np.testing.assert_array_equal(fastdpm.get_VAR_noise(20, 1000, 1e-4, 0.02, "quadratic"),
                                      j_diff.get_VAR_noise(20, 1000, 1e-4, 0.02, "quadratic"))
        assert fastdpm.get_STEP_step(10, 1000, "linear") == j_diff.get_STEP_step(10, 1000,
                                                                                  "linear")
        with pytest.raises(ValueError):
            make_fast_sampling_plan(None, 100, 1e-4, 0.02, length=5, sampling_method="ddim")

    def test_t_embedding_at_fractional_tau(self):
        plan = make_fast_sampling_plan(None, 1000, 1e-4, 0.02, length=50)
        tau = plan.tau.numpy()
        assert (tau != np.round(tau)).any()
        # sin/cos of arguments up to ~1000 from two math libraries: they
        # differ by up to one float32 ulp of the argument (2^-14 near 1000)
        np.testing.assert_allclose(calc_t_emb(plan.tau, 128).numpy(),
                                   _f(j_diff.calc_t_emb(jnp.asarray(tau), 128)),
                                   rtol=1e-5, atol=2.0 ** -14)


class TestFastSampling:
    @pytest.mark.parametrize("kappa", [0.0, 0.5])
    def test_shared_noise_matches_jax(self, kappa):
        shape, S = (2, 16, 3), 10
        jplan = j_diff.make_fast_sampling_plan(None, 200, 1e-4, 0.02, length=S, kappa=kappa)
        key = jax.random.key(3)
        ref = _f(j_diff.fast_sampling(key, _eps, shape, jplan))
        x_T, noise = jax_noise_stream(key, shape, S)
        plan = make_fast_sampling_plan(None, 200, 1e-4, 0.02, length=S, kappa=kappa)
        out = fast_sampling(_eps, shape, plan, device="cpu", x_T=_t(x_T), noise=_t(noise))
        np.testing.assert_allclose(out.numpy(), ref, **LOOP_TOL)

    def test_generator_draws(self):
        plan = make_fast_sampling_plan(None, 100, 1e-4, 0.02, length=5)
        g = torch.Generator().manual_seed(0)
        a = fast_sampling(_eps, (1, 8, 3), plan, device="cpu", generator=g)
        b = fast_sampling(_eps, (1, 8, 3), plan, device="cpu",
                          generator=torch.Generator().manual_seed(0))
        assert torch.equal(a, b) and torch.isfinite(a).all()
        with pytest.raises(ValueError, match="noise must be"):
            fast_sampling(_eps, (1, 8, 3), plan, device="cpu", noise=torch.zeros(4, 1, 8, 3))

    def test_coarse_sampler_with_fast_plan_matches_jax(self):
        """The tiny network, weights carried across, FastDPM over a VAR plan
        (fractional taus through the time embedding) on the shipped T=1000
        schedule.  Few steps: a float32 rounding difference in one step's x
        can flip a later FPS pick or radius test of the random network."""
        cfg = tiny_pointnet_config()
        port = PointNet2CloudCondition.from_config(cfg, device="cpu", seed=11)
        jm, params = JaxModel.from_config(cfg), state_dict_to_flax(port.state_dict())
        rng = np.random.default_rng(12)
        B, N, M, S = 2, 64, 96, 4
        cond = np.concatenate([rng.uniform(-0.5, 0.5, (B, M, 3)), np.ones((B, M, 1))],
                              -1).astype(np.float32)
        label = np.array([1, 4], np.int32)
        key = jax.random.key(13)
        js = j_diff.calc_diffusion_hyperparams(1000, 1e-4, 0.02)
        jplan = j_diff.make_fast_sampling_plan(js, 1000, 1e-4, 0.02, length=S)
        j_sampler = j_gen.make_coarse_sampler(jm, js, N, fast_plan=jplan)
        ref = _f(jax.jit(j_sampler)(params, key, jnp.asarray(cond), jnp.asarray(label)))
        x_T, noise = jax_noise_stream(key, (B, N, 3), S)
        sched = calc_diffusion_hyperparams(1000, 1e-4, 0.02)
        plan = make_fast_sampling_plan(sched, 1000, 1e-4, 0.02, length=S)
        sampler = make_coarse_sampler(port, sched, N, fast_plan=plan)
        out = sampler(_t(cond), _t(label), x_T=_t(x_T), noise=_t(noise))
        assert out.shape == (B, N, 3)
        np.testing.assert_allclose(out.numpy(), ref, **F32_TOL)


class TestDdpmExtras:
    def test_t_slices_match_jax(self):
        T, shape = 8, (2, 16, 3)
        js = j_diff.calc_diffusion_hyperparams(T, 1e-4, 0.05)
        key = jax.random.key(5)
        ref, ref_slices = j_diff.ddpm.sampling(key, _eps, shape, js, t_slices=[0, 3, 6])
        x_T, noise = jax_noise_stream(key, shape, T)
        out, slices = ddpm.sampling(_eps, shape, calc_diffusion_hyperparams(T, 1e-4, 0.05),
                                    device="cpu", x_T=_t(x_T), noise=_t(noise),
                                    t_slices=[0, 3, 6])
        np.testing.assert_allclose(out.numpy(), _f(ref), **LOOP_TOL)
        assert sorted(slices) == [0, 3, 6]
        for t in (0, 3, 6):
            np.testing.assert_allclose(slices[t].numpy(), _f(ref_slices[t]), **LOOP_TOL)
        np.testing.assert_array_equal(slices[0].numpy(), out.numpy())  # no noise at t = 0

    def test_warm_start_matches_jax(self):
        T, shape, ws = 12, (2, 16, 3), 5
        js = j_diff.calc_diffusion_hyperparams(T, 1e-4, 0.05)
        XT = np.random.default_rng(6).normal(size=shape).astype(np.float32)
        key = jax.random.key(7)
        ref, ref_slices = j_diff.ddpm.sampling(key, _eps, shape, js, t_slices=[2, 8],
                                               XT=jnp.asarray(XT), warm_start_step=ws)
        z0, noise = jax_noise_stream(key, shape, ws)
        out, slices = ddpm.sampling(_eps, shape, calc_diffusion_hyperparams(T, 1e-4, 0.05),
                                    device="cpu", x_T=_t(z0), noise=_t(noise),
                                    t_slices=[2, 8], XT=_t(XT), warm_start_step=ws)
        np.testing.assert_allclose(out.numpy(), _f(ref), **LOOP_TOL)
        np.testing.assert_allclose(slices[2].numpy(), _f(ref_slices[2]), **LOOP_TOL)
        assert not slices[8].any() and not _f(ref_slices[8]).any()  # never visited
        with pytest.raises(ValueError, match="warm_start_step"):
            ddpm.sampling(_eps, shape, calc_diffusion_hyperparams(T, 1e-4, 0.05),
                          device="cpu", XT=_t(XT))

    def test_coarse_sampler_warm_start_matches_jax(self):
        cfg = tiny_pointnet_config()
        port = PointNet2CloudCondition.from_config(cfg, device="cpu", seed=8)
        jm, params = JaxModel.from_config(cfg), state_dict_to_flax(port.state_dict())
        rng = np.random.default_rng(9)
        B, N, M, T, ws = 2, 64, 96, 6, 3
        cond = np.concatenate([rng.uniform(-0.5, 0.5, (B, M, 3)), -np.ones((B, M, 1))],
                              -1).astype(np.float32)
        label = np.array([0, 2], np.int32)
        XT = rng.normal(size=(B, N, 3)).astype(np.float32)
        key = jax.random.key(10)
        js = j_diff.calc_diffusion_hyperparams(T, 1e-4, 0.02)
        j_sampler = j_gen.make_coarse_sampler(jm, js, N, t_slices=[1], warm_start_step=ws)
        ref, ref_sl = jax.jit(j_sampler)(params, key, jnp.asarray(cond), jnp.asarray(label),
                                         jnp.asarray(XT))
        z0, noise = jax_noise_stream(key, (B, N, 3), ws)
        sampler = make_coarse_sampler(port, calc_diffusion_hyperparams(T, 1e-4, 0.02), N,
                                      t_slices=[1], warm_start_step=ws)
        out, sl = sampler(_t(cond), _t(label), x_T=_t(z0), noise=_t(noise), XT=_t(XT))
        np.testing.assert_allclose(out.numpy(), _f(ref), **F32_TOL)
        np.testing.assert_allclose(sl[1].numpy(), _f(ref_sl[1]), **F32_TOL)
