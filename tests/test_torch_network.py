"""The whole slice: the port's PointNet2CloudCondition against the JAX
package's on ``tiny_pointnet_config``, with the same weights.

The port model is built with seeded weights (GroupNorm affines perturbed
too), converted into a Flax tree and applied by the JAX model to the same
numpy inputs.  float32: tight tolerance (summation order only).  bf16: the
two run the same roundings, but a flipped bf16 rounding travels through
the network and jitted XLA may keep fused bf16 intermediates in float32, so
the tolerance is a few bf16 ulps of the output scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_diffusion_refinement_tpu.config import tiny_pointnet_config
from point_diffusion_refinement_tpu.models import PointNet2CloudCondition as JaxModel
from point_diffusion_refinement_tpu_torch.models import PointNet2CloudCondition
from point_diffusion_refinement_tpu_torch.utils.weights import state_dict_to_flax

F32_TOL = dict(rtol=1e-4, atol=2e-5)
BF16_TOL = dict(rtol=2.0 ** -6, atol=5e-2)


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
    x = rng.normal(size=(B, N, 3)).astype(np.float32)
    cond = np.concatenate(
        [rng.uniform(-0.5, 0.5, (B, M, 3)), rng.integers(0, 2, (B, M, 1)) * 2.0 - 1.0],
        axis=-1).astype(np.float32)
    ts = rng.integers(0, 50, (B,)).astype(np.float32)
    label = rng.integers(0, 16, (B,)).astype(np.int32)
    return x, cond, ts, label


def _pair(cfg, seed):
    port = _randomize(PointNet2CloudCondition.from_config(cfg, device="cpu", seed=seed), seed)
    return port, JaxModel.from_config(cfg), state_dict_to_flax(port.state_dict())


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _f(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def setup(request):
    """Port model, inputs, and the JAX model's forward and encode+denoise
    outputs on them (one jitted program per dtype)."""
    cfg = tiny_pointnet_config()
    cfg["compute_dtype"] = request.param
    port, jm, params = _pair(cfg, 0)
    data = _inputs(2, 64, 96, 1)

    # the JAX forward is encode_condition followed by denoise
    @jax.jit
    def run(p, x, cond, ts, label):
        return jm.apply(p, x, cond, ts, label), jm.apply(p, cond, method=jm.encode_condition)

    ref = run(params, *map(jnp.asarray, data))
    tol = F32_TOL if request.param == "float32" else BF16_TOL
    return port, data, ref, tol


class TestTinyNetwork:
    def test_forward(self, setup):
        port, (x, cond, ts, label), (ref, _), tol = setup
        with torch.no_grad():
            out = port(_t(x), _t(cond), _t(ts), _t(label))
        assert out.shape == (2, 64, 3) and out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), _f(ref), **tol)
        assert np.abs(_f(ref)).mean() > 1e-2

    def test_encode_then_denoise(self, setup):
        port, (x, cond, ts, label), (ref, jcf), tol = setup
        with torch.no_grad():
            cf = port.encode_condition(_t(cond))
            out = port.denoise(_t(x), _t(ts), _t(label), cf)
        np.testing.assert_allclose(out.numpy(), _f(ref), **tol)
        for a, b in zip(cf.l_uvw, jcf.l_uvw):
            np.testing.assert_array_equal(a.numpy(), _f(b))  # FPS picks, exact
        np.testing.assert_allclose(cf.global_feature.float().numpy(),
                                   _f(jcf.global_feature), **tol)
        for a, b in zip(cf.decoder_feats[1:], jcf.decoder_feats[1:]):
            np.testing.assert_allclose(a.float().numpy(), _f(b), **tol)
