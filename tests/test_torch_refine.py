"""Refinement and upsampling: the port against the JAX package.

``point_upsample`` is elementwise float32 on the same inputs: exactly
equal.  The refine network is ``tiny_pointnet_config`` with
``include_t=False`` and a widened head; its seeded weights are carried into
the JAX model as a Flax tree.  float32: tight tolerance (summation order
only).  bf16: the two run the same roundings, but a flipped bf16 rounding
travels through the network, so the tolerance is a few bf16 ulps of the
output scale.  The displacement is compared before the x0.001 output
scale, which would hide it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_diffusion_refinement_tpu.config import EXPERIMENTS as J_EXPERIMENTS
from point_diffusion_refinement_tpu.config import tiny_pointnet_config
from point_diffusion_refinement_tpu.models import PointNet2CloudCondition as JaxModel
from point_diffusion_refinement_tpu.models.upsample import point_upsample as j_point_upsample
from point_diffusion_refinement_tpu.sample import generate as j_gen
from point_diffusion_refinement_tpu_torch.config import EXPERIMENTS
from point_diffusion_refinement_tpu_torch.models import PointNet2CloudCondition, point_upsample
from point_diffusion_refinement_tpu_torch.sample import make_refiner
from point_diffusion_refinement_tpu_torch.utils.weights import (
    load_flax_params,
    state_dict_to_flax,
)
from torch_threads import one_torch_thread  # noqa: F401

F32_TOL = dict(rtol=1e-4, atol=2e-5)
BF16_TOL = dict(rtol=2.0 ** -6, atol=5e-2)
OSF = 0.001  # output_scale_factor of the shipped refine configs


def _t(a):
    return torch.from_numpy(np.array(a))


def _f(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _refine_cfg(F, center=False, dtype="float32"):
    cfg = tiny_pointnet_config(include_t=False)
    cfg["compute_dtype"] = dtype
    if F > 1:
        cfg["point_upsample_factor"] = F
        cfg["include_displacement_center_to_final_output"] = center
    return cfg


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
    """The DDPM network test's inputs, with the noisy cloud as the coarse
    one."""
    rng = np.random.default_rng(seed)
    coarse = rng.normal(size=(B, N, 3)).astype(np.float32)
    cond = np.concatenate(
        [rng.uniform(-0.5, 0.5, (B, M, 3)), rng.integers(0, 2, (B, M, 1)) * 2.0 - 1.0],
        axis=-1).astype(np.float32)
    label = rng.integers(0, 16, (B,)).astype(np.int32)
    return coarse, cond, label


class TestPointUpsample:
    @pytest.mark.parametrize("F", [2, 4, 8])
    @pytest.mark.parametrize("center", [False, True])
    def test_matches_jax_exactly(self, F, center):
        rng = np.random.default_rng(F)
        coarse = rng.uniform(-0.5, 0.5, (2, 16, 3)).astype(np.float32)
        width = 3 * F if center else 3 * (F + 1)
        disp = rng.normal(size=(2, 16, width)).astype(np.float32)
        ref, ref_mid = j_point_upsample(jnp.asarray(coarse), jnp.asarray(disp), F, center, OSF)
        out, mid = point_upsample(_t(coarse), _t(disp), F, center, OSF)
        assert out.shape == (2, 16 * F, 3) and out.dtype == torch.float32
        np.testing.assert_array_equal(out.numpy(), _f(ref))
        np.testing.assert_array_equal(mid.numpy(), _f(ref_mid))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def refine_pair(request):
    """Port refine net (F=2), the JAX model, its Flax tree and inputs."""
    cfg = _refine_cfg(2, dtype=request.param)
    port = _randomize(PointNet2CloudCondition.from_config(cfg, device="cpu", seed=21), 21)
    tol = F32_TOL if request.param == "float32" else BF16_TOL
    return port, JaxModel.from_config(cfg), state_dict_to_flax(port.state_dict()), tol


class TestRefiner:
    def test_displacement_matches_jax(self, refine_pair):
        port, jm, params, tol = refine_pair
        coarse, cond, label = _inputs(2, 64, 96, 22)
        ref = _f(jax.jit(lambda p, *a: jm.apply(p, *a))(
            params, jnp.asarray(coarse), jnp.asarray(cond), None, jnp.asarray(label)))
        with torch.no_grad():
            out = port(_t(coarse), _t(cond), None, _t(label))
        # the last Dense has no dtype: its output is float32 under bf16 too
        assert out.shape == (2, 64, 9) and out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), ref, **tol)
        assert np.abs(ref).mean() > 1e-2

    def test_make_refiner_matches_jax(self, refine_pair):
        port, jm, params, tol = refine_pair
        coarse, cond, label = _inputs(2, 64, 96, 23)
        j_refine = j_gen.make_refiner(jm, point_upsample_factor=2)
        ref = _f(jax.jit(j_refine, static_argnums=4)(
            params, jnp.asarray(coarse), jnp.asarray(cond), jnp.asarray(label), OSF))
        out = make_refiner(port, point_upsample_factor=2)(_t(coarse), _t(cond), _t(label), OSF)
        assert out.shape == (2, 128, 3) and out.dtype == torch.float32
        # the displacement tolerance, scaled by the output scale factor,
        # on top of the coarse positions' float32 rounding
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6,
                                   atol=OSF * tol["atol"] + 1e-6)
        assert np.abs(out.numpy() - np.repeat(coarse, 2, axis=1)).max() > 1e-4

    def test_factor_one_adds_the_scaled_displacement(self):
        cfg = _refine_cfg(1)
        port = _randomize(PointNet2CloudCondition.from_config(cfg, device="cpu", seed=24), 24)
        jm, params = JaxModel.from_config(cfg), state_dict_to_flax(port.state_dict())
        coarse, cond, label = _inputs(2, 64, 96, 25)
        ref = _f(jax.jit(j_gen.make_refiner(jm), static_argnums=4)(
            params, jnp.asarray(coarse), jnp.asarray(cond), jnp.asarray(label), OSF))
        out = make_refiner(port)(_t(coarse), _t(cond), _t(label), OSF)
        assert out.shape == (2, 64, 3)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=OSF * 2e-5 + 1e-6)


def _flax_shapes(cfg, n, m):
    model = JaxModel.from_config(cfg)
    f32 = jnp.float32
    p = jax.eval_shape(
        model.init, jax.random.key(0), jax.ShapeDtypeStruct((1, n, 3), f32),
        jax.ShapeDtypeStruct((1, m, 4), f32), None, jax.ShapeDtypeStruct((1,), jnp.int32))
    return {jax.tree_util.keystr(k): tuple(v.shape)
            for k, v in jax.tree_util.tree_flatten_with_path(p)[0]}


def _port_shapes(model):
    tree = state_dict_to_flax(model.state_dict())
    return {jax.tree_util.keystr(k): tuple(np.shape(v))
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


class TestRefineWeights:
    @pytest.mark.parametrize("F,center", [(1, False), (8, False), (8, True)])
    def test_tiny_refine_tree_matches_flax(self, F, center):
        cfg = _refine_cfg(F, center)
        model = PointNet2CloudCondition(cfg)
        shapes = _port_shapes(model)
        assert shapes == _flax_shapes(cfg, 64, 96)
        assert not any("fc_t" in k for k in shapes)
        head = 3 * F if center else 3 * (F + 1) if F > 1 else 3
        assert shapes["['params']['head_out']['kernel']"] == (128, head)

    def test_upsample_16384_tree_matches_flax(self):
        """The shipped x8 refine net at full width: same tree as Flax, and a
        Flax tree loads into it."""
        pc = EXPERIMENTS["upsample_16384"]()["pointnet_config"]
        assert pc == J_EXPERIMENTS["upsample_16384"]()["pointnet_config"]
        model = PointNet2CloudCondition(pc)
        assert _port_shapes(model) == _flax_shapes(pc, 2048, 3072)
        other = PointNet2CloudCondition(pc)
        load_flax_params(other, state_dict_to_flax(model.state_dict()))
        for k, v in other.state_dict().items():
            assert torch.equal(v, model.state_dict()[k]), k
