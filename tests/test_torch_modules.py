"""The port's network modules against the JAX package's on the CPU, with the
same weights on both sides.

Each port module is built with seeded random parameters (GroupNorm scales
and biases perturbed too), its ``state_dict`` is converted into a Flax tree
(``utils/weights.py``) and the JAX module is applied with it to the same
numpy inputs.  float32 tolerances cover summation order only; the bf16 cases
compare the port's fused ball-group route with the JAX package's unfused
grouping, which round at the same places.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_diffusion_refinement_tpu.models import attention as j_att
from point_diffusion_refinement_tpu.models import common as j_common
from point_diffusion_refinement_tpu.models import modules as j_mod
from point_diffusion_refinement_tpu_torch.models import attention as t_att
from point_diffusion_refinement_tpu_torch.models import common as t_common
from point_diffusion_refinement_tpu_torch.models import modules as t_mod
from point_diffusion_refinement_tpu_torch.utils.weights import state_dict_to_flax
from torch_threads import one_torch_thread  # noqa: F401

# float32: the two frameworks sum in different orders (GroupNorm statistics,
# matmul accumulation).  bf16: a rounding of a bf16 intermediate can flip
# and travel on, so outputs may differ by a few bf16 ulps.  The bf16 cases
# run the JAX module eagerly: jitted XLA may keep fused bf16 intermediates in
# float32 (excess precision) and round elsewhere than the port.
F32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=2.0 ** -7, atol=5e-2)

ATT = dict(use_attention=True, attention_bn=True, attention_transform_out=True,
           attention_last_activation=True)
COMMON = dict(bn=True, bn_first=False, bias=True, res_connect=True)


def _randomize(module, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            noise = torch.randn(p.shape, generator=g)
            if name.endswith("scale"):
                p.copy_(1.0 + 0.2 * noise)
            elif name.endswith("bias"):
                p.copy_(0.1 * noise)
            else:
                p.copy_(noise / max(p.shape[-1], 1) ** 0.5)
    return module.eval()


def _jax(module, port_module, *args, jit=True, **kw):
    params = state_dict_to_flax(port_module.state_dict())
    if not jit:
        return module.apply(params, *args, **kw)
    arrays = [a for a in args if not isinstance(a, str)]
    fn = jax.jit(lambda p, *xs: module.apply(p, *_refill(args, xs), **kw))
    return fn(params, *arrays)


def _refill(args, arrays):
    it = iter(arrays)
    return [a if isinstance(a, str) else next(it) for a in args]


def _f(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(autouse=True)
def no_grad():
    with torch.no_grad():
        yield


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    return dict(
        xyz=rng.uniform(-1, 1, (2, 96, 3)).astype(np.float32),
        feat=rng.normal(size=(2, 96, 7)).astype(np.float32),
        t_emb=rng.normal(size=(2, 16)).astype(np.float32),
        cond=rng.normal(size=(2, 12)).astype(np.float32),
        cls=rng.normal(size=(2, 8)).astype(np.float32),
    )


class TestPartialGroupNorm:
    @pytest.mark.parametrize("C", [41, 64, 20])
    def test_matches_jax(self, C):
        x = np.random.default_rng(C).normal(size=(2, 10, 4, C)).astype(np.float32)
        port = _randomize(t_common.PartialGroupNorm(C, 32), C)
        ref = _jax(j_common.PartialGroupNorm(32), port, jnp.asarray(x)) if C >= 32 else x
        out = port(_t(x)).numpy()
        np.testing.assert_allclose(out, _f(ref), **F32_TOL)
        if C < 32:  # narrower than the group count: nothing is normalised
            assert not list(port.parameters())

    def test_bf16_affine(self):
        x = np.random.default_rng(1).normal(size=(2, 10, 4, 64)).astype(np.float32)
        port = _randomize(t_common.PartialGroupNorm(64, 32, torch.bfloat16), 2)
        xb = jnp.asarray(x).astype(jnp.bfloat16)
        ref = _jax(j_common.PartialGroupNorm(32, dtype=jnp.bfloat16), port, xb, jit=False)
        out = port(_t(_f(xb)).to(torch.bfloat16))
        assert out.dtype == torch.bfloat16
        np.testing.assert_allclose(out.float().numpy(), _f(ref), **BF16_TOL)


class TestAttentionPool:
    @pytest.mark.parametrize("counts_kind", ["counts", "all"])
    def test_matches_jax(self, counts_kind):
        rng = np.random.default_rng(2)
        q = rng.normal(size=(2, 20, 10)).astype(np.float32)
        g = rng.normal(size=(2, 20, 8, 13)).astype(np.float32)
        v = rng.normal(size=(2, 20, 8, 24)).astype(np.float32)
        counts = rng.integers(0, 9, (2, 20)).astype(np.int32) if counts_kind == "counts" else "all"
        port = _randomize(t_att.AttentionPool(10, 13, 24, 32), 3)
        ref = _jax(j_att.AttentionPool(32), port, jnp.asarray(q), jnp.asarray(g),
                   jnp.asarray(v), counts if isinstance(counts, str) else jnp.asarray(counts))
        out = port(_t(q), _t(g), _t(v), counts if isinstance(counts, str) else _t(counts))
        np.testing.assert_allclose(out.numpy(), _f(ref), **F32_TOL)


def _sa_pair(in_w, npoint, radius, nsample, dtype, seed):
    kw = dict(include_t=True, include_condition=True, include_second_condition=True,
              use_xyz=True, include_abs_coordinate=True, include_center_coordinate=True,
              **COMMON, **ATT)
    port = _randomize(t_mod.SetAbstraction(
        in_w, npoint, radius, nsample, (8, 8, 16), t_features=16, condition_features=12,
        second_condition_features=8, dtype=dtype, **kw), seed)
    jax_mod = j_mod.SetAbstraction(
        npoint=npoint, radius=radius, nsample=nsample, mlp=(8, 8, 16),
        dtype=jnp.bfloat16 if dtype is not None else None, **kw)
    return port, jax_mod


class TestSetAbstraction:
    @pytest.mark.parametrize("fps_ordered", [False, True])
    def test_matches_jax(self, data, fps_ordered):
        port, jm = _sa_pair(7, 32, 0.4, 8, None, 4)
        args = (data["xyz"], data["feat"])
        emb = (data["t_emb"], data["cond"], data["cls"])
        jx, jf = _jax(jm, port, *map(jnp.asarray, args), *map(jnp.asarray, emb),
                      fps_ordered=fps_ordered)
        tx, tf = port(*map(_t, args), *map(_t, emb), fps_ordered=fps_ordered)
        np.testing.assert_array_equal(tx.numpy(), _f(jx))
        np.testing.assert_allclose(tf.numpy(), _f(jf), **F32_TOL)

    def test_fused_route_bf16(self):
        # support >= 1024 and npoint % 128 == 0: the port takes the fused
        # ball-group route ("row0" empty balls), JAX its unfused grouping
        rng = np.random.default_rng(9)
        xyz = rng.normal(size=(1, 1024, 3)).astype(np.float32)
        feat = rng.normal(size=(1, 1024, 7)).astype(np.float32)
        emb = [rng.normal(size=(1, w)).astype(np.float32) for w in (16, 12, 8)]
        port, jm = _sa_pair(7, 128, 0.2, 8, torch.bfloat16, 5)
        assert port.fused_eligible(_t(xyz), _t(feat), True)
        jx, jf = _jax(jm, port, jnp.asarray(xyz), jnp.asarray(feat), *map(jnp.asarray, emb),
                      jit=False)
        tx, tf = port(_t(xyz), _t(feat), *map(_t, emb), fused=True)
        np.testing.assert_array_equal(tx.numpy(), _f(jx))
        np.testing.assert_allclose(tf.float().numpy(), _f(jf), **BF16_TOL)
        assert np.abs(_f(jf)).mean() > 1e-2


class TestKnnFeaturePropagation:
    def test_matches_jax(self, data):
        rng = np.random.default_rng(6)
        known = data["xyz"][:, :24]
        kf = rng.normal(size=(2, 24, 11)).astype(np.float32)
        kw = dict(include_t=True, include_condition=True, include_second_condition=True,
                  **COMMON, **ATT)
        port = _randomize(t_mod.KnnFeaturePropagation(
            7, 11, (16, 16), (16, 16), 4, t_features=16, condition_features=12,
            second_condition_features=8, **kw), 7)
        jm = j_mod.KnnFeaturePropagation(mlp1=(16, 16), mlp2=(16, 16), k=4, **kw)
        args = (data["xyz"], known, data["feat"], kf, data["t_emb"], data["cond"], data["cls"])
        ref = _jax(jm, port, *map(jnp.asarray, args))
        out = port(*map(_t, args))
        np.testing.assert_allclose(out.numpy(), _f(ref), **F32_TOL)


class TestFeaturePropagation:
    def test_matches_jax(self, data):
        rng = np.random.default_rng(8)
        known = data["xyz"][:, :24]
        kf = rng.normal(size=(2, 24, 11)).astype(np.float32)
        port = _randomize(t_mod.FeaturePropagation(7, 11, (16, 16), include_t=True,
                                                   t_features=16, **COMMON), 8)
        jm = j_mod.FeaturePropagation(mlp=(16, 16), include_t=True, **COMMON)
        args = (data["xyz"], known, data["feat"], kf, data["t_emb"])
        ref = _jax(jm, port, *map(jnp.asarray, args))
        out = port(*map(_t, args))
        np.testing.assert_allclose(out.numpy(), _f(ref), **F32_TOL)


def _ft_pair(support_w, query_w, dtype, seed):
    kw = dict(use_xyz=True, include_abs_coordinate=True, include_center_coordinate=True,
              **COMMON, **ATT)
    port = _randomize(t_mod.FeatureTransfer(support_w, query_w, (8, 8), 0.3, 8,
                                            dtype=dtype, **kw), seed)
    jm = j_mod.FeatureTransfer(mlp=(8, 8), radius=0.3, k=8,
                               dtype=jnp.bfloat16 if dtype is not None else None, **kw)
    return port, jm


class TestFeatureTransfer:
    def test_matches_jax(self, data):
        rng = np.random.default_rng(10)
        q = rng.uniform(-1.5, 1.5, (2, 40, 3)).astype(np.float32)  # some empty balls
        qf = rng.normal(size=(2, 40, 5)).astype(np.float32)
        port, jm = _ft_pair(7, 5, None, 11)
        args = (data["xyz"], data["feat"], q)
        ref = _jax(jm, port, *map(jnp.asarray, args), query_feats=jnp.asarray(qf), subset=False)
        out = port(*map(_t, args), query_feats=_t(qf), subset=False)
        np.testing.assert_allclose(out.numpy(), _f(ref), **F32_TOL)

    def test_pregrouped_fused_bf16(self, data):
        # the FT pair's fused group ("center_zero" empty balls) fed in as
        # ``pregrouped`` == JAX's unfused subset=False grouping, in bf16
        from point_diffusion_refinement_tpu_torch.ops import ball_group

        rng = np.random.default_rng(12)
        q = rng.uniform(-1.5, 1.5, (2, 128, 3)).astype(np.float32)
        qf = rng.normal(size=(2, 128, 5)).astype(np.float32)
        port, jm = _ft_pair(7, 5, torch.bfloat16, 13)
        (g,), counts = ball_group(_t(data["xyz"]), [_t(data["feat"])], _t(q), 0.3, 8,
                                  include_center=True, empty_mode="center_zero")
        assert (counts == 0).any()
        ref = _jax(jm, port, jnp.asarray(data["xyz"]), jnp.asarray(data["feat"]),
                   jnp.asarray(q), query_feats=jnp.asarray(qf), subset=False, jit=False)
        out = port(None, None, None, query_feats=_t(qf), pregrouped=(g, counts))
        np.testing.assert_allclose(out.float().numpy(), _f(ref), **BF16_TOL)
        assert np.abs(_f(ref)).mean() > 1e-2
