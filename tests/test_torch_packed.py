"""The packed first layers and the whole accelerated inference path against
the JAX package, on the CPU.

``packed=True`` merges the products that read a grouped tensor (the
conditioned MLP's first Dense, its residual projection, the attention pool's
key Dense) into one; the JAX package does the same under ``PDR_PACKED=1``.
The per-output arithmetic is unchanged, so packed agrees with unpacked and
with JAX to float32 summation order.

The whole path: ``denoise(fused=True, fused_attention=True, fused_knn=True)``
at a narrow config whose sizes open the gates (a 1024-point condition, 2048
noisy points, 1024 points at level 1) against the JAX ``denoise`` with
``PDR_FUSED_ATTENTION=1``, ``PDR_WINDOWED_KNNFP=1`` and windowed feature
transfer (Pallas kernels in interpret mode, jitted), with the same weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_diffusion_refinement_tpu.config import tiny_pointnet_config
from point_diffusion_refinement_tpu.models import PointNet2CloudCondition as JaxModel
from point_diffusion_refinement_tpu.models import modules as j_mod
from point_diffusion_refinement_tpu_torch.diffusion import calc_diffusion_hyperparams
from point_diffusion_refinement_tpu_torch.models import PointNet2CloudCondition
from point_diffusion_refinement_tpu_torch.models import attention as t_att
from point_diffusion_refinement_tpu_torch.models import grouping as t_grouping
from point_diffusion_refinement_tpu_torch.models import modules as t_mod
from point_diffusion_refinement_tpu_torch.sample import make_coarse_sampler, make_refiner
from point_diffusion_refinement_tpu_torch.utils.weights import state_dict_to_flax
from torch_threads import one_torch_thread  # noqa: F401

# float32: summation order only (one merged product against three)
F32_TOL = dict(rtol=1e-4, atol=1e-5)
# The JAX package's own bound for its whole network with the windowed kernels
# on against off (tests/test_pallas_window.py): bf16 roundings that flip
# early travel through every level.
NET_MAX, NET_MEAN = 8e-2, 1.5e-2

ATT = dict(use_attention=True, attention_bn=True, attention_transform_out=True,
           attention_last_activation=True)
COMMON = dict(bn=True, bn_first=False, bias=True, res_connect=True)


@pytest.fixture(autouse=True)
def no_grad():
    with torch.no_grad():
        yield


def _randomize(module, seed, dense=True):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            noise = torch.randn(p.shape, generator=g)
            if name.endswith("scale"):
                p.copy_(1.0 + 0.2 * noise)
            elif name.endswith("bias"):
                p.copy_(0.1 * noise)
            elif dense:
                p.copy_(noise / max(p.shape[-1], 1) ** 0.5)
    return module.eval()


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _f(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _jax_packed(monkeypatch, module, port, *args, **kw):
    monkeypatch.setenv("PDR_PACKED", "1")
    out = module.apply(state_dict_to_flax(port.state_dict()), *args, **kw)
    monkeypatch.delenv("PDR_PACKED")
    return out


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


@pytest.fixture
def packed_calls(monkeypatch):
    """What ``_packed_first_layers`` merged at each call: the number of
    layers (0 where it declined)."""
    seen = []
    real = t_mod._packed_first_layers

    def spy(grouped, cm, ap, dtype):
        out = real(grouped, cm, ap, dtype)
        seen.append(0 if out is None else 1 + (out[1] is not None) + (out[2] is not None))
        return out

    monkeypatch.setattr(t_mod, "_packed_first_layers", spy)
    return seen


class TestPackedModules:
    @pytest.mark.parametrize("use_attention", [True, False], ids=["attention", "maxpool"])
    def test_set_abstraction(self, data, monkeypatch, packed_calls, use_attention):
        kw = dict(include_t=True, include_condition=True, include_second_condition=True,
                  use_xyz=True, include_abs_coordinate=True, include_center_coordinate=True,
                  **COMMON, **dict(ATT, use_attention=use_attention))
        port = _randomize(t_mod.SetAbstraction(
            7, 32, 0.4, 8, (8, 8, 16), t_features=16, condition_features=12,
            second_condition_features=8, **kw), 4)
        jm = j_mod.SetAbstraction(npoint=32, radius=0.4, nsample=8, mlp=(8, 8, 16), **kw)
        args = (data["xyz"], data["feat"], data["t_emb"], data["cond"], data["cls"])
        _, ref = _jax_packed(monkeypatch, jm, port, *map(jnp.asarray, args))
        _, off = port(*map(_t, args))
        assert packed_calls == []
        _, on = port(*map(_t, args), packed=True)
        # first Dense + residual projection (16 channels in, 16 out of the
        # grouped 16-wide tensor? no: 7 + 9 = 16 = f_last, identity) + key
        assert packed_calls == [2 if use_attention else 0]
        np.testing.assert_allclose(on.numpy(), _f(ref), **F32_TOL)
        np.testing.assert_allclose(on.numpy(), off.numpy(), **F32_TOL)

    def test_set_abstraction_with_residual_projection(self, data, monkeypatch, packed_calls):
        kw = dict(use_xyz=True, include_abs_coordinate=True, include_center_coordinate=False,
                  **COMMON, **ATT)
        port = _randomize(t_mod.SetAbstraction(7, 32, 0.4, 8, (8, 24), **kw), 6)
        jm = j_mod.SetAbstraction(npoint=32, radius=0.4, nsample=8, mlp=(8, 24), **kw)
        args = (data["xyz"], data["feat"])
        _, ref = _jax_packed(monkeypatch, jm, port, *map(jnp.asarray, args))
        _, on = port(*map(_t, args), packed=True)
        _, off = port(*map(_t, args))
        assert packed_calls == [3]  # first Dense, residual projection, key
        np.testing.assert_allclose(on.numpy(), _f(ref), **F32_TOL)
        np.testing.assert_allclose(on.numpy(), off.numpy(), **F32_TOL)

    def test_feature_transfer(self, data, monkeypatch, packed_calls):
        rng = np.random.default_rng(10)
        q = rng.uniform(-1.5, 1.5, (2, 40, 3)).astype(np.float32)  # some empty balls
        qf = rng.normal(size=(2, 40, 5)).astype(np.float32)
        kw = dict(use_xyz=True, include_abs_coordinate=True, include_center_coordinate=True,
                  **COMMON, **ATT)
        port = _randomize(t_mod.FeatureTransfer(7, 5, (8, 8), 0.3, 8, **kw), 11)
        jm = j_mod.FeatureTransfer(mlp=(8, 8), radius=0.3, k=8, **kw)
        args = (data["xyz"], data["feat"], q)
        ref = _jax_packed(monkeypatch, jm, port, *map(jnp.asarray, args),
                          query_feats=jnp.asarray(qf), subset=False)
        on = port(*map(_t, args), query_feats=_t(qf), subset=False, packed=True)
        off = port(*map(_t, args), query_feats=_t(qf), subset=False)
        assert packed_calls == [3]
        np.testing.assert_allclose(on.numpy(), _f(ref), **F32_TOL)
        np.testing.assert_allclose(on.numpy(), off.numpy(), **F32_TOL)

    def test_knn_feature_propagation(self, data, monkeypatch, packed_calls):
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
        ref = _jax_packed(monkeypatch, jm, port, *map(jnp.asarray, args))
        on = port(*map(_t, args), packed=True)
        off = port(*map(_t, args))
        assert packed_calls == [3]  # mlp1 only: mlp2 reads no grouped tensor
        np.testing.assert_allclose(on.numpy(), _f(ref), **F32_TOL)
        np.testing.assert_allclose(on.numpy(), off.numpy(), **F32_TOL)

    def test_norm_first_stack_is_left_alone(self, data, packed_calls):
        kw = dict(use_xyz=True, include_abs_coordinate=True, bn=True, bn_first=True,
                  bias=True, res_connect=True, first_conv_features=8, **ATT)
        port = _randomize(t_mod.SetAbstraction(7, 32, 0.4, 8, (8, 24), **kw), 8)
        args = (_t(data["xyz"]), _t(data["feat"]))
        _, on = port(*args, packed=True)
        _, off = port(*args)
        assert packed_calls == [0] and torch.equal(on, off)


class TestPrecedence:
    def test_packed_beats_fused_attention(self, monkeypatch, packed_calls):
        """With both on, a pool that is handed its key by the packed product
        stays unfused; with ``packed`` off the same site is fused."""
        fused = []
        real = t_att.fused_attention_pool
        monkeypatch.setattr(t_att, "fused_attention_pool",
                            lambda *a, **k: fused.append(k["K"]) or real(*a, **k))
        rng = np.random.default_rng(1)
        xyz = _t(rng.uniform(-1, 1, (2, 96, 3)).astype(np.float32))
        feat = _t(rng.normal(size=(2, 96, 7)).astype(np.float32))
        kw = dict(use_xyz=True, include_abs_coordinate=True, **COMMON, **ATT)
        port = _randomize(t_mod.SetAbstraction(7, 32, 0.4, 8, (8, 24), dtype=torch.bfloat16,
                                               **kw), 9)
        _, both = port(xyz, feat, fused_attention=True, packed=True)
        assert fused == [] and packed_calls == [3] and both.dtype == torch.bfloat16
        _, only_fused = port(xyz, feat, fused_attention=True)
        assert fused == [8] and only_fused.dtype == torch.float32
        _, neither = port(xyz, feat)
        for out in (both, only_fused):
            np.testing.assert_allclose(out.float().numpy(), neither.float().numpy(),
                                       rtol=2e-2, atol=2e-2)


# ---- the whole path -------------------------------------------------------
def _wide_gate_config():
    cfg = tiny_pointnet_config()
    cfg["compute_dtype"] = "bfloat16"
    cfg["architecture"]["npoint"] = [1024, 64]
    cfg["condition_net_architecture"]["npoint"] = [128, 64]
    return cfg


def _net_inputs(seed=3, B=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, 2048, 3)).astype(np.float32) * 0.4
    cond = np.concatenate([rng.uniform(-0.5, 0.5, (B, 1024, 3)),
                           rng.integers(0, 2, (B, 1024, 1)) * 2.0 - 1.0], -1).astype(np.float32)
    return x, cond, np.full((B,), 5.0, np.float32), np.full((B,), 7, np.int32)


@pytest.fixture
def route_calls(monkeypatch):
    seen = {"attention": 0, "knn_group": 0}
    real_att, real_knn = t_att.fused_attention_pool, t_grouping.knn_group

    def att(*a, **k):
        seen["attention"] += 1
        return real_att(*a, **k)

    def knn(*a):
        seen["knn_group"] += 1
        return real_knn(*a)

    monkeypatch.setattr(t_att, "fused_attention_pool", att)
    monkeypatch.setattr(t_grouping, "knn_group", knn)
    return seen


@pytest.fixture(scope="module")
def network():
    cfg = _wide_gate_config()
    port = _randomize(PointNet2CloudCondition.from_config(cfg, device="cpu", seed=2), 2,
                      dense=False)
    return cfg, port


def test_denoise_with_variants_matches_jax(network, route_calls, packed_calls, monkeypatch):
    cfg, port = network
    x, cond, ts, label = _net_inputs()
    cf = port.encode_condition(_t(cond))
    off = port.denoise(_t(x), _t(ts), _t(label), cf, fused=True)
    assert route_calls == {"attention": 0, "knn_group": 0} and packed_calls == []
    on = port.denoise(_t(x), _t(ts), _t(label), cf, fused=True, fused_attention=True,
                      fused_knn=True)
    # two levels: 2 encoder FT + 2 SA + 3 decoder FT + 2 FP pools; the kNN
    # group only where the support has 1024 points (FP level 0)
    assert route_calls == {"attention": 9, "knn_group": 1}
    # without the fused inference routing the variants stay off, as in training
    port.denoise(_t(x), _t(ts), _t(label), cf, fused_attention=True, fused_knn=True,
                 packed=True)
    port(_t(x), _t(cond), _t(ts), _t(label))
    assert route_calls == {"attention": 9, "knn_group": 1} and packed_calls == []
    all_on = port.denoise(_t(x), _t(ts), _t(label), cf, fused=True, fused_attention=True,
                          fused_knn=True, packed=True)
    # packed wins at all nine sites; the kNN group is independent of it
    assert route_calls == {"attention": 9, "knn_group": 2} and len(packed_calls) == 9
    assert all(n >= 2 for n in packed_calls)

    monkeypatch.setenv("PDR_FUSED_ATTENTION", "1")
    monkeypatch.setenv("PDR_WINDOWED_KNNFP", "1")
    jm, params = JaxModel.from_config(cfg), state_dict_to_flax(port.state_dict())
    # jitted: the interpret-mode kernels run compiled, not op by op (the
    # routing reads the environment while tracing)
    encode = jax.jit(lambda p, c: jm.apply(p, c, windowed_ft=True, method=jm.encode_condition))
    denoise = jax.jit(lambda p, *a: jm.apply(p, *a, method=jm.denoise))
    jcf = encode(params, jnp.asarray(cond))
    assert jcf.ft_sups[0] is not None
    ref = _f(denoise(params, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(label), jcf))
    assert np.abs(ref).mean() > 1e-2
    for out in (on, all_on, off):
        diff = np.abs(out.numpy() - ref)
        assert diff.max() <= NET_MAX and diff.mean() <= NET_MEAN, (diff.max(), diff.mean())


def test_samplers_take_the_keywords(network, route_calls):
    """``make_coarse_sampler`` over a 4-step schedule and ``make_refiner``
    with the keywords on: the routes are taken on every step and in the
    refine forward, and the results stay close to the routes-off ones (same
    start, same noise; one bf16 network evaluation differs by at most
    NET_MAX and a reverse step scales that down)."""
    cfg, port = network
    _, cond, _, label = _net_inputs()
    schedule = calc_diffusion_hyperparams(4, 1e-4, 0.02)
    rng = np.random.default_rng(0)
    x_T = _t(rng.normal(size=(1, 2048, 3)).astype(np.float32))
    noise = _t(rng.normal(size=(4, 1, 2048, 3)).astype(np.float32))
    kw = dict(x_T=x_T, noise=noise)
    base = make_coarse_sampler(port, schedule, 2048)(_t(cond), _t(label), **kw)
    assert route_calls == {"attention": 0, "knn_group": 0}
    fast = make_coarse_sampler(port, schedule, 2048, fused_attention=True, fused_knn=True)(
        _t(cond), _t(label), **kw)
    assert route_calls == {"attention": 36, "knn_group": 4}
    assert tuple(fast.shape) == (1, 2048, 3) and bool(torch.isfinite(fast).all())
    np.testing.assert_allclose(fast.numpy(), base.numpy(), atol=NET_MAX)

    rcfg = dict(cfg, include_t=False)
    refiner_net = _randomize(PointNet2CloudCondition.from_config(rcfg, device="cpu", seed=4),
                             4, dense=False)
    coarse = _t(rng.uniform(-0.5, 0.5, (1, 2048, 3)).astype(np.float32))
    for k in route_calls:
        route_calls[k] = 0
    plain = make_refiner(refiner_net)(coarse, _t(cond), _t(label), 0.1)
    assert route_calls == {"attention": 0, "knn_group": 0}
    quick = make_refiner(refiner_net, fused_attention=True, fused_knn=True, packed=True)(
        coarse, _t(cond), _t(label), 0.1)
    assert route_calls == {"attention": 0, "knn_group": 1}  # packed wins the pools
    quick = make_refiner(refiner_net, fused_attention=True, fused_knn=True)(
        coarse, _t(cond), _t(label), 0.1)
    assert route_calls == {"attention": 9, "knn_group": 2}
    np.testing.assert_allclose(quick.numpy(), plain.numpy(), atol=0.1 * NET_MAX)
