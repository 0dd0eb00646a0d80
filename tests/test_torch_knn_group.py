"""The port's fused kNN group against the JAX package, on the CPU.

``ops.knn_group`` (on CPU tensors its plain version) is held against the JAX
package's ``group_knn_features(..., lossy_features=True)``, the reference the
JAX tests hold their windowed kernel to, with those tests' tolerances
(``tests/test_pallas_window.py``): bf16-rounded channels to 2e-2 absolute,
distances and weights to 1e-2 relative; in fact the two agree far closer,
and the neighbour sets are compared exactly through the distance channel.
On a uniform cloud, where the windowed kernel's window check is sound, it is
also held against ``windowed_knn_group`` in interpret mode, brought back from
sorted-query order through ``qctx.order``.  ``KnnFeaturePropagation`` with
``fused_knn=True`` is held against the JAX module on its windowed route.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_diffusion_refinement_tpu.models import grouping as j_grouping
from point_diffusion_refinement_tpu.models import modules as j_mod
from point_diffusion_refinement_tpu.ops import pallas_window as j_pw
from point_diffusion_refinement_tpu_torch import ops
from point_diffusion_refinement_tpu_torch.models import grouping as t_grouping
from point_diffusion_refinement_tpu_torch.models import modules as t_mod
from point_diffusion_refinement_tpu_torch.utils.weights import state_dict_to_flax
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def no_grad():
    with torch.no_grad():
        yield


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _f(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _check_channels(got, ref, C):
    """The JAX tests' tolerances, per channel group."""
    np.testing.assert_allclose(got[..., :C], ref[..., :C], atol=2e-2, rtol=0)
    np.testing.assert_allclose(got[..., C + 2:], ref[..., C + 2:], atol=2e-2, rtol=0)
    np.testing.assert_allclose(got[..., C], ref[..., C], rtol=1e-2, atol=1e-4)
    np.testing.assert_allclose(got[..., C + 1], ref[..., C + 1], rtol=1e-2, atol=1e-3)


def _cloud(seed, B, N, M, C):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    q = rng.uniform(-1, 1, (B, M, 3)).astype(np.float32)
    feats = rng.normal(size=(B, N, C)).astype(np.float32)
    return xyz, q, feats


@pytest.mark.parametrize("N,M,C,k,ties", [(300, 130, 36, 8, False), (64, 50, 5, 4, True),
                                          (8, 40, 3, 8, True), (1, 5, 2, 1, False),
                                          (300, 130, 12, 24, False), (256, 60, 6, 256, True)],
                         ids=["plain", "ties", "k_eq_N_ties", "one_point", "k24",
                              "k_eq_N_256"])
def test_matches_jax_group_knn_features(N, M, C, k, ties):
    xyz, q, feats = _cloud(N + M, 2, N, M, C)
    if ties:
        xyz[:, N // 2:] = xyz[:, : N - N // 2]  # every point twice: ties
        q[:, :3] = xyz[:, :3]  # queries on support points: zero distances
    ref = _f(j_grouping.group_knn_features(jnp.asarray(q), jnp.asarray(xyz),
                                           jnp.asarray(feats), k, lossy_features=True))
    got = ops.knn_group(_t(q), _t(xyz), _t(feats), k)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, M, k, C + 11)
    got = got.float().numpy()
    _check_channels(got, ref, C)
    # features and positions are roundings of the same float32 values
    np.testing.assert_array_equal(got[..., :C], ref[..., :C])
    np.testing.assert_array_equal(got[..., C + 2:], ref[..., C + 2:])
    np.testing.assert_array_equal(got[..., C], ref[..., C])
    # and the port's own unfused grouping has the same values
    unfused = t_grouping.group_knn_features(_t(q), _t(xyz), _t(feats), k,
                                            lossy_features=True).float().numpy()
    np.testing.assert_array_equal(got[..., :C + 1], unfused[..., :C + 1])
    np.testing.assert_array_equal(got[..., C + 2:], unfused[..., C + 2:])
    np.testing.assert_allclose(got[..., C + 1], unfused[..., C + 1], rtol=2.0 ** -7)


def test_rows_are_the_knn_kernel_neighbours():
    """The rows imply ``knn``'s indices: gathering by them reproduces the
    feature and position channels exactly."""
    xyz, q, feats = _cloud(3, 2, 200, 70, 9)
    xyz[:, 100:] = xyz[:, :100]
    dist, idx = ops.knn(_t(q), _t(xyz), 8)
    got = ops.knn_group(_t(q), _t(xyz), _t(feats), 8)
    rows = ops.group_points(_t(feats).to(torch.bfloat16), idx)
    assert torch.equal(got[..., :9], rows)
    assert torch.equal(got[..., 9], dist.to(torch.bfloat16))
    assert torch.equal(got[..., 11:14], ops.group_points(_t(xyz), idx).to(torch.bfloat16))
    w = got[..., 10].float().sum(-1)
    np.testing.assert_allclose(w.numpy(), 1.0, atol=2e-2)


@pytest.mark.parametrize("window", [256, 384])
def test_matches_jax_windowed_kernel(window):
    """Uniform cloud: the Pallas kernel (interpret mode), unsorted through
    ``qctx.order``."""
    B, N, M, C, k = 2, 1024, 256, 36, 8
    xyz, q, feats = _cloud(11, B, N, M, C)
    sup = j_pw.build_support_ctx(jnp.asarray(xyz), [jnp.asarray(feats)])
    qc = j_pw.build_query_ctx(jnp.asarray(q), sup.axis_onehot)
    ref_sorted = _f(j_pw.windowed_knn_group(sup, qc, k, window=window, interpret=True))
    order = np.asarray(qc.order)
    got = ops.knn_group(_t(q), _t(xyz), _t(feats), k).float().numpy()
    got_sorted = np.take_along_axis(got, order[:, :, None, None], axis=1)
    _check_channels(got_sorted, ref_sorted, C)
    np.testing.assert_array_equal(got_sorted[..., :C], ref_sorted[..., :C])


@pytest.mark.parametrize("k", [24])
def test_matches_jax_windowed_kernel_any_k(k):
    """k beyond 16, against the Pallas kernel (interpret mode), unsorted
    through ``qctx.order``.  Its window must outsize k by 128, so k = N is
    held against ``group_knn_features`` above."""
    B, N, M, C = 2, 256, 128, 12
    xyz, q, feats = _cloud(12, B, N, M, C)
    sup = j_pw.build_support_ctx(jnp.asarray(xyz), [jnp.asarray(feats)])
    qc = j_pw.build_query_ctx(jnp.asarray(q), sup.axis_onehot)
    ref_sorted = _f(j_pw.windowed_knn_group(sup, qc, k, window=256, interpret=True))
    order = np.asarray(qc.order)
    got = ops.knn_group_plain(_t(q), _t(xyz), _t(feats), k).float().numpy()
    assert got.shape == (B, M, k, C + 11)
    got_sorted = np.take_along_axis(got, order[:, :, None, None], axis=1)
    _check_channels(got_sorted, ref_sorted, C)
    np.testing.assert_array_equal(got_sorted[..., :C], ref_sorted[..., :C])


COMMON = dict(bn=True, bn_first=False, bias=True, res_connect=True)
ATT = dict(use_attention=True, attention_bn=True, attention_transform_out=True,
           attention_last_activation=True)


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


def _fp(dtype=torch.bfloat16, k=8, uw=7, kw=11):
    return _randomize(t_mod.KnnFeaturePropagation(
        uw, kw, (16, 16), (16, 16), k, include_t=True, t_features=16,
        include_condition=True, condition_features=12, include_second_condition=True,
        second_condition_features=8, dtype=dtype, **COMMON, **ATT), 7)


def test_feature_propagation_matches_jax_windowed(monkeypatch):
    """256 queries on a 1024-point support, narrow features: the port's
    ``fused_knn=True`` against the JAX module with ``PDR_WINDOWED_KNNFP=1``
    and ``windowed=True``.  bf16 compute on both sides; the JAX route emits
    positions from hi/lo bf16 halves, the port from float32, so grouped
    values may differ by one bf16 ulp, which two MLPs and an attention pool
    carry on: 5e-2 absolute on outputs of order 1, mean 1e-2."""
    monkeypatch.setenv("PDR_WINDOWED_KNNFP", "1")
    rng = np.random.default_rng(21)
    B, N, M = 1, 1024, 256
    known = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    unknown = rng.uniform(-1, 1, (B, M, 3)).astype(np.float32)
    uf = rng.normal(size=(B, M, 7)).astype(np.float32)
    kf = rng.normal(size=(B, N, 11)).astype(np.float32)
    emb = [rng.normal(size=(B, w)).astype(np.float32) for w in (16, 12, 8)]
    port = _fp()
    assert port.fused_knn_eligible(_t(unknown), _t(known), _t(kf), True)
    seen = []
    real = t_grouping.knn_group
    monkeypatch.setattr(t_grouping, "knn_group",
                        lambda *a: seen.append(a[3]) or real(*a))
    args = (unknown, known, uf, kf, *emb)
    out = port(*map(_t, args), fused_knn=True)
    assert seen == [8]
    unfused = port(*map(_t, args))
    assert seen == [8]  # off by default
    jm = j_mod.KnnFeaturePropagation(
        mlp1=(16, 16), mlp2=(16, 16), k=8, include_t=True, include_condition=True,
        include_second_condition=True, dtype=jnp.bfloat16, **COMMON, **ATT)
    assert jm._windowed_eligible(jnp.asarray(unknown), jnp.asarray(known),
                                 jnp.asarray(kf), True)
    ref = _f(jm.apply(state_dict_to_flax(port.state_dict()), *map(jnp.asarray, args),
                      windowed=True))
    got = out.float().numpy()
    np.testing.assert_allclose(got, ref, atol=5e-2, rtol=0)
    assert np.abs(got - ref).mean() < 1e-2 and np.abs(ref).mean() > 1e-1
    np.testing.assert_allclose(got, unfused.float().numpy(), atol=5e-2, rtol=0)


@pytest.mark.parametrize("change,eligible", [
    ({}, True),
    (dict(flag=False), False),
    (dict(dtype=None), False),
    (dict(N=1023), False),
    (dict(M=200), False),
    (dict(M=384), True),
    (dict(kw=248), True),
    (dict(kw=249), False),
    (dict(no_known=True), False),
], ids=["base", "flag_off", "float32", "small_support", "queries_not_x128", "queries_384",
        "table_256", "table_257", "no_known"])
def test_eligibility_rule(change, eligible, monkeypatch):
    """bf16, support >= 1024, queries a multiple of 128, k <= support and a
    packed table (8 + C) of at most 256 channels: the JAX rule, case by case,
    and the JAX module agrees on every case its rule covers."""
    monkeypatch.setenv("PDR_WINDOWED_KNNFP", "1")
    N, M, kw = change.get("N", 1024), change.get("M", 256), change.get("kw", 11)
    flag = change.get("flag", True)
    dtype = change.get("dtype", torch.bfloat16)
    port = _fp(dtype=dtype, kw=kw)
    unknown, known, kf = torch.zeros(1, M, 3), torch.zeros(1, N, 3), torch.zeros(1, N, kw)
    if change.get("no_known"):
        known = kf = None
    assert port.fused_knn_eligible(unknown, known, kf, flag) is eligible
    jm = j_mod.KnnFeaturePropagation(mlp1=(16, 16), mlp2=(16, 16), k=8,
                                     dtype=jnp.bfloat16 if dtype is not None else None)
    j_ok = bool(jm._windowed_eligible(
        jnp.zeros((1, M, 3)), None if known is None else jnp.zeros((1, N, 3)),
        None if kf is None else jnp.zeros((1, N, kw)), flag))
    if j_ok and kw == 249:  # the JAX rule defers the table width to build_support_ctx_auto
        assert j_pw.build_support_ctx(jnp.zeros((1, N, 3)), [jnp.zeros((1, N, kw))],
                                      max_ct=256) is None
    else:
        assert j_ok is eligible


def test_k_larger_than_support_is_not_fused():
    port = _fp(k=8)
    assert not port.fused_knn_eligible(torch.zeros(1, 128, 3), torch.zeros(1, 4, 3),
                                       torch.zeros(1, 4, 11), True)
