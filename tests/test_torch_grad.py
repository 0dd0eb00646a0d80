"""Gradients of the port's grouping ops, EMD and chamfer against the JAX
package's, and the plain version of the fused ball-query + gather kernel
against the Pallas kernel in interpret mode.

Inputs come from a numpy seed and go through both packages.  On the CPU the
port's wrappers run their plain versions, so the fused and unfused routes
of the port must agree exactly where both sum a gather's cotangent in the
scatter-add's order (``ops/scatter.py``: runs of a ball's slots, then the
runs), as they do on the card: there the unfused gathers take the ordered
backward (``ops/sampling.py::_OrderedGather``), which the tests that compare
the routes also give them on the CPU (``_ordered_gathers``); against
the JAX custom VJPs the tolerance is bf16-sized, because those round the
cotangents (and the windowed kernel its outputs) to bfloat16 for the MXU
and the port does not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_diffusion_refinement_tpu.models import grouping as jgrouping
from point_diffusion_refinement_tpu.ops import chamfer as jchamfer
from point_diffusion_refinement_tpu.ops import emd as jemd
from point_diffusion_refinement_tpu.ops.pallas_neighbors import ball_query_group_pallas
from point_diffusion_refinement_tpu.ops.windowed_grad import windowed_group_train
from point_diffusion_refinement_tpu_torch import ops
from point_diffusion_refinement_tpu_torch.models.grouping import (
    fused_ball_gather,
    query_and_group,
)
from point_diffusion_refinement_tpu_torch.models.modules import SetAbstraction
from point_diffusion_refinement_tpu_torch.ops import chamfer, emd
from torch_threads import one_torch_thread  # noqa: F401


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _clouds(seed, B, N, M, C, lo=-1.0, hi=1.0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(lo, hi, (B, N, 3)).astype(np.float32)
    c = rng.uniform(lo, hi, (B, M, 3)).astype(np.float32)
    f = rng.uniform(-1, 1, (B, N, C)).astype(np.float32)
    return x, c, f


# ---- (d) kernel #8's plain version and the fused route of query_and_group ----

def test_ball_query_group_plain_matches_pallas_interpret():
    """idx and counts equal; gathered values to the Pallas kernel's own
    tolerance (its hi/lo bf16 split keeps ~16 mantissa bits; the port's rows
    are exact float32, checked against table[idx] with no tolerance)."""
    B, N, M, K, C = 2, 300, 170, 8, 37
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    c = rng.uniform(-1, 1, (B, M, 3)).astype(np.float32)
    table = rng.uniform(-9, 9, (B, N, C)).astype(np.float32)
    g_ref, i_ref, n_ref = ball_query_group_pallas(
        jnp.asarray(x), jnp.asarray(c), jnp.asarray(table), 0.3, K, True)
    g, i, n = ops.ball_query_group(_t(x), _t(c), _t(table), 0.3, K)
    assert (n.numpy() == 0).any() and (n.numpy() == K).any()
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_array_equal(n.numpy(), np.asarray(n_ref))
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=2e-5, atol=2e-4)
    expect = np.take_along_axis(table[:, None], i.numpy().astype(np.int64)[..., None], axis=2)
    np.testing.assert_array_equal(g.numpy(), expect)
    qi, qn = ops.ball_query(_t(x), _t(c), 0.3, K)
    assert torch.equal(i, qi) and torch.equal(n, qn)


GROUP_KW = [
    dict(use_xyz=True, include_abs_coordinate=True, include_center_coordinate=True,
         subset=False),
    dict(use_xyz=True, include_abs_coordinate=False, include_center_coordinate=False,
         subset=True),
    dict(use_xyz=False, include_abs_coordinate=False, include_center_coordinate=False,
         subset=False),
]


@pytest.mark.parametrize("kw", GROUP_KW, ids=["ft", "sa", "features_only"])
def test_query_and_group_fused_equals_unfused_and_jax(kw):
    x, c, f = _clouds(1, 2, 200, 60, 5)
    kw = dict(radius=0.3, nsample=8, **kw)
    ref, cnt_ref = jgrouping.query_and_group(jnp.asarray(x), jnp.asarray(c), jnp.asarray(f), **kw)
    a, na = query_and_group(_t(x), _t(c), _t(f), **kw)
    b, nb = query_and_group(_t(x), _t(c), _t(f), fused_gather=True, **kw)
    assert (na.numpy() == 0).any()
    assert torch.equal(a, b) and torch.equal(na, nb)
    np.testing.assert_array_equal(nb.numpy(), np.asarray(cnt_ref))
    np.testing.assert_allclose(b.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_query_and_group_fused_without_features():
    x, c, _ = _clouds(2, 2, 120, 40, 1)
    kw = dict(radius=0.4, nsample=8, use_xyz=True, include_abs_coordinate=True)
    a, _ = query_and_group(_t(x), _t(c), None, **kw)
    b, _ = query_and_group(_t(x), _t(c), None, fused_gather=True, **kw)
    assert torch.equal(a, b) and a.shape == (2, 40, 8, 6)


# ---- (e) the fused gather's gradient ------------------------------------------

# the float32 gap allowed between two orders of one sum, a share of the sum
# of its terms' magnitudes
ORDER_RTOL = 1e-6


def _near_in_another_order(got, ref, magnitude):
    """``got`` equals ``ref`` up to the order of float32 sums: each element
    within ORDER_RTOL of the sum of its terms' magnitudes (``magnitude``)."""
    gap = (got - ref).abs()
    assert bool((gap <= ORDER_RTOL * magnitude.abs()).all()), float((gap / magnitude.abs()).max())


def _ordered_gathers(monkeypatch):
    """The gathers take the ordered backward on the CPU too, as they do on
    the card: a gather's gradient sums in the scatter-add's order, the one
    of the fused routes' backwards (the indexed load's own backward sums in
    slot order)."""
    from point_diffusion_refinement_tpu_torch.ops import sampling

    monkeypatch.setattr(sampling, "_ordered_backward",
                        lambda p: p.requires_grad and torch.is_grad_enabled())


def test_fused_gather_grad_matches_jax_vjp_and_unfused(monkeypatch):
    """d(loss)/d(features): equal to autograd through the port's unfused
    path (its gather's backward the ordered scatter-add, as on the card),
    and within the JAX test's own tolerance (rtol = atol = 2e-2: its VJP
    rounds the cotangent to bf16) of the JAX fused VJP in interpret mode."""
    import point_diffusion_refinement_tpu.ops.pallas_neighbors as pn
    from point_diffusion_refinement_tpu.ops import sampling as jsampling

    x, c, f = _clouds(3, 1, 100, 24, 6)
    kw = dict(radius=0.4, nsample=8, use_xyz=True, subset=True)
    monkeypatch.setattr(jsampling, "_use_pallas", lambda: True)
    monkeypatch.setattr(jgrouping, "_use_fused_ball_gather", lambda *a: True)
    orig = pn.ball_query_group_pallas
    monkeypatch.setattr(pn, "ball_query_group_pallas", lambda *a, **k: orig(*a[:5], True))
    g_jax = jax.grad(lambda f_: jnp.sum(jgrouping.query_and_group(
        jnp.asarray(x), jnp.asarray(c), f_, **kw)[0] ** 2))(jnp.asarray(f))

    def grads(fused, magnitude=False):
        ft = _t(f, grad=True)
        out, _ = query_and_group(_t(x), _t(c), ft, fused_gather=fused, **kw)
        # the loss's cotangent 2 out, or its magnitude |2 out|
        ((out * (2 * out).detach().abs()).sum() if magnitude else (out ** 2).sum()).backward()
        return ft.grad

    # autograd through the indexed load (slot order), an independent sum
    by_index, magnitude = grads(False), grads(False, magnitude=True)
    _ordered_gathers(monkeypatch)
    fused = grads(True)
    assert torch.equal(grads(False), fused)
    _near_in_another_order(fused, by_index, magnitude)
    np.testing.assert_allclose(fused.numpy(), np.asarray(g_jax), rtol=2e-2, atol=2e-2)


def test_fused_ball_gather_is_differentiable_in_table_only():
    x, c, f = _clouds(4, 2, 80, 30, 4)
    xt, ct, tab = _t(x, True), _t(c, True), _t(f, True)
    g, idx, counts = fused_ball_gather(xt, ct, tab, 0.4, 8)
    assert g.requires_grad and not idx.requires_grad and not counts.requires_grad
    w = torch.from_numpy(np.random.default_rng(0).standard_normal(g.shape).astype(np.float32))
    (g * w).sum().backward()
    assert xt.grad is None and ct.grad is None
    ref = ops.group_scatter_add_plain(w, idx, 80)
    assert torch.equal(tab.grad, ref)
    # the scatter against a dense one-hot contraction (float64)
    oh = np.zeros((2, 30, 8, 80))
    np.put_along_axis(oh, idx.numpy().astype(np.int64)[..., None], 1.0, axis=-1)
    dense = np.einsum("bmkn,bmkc->bnc", oh, w.numpy().astype(np.float64))
    np.testing.assert_allclose(ref.numpy(), dense, rtol=1e-5, atol=1e-6)


def test_group_scatter_add_masks_empty_balls_and_takes_bf16():
    x, c, _ = _clouds(5, 2, 60, 25, 1)
    c[:, ::4] += 5.0
    idx, counts = ops.ball_query(_t(x), _t(c), 0.5, 8)
    dg = torch.randn(2, 25, 8, 7, generator=torch.Generator().manual_seed(0))
    full = ops.group_scatter_add(dg, idx, 60)
    masked = ops.group_scatter_add(dg, idx, 60, counts)
    have = (counts > 0).float()[..., None, None]
    assert torch.equal(masked, ops.group_scatter_add(dg * have, idx, 60))
    assert not torch.equal(full, masked)
    half = ops.group_scatter_add(dg.to(torch.bfloat16), idx, 60)
    assert half.dtype == torch.float32
    assert torch.equal(half, ops.group_scatter_add(dg.to(torch.bfloat16).float(), idx, 60))


# ---- (e) ball_group_train ---------------------------------------------------------

B, N, M, K, C = 2, 256, 128, 8, 12
RADIUS = 0.35


def _windowed_data():
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    feats = rng.standard_normal((B, N, C)).astype(np.float32)
    new_xyz = (xyz[:, :M] + 0.01).astype(np.float32)
    return xyz, feats, new_xyz


def _reduce_jax(g):
    g = g.astype(jnp.float32)
    return jnp.sum(jnp.square(g) * (1.0 + 0.1 * jnp.arange(g.shape[-1], dtype=jnp.float32)))


def _reduce(g):
    g = g.to(torch.float32)
    return (g.square() * (1.0 + 0.1 * torch.arange(g.shape[-1], dtype=torch.float32))).sum()


def test_ball_group_train_grads_match_jax_windowed_vjp():
    """The three gradients against ``windowed_group_train``'s custom VJP in
    interpret mode, with that test's quadratic, centre-permutation-invariant
    loss and its tolerances (3e-2 of the largest entry, cosine > 0.99: the
    JAX forward and cotangents are bf16-rounded)."""
    xyz, feats, new_xyz = _windowed_data()
    g_jax = jax.grad(
        lambda a, b, c: _reduce_jax(windowed_group_train(a, b, c, RADIUS, K, False, "row0", True)[0]),
        argnums=(0, 1, 2))(jnp.asarray(xyz), jnp.asarray(feats), jnp.asarray(new_xyz))
    leaves = [_t(a, grad=True) for a in (xyz, feats, new_xyz)]
    grouped, counts, idx = ops.ball_group_train(*leaves, RADIUS, K, False, "row0")
    assert grouped.dtype == torch.bfloat16 and not counts.requires_grad
    _reduce(grouped).backward()
    for a, t, name in zip(g_jax, leaves, ("xyz", "feats", "new_xyz")):
        a, b = np.asarray(a), t.grad.numpy()
        scale = np.abs(a).max() + 1e-6
        np.testing.assert_allclose(b / scale, a / scale, atol=3e-2, err_msg=name)
        cos = float((a * b).sum()) / float(np.linalg.norm(a) * np.linalg.norm(b) + 1e-12)
        assert cos > 0.99, (name, cos)


@pytest.mark.parametrize("mode", ["row0", "center_zero"])
@pytest.mark.parametrize("center", [False, True])
def test_ball_group_train_grads_equal_autograd_through_plain(mode, center, monkeypatch):
    """Exactly (float32 tables: both sum the bf16 cotangent in float32, in
    the scatter-add's order, the plain version's gathers taking the ordered
    backward as on the card) against autograd through ``ball_group_plain``,
    with empty balls in both empty modes; and within float32 rounding
    (ORDER_RTOL) of autograd through the indexed load of the plain version
    unpatched, which sums in slot order."""
    xyz, feats, new_xyz = _windowed_data()
    new_xyz[:, ::5] += 4.0
    w = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (B, M, K, C + (9 if center else 6))).astype(np.float32))

    def run(fn, weight):
        leaves = [_t(a, grad=True) for a in (xyz, feats, new_xyz)]
        if fn is not None:
            grouped, counts, idx = fn(*leaves, RADIUS, K, center, mode)
            qi, qn = ops.ball_query(leaves[0], leaves[2], RADIUS, K)
            assert torch.equal(idx, qi) and torch.equal(counts, qn) and (qn == 0).any()
        else:
            (grouped,), _ = ops.ball_group_plain(
                leaves[0], [leaves[1]], leaves[2], RADIUS, K, center, mode)
        (grouped.float() * weight).sum().backward()
        return [grouped.detach()] + [t.grad for t in leaves]

    # the loss is linear in the grouped values: with |w| each gradient is the
    # sum of its terms' magnitudes (negated for the centres, whose terms
    # enter with a minus sign)
    by_index, magnitude = run(None, w), run(None, w.abs())
    _ordered_gathers(monkeypatch)
    got, want = run(ops.ball_group_train, w), run(None, w)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(got[0], by_index[0])
    for a, b, m in zip(got[1:], by_index[1:], magnitude[1:]):
        _near_in_another_order(a, b, m)


def test_set_abstraction_fused_sa_route_matches_unfused():
    """A SetAbstraction level that passes ``train_fused_eligible`` (bf16
    compute, support >= 1024, npoint % 128 == 0): loss and parameter
    gradients of the fused route against the unfused one, within bf16
    tolerances (the fused group rounds positions to bf16 before the first
    Dense does)."""
    xyz, feats, _ = _windowed_data()
    xyz = np.tile(xyz, (1, 4, 1))[:, :1024] + np.linspace(0, 1e-3, 1024, dtype=np.float32)[None, :, None]
    feats = np.tile(feats, (1, 4, 1))[:, :1024]
    mod = SetAbstraction(C, 128, RADIUS, K, (16, 16), include_abs_coordinate=True,
                         dtype=torch.bfloat16)
    assert mod.train_fused_eligible(_t(xyz), _t(feats), True)
    assert not mod.train_fused_eligible(_t(xyz), _t(feats), False)
    assert not mod.train_fused_eligible(_t(xyz[:, :512]), _t(feats[:, :512]), True)
    assert not mod.train_fused_eligible(_t(xyz), _t(np.tile(feats, (1, 1, 11))), True)
    results = []
    for fused_sa in (False, True):
        mod.zero_grad()
        ft = _t(feats, grad=True)
        _, out = mod(_t(xyz), ft, fused_sa=fused_sa)
        loss = out.float().square().sum()
        loss.backward()
        results.append((float(loss.detach()), ft.grad.clone(),
                        [p.grad.clone() for p in mod.parameters()]))
    (v0, f0, g0), (v1, f1, g1) = results
    np.testing.assert_allclose(v1, v0, rtol=3e-2)
    for a, b in zip([f0] + g0, [f1] + g1):
        scale = float(a.abs().max()) + 1e-6
        assert float((a - b).abs().max()) / scale <= 5e-2


# ---- (f) EMD backward, and chamfer ------------------------------------------------

@pytest.mark.parametrize("tiled", [False, True])
def test_emd_backward_matches_jax(monkeypatch, tiled):
    """Gradients of both clouds against ``jax.grad(earth_mover_distance)``,
    untiled and row-tiled (chunks of 16 rows, a ragged last chunk).
    Untiled: 1e-5 of the largest entry.  Tiled: 2e-3, because the JAX tiled
    auction itself differs from its untiled one at that level (the
    auction's exp(-16384 d) rounds amplify float32 summation order)."""
    rng = np.random.default_rng(0)
    a = rng.uniform(-0.5, 0.5, (2, 40, 3)).astype(np.float32)
    b = rng.uniform(-0.5, 0.5, (2, 56, 3)).astype(np.float32)
    w = np.array([1.0, 2.0], np.float32)
    if tiled:
        monkeypatch.setattr(jemd, "_emd_row_chunk", lambda B, n, m: 16)
        monkeypatch.setattr(emd, "emd_row_chunk", lambda B, n, m: 16)
    v_jax = jemd.earth_mover_distance(jnp.asarray(a), jnp.asarray(b))
    g_jax = jax.grad(lambda x, y: (jemd.earth_mover_distance(x, y) * w).sum(),
                     argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta, tb = _t(a, True), _t(b, True)
    cost = emd.earth_mover_distance(ta, tb)
    assert cost.requires_grad
    (cost * _t(w)).sum().backward()
    np.testing.assert_allclose(cost.detach().numpy(), np.asarray(v_jax),
                               rtol=1e-4 if tiled else 1e-5)
    tol = 2e-3 if tiled else 1e-5
    for got, want in ((ta.grad, g_jax[0]), (tb.grad, g_jax[1])):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= tol * np.abs(want).max()
    # no gradient asked for: the forward-only route, same value, nothing kept
    plain = emd.earth_mover_distance(_t(a), _t(b))
    assert not plain.requires_grad and torch.equal(plain, cost.detach())


@pytest.mark.parametrize("which", [0, 1])
def test_chamfer_gradients_match_jax(which):
    """cd_p and cd_t are differentiable by construction (the distance is
    recomputed from the argmin's neighbour); float32, 1e-5 of the largest
    entry."""
    rng = np.random.default_rng(2)
    out = rng.uniform(-0.5, 0.5, (2, 70, 3)).astype(np.float32)
    gt = rng.uniform(-0.5, 0.5, (2, 50, 3)).astype(np.float32)
    g_jax = jax.grad(lambda o, g: jchamfer.calc_cd(o, g)[which].mean(), argnums=(0, 1))(
        jnp.asarray(out), jnp.asarray(gt))
    to, tg = _t(out, True), _t(gt, True)
    chamfer.calc_cd(to, tg)[which].mean().backward()
    for got, want in ((to.grad, g_jax[0]), (tg.grad, g_jax[1])):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
