"""The port's PVCNN2 backbone against the JAX package's ``models/pvcnn.py``.

Voxel transfers on the same inputs (cell borders and .5 rounding ties
included), ``PVConv`` with and without attention and squeeze-excitation,
and the JAX tests' miniature ``PVCNN2Completion``: forward and the gradient
of a loss, with the port's seeded weights carried into the Flax tree.
float32 throughout; the two differ in summation order only.  A PVConv
agrees to 1e-6 of its output's scale; through the whole net the voxel
attention's unscaled softmax amplifies that (1.1e-5 seen over seeds 5-7),
so the net is held to 3e-5 of its output's scale, and gradients to 1e-4 of
each tensor's scale (a tensor whose gradient is float32 noise, such as a
Conv bias just before a GroupNorm, to 1e-6 of the largest gradient).
Also: Conv kernels round-trip through ``utils/weights.py``, and dropout,
though configured, stays off in the train step, as in the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_diffusion_refinement_tpu.models import pvcnn as jpv
from point_diffusion_refinement_tpu_torch import train as ptrain
from point_diffusion_refinement_tpu_torch.diffusion import calc_diffusion_hyperparams
from point_diffusion_refinement_tpu_torch.models import pvcnn as ppv
from point_diffusion_refinement_tpu_torch.ops import voxelize
from point_diffusion_refinement_tpu_torch.utils.weights import (
    flax_to_state_dict,
    state_dict_to_flax,
)
from torch_threads import one_torch_thread  # noqa: F401

VOX_TOL = 1e-6  # voxel transfers, absolute, on values of order 1
CONV_RTOL = 1e-5  # one PVConv, of the output's largest magnitude
OUT_RTOL = 3e-5  # the whole net, of the output's largest magnitude
GRAD_RTOL = 1e-4  # of each gradient tensor's largest magnitude
GRAD_FLOOR = 1e-6  # of the largest gradient entry of the whole tree
MINI = dict(
    num_classes=3, sv_points=32, embed_dim=16, use_att=True, dropout=None,
    extra_feature_channels=0,
    sa_blocks=(
        ((8, 1, 4), (16, 0.2, 8, (8, 16))),
        (None, (8, 0.4, 8, (16, 16))),
    ),
    fp_blocks=(
        ((16, 16), (8, 1, 4)),
        ((16, 8), (8, 1, 4)),
    ),
)


def _t(a):
    return torch.from_numpy(np.array(a))


def _randomize(model, seed):
    """Seeded Flax-style kernels and GroupNorm affines away from 1 / 0."""
    g = torch.Generator().manual_seed(seed)
    ppv.init_weights(model, g)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("scale"):
                p.copy_(1.0 + 0.2 * torch.randn(p.shape, generator=g))
            elif name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
    return model


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * float(np.abs(want).max()))


class TestVoxelTransfers:
    def test_normalize_coords(self):
        rng = np.random.default_rng(0)
        coords = rng.uniform(-3, 3, (2, 40, 3)).astype(np.float32)
        want = np.asarray(jax.jit(jpv.normalize_coords, static_argnums=1)(coords, 8))
        got = voxelize.normalize_coords(_t(coords), 8).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=8 * VOX_TOL)

    def test_normalize_coords_stops_the_gradient(self):
        coords = torch.randn(1, 10, 3, requires_grad=True)
        assert not voxelize.normalize_coords(coords, 4).requires_grad

    def test_rounding_ties_and_scatter_mean(self):
        """.5 ties round half to even, as jnp.round; the scatter-mean over
        the rounded voxels equals the JAX segment-sum mean."""
        r = 4
        rng = np.random.default_rng(1)
        ties = np.array([0.5, 1.5, 2.5, 0.0, 3.0, 1.0], np.float32)
        norm = rng.choice(ties, (2, 30, 3)).astype(np.float32)
        want_idx = np.asarray(jnp.round(jnp.asarray(norm)).astype(jnp.int32))
        idx = voxelize.voxel_index(_t(norm))
        np.testing.assert_array_equal(idx.numpy(), want_idx)
        feats = rng.standard_normal((2, 30, 5)).astype(np.float32)
        want = np.asarray(jax.jit(jpv.avg_voxelize, static_argnums=2)(feats, want_idx, r))
        got = voxelize.avg_voxelize(_t(feats), idx, r).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=VOX_TOL)

    def test_trilinear_on_cell_borders(self):
        """Fractional points, integer points (cell borders) and the top
        border r - 1, where the upper corner is clamped."""
        r = 4
        rng = np.random.default_rng(2)
        vox = rng.standard_normal((2, r, r, r, 6)).astype(np.float32)
        frac = rng.uniform(0, r - 1, (2, 20, 3))
        border = rng.integers(0, r, (2, 12, 3)).astype(np.float64)
        top = np.full((2, 2, 3), r - 1.0)
        coords = np.concatenate([frac, border, top], axis=1).astype(np.float32)
        want = np.asarray(jax.jit(jpv.trilinear_devoxelize, static_argnums=2)(vox, coords, r))
        got = voxelize.trilinear_devoxelize(_t(vox), _t(coords), r).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=VOX_TOL)


def _flax(model):
    return jax.tree_util.tree_map(jnp.asarray, state_dict_to_flax(model.state_dict()))


@pytest.mark.parametrize("attention,with_se", [(False, False), (False, True), (True, False)])
def test_pvconv(attention, with_se):
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((2, 40, 8)).astype(np.float32)
    coords = rng.uniform(-1, 1, (2, 40, 3)).astype(np.float32)
    port = _randomize(ppv.PVConv(8, 16, 4, attention=attention, dropout=None,
                                 with_se=with_se, with_se_relu=True), 4)
    jm = jpv.PVConv(16, 4, attention=attention, dropout=None, with_se=with_se,
                    with_se_relu=True)
    want = jax.jit(jm.apply)(_flax(port), feats, coords)
    got = port(_t(feats), _t(coords)).detach().numpy()
    _close(got, want, CONV_RTOL)


@pytest.fixture(scope="module")
def mini():
    """The miniature completion net both ways: the JAX forward and the
    gradient of mean(out^2), jitted once."""
    rng = np.random.default_rng(5)
    x = rng.uniform(-0.5, 0.5, (2, 24, 3)).astype(np.float32)
    cond = rng.uniform(-0.5, 0.5, (2, 16, 3)).astype(np.float32)
    ts = np.array([0.0, 500.0], np.float32)
    port = _randomize(ppv.PVCNN2Completion(**MINI), 6)
    jm = jpv.PVCNN2Completion(**MINI)

    @jax.jit
    def run(p):
        loss_fn = lambda q: jnp.mean(jm.apply(q, x, cond, ts) ** 2)
        return jm.apply(p, x, cond, ts), jax.grad(loss_fn)(p)

    out, grads = run(_flax(port))
    return port, (x, cond, ts), np.asarray(out), grads


def test_completion_forward(mini):
    port, (x, cond, ts), want, _ = mini
    got = port(_t(x), _t(cond), _t(ts))
    assert got.shape == (2, 24, 3)
    _close(got.detach().numpy(), want, OUT_RTOL)


def test_completion_gradient(mini):
    port, (x, cond, ts), _, grads = mini
    port.zero_grad()
    torch.mean(port(_t(x), _t(cond), _t(ts)) ** 2).backward()
    ref = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, grads))
    named = dict(port.named_parameters())
    assert set(ref) == set(named)
    top = max(float(r.abs().max()) for r in ref.values())
    for name, p in named.items():
        scale = float(ref[name].abs().max())
        err = float((p.grad - ref[name]).abs().max())
        assert err <= GRAD_RTOL * scale + GRAD_FLOOR * top, (name, err, scale)


def test_flax_tree_names_match(mini):
    """Every Flax parameter path of the JAX init is a port state_dict key,
    with the Conv kernels in torch's layout."""
    port, (x, cond, ts), _, _ = mini
    tree = jax.eval_shape(
        lambda: jpv.PVCNN2Completion(**MINI).init(jax.random.key(0), x, cond, ts))
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}
    sd = port.state_dict()
    assert len(flat) == len(sd)
    for path, shape in flat.items():
        key = path.removeprefix("params/").replace("/", ".").replace(".kernel", ".weight")
        want = shape if len(shape) == 1 else (shape[-1], shape[-2]) + shape[:-2]
        assert tuple(sd[key].shape) == tuple(want), path


def test_conv_kernel_round_trip():
    """A Flax Conv kernel (kd, kh, kw, Cin, Cout) becomes Conv3d's (Cout,
    Cin, kd, kh, kw) and comes back bit for bit; Dense kernels transpose."""
    rng = np.random.default_rng(7)
    tree = {"params": {"PVConv_0": {
        "Conv_0": {"kernel": rng.standard_normal((3, 3, 3, 4, 8)).astype(np.float32),
                   "bias": rng.standard_normal(8).astype(np.float32)},
        "Dense_0": {"kernel": rng.standard_normal((4, 8)).astype(np.float32)}}}}
    sd = flax_to_state_dict(tree)
    w = tree["params"]["PVConv_0"]["Conv_0"]["kernel"]
    assert tuple(sd["PVConv_0.Conv_0.weight"].shape) == (8, 4, 3, 3, 3)
    np.testing.assert_array_equal(sd["PVConv_0.Conv_0.weight"][5, 2, 0, 1, 2].numpy(),
                                  w[0, 1, 2, 2, 5])
    np.testing.assert_array_equal(sd["PVConv_0.Dense_0.weight"].numpy(),
                                  tree["params"]["PVConv_0"]["Dense_0"]["kernel"].T)
    back = state_dict_to_flax(sd)
    for name in ("Conv_0", "Dense_0"):
        for leaf, arr in tree["params"]["PVConv_0"][name].items():
            np.testing.assert_array_equal(back["params"]["PVConv_0"][name][leaf], arr)


def test_dropout_configured_but_off_in_the_train_step():
    """Dropout 0.1 in every PVConv and 0.5 at the head, the model in
    ``train()`` mode: the step's loss equals the dropout-free network's at
    the same draws, as the JAX steps run without a dropout draw."""
    rng = np.random.default_rng(8)
    x0 = _t(rng.uniform(-0.5, 0.5, (2, 24, 3)).astype(np.float32))
    cond = _t(rng.uniform(-0.5, 0.5, (2, 16, 3)).astype(np.float32))
    label = torch.zeros(2, dtype=torch.int64)
    t, z = torch.tensor([3, 7]), torch.randn(2, 24, 3, generator=torch.Generator().manual_seed(0))
    sched = calc_diffusion_hyperparams(10, 1e-4, 0.02)
    with_dropout = _randomize(ppv.PVCNN2Completion(**{**MINI, "dropout": 0.1}), 9).train()
    without = ppv.PVCNN2Completion(**MINI)
    without.load_state_dict(with_dropout.state_dict())
    with torch.no_grad():
        losses = [float(ptrain.make_completion_loss(m, sched)(x0, cond, label, t, z))
                  for m in (with_dropout, with_dropout, without)]
    assert losses[0] == losses[1] == losses[2]
    # asked for, dropout does act
    with torch.no_grad():
        y = with_dropout(x0, cond, t.float(), deterministic=False)
        assert not torch.equal(y, with_dropout(x0, cond, t.float()))
