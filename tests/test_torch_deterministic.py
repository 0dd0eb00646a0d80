"""The port's training step repeats run to run, as the JAX package's jitted
step does: every backward of a gather sums in a fixed order.

On the card the ordered scatter-add (``csrc/group_scatter_ordered.cu``)
sums in the order of its plain version (``ops/scatter.py::
group_scatter_add_plain``, two serial ``index_add_`` on the CPU).  A run is
a maximal stretch of consecutive slots (m, k), (m, k + 1), ... of one ball
whose idx equals the row (a ball that ``counts`` skips has none); each run's
terms are summed in slot order from 0.0, then the runs' partials into the
row in ascending order of their first slot, from 0.0.  Its card cases are
in ``tests/test_torch_kernels_cuda.py``.  Here, on the CPU:

- the gathers' autograd Function (``ops/sampling.py::_OrderedGather``, the
  route of ``gather_points`` / ``group_points`` on the card) against the JAX
  package's ``gather_points`` / ``group_points`` and their ``jax.grad``, and
  against the indexed load's own autograd gradient;
- the plain scatter-add against a float32 loop written out in that order
  (empty balls, padded balls, repeats inside a ball, ``counts``, a bf16
  channel slice, every slot on one row), at K = 1 bit-equal to one
  ``index_add_`` in slot order (the order before runs), and the two-table
  form (``group_scatter_add_pair``, ``ball_group_train``'s backward) equal
  to single calls;
- the plain scatter-add against the JAX package's backward of the fused
  gather (``models/grouping.py::_fused_ball_gather_bwd``, a one-hot einsum),
  including every slot on one row, empty balls skipped through ``counts``
  and a bf16 channel slice read in place;
- ``avg_voxelize`` / ``trilinear_devoxelize`` through the new routes
  against the formulas they replaced; the update's backward under cuDNN's
  deterministic algorithms (PVCNN2's Conv3d);
- two runs of three steps of the tiny DDPM, x8 refine and denoise steps
  (fused routes on), bit-equal.

Tolerances: a gather is exact; a gradient is a float32 sum of a few
slots' cotangents taken in another order than JAX's scatter or einsum,
held to GRAD_TOL of the largest entry (or, for the einsum, to
SCATTER_TOL of each element's own sum of magnitudes, the scale of a
reordered float32 sum's rounding error).
"""

import numpy as np
import pytest
import torch

from point_diffusion_refinement_tpu_torch import train as ptrain
from point_diffusion_refinement_tpu_torch.config import tiny_pointnet_config
from point_diffusion_refinement_tpu_torch.diffusion import calc_diffusion_hyperparams
from point_diffusion_refinement_tpu_torch.models import PointNet2CloudCondition
from point_diffusion_refinement_tpu_torch.ops import sampling, scatter, voxelize
from torch_threads import one_torch_thread  # noqa: F401

GRAD_TOL = 1e-6
SCATTER_TOL = 1e-5
STEPS = 3


def _rng(seed):
    return np.random.default_rng(seed)


def _indexed_load(points, idx):
    bi = torch.arange(points.shape[0])[(slice(None),) + (None,) * (idx.dim() - 1)]
    return points[bi, idx.long()]


@pytest.mark.parametrize("kind", ["gather", "group"])
def test_ordered_gather_against_jax_and_the_indexed_load(kind):
    import jax
    import jax.numpy as jnp

    from point_diffusion_refinement_tpu.ops import sampling as jsampling

    rng = _rng(1)
    B, N, C = 2, 40, 5
    shape = (B, 70) if kind == "gather" else (B, 30, 6)
    pts = rng.standard_normal((B, N, C)).astype(np.float32)
    idx = rng.integers(0, N, shape).astype(np.int32)
    idx[:, :10] = 3  # one row taken many times
    w = rng.standard_normal(shape + (C,)).astype(np.float32)

    jfn = jsampling.gather_points if kind == "gather" else jsampling.group_points
    j_out = np.array(jfn(jnp.asarray(pts), jnp.asarray(idx)))
    j_grad = np.array(jax.grad(
        lambda p: jnp.sum(jfn(p, jnp.asarray(idx)) * jnp.asarray(w)))(jnp.asarray(pts)))

    p = torch.from_numpy(pts).requires_grad_()
    i = torch.from_numpy(idx)
    out = (sampling._OrderedGather.apply(p, i[:, :, None])[:, :, 0] if kind == "gather"
           else sampling._OrderedGather.apply(p, i))
    (grad,) = torch.autograd.grad((out * torch.from_numpy(w)).sum(), p)
    assert torch.equal(out.detach(), torch.from_numpy(j_out))
    assert float((grad - torch.from_numpy(j_grad)).abs().max()) <= GRAD_TOL * np.abs(j_grad).max()

    q = torch.from_numpy(pts).requires_grad_()
    (ref,) = torch.autograd.grad((_indexed_load(q, i) * torch.from_numpy(w)).sum(), q)
    assert float((grad - ref).abs().max()) <= GRAD_TOL * float(ref.abs().max())

    # on the CPU the public gathers stay the indexed load
    fn = sampling.gather_points if kind == "gather" else sampling.group_points
    assert "Index" in type(fn(q, i).grad_fn).__name__


def _ball_slots(rng, B, N, M, K, empty_every):
    """Ball-query-like slots: a ball's count of neighbours, then repeats of
    its first one (row 0 for an empty ball)."""
    counts = rng.integers(0, K + 1, (B, M)).astype(np.int32)
    counts[:, ::empty_every] = 0
    idx = np.zeros((B, M, K), np.int32)
    for b in range(B):
        for m in range(M):
            n = counts[b, m]
            if n:
                picks = np.sort(rng.choice(N, n, replace=False))
                idx[b, m, :n] = picks
                idx[b, m, n:] = picks[0]
    return idx, counts


def _bf16_values(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("case", ["balls", "every_slot_one_row", "empty_balls_counts",
                                  "bf16_slice"])
def test_scatter_plain_against_jax_einsum(case):
    import jax.numpy as jnp

    from point_diffusion_refinement_tpu.models.grouping import _fused_ball_gather_bwd

    rng = _rng(2)
    B, N, M, K, C = 2, 60, 48, 8, 7
    idx, counts = _ball_slots(rng, B, N, M, K, empty_every=5)
    if case == "every_slot_one_row":
        idx[:] = 11
    dg = _bf16_values(rng.standard_normal((B, M, K, C)).astype(np.float32))
    use_counts = case == "empty_balls_counts"
    jax_dg = dg * (counts > 0)[..., None, None] if use_counts else dg
    (_, _, j_out) = _fused_ball_gather_bwd(0.1, K, (jnp.asarray(idx), (B, N, C)),
                                           (jnp.asarray(jax_dg), None, None))
    j_out = torch.from_numpy(np.array(j_out))

    if case == "bf16_slice":
        wide = torch.zeros(B, M, K, C + 5, dtype=torch.bfloat16)
        wide[..., 2:2 + C] = torch.from_numpy(dg).to(torch.bfloat16)
        t_dg = wide[..., 2:2 + C]
        assert t_dg.stride(2) == C + 5
    else:
        t_dg = torch.from_numpy(dg)
    t_idx = torch.from_numpy(idx)
    t_counts = torch.from_numpy(counts) if use_counts else None
    out = scatter.group_scatter_add_plain(t_dg, t_idx, N, t_counts)
    scale = scatter.group_scatter_add_plain(t_dg.float().abs(), t_idx, N, t_counts)
    assert out.dtype == torch.float32 and out.shape == (B, N, C)
    assert bool(((out - j_out).abs() <= SCATTER_TOL * scale + 1e-12).all())
    # the wrapper takes the plain version for CPU tensors, either kernel asked
    for det in (True, False):
        assert torch.equal(scatter.group_scatter_add(t_dg, t_idx, N, t_counts,
                                                     deterministic=det), out)
    if case == "every_slot_one_row":
        assert not out[:, :11].any() and not out[:, 12:].any()
    if use_counts:
        # a skipped ball adds nothing: the same as zeroing its slots
        assert torch.equal(out, scatter.group_scatter_add_plain(
            torch.from_numpy(jax_dg), t_idx, N))


def _run_order_loop(dg, idx, n_rows, counts=None):
    """The scatter-add written out in runs: each run's terms summed in slot
    order from 0.0, its partial added to the row as the runs come (so in
    ascending order of their first slot), all in float32."""
    B, M, K, C = dg.shape
    out = np.zeros((B, n_rows, C), np.float32)
    for b in range(B):
        for m in range(M):
            if counts is not None and counts[b, m] == 0:
                continue
            k = 0
            while k < K:
                row = idx[b, m, k]
                part = np.zeros(C, np.float32)
                while k < K and idx[b, m, k] == row:
                    part = part + dg[b, m, k]
                    k += 1
                out[b, row] = out[b, row] + part
    return out


def _slot_order(dg, idx, n_rows, counts=None):
    """One ``index_add_`` of every slot in slot order: the plain version
    before runs (a skipped ball's slots zeroed)."""
    B, M, K, C = dg.shape
    vals = dg.to(torch.float32)
    if counts is not None:
        vals = vals * (counts > 0).to(torch.float32)[..., None, None]
    flat = idx.long() + torch.arange(B)[:, None, None] * n_rows
    out = torch.zeros((B * n_rows, C), dtype=torch.float32)
    out.index_add_(0, flat.reshape(-1), vals.reshape(-1, C))
    return out.reshape(B, n_rows, C)


def _spread(rng, shape):
    """float32 values over six decades, so that another order of the sums
    rounds differently."""
    return (rng.standard_normal(shape) * 10.0 ** rng.uniform(-3, 3, shape)).astype(np.float32)


@pytest.mark.parametrize("case", ["empty_balls", "padded_balls", "repeats", "counts",
                                  "bf16_slice", "every_slot_one_row"])
def test_scatter_plain_in_run_order(case):
    rng = _rng(4)
    B, N, M, K, C = 2, 30, 40, 6, 5
    idx, counts = _ball_slots(rng, B, N, M, K, empty_every=3)
    if case == "padded_balls":
        idx, counts = _ball_slots(rng, B, N, M, K, empty_every=M + 1)
    elif case == "repeats":  # runs inside a ball, and one row in runs apart
        idx = rng.integers(0, 4, (B, M, K)).astype(np.int32)
    elif case == "every_slot_one_row":
        idx[:] = 7
    dg = _spread(rng, (B, M, K, C))
    use_counts = case == "counts"
    if case == "bf16_slice":
        dg = _bf16_values(dg)
        wide = torch.zeros(B, M, K, C + 3, dtype=torch.bfloat16)
        wide[..., 1:1 + C] = torch.from_numpy(dg).to(torch.bfloat16)
        t_dg = wide[..., 1:1 + C]
        assert t_dg.stride(2) == C + 3
    else:
        t_dg = torch.from_numpy(dg)
    t_idx, t_counts = torch.from_numpy(idx), torch.from_numpy(counts) if use_counts else None
    out = scatter.group_scatter_add_plain(t_dg, t_idx, N, t_counts)
    want = _run_order_loop(dg, idx, N, counts if use_counts else None)
    assert out.dtype == torch.float32 and out.shape == (B, N, C)
    assert torch.equal(out, torch.from_numpy(want))
    assert torch.equal(scatter.group_scatter_add(t_dg, t_idx, N, t_counts), out)
    if case in ("empty_balls", "every_slot_one_row"):
        # the order is the runs', not the slots': the sums round otherwise
        assert not torch.equal(out, _slot_order(t_dg, t_idx, N, t_counts))


@pytest.mark.parametrize("case", ["random", "hot_spot", "signed_zeros", "counts"])
def test_scatter_plain_k1_equals_slot_order(case):
    """At K = 1 (the voxel sums, the devoxelize and chamfer gathers, the
    class embedding) every run is one slot: bit-equal to one ``index_add_``
    in slot order."""
    rng = _rng(5)
    B, N, M, C = 3, 50, 400, 4
    idx = rng.integers(0, N, (B, M, 1)).astype(np.int32)
    if case == "hot_spot":
        idx[:, ::2] = 9
    dg = _spread(rng, (B, M, 1, C))
    if case == "signed_zeros":
        dg[:, ::3] = -0.0
        dg[:, 1::5] = 0.0
    counts = rng.integers(0, 2, (B, M)).astype(np.int32) if case == "counts" else None
    t_dg, t_idx = torch.from_numpy(dg), torch.from_numpy(idx)
    t_counts = torch.from_numpy(counts) if counts is not None else None
    out = scatter.group_scatter_add_plain(t_dg, t_idx, N, t_counts)
    assert torch.equal(out, _slot_order(t_dg, t_idx, N, t_counts))
    assert torch.equal(out, torch.from_numpy(_run_order_loop(dg, idx, N, counts)))


@pytest.mark.parametrize("use_counts", [False, True])
def test_scatter_pair_equals_single_calls(use_counts):
    rng = _rng(6)
    B, N, M, K, C = 2, 40, 30, 8, 6
    idx, counts = _ball_slots(rng, B, N, M, K, empty_every=4)
    wide = torch.from_numpy(_spread(rng, (B, M, K, C + 9))).to(torch.bfloat16)
    d_feat = wide[..., :C]
    d_pos = torch.from_numpy(_spread(rng, (B, M, K, 3)))
    t_idx, t_counts = torch.from_numpy(idx), torch.from_numpy(counts) if use_counts else None
    a, b = scatter.group_scatter_add_pair(d_feat, d_pos, t_idx, N, t_counts)
    assert torch.equal(a, scatter.group_scatter_add(d_feat, t_idx, N, t_counts))
    assert torch.equal(b, scatter.group_scatter_add(d_pos, t_idx, N, t_counts))


@pytest.mark.parametrize("mode", ["center_zero", "row0"])
def test_ball_group_train_backward_pair_equals_single(mode):
    """``ball_group_train``'s backward takes the two-table form where both
    the features and the support need a gradient: each equals what it gets
    alone."""
    from point_diffusion_refinement_tpu_torch import ops

    rng = _rng(7)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 120, 3)).astype(np.float32))
    q = torch.from_numpy(rng.uniform(-1, 1, (2, 40, 3)).astype(np.float32))
    q[:, ::4] += 5.0  # empty balls
    f = torch.from_numpy(rng.standard_normal((2, 120, 7)).astype(np.float32))

    def grads(need):
        leaves = [t.clone().requires_grad_(n) for t, n in zip((x, f, q), need)]
        g, _, _ = ops.ball_group_train(*leaves, 0.4, 8, True, mode)
        w = torch.from_numpy(_rng(8).standard_normal(g.shape).astype(np.float32))
        out = torch.autograd.grad((g.float() * w).sum(), [t for t in leaves if t.requires_grad])
        return dict(zip([i for i, n in enumerate(need) if n], out))

    both = grads((True, True, True))
    assert torch.equal(both[0], grads((True, False, False))[0])
    assert torch.equal(both[1], grads((False, True, False))[1])
    assert torch.equal(both[2], grads((False, False, True))[2])


def _avg_voxelize_before(features, vox_coords, r):
    """``avg_voxelize`` as it was: two ``index_add_``."""
    B, N, C = features.shape
    flat = (voxelize._flat(vox_coords.to(torch.int64), r)
            + torch.arange(B)[:, None] * (r ** 3)).reshape(-1)
    sums = features.new_zeros(B * r ** 3, C).index_add_(0, flat, features.reshape(B * N, C))
    cnt = features.new_zeros(B * r ** 3).index_add_(0, flat, features.new_ones(B * N))
    return (sums / torch.clamp(cnt, min=1.0)[:, None]).reshape(B, r, r, r, C)


def _trilinear_before(voxels, norm_coords, r):
    """``trilinear_devoxelize`` as it was: eight ``torch.gather`` corners."""
    B, C = voxels.shape[0], voxels.shape[-1]
    v = voxels.reshape(B, r ** 3, C)
    c0f = torch.floor(norm_coords)
    c0 = c0f.to(torch.int64)
    c1 = torch.clamp(c0 + 1, max=r - 1)
    frac = norm_coords - c0f
    out = 0.0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                ix = c1[..., 0] if dx else c0[..., 0]
                iy = c1[..., 1] if dy else c0[..., 1]
                iz = c1[..., 2] if dz else c0[..., 2]
                w = ((frac[..., 0] if dx else 1 - frac[..., 0])
                     * (frac[..., 1] if dy else 1 - frac[..., 1])
                     * (frac[..., 2] if dz else 1 - frac[..., 2]))
                flat = ix * (r * r) + iy * r + iz
                g = torch.gather(v, 1, flat[..., None].expand(B, flat.shape[1], C))
                out = out + g * w[..., None]
    return out


def test_voxel_transfers_against_their_previous_results():
    rng = _rng(3)
    B, N, C, r = 2, 300, 6, 5
    coords = torch.from_numpy(rng.uniform(-1, 1, (B, N, 3)).astype(np.float32))
    coords[:, :40] = coords[:, :1]  # a full voxel
    feats = torch.from_numpy(rng.standard_normal((B, N, C)).astype(np.float32))
    nc = voxelize.normalize_coords(coords, r)
    vox = voxelize.voxel_index(nc)
    w = torch.from_numpy(rng.standard_normal((B, r, r, r, C)).astype(np.float32))

    f1, f2 = feats.clone().requires_grad_(), feats.clone().requires_grad_()
    got, ref = voxelize.avg_voxelize(f1, vox, r), _avg_voxelize_before(f2, vox, r)
    assert torch.equal(got, ref)
    (g1,) = torch.autograd.grad((got * w).sum(), f1)
    (g2,) = torch.autograd.grad((ref * w).sum(), f2)
    assert torch.equal(g1, g2)

    grid = torch.from_numpy(rng.standard_normal((B, r, r, r, C)).astype(np.float32))
    v1, v2 = grid.clone().requires_grad_(), grid.clone().requires_grad_()
    wp = torch.from_numpy(rng.standard_normal((B, N, C)).astype(np.float32))
    got = voxelize.trilinear_devoxelize(v1, nc, r)
    ref = _trilinear_before(v2, nc, r)
    assert torch.equal(got, ref)
    (g1,) = torch.autograd.grad((got * wp).sum(), v1)
    (g2,) = torch.autograd.grad((ref * wp).sum(), v2)
    assert float((g1 - g2).abs().max()) <= GRAD_TOL * float(g2.abs().max())


CASES = {
    "ddpm": dict(task="completion"),
    "refine_x8": dict(task="refine_completion", factor=8, cd="cd_t", inter=1.0),
    "denoise": dict(task="denoise", factor=1, cd="cd_p", inter=0.0),
}


def _run_steps(case: str):
    """STEPS steps of the tiny network's step with the fused routes on, from
    seeded weights and batches: the losses and the parameters after."""
    c = CASES[case]
    cfg = tiny_pointnet_config(include_t=c["task"] == "completion")
    if c["task"] != "completion":
        cfg["point_upsample_factor"] = c["factor"]
        cfg["include_displacement_center_to_final_output"] = False
    model = PointNet2CloudCondition.from_config(cfg, device="cpu", seed=3)
    state = ptrain.create_train_state(model, seed=1)
    routes = dict(fused_gather=True, fused_sa=True)
    if c["task"] == "completion":
        step = ptrain.make_completion_train_step(
            model, calc_diffusion_hyperparams(50, 1e-4, 0.02), **routes)
    else:
        step = ptrain.make_refine_train_step(
            model, scale=1.0, cd_loss_type=c["cd"], point_upsample_factor=c["factor"],
            intermediate_loss_weight=c["inter"], task=c["task"], noise_magnitude=0.02,
            **routes)
    losses = []
    for i in range(STEPS):
        rng = _rng(20 + i)
        x0 = torch.from_numpy(rng.uniform(-0.5, 0.5, (2, 64, 3)).astype(np.float32))
        cond = torch.from_numpy(np.concatenate(
            [rng.uniform(-0.5, 0.5, (2, 96, 3)), rng.integers(0, 2, (2, 96, 1)) * 2.0 - 1.0],
            axis=-1).astype(np.float32))
        label = torch.from_numpy(rng.integers(0, 16, (2,)))
        if c["task"] == "completion":
            out = step(state, x0, cond, label)
        else:
            coarse = x0 + 0.05 * torch.from_numpy(rng.standard_normal((2, 64, 3)).astype(
                np.float32))
            x_gt = x0 if c["factor"] == 1 else x0.repeat(1, c["factor"], 1)
            out = step(state, x_gt, cond, label, coarse, 0.37)
        losses.append(out[1].clone())
    return losses, [p.detach().clone() for p in model.parameters()]


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_runs_of_the_step_are_bit_equal(case):
    (la, pa), (lb, pb) = _run_steps(case), _run_steps(case)
    assert all(torch.isfinite(v) for v in la)
    assert all(torch.equal(a, b) for a, b in zip(la, lb))
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))


def test_update_backward_takes_deterministic_cudnn():
    """The update's ``backward()`` runs with cuDNN's deterministic
    algorithms (``train/step.py::_ordered_backward``: on the card PVCNN2's
    Conv3d weight gradient otherwise sums in an order that changes run to
    run), and the flag is restored after it."""
    from point_diffusion_refinement_tpu_torch.train import step as step_mod

    seen = []

    class Spy(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            seen.append(torch.backends.cudnn.deterministic)
            return g

    model = torch.nn.Linear(3, 2)
    state = ptrain.create_train_state(model, seed=0)
    update = step_mod._make_update(model, lambda x: Spy.apply(model(x)).square().mean(), False)
    before = torch.backends.cudnn.deterministic
    loss = update(state.optimizer, torch.ones(4, 3))
    assert seen == [True]
    assert torch.backends.cudnn.deterministic == before
    assert torch.isfinite(loss)
