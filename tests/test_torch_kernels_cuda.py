"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a GPU every test skips.  The file imports neither
JAX nor the JAX package, so it runs on a GPU machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Indices, counts, coordinates, kNN distances and grouped bf16 values must
be equal: kernel and plain version compute the same separately rounded
float32 distances and round the same float32 values to bf16.  The
scatter-add kernel sums float32 with atomics, in an order that changes from
run to run: it is held to SCATTER_TOL of the largest row sum.
"""

import numpy as np
import pytest
import torch

from point_diffusion_refinement_tpu_torch import ops

pytestmark = pytest.mark.cuda

# float32 sums of up to a few thousand terms in a different order
SCATTER_TOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _cloud(rng, *shape, lo=-1.0, hi=1.0):
    return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32))


def test_ball_query(dev):
    rng = np.random.default_rng(0)
    x, c = _cloud(rng, 2, 1500, 3).to(dev), _cloud(rng, 2, 300, 3).to(dev)
    c[:, :5] += 5.0  # empty balls
    for r, k in ((0.3, 32), (0.1, 8), (3.0, 4)):
        i, n = ops.ball_query(x, c, r, k)
        ri, rn = ops.ball_query_plain(x, c, r, k)
        assert torch.equal(i, ri) and torch.equal(n, rn)
    small = x[:, :16]  # K > N, a strided (non-contiguous) input
    i, n = ops.ball_query(small, c, 1.6, 32)
    ri, rn = ops.ball_query_plain(small, c, 1.6, 32)
    assert torch.equal(i, ri) and torch.equal(n, rn)


@pytest.mark.parametrize("k", [1, 3, 8, 16])
def test_knn(dev, k):
    rng = np.random.default_rng(1)
    x, q = _cloud(rng, 2, 700, 3).to(dev), _cloud(rng, 2, 257, 3).to(dev)
    x[:, 100:110] = x[:, 90:100]  # duplicate points: ties
    d, i = ops.knn(q, x, k)
    rd, ri = ops.knn_plain(q, x, k)
    assert torch.equal(i, ri) and torch.equal(d, rd)


@pytest.mark.parametrize("n", [300, 3072])
def test_fps_with_coordinates(dev, n):
    rng = np.random.default_rng(2)
    x = _cloud(rng, 3, n, 3, lo=0.2, hi=1.5).to(dev)
    x[:, n - 40:] = 0.0  # padding points are never picked
    i, co = ops.furthest_point_sample_and_gather(x, 128)
    ri, rco = ops.furthest_point_sample_and_gather_plain(x, 128)
    assert torch.equal(i, ri) and torch.equal(co, rco)
    assert (i[:, 1:] < n - 40).all()


def _mirrored(rng, B, n):
    """Mirror-preprocessing input: partials with some z = 0 points (their
    mirror images are exact duplicates), zero padding rows, and one
    all-padding cloud."""
    p = rng.uniform(-0.5, 0.5, (B, n, 3)).astype(np.float32)
    p[:, : n // 8, 2] = 0.0
    p[:, n - n // 16:] = 0.0
    p[-1] = 0.0
    return torch.from_numpy(np.concatenate([p, p * np.float32([1, 1, -1])], axis=1))


@pytest.mark.parametrize("B,n,npoint", [(64, 2048, 3072), (64, 2048, 2048), (2, 8192, 2048)])
def test_fps_idx(dev, B, n, npoint):
    """Idx-only FPS at the preprocessing shapes (2n = 4096 points, shared
    memory) and beyond shared memory (2n = 16384, the global-memory path);
    the coordinates entry takes the same path at that N."""
    x = _mirrored(np.random.default_rng(4), B, n).to(dev)
    i = ops.furthest_point_sample(x, npoint)
    ri = ops.furthest_point_sample_plain(x, npoint)
    assert torch.equal(i, ri)
    assert (i[-1] == 0).all()  # all-padding cloud
    if 2 * n > 12288:
        ci, co = ops.furthest_point_sample_and_gather(x, npoint)
        assert torch.equal(ci, ri) and torch.equal(co, ops.gather_points(x, ri))


@pytest.mark.parametrize("mode", ["center_zero", "row0"])
def test_ball_group(dev, mode):
    rng = np.random.default_rng(3)
    x, q = _cloud(rng, 2, 1100, 3).to(dev), _cloud(rng, 2, 384, 3).to(dev)
    q[:, ::7] += 3.0  # empty balls
    tabs = [torch.randn(2, 1100, 4, device=dev), torch.randn(2, 1100, 33, device=dev)]
    for center in (False, True):
        outs, n = ops.ball_group(x, tabs, q, 0.25, 32, center, mode)
        routs, rn = ops.ball_group_plain(x, tabs, q, 0.25, 32, center, mode)
        assert torch.equal(n, rn)
        for o, r in zip(outs, routs):
            assert o.dtype == torch.bfloat16 and torch.equal(o, r)


@pytest.mark.parametrize("N,M,K,C,r", [(3072, 2050, 32, 35, 0.3), (64, 16, 32, 259, 1.3),
                                       (300, 170, 8, 3, 0.3), (16, 100, 32, 7, 1.6)])
def test_ball_query_group(dev, N, M, K, C, r):
    """Kernel #8 at a level-0 shape (M not a multiple of the block), a deep
    level with a wide table, a 3-channel table and K > N: idx and counts
    equal the ball-query kernel's, gathered rows are the exact table rows."""
    rng = np.random.default_rng(5)
    x, c = _cloud(rng, 2, N, 3).to(dev), _cloud(rng, 2, M, 3).to(dev)
    c[:, ::9] += 5.0  # empty balls
    table = _cloud(rng, 2, N, C, lo=-9, hi=9).to(dev)
    g, i, n = ops.ball_query_group(x, c, table, r, K)
    rg, ri, rn = ops.ball_query_group_plain(x, c, table, r, K)
    qi, qn = ops.ball_query(x, c, r, K)
    assert (n == 0).any() and (n == min(K, N)).any()
    assert torch.equal(i, ri) and torch.equal(n, rn) and torch.equal(g, rg)
    assert torch.equal(i, qi) and torch.equal(n, qn)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_group_scatter_add(dev, dtype, masked):
    rng = np.random.default_rng(6)
    B, N, M, K, C = 2, 500, 300, 16, 37
    x, c = _cloud(rng, B, N, 3).to(dev), _cloud(rng, B, M, 3).to(dev)
    c[:, ::5] += 5.0  # empty balls: every slot is row 0
    idx, counts = ops.ball_query(x, c, 0.3, K)
    wide = torch.randn(B, M, K, C + 9, device=dev).to(dtype)
    for dg in (wide[..., :C], wide[..., :C].contiguous(), wide[..., C:C + 3]):
        out = ops.group_scatter_add(dg, idx, N, counts if masked else None)
        ref = ops.group_scatter_add_plain(dg, idx, N, counts if masked else None)
        assert out.dtype == torch.float32 and out.shape == (B, N, dg.shape[-1])
        assert float((out - ref).abs().max()) <= SCATTER_TOL * float(ref.abs().max())


@pytest.mark.parametrize("mode", ["center_zero", "row0"])
def test_ball_group_idx_and_grads(dev, mode):
    """The fused group's idx output equals the ball-query kernel's, and
    ``ball_group_train``'s three gradients equal autograd through the plain
    version (float32 tables, so both sum the cotangent in float32)."""
    rng = np.random.default_rng(7)
    x, q = _cloud(rng, 2, 1100, 3).to(dev), _cloud(rng, 2, 384, 3).to(dev)
    q[:, ::7] += 3.0
    f = torch.randn(2, 1100, 33, device=dev)
    _, n, i = ops.ball_group(x, [f], q, 0.25, 32, True, mode, return_idx=True)
    qi, qn = ops.ball_query(x, q, 0.25, 32)
    assert torch.equal(i, qi) and torch.equal(n, qn)
    leaves = [t.clone().requires_grad_() for t in (x, f, q)]
    g, _, _ = ops.ball_group_train(*leaves, 0.25, 32, True, mode)
    w = torch.randn_like(g, dtype=torch.float32)
    grads = torch.autograd.grad((g.float() * w).sum(), leaves)
    with ops.plain_ops():
        (rg,), _ = ops.ball_group_plain(leaves[0], [leaves[1]], leaves[2], 0.25, 32, True, mode)
        refs = torch.autograd.grad((rg.float() * w).sum(), leaves)
    assert torch.equal(g, rg)
    for a, b in zip(grads, refs):
        assert float((a - b).abs().max()) <= SCATTER_TOL * float(b.abs().max())


def test_launch_counts(dev):
    x = torch.rand(1, 64, 3, device=dev)
    ops.reset_launch_counts()
    ops.ball_query(x, x, 0.2, 8)
    ops.knn(x, x, 4)
    ops.furthest_point_sample_and_gather(x, 8)
    ops.furthest_point_sample(x, 8)
    ops.ball_group(x, [x, x], x, 0.2, 8)
    _, i, _ = ops.ball_query_group(x, x, x, 0.2, 8)
    ops.group_scatter_add(torch.ones(1, 64, 8, 3, device=dev), i, 64)
    with ops.plain_ops():  # reference runs on the card are not launches
        ops.ball_query(x, x, 0.2, 8)
        ops.furthest_point_sample(x, 8)
    assert ops.launch_counts() == {"fps": 1, "fps_idx": 1, "ball_query": 1, "knn": 1,
                                   "ball_group": 1, "ball_query_group": 1,
                                   "group_scatter_add": 1}
