"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a GPU every test skips.  The file imports neither
JAX nor the JAX package, so it runs on a GPU machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Indices, counts, coordinates, kNN distances and grouped bf16 values must
be equal: kernel and plain version compute the same separately rounded
float32 distances and round the same float32 values to bf16.
"""

import numpy as np
import pytest
import torch

from point_diffusion_refinement_tpu_torch import ops

pytestmark = pytest.mark.cuda


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


def test_launch_counts(dev):
    x = torch.rand(1, 64, 3, device=dev)
    ops.reset_launch_counts()
    ops.ball_query(x, x, 0.2, 8)
    ops.knn(x, x, 4)
    ops.furthest_point_sample_and_gather(x, 8)
    ops.furthest_point_sample(x, 8)
    ops.ball_group(x, [x, x], x, 0.2, 8)
    with ops.plain_ops():  # reference runs on the card are not launches
        ops.ball_query(x, x, 0.2, 8)
        ops.furthest_point_sample(x, 8)
    assert ops.launch_counts() == {"fps": 1, "fps_idx": 1, "ball_query": 1, "knn": 1,
                                   "ball_group": 1}
