"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a GPU every test skips.  The file imports neither
JAX nor the JAX package, so it runs on a GPU machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Indices, counts, coordinates, kNN distances and grouped bf16 values must
be equal: kernel and plain version compute the same separately rounded
float32 distances and round the same float32 values to bf16.  The
ordered scatter-add (``group_scatter_add``'s default) sums each row in
its fixed order (each run of a ball's consecutive slots on the row in
slot order, then the runs in order of their first slot), as its plain
version does on the CPU: two launches are bit-equal and equal the plain
version on CPU copies, also through the two-table form and in a captured
graph's replay.  The atomic kernel B
(``deterministic=False``) sums float32 with atomics, in an order that
changes from run to run: it is held to SCATTER_TOL of the largest row sum
(the new cases: of each element's own sum of magnitudes).  The attention
sweeps repeat their plain versions' rounding points but add their float32
products in another order: statistics are held to STATS_TOL, the pooled
output to ATTENTION_TOL (a bf16 rounding that flips moves one term by 2^-8).
"""

import numpy as np
import pytest
import torch

from point_diffusion_refinement_tpu_torch import ops
from point_diffusion_refinement_tpu_torch.ops import neighbors, sampling, scatter

pytestmark = pytest.mark.cuda

# float32 sums of up to a few thousand terms in a different order
SCATTER_TOL = 1e-5
# float32 sums of bf16 values, a few of which round the other way
STATS_TOL = 2e-3
ATTENTION_TOL = 2e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    # bf16 products of the plain versions accumulate in float32, as the
    # kernels' do: cuBLAS's reduced-precision reduction of bf16 products
    # flips bf16 roundings of products over a thousand deep
    mm = torch.backends.cuda.matmul
    saved = mm.allow_bf16_reduced_precision_reduction
    mm.allow_bf16_reduced_precision_reduction = False
    yield torch.device("cuda")
    mm.allow_bf16_reduced_precision_reduction = saved


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


@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
@pytest.mark.parametrize("k", [1, 3, 8, 16, 17, 32, 33, 100, "N"])
def test_knn(dev, k, lanes):
    """Every register width of the kernel (k <= 32), the passes beyond it
    (k > 32, up to k = N), every lane count a query."""
    from point_diffusion_refinement_tpu_torch.ops import neighbors

    rng = np.random.default_rng(1)
    x, q = _cloud(rng, 2, 700, 3).to(dev), _cloud(rng, 2, 257, 3).to(dev)
    x[:, 100:110] = x[:, 90:100]  # duplicate points: ties
    k = x.shape[1] if k == "N" else k
    d, i = neighbors._knn_launch(q, x, k, lanes)
    rd, ri = ops.knn_plain(q, x, k)
    assert torch.equal(i, ri) and torch.equal(d, rd)
    if lanes == neighbors.knn_lanes(q.shape[0] * q.shape[1]):
        d2, i2 = ops.knn(q, x, k)
        assert torch.equal(i2, ri) and torch.equal(d2, rd)


@pytest.mark.parametrize("N,M,k", [
    (33, 5, 33),  # k = N, M < one block
    (1, 3, 1),  # one point
    (97, 1, 40),  # N not a multiple of 32, one query
    (5000, 300, 20),  # beyond one staged tile of points
    (2048, 2048, 8),  # the level-0 feature propagation's shape, one cloud
])
def test_knn_shapes(dev, N, M, k):
    from point_diffusion_refinement_tpu_torch.ops import neighbors

    rng = np.random.default_rng(N + M)
    x, q = _cloud(rng, 2, N, 3).to(dev), _cloud(rng, 2, M, 3).to(dev)
    for lanes in (1, 2, 4, 8):
        d, i = neighbors._knn_launch(q, x, k, lanes)
        rd, ri = ops.knn_plain(q, x, k)
        assert torch.equal(i, ri) and torch.equal(d, rd)


@pytest.mark.parametrize("k", [1, 8, 17, 32, 64])
def test_knn_tie_heavy_grid(dev, k):
    """Queries on a regular grid of points: most distances tie, and the
    lowest index must win every tie, across lanes and across passes."""
    from point_diffusion_refinement_tpu_torch.ops import neighbors

    side = 9
    g = torch.stack(torch.meshgrid(*[torch.arange(side, dtype=torch.float32) * 0.25] * 3,
                                   indexing="ij"), -1).reshape(1, -1, 3)
    pts = torch.cat([g, g.flip(1)], 0).to(dev)
    q = torch.cat([pts[:, ::7], pts[:, 3::11][:, : pts[:, ::7].shape[1]] + 0.125], 1)
    q = q.contiguous()
    rd, ri = ops.knn_plain(q, pts, k)
    for lanes in (1, 2, 4, 8):
        d, i = neighbors._knn_launch(q, pts, k, lanes)
        assert torch.equal(i, ri) and torch.equal(d, rd)


def test_knn_refuses_k_beyond_n(dev):
    x = torch.rand(1, 10, 3, device=dev)
    with pytest.raises(ValueError, match="1 <= k <= N"):
        ops.knn(x, x, 11)


def test_query_and_group_nn_32(dev):
    """``neighbor_definition="nn"`` with nsample 32 takes the kNN kernel at
    k = 32 and equals the plain route."""
    from point_diffusion_refinement_tpu_torch.models.grouping import query_and_group

    rng = np.random.default_rng(9)
    xyz, centres = _cloud(rng, 2, 600, 3).to(dev), _cloud(rng, 2, 128, 3).to(dev)
    feats = _cloud(rng, 2, 600, 16).to(dev)
    kw = dict(radius=0.2, nsample=32, neighbor_def="nn", include_abs_coordinate=True)
    ops.reset_launch_counts()
    out = query_and_group(xyz, centres, feats, **kw)
    assert ops.launch_counts()["knn"] == 1
    with ops.plain_ops():
        ref = query_and_group(xyz, centres, feats, **kw)
    assert out.features.shape == (2, 128, 32, 16 + 6) and out.counts == "all"
    assert torch.equal(out.features, ref.features)


@pytest.mark.parametrize("n", [300, 3072])
def test_fps_with_coordinates(dev, n):
    rng = np.random.default_rng(2)
    x = _cloud(rng, 3, n, 3, lo=0.2, hi=1.5).to(dev)
    x[:, n - 40:] = 0.0  # padding points are never picked
    i, co = ops.furthest_point_sample_and_gather(x, 128)
    ri, rco = ops.furthest_point_sample_and_gather_plain(x, 128)
    assert torch.equal(i, ri) and torch.equal(co, rco)
    assert (i[:, 1:] < n - 40).all()


def _hard_rows(rng, n):
    """Four rows of n points: random, half padding, exact duplicates, all
    padding."""
    x = rng.uniform(-1.0, 1.0, (4, n, 3)).astype(np.float32)
    x[1, n // 2:] = 0.0
    x[2, n // 2: n // 2 + n // 4] = x[2, : n // 4]
    x[3] = 0.0
    return torch.from_numpy(x)


def _fps_agrees(x, npoint, config=None):
    ri, rco = ops.furthest_point_sample_and_gather_plain(x, npoint)
    if config is None:
        i, co = ops.furthest_point_sample_and_gather(x, npoint)
        i2 = ops.furthest_point_sample(x, npoint)
    else:
        i, co = sampling._fps_launch(x, npoint, True, config=config)
        i2, _ = sampling._fps_launch(x, npoint, False, config=config)
    return torch.equal(i, ri) and torch.equal(i2, ri) and torch.equal(co, rco)


# N on and around every boundary of the wrapper's (threads, points a thread)
# choice, the last one past shared memory (the workspace path); most are not
# multiples of 32
FPS_BOUNDARY_N = sorted({n for b, _, _ in sampling.FPS_BLOCKS for n in (b - 1, b, b + 1)})


@pytest.mark.parametrize("n", FPS_BOUNDARY_N)
def test_fps_at_block_boundaries(dev, n):
    x = _hard_rows(np.random.default_rng(n), n).to(dev)
    assert _fps_agrees(x, 160)
    i = ops.furthest_point_sample(x, 160)
    assert (i[3] == 0).all()  # all padding: index 0 throughout
    assert (i[1, 1:] < n // 2).all()  # padding is never picked


@pytest.mark.parametrize("config", sampling.FPS_CONFIGS, ids=lambda c: f"{c[0]}x{c[1]}")
def test_fps_every_block_the_kernel_builds(dev, config):
    """Each (threads, points a thread) of the register path, full and with
    a ragged last warp, against the plain version."""
    cap = config[0] * config[1]
    for n in (cap, cap - 37):
        x = _hard_rows(np.random.default_rng(cap), n).to(dev)
        assert _fps_agrees(x, 96, config)


@pytest.mark.parametrize("n", [1, 31, 97, 1000])
def test_fps_npoint_one_and_n(dev, n):
    """npoint = 1 (idx 0 only) and npoint = N (every real point once, then
    repeats of the first real point for padding rows)."""
    x = _hard_rows(np.random.default_rng(5), n).to(dev)
    assert _fps_agrees(x, 1)
    assert _fps_agrees(x, n)
    assert sorted(ops.furthest_point_sample(x, n)[0].tolist()) == list(range(n))


@pytest.mark.parametrize("side", [8, 14, 16])
def test_fps_tie_heavy_grid(dev, side):
    """A regular grid: many points share the running maximum at every pick,
    so the lowest-index rule of the block argmax decides."""
    g = torch.stack(torch.meshgrid(*[torch.arange(side, dtype=torch.float32) * 0.1 + 0.05] * 3,
                                   indexing="ij"), -1).reshape(1, -1, 3)
    x = torch.cat([g, g.flip(1)], 0).to(dev)
    assert _fps_agrees(x, min(side ** 3, 700))


@pytest.mark.parametrize("N,M,K,r", [
    (1000, 301, 1, 0.2),  # N not a multiple of 32, M not a multiple of 8, K = 1
    (77, 13, 100, 0.5),  # K > N
    (16, 2050, 32, 1.6),  # the decoder's 16-point level, K > N
    (300, 50, 8, 1e-4),  # all balls empty
    (300, 50, 8, 9.0),  # the radius covers the whole support
    (3072, 1024, 32, 0.1),  # condition SA level 0
])
def test_ball_query_edge_cases(dev, N, M, K, r):
    rng = np.random.default_rng(N + M)
    x, c = _cloud(rng, 3, N, 3).to(dev), _cloud(rng, 3, M, 3).to(dev)
    i, n = ops.ball_query(x, c, r, K)
    ri, rn = ops.ball_query_plain(x, c, r, K)
    assert torch.equal(i, ri) and torch.equal(n, rn)
    if r < 1e-3:
        assert (n == 0).all() and (i == 0).all()
    if r > 5:
        assert (n == min(N, K)).all()


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


def _ball_group_agrees(x, tabs, q, r, K, center, mode, queries_per_warp=None):
    """Kernel against plain version: grouped values, counts and idx equal."""
    from point_diffusion_refinement_tpu_torch.ops.ball_group import _launch

    if queries_per_warp is None:
        outs, n, i = ops.ball_group(x, tabs, q, r, K, center, mode, return_idx=True)
    else:
        tb = [t.to(torch.bfloat16).contiguous() for t in tabs]
        B, M = q.shape[:2]
        outs = [torch.empty(B, M, K, t.shape[-1] + (9 if center else 6), dtype=torch.bfloat16,
                            device=x.device) for t in tb]
        n = torch.empty(B, M, dtype=torch.int32, device=x.device)
        i = torch.empty(B, M, K, dtype=torch.int32, device=x.device)
        _launch(x, tb, q, r, K, center, mode, outs, n, i, queries_per_warp)
    routs, rn, ri = ops.ball_group_plain(x, tabs, q, r, K, center, mode, return_idx=True)
    assert torch.equal(n, rn) and torch.equal(i, ri)
    assert all(o.dtype == torch.bfloat16 and torch.equal(o, ro) for o, ro in zip(outs, routs))
    return rn


# one or two tables; widths that take 16-, 8-, 4- and 2-byte row vectors and
# the scalar path (C not a multiple of 8, odd C)
BALL_GROUP_TABLES = [(4,), (32,), (4, 32), (33, 2), (13,), (1, 6), (160,)]


@pytest.mark.parametrize("K", [1, 8, 32, 64])
@pytest.mark.parametrize("mode", ["center_zero", "row0"])
def test_ball_group_widths(dev, K, mode):
    rng = np.random.default_rng(K)
    x, q = _cloud(rng, 2, 1100, 3).to(dev), _cloud(rng, 2, 301, 3).to(dev)
    q[:, ::7] += 3.0  # empty balls
    seen_full = False
    for widths in BALL_GROUP_TABLES:
        tabs = [torch.randn(2, 1100, c, device=dev) for c in widths]
        for center in (False, True):
            n = _ball_group_agrees(x, tabs, q, 0.5, K, center, mode)
            seen_full |= bool((n == K).any())
    assert seen_full and bool((n == 0).any())


@pytest.mark.parametrize("K", [96, 160])
@pytest.mark.parametrize("mode", ["center_zero", "row0"])
def test_ball_group_any_nsample(dev, K, mode):
    """nsample past the kernel's 64-slot pass (the scan resumes where the
    last pass stopped): balls of 0 to K points and beyond, two tables and
    one, with and without the centre channels, and a support read from
    global memory."""
    rng = np.random.default_rng(K)
    for N, r in ((1100, 0.8), (9000, 0.4)):
        x, q = _cloud(rng, 2, N, 3).to(dev), _cloud(rng, 2, 301, 3).to(dev)
        q[:, ::7] += 3.0  # empty balls
        tabs = [torch.randn(2, N, 4, device=dev), torch.randn(2, N, 33, device=dev)]
        seen = []
        for t in (tabs, tabs[1:]):
            for center in (False, True):
                seen.append(_ball_group_agrees(x, t, q, r, K, center, mode))
        n = torch.cat(seen)
        assert (n == 0).any() and (n == K).any() and ((n > 64) & (n < K)).any()


def test_ball_group_refuses_a_table_too_wide(dev):
    """What still raises, before launch: a table whose assembly buffers and
    staged support overflow a block's shared memory (not nsample)."""
    x = torch.rand(1, 3072, 3, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        ops.ball_group(x, [torch.rand(1, 3072, 1500, device=dev)], x[:, :64], 0.1, 96)


@pytest.mark.parametrize("r,expect", [(1e-4, "empty"), (9.0, "full")])
@pytest.mark.parametrize("mode", ["center_zero", "row0"])
def test_ball_group_all_empty_and_all_full(dev, r, expect, mode):
    rng = np.random.default_rng(11)
    x, q = _cloud(rng, 2, 700, 3).to(dev), _cloud(rng, 2, 100, 3).to(dev)
    tabs = [torch.randn(2, 700, 5, device=dev), torch.randn(2, 700, 16, device=dev)]
    n = _ball_group_agrees(x, tabs, q, r, 32, True, mode)
    assert (n == (0 if expect == "empty" else 32)).all()


@pytest.mark.parametrize("N,M,qpw", [(9000, 70, None), (16, 2050, None), (300, 17, 1),
                                     (3072, 2048, 4), (1100, 129, 3)])
def test_ball_group_shapes(dev, N, M, qpw):
    """A support beyond shared memory (read from global memory), K > N, a
    few queries a block, and other queries a warp than the wrapper's."""
    rng = np.random.default_rng(N)
    x, q = _cloud(rng, 2, N, 3).to(dev), _cloud(rng, 2, M, 3).to(dev)
    q[:, ::9] += 3.0
    tabs = [torch.randn(2, N, 4, device=dev), torch.randn(2, N, 35, device=dev)]
    r = 1.6 if N <= 16 else 0.15
    _ball_group_agrees(x, tabs, q, r, 32, True, "center_zero", qpw)
    _ball_group_agrees(x, tabs[1:], q, r, 32, False, "row0", qpw)


def test_ball_group_unaligned_table(dev):
    """A bf16 table whose rows start off a 16-byte boundary (a view at an
    odd element offset) takes narrower row vectors."""
    rng = np.random.default_rng(12)
    x, q = _cloud(rng, 2, 500, 3).to(dev), _cloud(rng, 2, 64, 3).to(dev)
    for C in (8, 16):
        flat = torch.randn(2 * 500 * C + 1, device=dev).to(torch.bfloat16)
        tab = flat[1:].view(2, 500, C)
        assert tab.is_contiguous() and tab.data_ptr() % 16 != 0
        _ball_group_agrees(x, [tab], q, 0.3, 32, True, "center_zero")


def test_ball_group_scan_only(dev):
    """The scan without the write (how the scan's share of the time is
    measured) gives the same counts and idx."""
    from point_diffusion_refinement_tpu_torch.ops.ball_group import _launch

    rng = np.random.default_rng(13)
    x, q = _cloud(rng, 2, 3072, 3).to(dev), _cloud(rng, 2, 2048, 3).to(dev)
    tab = torch.randn(2, 3072, 4, device=dev).to(torch.bfloat16)
    n = torch.empty(2, 2048, dtype=torch.int32, device=dev)
    i = torch.empty(2, 2048, 32, dtype=torch.int32, device=dev)
    _launch(x, [tab], q, 0.1, 32, True, "center_zero", None, n, i)
    ri, rn = ops.ball_query_plain(x, q, 0.1, 32)
    assert torch.equal(n, rn) and torch.equal(i, ri)


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


def _gather_agrees(x, c, table, r, K, qpw=None):
    """Kernel #8 against its plain version and the ball-query kernel: idx,
    counts and the gathered rows equal (``qpw``: centres a warp, else the
    wrapper's choice)."""
    if qpw is None:
        g, i, n = ops.ball_query_group(x, c, table, r, K)
    else:
        g = torch.empty(*c.shape[:2], K, table.shape[-1], device=x.device)
        i = torch.empty(*c.shape[:2], K, dtype=torch.int32, device=x.device)
        n = torch.empty(c.shape[:2], dtype=torch.int32, device=x.device)
        neighbors._gather_launch(x, c, table, r, g, i, n, qpw)
    rg, ri, rn = ops.ball_query_group_plain(x, c, table, r, K)
    qi, qn = ops.ball_query(x, c, r, K)
    assert torch.equal(i, ri) and torch.equal(n, rn) and torch.equal(g, rg)
    assert torch.equal(i, qi) and torch.equal(n, qn)
    return n


@pytest.mark.parametrize("C", [1, 3, 35, 36, 259, 1030])
@pytest.mark.parametrize("K", [1, 32, 160])
def test_ball_query_group_widths(dev, C, K):
    """Kernel #8 at table widths assembled in groups with an unaligned head
    and tail (1, 3, 35, 259: 3 slots a group), an aligned one (36), a row
    too wide for the buffer (1030: one float a lane), and at one slot, a
    full pass, and three passes; M is no multiple of a block's centres."""
    rng = np.random.default_rng(C * 1000 + K)
    x, c = _cloud(rng, 2, 1500, 3).to(dev), _cloud(rng, 2, 301, 3).to(dev)
    c[:, ::7] += 5.0  # empty balls
    table = _cloud(rng, 2, 1500, C, lo=-9, hi=9).to(dev)
    n = _gather_agrees(x, c, table, 0.6, K)
    assert (n == 0).any() and (n == K).any()
    if K == 160:
        assert ((n > 64) & (n < K)).any()


@pytest.mark.parametrize("N,M,K,C,B,r", [
    (16, 100, 160, 35, 2, 1.6),  # K > N, three passes
    (40, 33, 64, 7, 2, 9.0),  # every ball full at K > N
    (9000, 70, 32, 35, 2, 0.15),  # a support past the staged limit
    (9000, 70, 160, 36, 2, 0.4),  # ... with several passes
    (3072, 2048, 32, 35, 32, 0.1),  # the level-0 feature transfer at B = 32
])
def test_ball_query_group_shapes(dev, N, M, K, C, B, r):
    rng = np.random.default_rng(N + K)
    x, c = _cloud(rng, B, N, 3).to(dev), _cloud(rng, B, M, 3).to(dev)
    c[:, ::9] += 50.0  # empty balls
    table = _cloud(rng, B, N, C, lo=-9, hi=9).to(dev)
    n = _gather_agrees(x, c, table, r, K)
    assert (n == 0).any()


@pytest.mark.parametrize("qpw", [1, 2, 4, 8])
def test_ball_query_group_queries_per_warp(dev, qpw):
    rng = np.random.default_rng(qpw)
    x, c = _cloud(rng, 4, 3072, 3).to(dev), _cloud(rng, 4, 1000, 3).to(dev)
    table = _cloud(rng, 4, 3072, 35).to(dev)
    _gather_agrees(x, c, table, 0.2, 32, qpw)


def test_ball_query_group_unaligned_table(dev):
    """A table view off a 16-byte boundary."""
    rng = np.random.default_rng(21)
    x, c = _cloud(rng, 2, 500, 3).to(dev), _cloud(rng, 2, 64, 3).to(dev)
    for C, shift in ((36, 1), (36, 2), (8, 3)):
        flat = torch.randn(2 * 500 * C + shift, device=dev)
        table = flat[shift:].view(2, 500, C)
        assert table.is_contiguous() and table.data_ptr() % 16 != 0
        _gather_agrees(x, c, table, 0.3, 32)


def _scatter_agrees(dg, idx, N, counts=None, balls_per_thread=None):
    if balls_per_thread is None:
        out = ops.group_scatter_add(dg, idx, N, counts, deterministic=False)
    else:
        out = scatter._scatter_launch(dg, dg.stride(2), idx, N, counts, balls_per_thread)
    ref = ops.group_scatter_add_plain(dg, idx, N, counts)
    # each element against its own sum of magnitudes, the scale of a
    # reordered float32 sum's rounding error
    scale = ops.group_scatter_add_plain(dg.abs(), idx, N, counts)
    assert out.dtype == torch.float32 and out.shape == (dg.shape[0], N, dg.shape[-1])
    assert bool(((out - ref).abs() <= SCATTER_TOL * scale + 1e-12).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("K", [1, 32, 160])
def test_group_scatter_add_slices(dev, dtype, masked, K):
    """Slices of a wider grouped row at offset 0 and at odd and even channel
    offsets (ld != C), and K = 1, 32 and 160 slots."""
    rng = np.random.default_rng(K)
    B, N, M = 2, 700, 300
    x, c = _cloud(rng, B, N, 3).to(dev), _cloud(rng, B, M, 3).to(dev)
    c[:, ::5] += 5.0  # empty balls: every slot is row 0
    idx, counts = ops.ball_query(x, c, 0.5, K)
    wide = torch.randn(B, M, K, 80, device=dev).to(dtype)
    for lo, C in ((0, 32), (1, 32), (2, 32), (3, 35), (8, 64), (0, 3), (5, 1)):
        _scatter_agrees(wide[..., lo:lo + C], idx, N, counts if masked else None)
    _scatter_agrees(wide[..., :40].contiguous(), idx, N, counts if masked else None)


@pytest.mark.parametrize("bpt", [1, 2, 4, 8])
def test_group_scatter_add_balls_per_thread(dev, bpt):
    """Threads taking 1 to 8 consecutive balls and carrying their runs
    across them: runs of empty balls, threads whose balls cross a batch row
    (M = 257 is no multiple of them), masked and unmasked, rows of 3, 35
    and 36 channels."""
    rng = np.random.default_rng(bpt + 40)
    B, N, M, K = 3, 500, 257, 32
    x, c = _cloud(rng, B, N, 3).to(dev), _cloud(rng, B, M, 3).to(dev)
    c[:, 100:180] += 5.0  # a run of empty balls
    c[:, ::3] += 5.0
    idx, counts = ops.ball_query(x, c, 0.3, K)
    for dtype in (torch.float32, torch.bfloat16):
        for C in (3, 35, 36):
            dg = torch.randn(B, M, K, C, device=dev).to(dtype)
            _scatter_agrees(dg, idx, N, None, bpt)
            _scatter_agrees(dg, idx, N, counts, bpt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_scatter_add_all_empty(dev, dtype):
    """Every ball empty, so every slot of every ball is row 0: the most
    atomics on one row; with counts, nothing is added."""
    B, N, M, K, C = 2, 300, 1024, 32, 35
    idx = torch.zeros(B, M, K, dtype=torch.int32, device=dev)
    counts = torch.zeros(B, M, dtype=torch.int32, device=dev)
    dg = torch.randn(B, M, K, C, device=dev).to(dtype)
    assert not ops.group_scatter_add(dg, idx, N, counts, deterministic=False).any()
    for bpt in (None, 1, 8):
        _scatter_agrees(dg, idx, N, None, bpt)
        if bpt is not None:
            assert not scatter._scatter_launch(dg, C, idx, N, counts, bpt).any()


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
        out = ops.group_scatter_add(dg, idx, N, counts if masked else None,
                                    deterministic=False)
        ref = ops.group_scatter_add_plain(dg, idx, N, counts if masked else None)
        assert out.dtype == torch.float32 and out.shape == (B, N, dg.shape[-1])
        assert float((out - ref).abs().max()) <= SCATTER_TOL * float(ref.abs().max())


def _ordered_agrees(dg, idx, N, counts=None):
    """Two launches of the ordered scatter-add bit-equal, and equal to the
    plain version run on CPU copies."""
    out = ops.group_scatter_add(dg, idx, N, counts)
    again = ops.group_scatter_add(dg, idx, N, counts, deterministic=True)
    ref = ops.group_scatter_add_plain(dg.cpu(), idx.cpu(), N,
                                      None if counts is None else counts.cpu())
    assert out.dtype == torch.float32 and out.shape == (dg.shape[0], N, dg.shape[-1])
    assert torch.equal(out, again)
    assert torch.equal(out.cpu(), ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_group_scatter_ordered_ft0(dev, dtype, masked):
    """The level-0 feature transfer at B = 4 (support 3072, 2048 balls,
    K = 32, 35 channels, most balls empty): a float32 cotangent and a bf16
    slice of a wider row."""
    rng = np.random.default_rng(60)
    B, N, M, K, C = 4, 3072, 2048, 32, 35
    sup = _cloud(rng, B, N, 3, lo=-0.5, hi=0.5).to(dev)
    q = torch.from_numpy(rng.standard_normal((B, M, 3)).astype(np.float32)).to(dev)
    idx, counts = ops.ball_query(sup, q, 0.1, K)
    dg = torch.randn(B, M, K, C, device=dev).to(dtype)
    wide = torch.randn(B, M, K, C + 9, device=dev).to(dtype)
    for d in (dg, wide[..., :C], wide[..., 4:4 + C]):
        _ordered_agrees(d, idx, N, counts if masked else None)


@pytest.mark.parametrize("case", ["every_slot_one_row", "every_slot_one_row_k1", "few_rows",
                                  "hot_spots", "wide", "runs_in_balls", "knn_k8"])
def test_group_scatter_ordered_lists(dev, case):
    """Lists of every length: one row taking every slot of its batch row at
    K = 32 (1024 runs of 32 slots: a long list) and at K = 1 (81920 runs
    of one slot: two bitmap windows, ordered 2048 at a time), lists of a
    few hundred runs, chamfer's K = 1 re-gather with hot spots, 300
    channels (five channel passes of a long list), runs inside balls and
    runs past a warp (K = 80), a kNN gather's backward (K = 8 distinct
    neighbours, ~32 one-slot runs a row, 320 channels: lists sorted by a
    warp), with and without empty balls skipped."""
    rng = np.random.default_rng(61)
    B, M, K = 2, 1024, 32
    if case == "every_slot_one_row":
        N, C = 300, 35
        idx = torch.zeros(B, M, K, dtype=torch.int32)
    elif case == "every_slot_one_row_k1":
        B, M, K, N, C = 2, 81920, 1, 500, 3
        idx = torch.full((B, M, K), 17, dtype=torch.int32)
    elif case == "knn_k8":
        M, K, N, C = 1024, 8, 256, 320
        idx = torch.from_numpy(np.stack([np.stack([rng.choice(N, K, replace=False)
                                                   for _ in range(M)]) for _ in range(B)])
                               .astype(np.int32))
    elif case == "runs_in_balls":
        M, K, N, C = 300, 80, 50, 19
        idx = torch.from_numpy(np.repeat(rng.integers(0, N, (B, M, K // 8)), 8, axis=2)
                               .astype(np.int32))
        idx[:, ::3, 5:] = idx[:, ::3, :1]  # a whole ball one run, across warps
    elif case == "few_rows":
        N, C = 8, 3
        idx = torch.from_numpy(rng.integers(0, N, (B, M, K)).astype(np.int32))
    elif case == "hot_spots":
        B, M, K, N, C = 4, 16384, 1, 16384, 3
        idx = torch.from_numpy(rng.integers(0, N, (B, M, K)).astype(np.int32))
        idx[:, : M // 2] = torch.from_numpy(rng.integers(0, 40, (B, M // 2, K)).astype(np.int32))
        idx[:, ::3] = 5
    else:
        N, C = 64, 300
        idx = torch.from_numpy(rng.integers(0, N, (B, M, K)).astype(np.int32))
        idx[:, :300] = 1
    counts = torch.from_numpy(rng.integers(0, 3, (B, M)).astype(np.int32))
    idx, counts = idx.to(dev), counts.to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        dg = torch.randn(B, M, K, C, device=dev).to(dtype)
        _ordered_agrees(dg, idx, N)
        _ordered_agrees(dg, idx, N, counts)


@pytest.mark.parametrize("masked", [False, True])
def test_group_scatter_ordered_pair(dev, masked):
    """The two-table form at the level-0 transfer of B = 4 (a bf16 slice of
    35 features, ld 44, and float32 positions, as ``ball_group_train``'s
    backward passes them): one launch, each result bit-equal to its single
    call and to the plain version on CPU copies."""
    rng = np.random.default_rng(63)
    B, N, M, K, C = 4, 3072, 2048, 32, 35
    sup = _cloud(rng, B, N, 3, lo=-0.5, hi=0.5).to(dev)
    q = torch.from_numpy(rng.standard_normal((B, M, 3)).astype(np.float32)).to(dev)
    idx, counts = ops.ball_query(sup, q, 0.1, K)
    counts = counts if masked else None
    wide = torch.randn(B, M, K, C + 9, device=dev).to(torch.bfloat16)
    feat, pos = wide[..., :C], torch.randn(B, M, K, 3, device=dev)
    ops.reset_launch_counts()
    a, b = ops.group_scatter_add_pair(feat, pos, idx, N, counts)
    assert ops.launch_counts()["group_scatter_ordered"] == 1
    for got, d in ((a, feat), (b, pos)):
        assert torch.equal(got, ops.group_scatter_add(d, idx, N, counts))
        ref = ops.group_scatter_add_plain(d.cpu(), idx.cpu(), N,
                                          None if counts is None else counts.cpu())
        assert torch.equal(got.cpu(), ref)


def test_group_scatter_ordered_graph_replay(dev):
    """A captured graph of the two-table form replays on new cotangents and
    a new idx (the same shapes) bit-equal to eager launches."""
    from point_diffusion_refinement_tpu_torch.utils.graphs import CapturedFunction

    rng = np.random.default_rng(64)
    B, N, M, K = 2, 700, 512, 32

    def inputs(seed):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        x = torch.rand(B, N, 3, generator=g, device=dev)
        c = torch.rand(B, M, 3, generator=g, device=dev)
        c[:, ::3] += 5.0
        idx, counts = ops.ball_query(x, c, 0.2, K)
        return (torch.randn(B, M, K, 40, generator=g, device=dev).to(torch.bfloat16)[..., 2:37],
                torch.randn(B, M, K, 3, generator=g, device=dev), idx, counts)

    fn = CapturedFunction(lambda d, p, i, n: ops.group_scatter_add_pair(d, p, i, N, n))
    for seed in (1, 2, 3, 4):  # the warm-up, the capture, two replays
        d, p, i, n = inputs(seed + int(rng.integers(0, 100)))
        got = fn(d, p, i, n)
        want = ops.group_scatter_add_pair(d, p, i, N, n)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert fn.num_graphs == 1
    assert fn.stats()[0]["launches"] == {"group_scatter_ordered": 1}
    fn.release()


@pytest.mark.parametrize("kind", ["gather", "group"])
def test_ordered_gather_backward(dev, kind):
    """``gather_points`` / ``group_points`` on a CUDA tensor that needs a
    gradient: the indexed load forward, the ordered scatter-add backward,
    bit-equal run to run and to the same Function on CPU copies."""
    rng = np.random.default_rng(62)
    pts = torch.from_numpy(rng.standard_normal((3, 500, 33)).astype(np.float32))
    shape = (3, 4000) if kind == "gather" else (3, 700, 16)
    idx = torch.from_numpy(rng.integers(0, 500, shape).astype(np.int32))
    idx[:, :200] = 7
    fn = sampling.gather_points if kind == "gather" else sampling.group_points
    w = torch.randn(shape + (33,))

    def grad(device, fused_fn):
        p = pts.to(device).requires_grad_()
        (g,) = torch.autograd.grad((fused_fn(p, idx.to(device)) * w.to(device)).sum(), p)
        return g

    on_cpu = grad("cpu", lambda p, i: sampling._OrderedGather.apply(
        p, i[:, :, None])[:, :, 0] if kind == "gather" else sampling._OrderedGather.apply(p, i))
    ops.reset_launch_counts()
    a, b = grad(dev, fn), grad(dev, fn)
    assert ops.launch_counts()["group_scatter_ordered"] == 2
    assert torch.equal(a, b) and torch.equal(a.cpu(), on_cpu)


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


@pytest.mark.parametrize("k,N,M,C,B", [
    (8, 1024, 2048, 160, 2), (3, 700, 257, 5, 2), (16, 16, 100, 33, 2), (1, 50, 130, 1, 2),
    (8, 1024, 2048, 160, 4), (1, 64, 300, 3, 32), (17, 300, 257, 6, 4),
    (32, 1024, 512, 160, 32), (33, 200, 100, 2, 4), (40, 40, 100, 7, 4), (40, 40, 64, 7, 32),
    (8, 64, 50, 12, 4), (3, 100, 70, 1030, 2),
])
def test_knn_group(dev, k, N, M, C, B):
    """Fused kNN + gather + packing: every channel equals the plain version's
    (same float32 distances, same ties, each channel rounded to bf16 once),
    at the level-0 shape at B = 2 and 4, at an M that is no multiple of the
    block, at k = 1, 17, 32, 33 (a second selection pass) and N with
    duplicates, with k * (C + 11) no multiple of 8 (a run with an unaligned
    head and tail), at a one-channel table, with rows read 16, 8 or 2 bytes
    at a time, a row too wide for the assembly buffer (C = 1030, by values),
    and at B = 32 (one lane a query)."""
    rng = np.random.default_rng(8)
    x, q = _cloud(rng, B, N, 3).to(dev), _cloud(rng, B, M, 3).to(dev)
    x[:, N // 2: N // 2 + 4] = x[:, :4]  # duplicate points: ties
    table = _cloud(rng, B, N, C, lo=-9, hi=9).to(dev)
    out = ops.knn_group(q, x, table, k)
    ref = ops.knn_group_plain(q, x, table, k)
    assert out.dtype == torch.bfloat16 and out.shape == (B, M, k, C + 11)
    assert torch.equal(out, ref)
    d, i = ops.knn(q, x, k)
    assert torch.equal(out[..., :C], ops.group_points(table.to(torch.bfloat16), i))
    assert torch.equal(out[..., C], d.to(torch.bfloat16))


def _attention_site(dev, seed, B, M, K, Cq, Ck, Cv, c_out, counts):
    from point_diffusion_refinement_tpu_torch.models.attention import AttentionPool

    g = torch.Generator(device="cpu").manual_seed(seed)
    pool = AttentionPool(Cq, Ck, Cv, c_out, dtype=torch.bfloat16)
    with torch.no_grad():
        for name, p in pool.named_parameters():
            noise = torch.randn(p.shape, generator=g)
            if name.endswith("scale"):
                p.copy_(1.0 + 0.2 * noise)
            elif name.endswith("bias"):
                p.copy_(0.1 * noise)
            else:
                p.copy_(noise / p.shape[-1] ** 0.5)
    pool = pool.to(dev).eval()
    feat = torch.randn(B, M, Cq, generator=g).to(dev)
    grouped = torch.randn(B, M, K, Ck, generator=g).to(dev).to(torch.bfloat16)
    gfo = torch.randn(B, M, K, Cv, generator=g).to(dev).to(torch.bfloat16)
    cnt = None
    if counts:
        cnt = torch.randint(0, K + 1, (B, M), generator=g).to(torch.int32)
        cnt[0, :2] = torch.tensor([0, K], dtype=torch.int32)
        cnt = cnt.to(dev)
    return pool, feat, grouped, gfo, cnt


ATTENTION_SITES = [
    # name, B, M, K, Cq, Ck, Cv, c_out, counts
    ("ft0", 2, 256, 32, 3, 41, 32, 32, True),
    ("sa0", 2, 128, 32, 35, 44, 32, 64, True),
    ("knnfp", 2, 256, 8, 128, 171, 128, 128, False),
    ("odd_m_k", 2, 37, 24, 35, 38, 32, 32, True),  # a last tile with one centre
    ("narrow", 1, 16, 4, 8, 12, 20, 20, True),  # GroupNorms of 20 channels
    ("deep", 2, 16, 8, 512, 651, 512, 512, False),  # weights beyond shared memory
    ("enc0", 2, 64, 32, 3, 13, 32, 32, True),  # the narrowest key
    ("k96", 2, 20, 96, 35, 41, 32, 32, True),  # a centre across two row tiles
    ("k96_all", 2, 9, 96, 16, 44, 64, 64, False),
    ("k8_m_odd", 2, 13, 8, 64, 41, 32, 32, True),  # M no multiple of a tile's centres
    ("wide", 2, 8, 8, 16, 1030, 64, 96, True),  # a key above 1000 channels: 32-row tiles
    ("wide_k96", 1, 3, 96, 16, 1030, 96, 64, False),
]


@pytest.mark.parametrize("site", ATTENTION_SITES, ids=[s[0] for s in ATTENTION_SITES])
def test_attention_sweeps(dev, site):
    """The three sweeps against their plain versions on the same inputs, then
    the whole pool against the plain pool and the unfused module."""
    from point_diffusion_refinement_tpu_torch.ops import attention_pool as ap

    _, B, M, K, Cq, Ck, Cv, c_out, counts = site
    pool, feat, grouped, gfo, cnt = _attention_site(dev, 11, B, M, K, Cq, Ck, Cv, c_out, counts)
    p = pool._fused_weights()
    w = pool.widths
    g2 = grouped.reshape(B, M * K, Ck)
    gfo2 = gfo.reshape(B, M * K, Cv)

    def close(a, b, tol):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert float((a - b).abs().max()) <= tol * max(float(b.abs().max()), 1.0)

    kst, vst = ap.attention_stats(g2, gfo2, p.key, p.value, K)
    rkst, rvst = ap.attention_stats_plain(g2, gfo2, p.key, p.value)
    close(kst, rkst, STATS_TOL), close(vst, rvst, STATS_TOL)
    gk = torch.Generator(device="cpu").manual_seed(12)
    mul_k = (1.0 + 0.2 * torch.randn(B, w["c2"], generator=gk)).to(dev)
    add_k = (0.1 * torch.randn(B, w["c2"], generator=gk)).to(dev)
    qp = torch.randn(B, M, w["inter_c"], generator=gk).to(dev).to(torch.bfloat16)
    hst = ap.attention_hstats(g2, qp, p.key, p.hidden, mul_k, add_k, K)
    rhst = ap.attention_hstats_plain(g2, qp, p.key, p.hidden, mul_k, add_k, K)
    close(hst, rhst, STATS_TOL)

    with torch.no_grad():
        out = pool(feat, grouped, gfo, cnt if counts else "all", fused=True)
        with ops.plain_ops():
            ref = pool(feat, grouped, gfo, cnt if counts else "all", fused=True)
        unfused = pool(feat, grouped, gfo, cnt if counts else "all").float()
    assert out.dtype == torch.float32 and out.shape == (B, M, c_out)
    assert bool(torch.isfinite(out).all())
    close(out, ref, ATTENTION_TOL)
    assert float((out - ref).abs().mean()) <= 1e-3 * max(float(ref.abs().mean()), 1e-3) + 1e-4
    close(out, unfused, 4e-2)


def test_attention_finishing_kernels(dev):
    """The two finishing kernels against their plain versions (the JAX
    package's glue) on the partial rows a sweep writes."""
    from point_diffusion_refinement_tpu_torch.ops import attention_pool as ap

    B, M, K = 2, 50, 24
    pool, feat, grouped, gfo, _ = _attention_site(dev, 15, B, M, K, 35, 44, 64, 64, False)
    p, w = pool._fused_weights(), pool.widths
    g2, gfo2 = grouped.reshape(B, M * K, 44), gfo.reshape(B, M * K, 64)
    part1 = ap._stats_launch(g2, gfo2, p.key, p.value, K)
    mm = torch.matmul(feat.to(torch.bfloat16), p.w0)
    got = ap.attention_finish_stats(mm, part1, p, w["c1"], w["c2"], w["c_out"], K)
    ref = ap.attention_finish_stats_plain(mm, part1, p, w["c1"], w["c2"], w["c_out"], K)
    qn, mul_k, add_k, gn2 = got
    for a, b in zip((qn, mul_k, add_k, *gn2), (ref[0], ref[1], ref[2], *ref[3])):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert float((a.float() - b.float()).abs().max()) <= STATS_TOL * max(
            float(b.float().abs().max()), 1.0)
    qp = torch.matmul(qn, p.w2q)
    part2 = ap._hstats_launch(g2, qp, p.key, p.hidden, mul_k, add_k, K)
    for a, b in zip(ap.attention_finish_h(part2, p, w["inter_c"], M, K),
                    ap.attention_finish_h_plain(part2, p, w["inter_c"], M, K)):
        assert a.dtype == torch.bfloat16
        assert float((a.float() - b.float()).abs().max()) <= STATS_TOL * max(
            float(b.float().abs().max()), 1.0)


def test_attention_raises_on_what_it_cannot_take(dev):
    from point_diffusion_refinement_tpu_torch.ops import attention_pool as ap

    # a key so wide that a 16-row tile does not fit a block's shared memory
    pool, feat, grouped, gfo, _ = _attention_site(dev, 13, 1, 2, 8, 8, 8000, 32, 32, False)
    with pytest.raises(ValueError, match="does not fit"):
        pool(feat, grouped, gfo, "all", fused=True)
    _, _, grouped, gfo, _ = _attention_site(dev, 13, 1, 2, 8, 8, 12, 32, 32, False)
    cpu = ap._layer(torch.randn(12, 32), torch.randn(32))
    with pytest.raises(ValueError, match="prepared on the CPU"):
        ap.attention_stats(grouped[:, :, :8].reshape(1, 16, 12).contiguous(),
                           gfo[:, :, :8].reshape(1, 16, 32).contiguous(), cpu, cpu, 8)


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
    ops.group_scatter_add(torch.ones(1, 64, 8, 3, device=dev), i, 64, deterministic=False)
    ops.knn_group(x, x, x, 4)
    pool, feat, grouped, gfo, _ = _attention_site(dev, 14, 1, 16, 8, 8, 12, 32, 32, False)
    with torch.no_grad():
        pool(feat, grouped, gfo, "all", fused=True)
        pool(feat, grouped, gfo, "all")  # the unfused pool launches nothing
    with ops.plain_ops():  # reference runs on the card are not launches
        ops.ball_query(x, x, 0.2, 8)
        ops.furthest_point_sample(x, 8)
        ops.knn_group(x, x, x, 4)
        with torch.no_grad():
            pool(feat, grouped, gfo, "all", fused=True)
    assert ops.launch_counts() == {"fps": 1, "fps_idx": 1, "ball_query": 1, "knn": 1,
                                   "ball_group": 1, "ball_query_group": 1,
                                   "group_scatter_add": 1, "group_scatter_ordered": 1,
                                   "knn_group": 1,
                                   "attention_stats": 1, "attention_hstats": 1,
                                   "attention_out": 1, "attention_finish_stats": 1,
                                   "attention_finish_h": 1}
