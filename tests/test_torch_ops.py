"""The port's kernel-bearing ops against the JAX package on the CPU.

Inputs come from seeded numpy and go through the JAX function and its
counterpart in ``point_diffusion_refinement_tpu_torch``.  On the CPU each
port op runs its plain PyTorch version; the JAX side runs its XLA path (the
dispatchers' CPU route) or, for the fused ball group, the Pallas kernel in
interpret mode.  Indices and counts must match exactly.  The CUDA kernels
themselves are held against the plain versions on the card by
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_diffusion_refinement_tpu.ops import interpolate as j_interp
from point_diffusion_refinement_tpu.ops import neighbors as j_nb
from point_diffusion_refinement_tpu.ops import sampling as j_smp
from point_diffusion_refinement_tpu.ops.pallas_window import (
    build_query_ctx,
    build_support_ctx_t,
    unsort_rows,
    windowed_ball_group_t,
)
from point_diffusion_refinement_tpu_torch import ops as t_ops
from point_diffusion_refinement_tpu_torch.ops import kernels
from point_diffusion_refinement_tpu_torch.ops import sampling as t_smp
from torch_threads import one_torch_thread  # noqa: F401

T = torch.from_numpy


def _np(x):
    return np.asarray(x)


@pytest.fixture
def clouds(rng_np):
    x = rng_np.uniform(-1, 1, (2, 300, 3)).astype(np.float32)
    c = rng_np.uniform(-1, 1, (2, 70, 3)).astype(np.float32)
    return x, c


class TestBallQuery:
    @pytest.mark.parametrize("radius,k", [(0.4, 16), (0.2, 4), (1.5, 32)])
    def test_matches_jax(self, clouds, radius, k):
        x, c = clouds
        ji, jn = j_nb.ball_query(jnp.asarray(x), jnp.asarray(c), radius, k)
        ti, tn = t_ops.ball_query(T(x), T(c), radius, k)
        assert ti.dtype == torch.int32 and tn.dtype == torch.int32
        np.testing.assert_array_equal(tn.numpy(), _np(jn))
        np.testing.assert_array_equal(ti.numpy(), _np(ji))

    def test_empty_and_overfull(self, rng_np):
        x = rng_np.uniform(-0.05, 0.05, (1, 64, 3)).astype(np.float32)
        c = np.concatenate([x[:, :4], np.ones((1, 2, 3), np.float32) * 5], axis=1)
        ji, jn = j_nb.ball_query(jnp.asarray(x), jnp.asarray(c), 0.2, 8)
        ti, tn = t_ops.ball_query(T(x), T(c), 0.2, 8)
        np.testing.assert_array_equal(tn.numpy(), _np(jn))
        np.testing.assert_array_equal(ti.numpy(), _np(ji))
        assert tn[0, -1] == 0 and (ti[0, -1] == 0).all()  # far centre: empty ball

    def test_k_exceeds_n(self, rng_np):
        x = rng_np.uniform(-1, 1, (1, 12, 3)).astype(np.float32)
        c = x[:, :3].copy()
        ji, jn = j_nb.ball_query(jnp.asarray(x), jnp.asarray(c), 3.0, 32)
        ti, tn = t_ops.ball_query(T(x), T(c), 3.0, 32)
        np.testing.assert_array_equal(tn.numpy(), _np(jn))
        np.testing.assert_array_equal(ti.numpy(), _np(ji))

    def test_radius_boundary_is_strict(self):
        # a point exactly on the sphere is outside (d^2 < r^2, strict)
        x = np.array([[[0.5, 0.0, 0.0], [0.25, 0.0, 0.0]]], np.float32)
        c = np.zeros((1, 1, 3), np.float32)
        ti, tn = t_ops.ball_query(T(x), T(c), 0.5, 4)
        ji, jn = j_nb.ball_query(jnp.asarray(x), jnp.asarray(c), 0.5, 4)
        assert int(tn[0, 0]) == int(_np(jn)[0, 0]) == 1
        np.testing.assert_array_equal(ti.numpy(), _np(ji))


class TestKnn:
    @pytest.mark.parametrize("k", [1, 3, 8])
    def test_matches_jax(self, clouds, k):
        x, c = clouds
        jd, ji = j_nb.knn(jnp.asarray(c), jnp.asarray(x), k)
        td, ti = t_ops.knn(T(c), T(x), k)
        np.testing.assert_array_equal(ti.numpy(), _np(ji))
        # XLA's CPU backend may contract a multiply-add of the distance into
        # an FMA: the float32 sums may differ in the last bit
        np.testing.assert_allclose(td.numpy(), _np(jd), rtol=2.5e-7, atol=0)

    def test_ties_go_to_lowest_index(self):
        x = np.zeros((1, 6, 3), np.float32)
        x[0, :, 0] = [1.0, -1.0, 1.0, 2.0, -1.0, 0.5]
        q = np.zeros((1, 1, 3), np.float32)
        jd, ji = j_nb.knn(jnp.asarray(q), jnp.asarray(x), 4)
        td, ti = t_ops.knn(T(q), T(x), 4)
        np.testing.assert_array_equal(ti.numpy(), _np(ji))
        assert ti[0, 0].tolist() == [5, 0, 1, 2]

    @pytest.mark.parametrize("k", [32, "N"])
    def test_any_k_matches_jax(self, clouds, k):
        """k beyond the kernel's one-pass register width, up to k = N, with
        duplicate points: indices equal; distances to the last bit of XLA's
        FMA contraction, as above."""
        x, c = clouds
        x = x.copy()
        x[:, 150:160] = x[:, 40:50]  # duplicates: ties
        k = x.shape[1] if k == "N" else k
        jd, ji = j_nb.knn(jnp.asarray(c), jnp.asarray(x), k)
        td, ti = t_ops.knn(T(c), T(x), k)
        assert ti.shape == (2, 70, k)
        np.testing.assert_array_equal(ti.numpy(), _np(ji))
        np.testing.assert_allclose(td.numpy(), _np(jd), rtol=2.5e-7, atol=0)

    def test_kernel_lanes_follow_the_query_count(self):
        """8 lanes a query at a B=4 denoise step's level-0 propagation (8192
        queries), 1 at B=32 (65536), and a power of two between."""
        from point_diffusion_refinement_tpu_torch.ops.neighbors import knn_lanes

        assert [knn_lanes(n) for n in (1, 8192, 16384, 32768, 65536, 10 ** 6)] == \
            [8, 8, 4, 2, 1, 1]

    def test_query_and_group_nn_32(self, clouds, rng_np):
        """``neighbor_definition="nn"`` at nsample 32 (the kNN at k = 32)."""
        from point_diffusion_refinement_tpu.models import grouping as j_grouping
        from point_diffusion_refinement_tpu_torch.models import grouping as t_grouping

        x, c = clouds
        f = rng_np.normal(size=(2, 300, 6)).astype(np.float32)
        kw = dict(radius=0.2, nsample=32, neighbor_def="nn", include_abs_coordinate=True,
                  include_center_coordinate=True)
        jg, jn = j_grouping.query_and_group(jnp.asarray(x), jnp.asarray(c), jnp.asarray(f), **kw)
        tg, tn = t_grouping.query_and_group(T(x), T(c), T(f), **kw)
        assert tn == jn == "all" and tg.shape == (2, 70, 32, 6 + 9)
        np.testing.assert_array_equal(tg.numpy(), _np(jg))


class TestFps:
    def test_matches_jax(self, clouds):
        x, _ = clouds
        jidx = _np(j_smp.furthest_point_sample(jnp.asarray(x), 64))
        tidx, tco = t_ops.furthest_point_sample_and_gather(T(x), 64)
        np.testing.assert_array_equal(tidx.numpy(), jidx)
        # coordinates are the exact float32 positions of the picks
        np.testing.assert_array_equal(tco.numpy(), np.take_along_axis(x, jidx[..., None], 1))
        np.testing.assert_array_equal(
            t_ops.furthest_point_sample(T(x), 64).numpy(), jidx)

    def test_padding_never_picked(self, rng_np):
        x = rng_np.uniform(0.5, 1.5, (2, 40, 3)).astype(np.float32)
        x[:, 30:] = 0.0  # |p|^2 <= 1e-3: padding
        jidx = _np(j_smp.furthest_point_sample(jnp.asarray(x), 16))
        tidx, _ = t_ops.furthest_point_sample_and_gather(T(x), 16)
        np.testing.assert_array_equal(tidx.numpy(), jidx)
        assert (tidx[:, 1:] < 30).all() and (tidx[:, 0] == 0).all()

    def test_duplicate_point_ties(self):
        # duplicated points tie on distance: the lowest index wins
        base = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 1]], np.float32)
        x = np.concatenate([base, base, base], 0)[None]
        jidx = _np(j_smp.furthest_point_sample(jnp.asarray(x), 6))
        tidx, _ = t_ops.furthest_point_sample_and_gather(T(x), 6)
        np.testing.assert_array_equal(tidx.numpy(), jidx)

    def test_grid_ties_to_npoint_n(self):
        # a regular grid: many points share the running maximum at every pick
        g = np.stack(np.meshgrid(*[np.arange(4, dtype=np.float32) * 0.25 + 0.1] * 3,
                                 indexing="ij"), -1).reshape(1, -1, 3)
        jidx = _np(j_smp.furthest_point_sample(jnp.asarray(g), 64))
        tidx, _ = t_ops.furthest_point_sample_and_gather(T(g), 64)
        np.testing.assert_array_equal(tidx.numpy(), jidx)
        assert sorted(tidx[0].tolist()) == list(range(64))

    def test_block_config_for_every_row_in_shared_memory(self):
        # the wrapper's (threads, points a thread) is a pair the kernel
        # source builds (its PDR_FPS_CONFIGS, in order) and holds the row
        src = (kernels.CSRC / "fps.cu").read_text()
        block = src[src.index("#define PDR_FPS_CONFIGS"):src.index("#endif")]
        built = [(int(t), int(p)) for t, p in re.findall(r"X\((\d+), (\d+)\)", block)]
        assert built == list(t_smp.FPS_CONFIGS)
        for n in range(1, t_smp.FPS_SMEM_MAX_POINTS + 1):
            threads, per = t_smp.fps_block_config(n)
            assert (threads, per) in t_smp.FPS_CONFIGS and threads * per >= n
        # 16 bytes of shared memory a point within a block's 227 KB
        assert max(t * p for t, p in t_smp.FPS_CONFIGS) * 16 <= 232448
        with pytest.raises(ValueError, match="workspace"):
            t_smp.fps_block_config(t_smp.FPS_SMEM_MAX_POINTS + 1)


class TestInterpolateAndMasks:
    def test_three_nn_interpolate(self, clouds, rng_np):
        x, c = clouds
        f = rng_np.normal(size=(2, 300, 5)).astype(np.float32)
        jd, ji = j_interp.three_nn(jnp.asarray(c), jnp.asarray(x))
        td, ti = t_ops.three_nn(T(c), T(x))
        np.testing.assert_array_equal(ti.numpy(), _np(ji))
        np.testing.assert_allclose(td.numpy(), _np(jd), rtol=1e-6)
        jw = j_interp.inverse_distance_weights(jd)
        tw = t_ops.inverse_distance_weights(td)
        np.testing.assert_allclose(tw.numpy(), _np(jw), rtol=1e-5)
        jo = j_interp.three_interpolate(jnp.asarray(f), ji, jw)
        to = t_ops.three_interpolate(T(f), ti, tw)
        np.testing.assert_allclose(to.numpy(), _np(jo), rtol=1e-5, atol=1e-6)

    def test_masked_mean_and_sqdist(self, rng_np):
        f = rng_np.normal(size=(2, 5, 8, 3)).astype(np.float32)
        cnt = np.array([[0, 1, 3, 8, 5], [2, 2, 8, 7, 1]], np.int32)
        np.testing.assert_allclose(
            t_ops.masked_mean(T(f), T(cnt)).numpy(),
            _np(j_nb.masked_mean(jnp.asarray(f), jnp.asarray(cnt))), rtol=1e-5, atol=1e-7)
        a = rng_np.normal(size=(2, 7, 3)).astype(np.float32)
        b = rng_np.normal(size=(2, 9, 3)).astype(np.float32)
        # last-bit freedom for an FMA-contracted sum on the XLA side
        np.testing.assert_allclose(
            t_ops.pairwise_sqdist(T(a), T(b)).numpy(),
            _np(j_nb.pairwise_sqdist(jnp.asarray(a), jnp.asarray(b))), rtol=2.5e-7, atol=0)


# -- fused ball group vs the transposed windowed TPU kernel (interpret mode),
#    at the sizes of tests/test_pallas_window_t.py
B, N, M, K = 2, 384, 512, 8
RADIUS = 0.25
# The TPU kernel rebuilds positions from hi/lo bf16 halves (~16 mantissa
# bits) before it computes rel/abs and rounds them to bf16; the port rounds
# the exact float32 values.  Position channels may therefore differ by one
# bf16 ulp (relative 2^-7) plus the hi/lo residual (< 2^-16 * |x| <= 5e-5
# here); feature channels must match exactly.
POS_RTOL, POS_ATOL = 2.0 ** -7, 2.0 ** -14


@pytest.fixture(scope="module")
def wclouds():
    rng = np.random.default_rng(7)
    xyz = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    xyz[0, :, 1] *= 3.0
    xyz[1, :, 0] *= 2.5
    q = rng.uniform(-1, 1, (B, M, 3)).astype(np.float32)
    q[0, :, 1] *= 3.0
    q[1, :, 0] *= 2.5
    fa = rng.normal(size=(B, N, 4)).astype(np.float32)
    fb = rng.normal(size=(B, N, 32)).astype(np.float32)
    return xyz, q, fa, fb


def _jax_grouped(xyz, q, feats, **kw):
    sup = build_support_ctx_t(jnp.asarray(xyz), [jnp.asarray(f) for f in feats])
    qc = build_query_ctx(jnp.asarray(q), sup.axis_onehot)
    wg = windowed_ball_group_t(sup, qc, RADIUS, K, window=256, interpret=True, **kw)
    grouped = [np.asarray(unsort_rows(g, qc), np.float32) for g in wg.grouped]
    counts = np.asarray(unsort_rows(wg.counts[..., None], qc))[..., 0]
    return grouped, counts


def _compare_grouped(port, ref, feat_dim):
    np.testing.assert_array_equal(port[..., :feat_dim], ref[..., :feat_dim])
    np.testing.assert_allclose(port[..., feat_dim:], ref[..., feat_dim:],
                               rtol=POS_RTOL, atol=POS_ATOL)


class TestFusedBallGroup:
    @pytest.mark.parametrize("empty_mode", ["center_zero", "row0"])
    def test_two_tables_and_empty_modes(self, wclouds, empty_mode):
        xyz, q, fa, fb = wclouds
        q = q.copy()
        q[:, ::5] += 2.0  # some balls empty
        ref, rcnt = _jax_grouped(xyz, q, [fa, fb], empty_mode=empty_mode)
        outs, cnt = t_ops.ball_group(T(xyz), [T(fa), T(fb)], T(q), RADIUS, K,
                                     empty_mode=empty_mode)
        np.testing.assert_array_equal(cnt.numpy(), rcnt)
        assert (cnt.numpy() == 0).any() and (cnt.numpy() > 1).any()
        for o, r, f in zip(outs, ref, (fa, fb)):
            assert o.dtype == torch.bfloat16 and o.shape == (B, M, K, f.shape[-1] + 6)
            _compare_grouped(o.float().numpy(), r, f.shape[-1])

    def test_include_center(self, wclouds):
        xyz, q, fa, fb = wclouds
        ref, rcnt = _jax_grouped(xyz, q, [fb], include_center=True)
        outs, cnt = t_ops.ball_group(T(xyz), [T(fb)], T(q), RADIUS, K, include_center=True)
        np.testing.assert_array_equal(cnt.numpy(), rcnt)
        assert outs[0].shape[-1] == fb.shape[-1] + 9
        _compare_grouped(outs[0].float().numpy(), ref[0], fb.shape[-1])

    def test_equals_query_and_group(self, wclouds):
        # the fused group is query_and_group's [feat, rel, abs, center]
        # layout rounded to bf16 (subset=False <-> center_zero)
        from point_diffusion_refinement_tpu.models.grouping import query_and_group

        xyz, q, fa, _ = wclouds
        g, cnt = query_and_group(
            jnp.asarray(xyz), jnp.asarray(q), jnp.asarray(fa), radius=RADIUS, nsample=K,
            use_xyz=True, include_abs_coordinate=True, include_center_coordinate=True,
            subset=False)
        outs, tcnt = t_ops.ball_group(T(xyz), [T(fa)], T(q), RADIUS, K, include_center=True)
        np.testing.assert_array_equal(tcnt.numpy(), _np(cnt))
        ref = _np(jnp.asarray(g).astype(jnp.bfloat16).astype(jnp.float32))
        np.testing.assert_array_equal(outs[0].float().numpy(), ref)


class TestRouting:
    def test_cpu_tensors_take_the_plain_version(self, clouds):
        x, c = clouds
        before = kernels.launch_counts()
        t_ops.ball_query(T(x), T(c), 0.4, 8)
        t_ops.knn(T(c), T(x), 3)
        t_ops.furthest_point_sample_and_gather(T(x), 8)
        t_ops.ball_group(T(x), [T(x)], T(c), 0.4, 8)
        assert kernels.launch_counts() == before

    def test_plain_ops_context(self, clouds):
        x, c = clouds
        torch.backends.cudnn.allow_tf32 = True
        with kernels.plain_ops():
            assert kernels.use_plain(T(x))
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
            i, n = t_ops.ball_query(T(x), T(c), 0.4, 8)
        assert torch.backends.cudnn.allow_tf32  # restored on exit
        ri, rn = t_ops.ball_query_plain(T(x), T(c), 0.4, 8)
        assert torch.equal(i, ri) and torch.equal(n, rn)

    def test_other_devices_raise(self):
        x = torch.zeros(1, 4, 3, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            t_ops.ball_query(x, x, 0.1, 2)
