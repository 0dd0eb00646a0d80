"""Mirror preprocessing and the idx-only FPS: the port against the JAX
package on the same numpy inputs.

Indices must be exactly equal (both compute the same separately rounded
float32 distances and break ties to the lowest index), and so must the
mirrored clouds, which are gathers of exact values.  The inputs hold padding
points, exact duplicates (points on z = 0 are their own mirror images) and
an all-padding row.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_diffusion_refinement_tpu.data import mirror as j_mirror
from point_diffusion_refinement_tpu.ops.pallas_fps import furthest_point_sample_pallas
from point_diffusion_refinement_tpu.ops.sampling import furthest_point_sample_xla
from point_diffusion_refinement_tpu_torch import ops
from point_diffusion_refinement_tpu_torch.data import generate_mirrored_partials, mirror_and_concat
from point_diffusion_refinement_tpu_torch.ops import kernels, sampling
from torch_threads import one_torch_thread  # noqa: F401


def _partials(seed, B, n):
    """Partials with some z = 0 points, zero padding and one all-padding
    cloud (the last)."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-0.5, 0.5, (B, n, 3)).astype(np.float32)
    p[:, : n // 8, 2] = 0.0
    p[:, n - n // 16:] = 0.0
    p[-1] = 0.0
    return p


def _mirrored_xyz(p):
    return np.concatenate([p, p * np.float32([1, 1, -1])], axis=1)


class TestFpsIdx:
    @pytest.mark.parametrize("npoint", [24, 96])
    def test_matches_jax_xla(self, npoint):
        x = _mirrored_xyz(_partials(0, 3, 64))
        ref = np.asarray(furthest_point_sample_xla(jnp.asarray(x), npoint))
        out = ops.furthest_point_sample(torch.from_numpy(x), npoint)
        assert out.dtype == torch.int32
        np.testing.assert_array_equal(out.numpy(), ref)
        assert (out[-1] == 0).all()  # all-padding row: index 0 throughout
        np.testing.assert_array_equal(
            ops.furthest_point_sample_plain(torch.from_numpy(x), npoint).numpy(), ref)

    def test_matches_pallas_interpret(self):
        x = _mirrored_xyz(_partials(1, 2, 48))
        ref = np.asarray(furthest_point_sample_pallas(jnp.asarray(x), 32, interpret=True))
        np.testing.assert_array_equal(
            ops.furthest_point_sample(torch.from_numpy(x), 32).numpy(), ref)

    def test_duplicate_ties_and_padding(self):
        # every point appears twice: the lowest index of a tie wins
        base = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0], [0, 0, 0]], np.float32)
        x = np.concatenate([base, base], 0)[None]
        ref = np.asarray(furthest_point_sample_xla(jnp.asarray(x), 8))
        out = ops.furthest_point_sample(torch.from_numpy(x), 8).numpy()
        np.testing.assert_array_equal(out, ref)
        assert 4 not in out[0, 1:] and 9 not in out[0, 1:]  # the padding point

    def test_rows_beyond_shared_memory_are_served(self):
        """N above the kernel's shared-memory row: no refusal (the kernel's
        global-memory path serves up to 2^18 points, as JAX's dispatcher)."""
        n = sampling.FPS_SMEM_MAX_POINTS + 500
        x = np.random.default_rng(2).uniform(-1, 1, (1, n, 3)).astype(np.float32)
        ref = np.asarray(furthest_point_sample_xla(jnp.asarray(x), 6))
        np.testing.assert_array_equal(
            ops.furthest_point_sample(torch.from_numpy(x), 6).numpy(), ref)
        assert sampling.FPS_MAX_POINTS == 2 ** 18

    def test_cpu_tensors_launch_nothing(self):
        before = kernels.launch_counts()
        ops.furthest_point_sample(torch.rand(2, 40, 3), 8)
        assert kernels.launch_counts() == before
        assert "fps_idx" in before and kernels.KERNELS["fps_idx"][0] == "fps.cu"

    def test_other_devices_raise(self):
        x = torch.zeros(1, 4, 3, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            ops.furthest_point_sample(x, 2)


class TestMirror:
    @pytest.mark.parametrize("axis", [2, 0])
    def test_mirror_and_concat_matches_jax(self, axis):
        p = _partials(3, 3, 40)
        ref = np.asarray(j_mirror.mirror_and_concat(jnp.asarray(p), 48, axis))
        out = mirror_and_concat(torch.from_numpy(p), 48, axis)
        assert out.shape == (3, 48, 4) and out.dtype == torch.float32
        np.testing.assert_array_equal(out.numpy(), ref)
        assert set(np.unique(ref[..., 3])) <= {-1.0, 1.0}

    def test_generate_mirrored_partials_matches_jax(self):
        p = _partials(4, 5, 32)
        ref = j_mirror.generate_mirrored_partials(p, 40, batch_size=2)
        out = generate_mirrored_partials(p, 40, batch_size=2, device="cpu")
        assert out.shape == (5, 40, 4) and out.dtype == np.float32
        np.testing.assert_array_equal(out, ref)

    def test_host_driver_needs_cuda_unless_cpu_is_asked(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            generate_mirrored_partials(_partials(5, 2, 8), 8)
