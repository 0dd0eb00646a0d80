"""Evaluation metrics and the evaluation loop: the port against the JAX
package on the same numpy clouds, and the port's copy of the shipped
experiment configurations.

Chamfer: nearest neighbours come from the same exact per-coordinate
distances (ties to the lowest index), so indices are equal and the metrics
differ by float32 summation order only (rtol 1e-5).  EMD: ten rounds of
float32 contractions whose summation order differs between the two
frameworks; the masses feed back from round to round, so the tolerance is
rtol 1e-4.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_diffusion_refinement_tpu.config import exp_configs as j_exp
from point_diffusion_refinement_tpu.ops import chamfer as j_chamfer
from point_diffusion_refinement_tpu.ops import emd as j_emd
from point_diffusion_refinement_tpu.sample import evaluate as j_evaluate  # the function
from point_diffusion_refinement_tpu_torch.config import exp_configs
from point_diffusion_refinement_tpu_torch.ops import chamfer, emd
from point_diffusion_refinement_tpu_torch.sample import evaluate
from torch_threads import one_torch_thread  # noqa: F401

CD_TOL = dict(rtol=1e-5, atol=1e-8)
EMD_TOL = dict(rtol=1e-4, atol=1e-7)


def _t(a):
    return torch.from_numpy(np.array(a))


def _f(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _clouds(seed, B, n, m):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.5, 0.5, (B, n, 3)).astype(np.float32)
    y = rng.uniform(-0.5, 0.5, (B, m, 3)).astype(np.float32)
    y[:, :8] = x[:, :8]  # exact matches: zero distances
    return x, y


class TestChamfer:
    @pytest.mark.parametrize("budget", [None, 2 * 70 * 4])
    def test_nn_sqdist_matches_jax(self, budget, monkeypatch):
        """Untiled, and row-chunked under a small tile budget."""
        if budget:
            monkeypatch.setattr(chamfer, "TILE_BUDGET", budget)
        x, y = _clouds(0, 2, 50, 70)
        jd, ji = j_chamfer.nn_sqdist(jnp.asarray(x), jnp.asarray(y))
        d, i = chamfer.nn_sqdist(_t(x), _t(y))
        assert i.dtype == torch.int32
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_allclose(d.numpy(), _f(jd), **CD_TOL)
        assert (d[:, :8] == 0).all()

    def test_jax_chunked_branch_matches(self):
        """The chunked helper with a small chunk (a ragged last chunk) against
        JAX's."""
        x, y = _clouds(1, 2, 40, 30)
        ji = j_chamfer._argmin_chunked(jnp.asarray(x), jnp.asarray(y), 16)
        np.testing.assert_array_equal(chamfer._argmin_chunked(_t(x), _t(y), 16).numpy(),
                                      np.asarray(ji))

    @pytest.mark.parametrize("budget", [None, 3 * 96 * 4])
    def test_calc_cd_matches_jax(self, budget, monkeypatch):
        """Untiled, and through the row-chunked branch under a small tile
        budget (chunks of min(128, M) rows; the multi-chunk split is held
        by the two tests around this one)."""
        if budget:
            monkeypatch.setattr(chamfer, "TILE_BUDGET", budget)
        out, gt = _clouds(2, 3, 64, 96)
        out = out + 0.004  # some pairs within the F1 threshold, some not
        ref = j_chamfer.calc_cd(jnp.asarray(out), jnp.asarray(gt), True, 1e-4)
        got = chamfer.calc_cd(_t(out), _t(gt), True, 1e-4)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), _f(r), **CD_TOL)
        assert 0.0 < float(got[2].min()) < 1.0

    def test_fscore_nan_maps_to_zero(self):
        far = torch.full((2, 5), 1.0)
        f, p1, p2 = chamfer.fscore(far, far)
        assert torch.equal(f, torch.zeros(2)) and not torch.isnan(f).any()

    def test_budget_picks_the_chunked_path(self, monkeypatch):
        x, y = _clouds(3, 2, 33, 20)
        ref = chamfer.nn_sqdist(_t(x), _t(y))
        monkeypatch.setattr(chamfer, "TILE_BUDGET", 2 * 20 * 4)
        seen = []
        orig = chamfer._argmin_chunked
        monkeypatch.setattr(chamfer, "_argmin_chunked",
                            lambda a, b, c: seen.append(c) or orig(a, b, c))
        d, i = chamfer.nn_sqdist(_t(x), _t(y))
        assert seen == [33]  # chunk = min(max(128, budget // (B*N)), M)
        assert torch.equal(i, ref[1]) and torch.equal(d, ref[0])


class TestEmd:
    @pytest.mark.parametrize("n,m", [(64, 64), (48, 80), (80, 48)])
    def test_matches_jax(self, n, m):
        x, y = _clouds(4, 2, n, m)
        ref = _f(j_emd.earth_mover_distance(jnp.asarray(x), jnp.asarray(y)))
        got = emd.earth_mover_distance(_t(x), _t(y))
        assert got.shape == (2,) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, **EMD_TOL)
        assert (got > 0).all()

    @pytest.mark.parametrize("n,m,nc", [(64, 64, 16), (50, 70, 16)])
    def test_tiled_rounds_match(self, n, m, nc):
        """The row-tiled rounds (a ragged last chunk included) against JAX's
        untiled rounds on the same clouds."""
        x, y = _clouds(5, 2, n, m)
        d = j_emd.pairwise_sqdist(jnp.asarray(x), jnp.asarray(y))
        ref, _, _ = j_emd._auction_rounds(d, n, m)
        got = emd._auction_rounds_tiled(_t(x), _t(y), nc)
        np.testing.assert_allclose(got.numpy(), _f(ref), **EMD_TOL)

    def test_row_chunk_matches_jax(self):
        for shape in ((32, 2048, 2048), (4, 16384, 16384), (2, 64, 64), (1, 9000, 8000)):
            assert emd.emd_row_chunk(*shape) == j_emd._emd_row_chunk(*shape)


class TestEvaluate:
    def _batches(self):
        rng = np.random.default_rng(6)
        out = []
        for _ in range(2):
            gt = rng.uniform(-0.5, 0.5, (4, 64, 3)).astype(np.float32)
            noisy = gt + rng.normal(0.0, 0.01, gt.shape).astype(np.float32)
            out.append({"complete": gt, "generated": noisy, "label": np.arange(4)})
        return out

    def test_per_sample_metrics_match_jax(self, tmp_path):
        batches = self._batches()
        ref = j_evaluate(lambda b: jnp.asarray(b["generated"]), batches,
                         scale=1.2, print_every=100)
        res = evaluate(lambda b: _t(b["generated"]), batches, scale=1.2,
                       save_generated_samples=True, save_dir=str(tmp_path),
                       keep_generated=True, print_every=100)
        for k in ("cd_distance", "cd_p", "f1"):
            np.testing.assert_allclose(res.metrics[k], ref.metrics[k], **CD_TOL, err_msg=k)
        np.testing.assert_allclose(res.metrics["emd_distance"], ref.metrics["emd_distance"],
                                   **EMD_TOL)
        np.testing.assert_allclose(res.avg_cd, ref.avg_cd, **CD_TOL)
        np.testing.assert_array_equal(res.labels, ref.labels)
        assert res.generated.shape == (8, 64, 3) and res.avg_cd > 0
        h5py = pytest.importorskip("h5py")
        with h5py.File(tmp_path / "mvp_generated_data_64pts.h5", "r") as f:
            np.testing.assert_array_equal(f["data"][:], res.generated)

    def test_identity_generator(self):
        """A generator that returns the ground truth: zero CD, F1 = 1 (as
        the JAX package's own test asks)."""
        res = evaluate(lambda b: _t(b["complete"]), self._batches(), print_every=100)
        assert res.avg_cd < 1e-10 and (res.metrics["f1"] > 0.99).all()
        assert res.avg_emd < 1e-3

    def test_unaugment_and_slices_match_jax(self):
        rng = np.random.default_rng(7)
        gt = rng.uniform(-0.5, 0.5, (2, 32, 3)).astype(np.float32)
        M = np.eye(3, dtype=np.float32) * 1.3
        aug = gt @ M.T
        batch = {"complete": aug, "generated": aug + 0.01, "label": np.zeros(2),
                 "M_inv": np.broadcast_to(np.linalg.inv(M.T), (2, 3, 3)).astype(np.float32),
                 "translation": np.full((2, 1, 3), 0.05, np.float32)}
        ref = j_evaluate(
            lambda b: (jnp.asarray(b["generated"]), {5: jnp.asarray(b["complete"])}), [batch],
            unaugment_results=True, compute_emd=False, print_every=100)
        res = evaluate(lambda b: (_t(b["generated"]), {5: _t(b["complete"])}), [batch],
                       unaugment_results=True, compute_emd=False, print_every=100)
        np.testing.assert_allclose(res.metrics["cd_distance"], ref.metrics["cd_distance"],
                                   **CD_TOL)
        assert not res.metrics["emd_distance"].any()
        np.testing.assert_allclose(res.t_slices[5], ref.t_slices[5], rtol=1e-6, atol=1e-7)


class TestExpConfigs:
    def test_experiments_equal_jax(self):
        assert list(exp_configs.EXPERIMENTS) == list(j_exp.EXPERIMENTS)
        for name, make in exp_configs.EXPERIMENTS.items():
            assert json.dumps(make(), sort_keys=True) == json.dumps(
                j_exp.EXPERIMENTS[name](), sort_keys=True), name

    def test_write_all(self, tmp_path):
        paths = exp_configs.write_all(str(tmp_path / "port"))
        j_paths = j_exp.write_all(str(tmp_path / "jax"))
        assert len(paths) == 7
        for p, q in zip(paths, j_paths):
            with open(p) as a, open(q) as b:
                assert json.load(a) == json.load(b)
        pc = exp_configs.EXPERIMENTS["upsample_16384"]()["pointnet_config"]
        assert pc["include_t"] is False and pc["point_upsample_factor"] == 8
