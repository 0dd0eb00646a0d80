"""The port's generation metrics against the JAX package's
``metrics/generation.py`` on seeded numpy clouds (S = R = 6, N = 64).

Tolerances: CD and EMD are ``tests/test_torch_eval.py``'s (the port's
chamfer and EMD against the JAX package's: float32 summation order, rtol
1e-5 and 1e-4).  MMD is a mean of those minima, so it takes the same
tolerance; coverage and 1-NNA are counts of argmin / argsort picks over
matrices that agree that closely, and the occupancy grids and JSD are the
same numpy on both sides: those must be equal.  The tests of
``tests/test_metrics_eval.py`` and ``tests/test_round3_fixes.py``
(``TestBatchedPairwiseMetrics``) are repeated on the port.
"""

import numpy as np
import pytest
import torch

from point_diffusion_refinement_tpu import metrics as jm
from point_diffusion_refinement_tpu_torch import metrics as pm
from torch_threads import one_torch_thread  # noqa: F401

CD_TOL = dict(rtol=1e-5, atol=1e-8)  # tests/test_torch_eval.py's
EMD_TOL = dict(rtol=1e-4, atol=1e-7)
S, N = 6, 64


def _clouds(seed, n=S, points=N, lo=-0.4, hi=0.4):
    return np.random.default_rng(seed).uniform(lo, hi, (n, points, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def sets():
    """Samples, references, and the JAX package's pairwise matrices."""
    sample, ref = _clouds(0), _clouds(1)
    return sample, ref, jm.pairwise_emd_cd(sample, ref, batch_size=4, sample_batch_size=3)


def test_emd_cd_matches_jax():
    a, b = _clouds(2), _clouds(3)
    got = pm.emd_cd(a, b)
    ref = jm.emd_cd(a, b)
    np.testing.assert_allclose(got["CD"].numpy(), np.asarray(ref["CD"]), **CD_TOL)
    np.testing.assert_allclose(got["EMD"].numpy(), np.asarray(ref["EMD"]), **EMD_TOL)
    np.testing.assert_array_equal(got["fscore"].numpy(), np.asarray(ref["fscore"]))


@pytest.mark.parametrize("tiles", [(4, 3), (16, 16), (1, 6)])
def test_pairwise_matches_jax(sets, tiles):
    sample, ref, (j_cd, j_emd) = sets
    cd, emd = pm.pairwise_emd_cd(sample, ref, batch_size=tiles[0], sample_batch_size=tiles[1])
    assert cd.dtype == np.float32 and cd.shape == (S, S)
    np.testing.assert_allclose(cd, j_cd, **CD_TOL)
    np.testing.assert_allclose(emd, j_emd, **EMD_TOL)


def test_pairwise_takes_tensors(sets):
    sample, ref, (j_cd, _) = sets
    cd, _ = pm.pairwise_emd_cd(torch.from_numpy(sample), torch.from_numpy(ref))
    assert isinstance(cd, np.ndarray)
    np.testing.assert_allclose(cd, j_cd, **CD_TOL)


def test_pairwise_matches_per_pair():
    """tests/test_round3_fixes.py::TestBatchedPairwiseMetrics on the port."""
    rng = np.random.default_rng(0)
    sample = rng.uniform(-1, 1, (5, 32, 3)).astype(np.float32)
    ref = rng.uniform(-1, 1, (7, 32, 3)).astype(np.float32)
    cd, emd = pm.pairwise_emd_cd(sample, ref, batch_size=4, sample_batch_size=3)
    for i in range(5):
        row = pm.emd_cd(np.broadcast_to(sample[i], ref.shape).copy(), ref)
        np.testing.assert_allclose(cd[i], row["CD"].numpy(), rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(emd[i], row["EMD"].numpy(), rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("which", [0, 1])
def test_lgan_mmd_cov_matches_jax(sets, which):
    sample, ref, j_mats = sets
    mat = pm.pairwise_emd_cd(sample, ref, batch_size=4, sample_batch_size=3)[which]
    got, want = pm.lgan_mmd_cov(mat), jm.lgan_mmd_cov(j_mats[which])
    assert sorted(got) == sorted(want)
    tol = CD_TOL if which == 0 else EMD_TOL
    for k in ("lgan_mmd", "lgan_mmd_smp"):
        np.testing.assert_allclose(got[k], want[k], **tol)
    assert got["lgan_cov"] == want["lgan_cov"]
    assert pm.lgan_mmd_cov(j_mats[which]) == want  # the same numpy


def test_one_nn_accuracy_matches_jax(sets):
    sample, ref, _ = sets
    mats = [pm.pairwise_emd_cd(x, y)[0] for x, y in ((sample, sample), (sample, ref),
                                                       (ref, ref))]
    jmats = [jm.pairwise_emd_cd(x, y)[0] for x, y in ((sample, sample), (sample, ref),
                                                        (ref, ref))]
    got, want = pm.one_nn_accuracy(*mats), jm.one_nn_accuracy(*jmats)
    assert got == want
    assert pm.one_nn_accuracy(*jmats) == want


def test_compute_all_metrics_matches_jax(sets):
    sample, ref, _ = sets
    got = pm.compute_all_metrics(sample, ref, batch_size=4)
    want = jm.compute_all_metrics(sample, ref, batch_size=4)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if k.startswith("lgan_mmd"):
            np.testing.assert_allclose(got[k], v, **(CD_TOL if k.endswith("CD") else EMD_TOL),
                                       err_msg=k)
        else:
            assert got[k] == v, k
    assert 0.0 <= got["1-NN-CD-acc"] <= 1.0


@pytest.mark.parametrize("in_sphere", [False, True])
@pytest.mark.parametrize("resolution", [12, 28])
def test_occupancy_grid_matches_jax(in_sphere, resolution):
    pcs = _clouds(4, points=256, lo=-0.6, hi=0.6)  # some points beyond the sphere
    ent, counters = pm.entropy_of_occupancy_grid(pcs, resolution, in_sphere)
    j_ent, j_counters = jm.entropy_of_occupancy_grid(pcs, resolution, in_sphere)
    assert ent == j_ent
    np.testing.assert_array_equal(counters, j_counters)
    t_ent, _ = pm.entropy_of_occupancy_grid(torch.from_numpy(pcs), resolution, in_sphere)
    assert t_ent == ent
    grid, spacing = pm.unit_cube_grid_point_cloud(resolution, in_sphere)
    j_grid, j_spacing = jm.unit_cube_grid_point_cloud(resolution, in_sphere)
    np.testing.assert_array_equal(grid, j_grid)
    assert spacing == j_spacing


def test_jsd_matches_jax(sets):
    sample, ref, _ = sets
    for res in (12, 28):
        assert pm.jsd_between_point_cloud_sets(sample, ref, res) == \
            jm.jsd_between_point_cloud_sets(sample, ref, res)
    P, Q = np.array([1.0, 2, 3, 0]), np.array([0.0, 1, 1, 2])
    assert pm.jensen_shannon_divergence(P, Q) == jm.jensen_shannon_divergence(P, Q)
    with pytest.raises(ValueError):
        pm.jensen_shannon_divergence(-P, Q)
    with pytest.raises(ValueError):
        pm.jensen_shannon_divergence(P, Q[:3])


# tests/test_metrics_eval.py on the port


def test_identical_sets():
    pcs = _clouds(5)
    cd, _ = pm.pairwise_emd_cd(pcs, pcs, batch_size=4)
    assert np.allclose(np.diag(cd), 0, atol=1e-5)
    res = pm.lgan_mmd_cov(cd)
    assert res["lgan_mmd"] < 1e-5 and res["lgan_cov"] == 1.0


def test_one_nn_accuracy_identical_distribution():
    a, b = _clouds(6, n=10, points=32), _clouds(7, n=10, points=32)
    res = pm.one_nn_accuracy(pm.pairwise_emd_cd(a, a, 8)[0], pm.pairwise_emd_cd(a, b, 8)[0],
                             pm.pairwise_emd_cd(b, b, 8)[0], 1)
    assert 0.2 <= res["acc"] <= 0.8


def test_jsd_zero_positive_symmetric():
    pcs = _clouds(8, n=5, points=128, lo=-0.3, hi=0.3)
    assert pm.jsd_between_point_cloud_sets(pcs, pcs, resolution=12) < 1e-9
    a = _clouds(9, n=5, points=128, lo=-0.45, hi=-0.05)
    b = _clouds(10, n=5, points=128, lo=0.05, hi=0.45)
    assert pm.jsd_between_point_cloud_sets(a, b, resolution=12) > 0.5
    P, Q = np.array([1.0, 2, 3, 0]), np.array([0.0, 1, 1, 2])
    j1, j2 = pm.jensen_shannon_divergence(P, Q), pm.jensen_shannon_divergence(Q, P)
    assert j1 == pytest.approx(j2) and 0 <= j1 <= 1.0
