"""Neighbour statistics and the network types of ``build_model``, against
the JAX package.

The per-module count histograms a forward records (names and integer
counts equal to the JAX ``neighbor_stats`` collection, through the plain
path and the fused training routes), the accumulator over two steps and its
report, the one-shot ``model_neighbor_stats`` report, ``train()`` with
``record_neighbor_stats``; then ``build_model`` for the three network types,
the refine task through ``train()`` for PVCNN2 and the pointwise network,
and the two ``ValueError``s: a completion eval of a network without
``encode_condition``, and a fused training route asked of a network that
has none.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_diffusion_refinement_tpu.config import tiny_pointnet_config
from point_diffusion_refinement_tpu.models import PointNet2CloudCondition as JaxModel
from point_diffusion_refinement_tpu.utils import neighbor_stats as jstats
from point_diffusion_refinement_tpu_torch import train as ptrain
from point_diffusion_refinement_tpu_torch.diffusion import calc_diffusion_hyperparams
from point_diffusion_refinement_tpu_torch.models import (
    PointNet2CloudCondition,
    PointwiseNet,
    PVCNN2Completion,
    collect_neighbor_stats,
)
from point_diffusion_refinement_tpu_torch.sample import pipeline as ppipe
from point_diffusion_refinement_tpu_torch.train.loop import build_model, train
from point_diffusion_refinement_tpu_torch.utils import neighbor_stats as pstats
from point_diffusion_refinement_tpu_torch.utils.weights import state_dict_to_flax
from torch_threads import one_torch_thread  # noqa: F401

PVD_MINI = dict(
    num_classes=3, sv_points=32, embed_dim=16, use_att=True, dropout=0.1,
    extra_feature_channels=0,
    sa_blocks=[[[8, 1, 4], [16, 0.2, 8, [8, 16]]], [None, [8, 0.4, 8, [16, 16]]]],
    fp_blocks=[[[16, 16], [8, 1, 4]], [[16, 8], [8, 1, 4]]],
)
POINTWISE_SMALL = dict(pnet_global_feature_architecture=[[4, 8, 16], [16, 32]])


def _stats_config(include_t=True):
    """The tiny network with every grouping module recording: the SA and FT
    ladders, and kNN feature propagations with the grouper."""
    cfg = tiny_pointnet_config(include_t=include_t)
    cfg["record_neighbor_stats"] = True
    for arch in ("architecture", "condition_net_architecture"):
        cfg[arch]["include_grouper"] = True
    return cfg


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 64, 3)).astype(np.float32)
    cond = np.concatenate([rng.uniform(-0.5, 0.5, (2, 96, 3)),
                           rng.integers(0, 2, (2, 96, 1)) * 2.0 - 1.0], -1).astype(np.float32)
    return x, cond, np.array([3.0, 20.0], np.float32), np.array([1, 2], np.int32)


def _args(data):
    x, cond, ts, label = map(torch.from_numpy, data)
    return x, cond, ts, label.long()


@pytest.fixture(scope="module")
def recorded():
    """The port model and, for two batches, the JAX collection and the
    port's recorded histograms (one jitted JAX program)."""
    cfg = _stats_config()
    port = PointNet2CloudCondition.from_config(cfg, device="cpu", seed=0)
    jm = JaxModel.from_config(cfg)
    params = jax.tree_util.tree_map(jnp.asarray, state_dict_to_flax(port.state_dict()))
    apply = jax.jit(lambda p, *a: jm.apply(p, *a, mutable=["neighbor_stats"])[1])
    runs = []
    for seed in (1, 2):
        data = _inputs(seed)
        coll = apply(params, *map(jnp.asarray, data))["neighbor_stats"]
        with torch.no_grad(), collect_neighbor_stats(port) as stats:
            port(*_args(data))
        runs.append((data, jax.tree_util.tree_map(np.asarray, coll), stats))
    return cfg, port, runs


def _jax_hists(coll):
    acc = jstats.NeighborStatsAccumulator()
    acc.update(coll)
    return acc.hists


def test_histograms_and_names_equal_jax(recorded):
    cfg, port, runs = recorded
    for _, coll, stats in runs:
        want = _jax_hists(coll)
        assert sorted(stats) == sorted(want)
        for name, hist in stats.items():
            np.testing.assert_array_equal(hist.numpy().astype(np.int64),
                                          want[name].astype(np.int64))
    names = sorted(runs[0][2])
    for prefix in ("sa_0", "sa_cond_0", "enc_map_0", "dec_map_0", "fp_0", "fp_cond_0"):
        assert f"{prefix}/count_hist" in names
    # a (nsample + 1,) histogram of every centre of the batch
    assert runs[0][2]["sa_0/count_hist"].shape == (cfg["architecture"]["nsample"][0] + 1,)
    assert float(runs[0][2]["sa_0/count_hist"].sum()) == 2 * cfg["architecture"]["npoint"][0]


def test_fused_routes_record_the_same_histograms(recorded):
    _, port, runs = recorded
    data, _, stats = runs[0]
    with torch.no_grad(), collect_neighbor_stats(port) as fused:
        port(*_args(data), fused_gather=True, fused_sa=True)
    assert sorted(fused) == sorted(stats)
    for name in stats:
        assert torch.equal(fused[name], stats[name]), name


def test_nothing_recorded_outside_the_context(recorded):
    _, port, runs = recorded
    with torch.no_grad():
        port(*_args(runs[0][0]))
    assert all(getattr(m, "_stats_sink", None) is None for m in port.modules())


def test_accumulator_over_two_steps(recorded, capsys):
    _, _, runs = recorded
    jacc, pacc = jstats.NeighborStatsAccumulator(), pstats.NeighborStatsAccumulator()
    for _, coll, stats in runs:
        jacc.update(coll)
        pacc.update(stats)
    assert pacc.forwards == jacc.forwards == 2
    assert sorted(pacc.hists) == sorted(jacc.hists)
    for name in jacc.hists:
        np.testing.assert_array_equal(pacc.hists[name], jacc.hists[name])
    assert pacc.report() == jacc.report()


def test_model_neighbor_stats_report_equals_jax(capsys):
    cfg = tiny_pointnet_config()
    x, cond, _, _ = _inputs(3)
    want = jstats.model_neighbor_stats(cfg, jnp.asarray(x), jnp.asarray(cond))
    assert pstats.model_neighbor_stats(cfg, x, cond) == want
    assert pstats.model_neighbor_stats(cfg, torch.from_numpy(x), torch.from_numpy(cond)) == want
    ladder = jstats.sa_ladder_neighbor_stats(jnp.asarray(x), [32, 16], [0.2, 0.4], [8, 8])
    got = pstats.sa_ladder_neighbor_stats(x, [32, 16], [0.2, 0.4], [8, 8])
    assert pstats.report(got) == jstats.report(ladder)


def test_step_returns_stats():
    """``record_stats``: the step returns (state, loss, stats); the loss
    equals the unrecorded one at the same draws."""
    cfg = _stats_config()
    port = PointNet2CloudCondition.from_config(cfg, device="cpu", seed=0)
    x, cond, _, label = _args(_inputs(4))
    sched = calc_diffusion_hyperparams(8, 1e-4, 0.02)
    t, z = torch.tensor([1, 5]), torch.randn(x.shape, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        loss, stats = ptrain.make_completion_loss(port, sched, record_stats=True)(
            x, cond, label, t, z)
        assert float(loss) == float(
            ptrain.make_completion_loss(port, sched)(x, cond, label, t, z))
    out = ptrain.make_completion_train_step(port, sched, record_stats=True)(
        ptrain.create_train_state(port, seed=0), x, cond, label)
    assert len(out) == 3 and sorted(out[2]) == sorted(stats)
    refine = PointNet2CloudCondition.from_config(_stats_config(False), device="cpu", seed=0)
    out = ptrain.make_refine_train_step(refine, record_stats=True)(
        ptrain.create_train_state(refine, seed=0), x, cond, label, x + 0.01, 0.001)
    assert len(out) == 3 and sorted(out[2]) == sorted(stats)


def _config(pc, root, task="completion", tested=0, epochs=2):
    return {
        "diffusion_config": {"T": 8, "beta_0": 1e-4, "beta_T": 0.02},
        "pointnet_config": {**pc, "model_name": "m"},
        "train_config": {"task": task, "root_directory": str(root), "n_epochs": epochs,
                         "epochs_per_ckpt": 1, "shuffle_seed": 0, "compute_emd": False,
                         "eval_sampling_steps": 2},
        "mvp_dataset_config": {
            "batch_size": 4, "npoints": 48, "num_samples_tested": tested,
            "eval_batch_size": 4, "scale": 1,
            "synthetic": dict(num_samples=8, npoints=48,
                              partial_points=32, mirror_to=48)},
        "refine_config": {"exp_name": "r", "output_scale_factor": 0.001},
    }


def test_train_records_neighbor_stats(tmp_path, capsys):
    cfg = _config(_stats_config(), tmp_path)
    result = train(cfg, device="cpu", fused_gather=True, fused_sa=True)
    acc = result["neighbor_stats"]
    assert isinstance(acc, pstats.NeighborStatsAccumulator)
    assert acc.forwards == len(result["losses"]) == 4
    npoint = cfg["pointnet_config"]["architecture"]["npoint"][0]
    assert acc.hists["sa_0/count_hist"].sum() == 4 * npoint * 4  # B * M * steps
    out = capsys.readouterr().out
    assert "Input cloud SA_module: neighbor count stats" in out  # the one-shot report
    assert "neighbor count stats over 2 forwards" in out  # the first checkpoint's
    # off: no accumulator, and none for another network type
    assert train(_config(tiny_pointnet_config(), tmp_path / "off"),
                 device="cpu")["neighbor_stats"] is None


def test_build_model_network_types():
    pp = build_model(tiny_pointnet_config(), device="cpu")
    assert isinstance(pp, PointNet2CloudCondition)
    pvd = build_model({"network_type": "pvd", "network_args": PVD_MINI}, device="cpu")
    assert isinstance(pvd, PVCNN2Completion)
    pw = build_model({"network_type": "pointwise_net", "network_args": POINTWISE_SMALL},
                     device="cpu", condition_features=4)
    assert isinstance(pw, PointwiseNet)
    # seeded: two builds are equal
    again = build_model({"network_type": "pvd", "network_args": PVD_MINI}, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(pvd.state_dict().values(),
                                                  again.state_dict().values()))
    with pytest.raises(ValueError):  # the pointwise network needs the width
        build_model({"network_type": "pointwise_net"}, device="cpu")
    with pytest.raises(ValueError):
        build_model({"network_type": "resnet"}, device="cpu")


@pytest.mark.parametrize("network", ["pvd", "pointwise_net"])
def test_other_networks_train_and_refine(network, tmp_path):
    """Completion training without in-loop eval, and the refine task with
    its in-loop eval and generation from its checkpoint: finite losses, every parameter
    moved but those with no gradient at all (a squeeze-excitation of 8
    channels has one hidden ReLU unit, which can be off for every input);
    the pointwise network's width comes from the batch."""
    pc = {"network_type": network,
          "network_args": PVD_MINI if network == "pvd" else POINTWISE_SMALL}
    done = train(_config(pc, tmp_path / "c"), device="cpu")
    assert len(done["losses"]) == 4 and np.isfinite(done["losses"]).all()
    fresh = build_model(pc, device="cpu", condition_features=4)
    start = dict(fresh.named_parameters())
    for name, p in done["model"].named_parameters():
        assert bool(torch.isfinite(p.grad).all()), name
        assert not torch.equal(p, start[name]) or not bool(p.grad.any()), name
    cfg = _config(pc, tmp_path / "r", task="refine_completion", tested=4, epochs=1)
    refine = train(cfg, device="cpu")
    assert refine["eval_records"]["iter"] == [1]
    assert np.isfinite(refine["losses"]).all()
    # generation from the refine checkpoint (the pointwise network's width
    # read back from it)
    res = ppipe.run_generation(cfg, device="cpu", save_generated=False, compute_emd=False,
                               num_samples_tested=4)
    assert len(res) == 1 and np.isfinite(res[0].avg_cd)


def test_value_errors(tmp_path):
    """A completion eval needs encode_condition, which PVCNN2 lacks (as the
    JAX sampler fails there); a fused training route needs a pointnet++
    network."""
    pc = {"network_type": "pvd", "network_args": PVD_MINI}
    with pytest.raises(ValueError, match="encode_condition"):
        train(_config(pc, tmp_path, tested=4, epochs=1), device="cpu")
    model = build_model(pc, device="cpu")
    sched = calc_diffusion_hyperparams(8, 1e-4, 0.02)
    for kw in (dict(fused_gather=True), dict(fused_sa=True)):
        with pytest.raises(ValueError, match="fused training route"):
            ptrain.make_completion_train_step(model, sched, **kw)
        with pytest.raises(ValueError, match="fused training route"):
            ptrain.make_refine_train_step(model, **kw)
    with pytest.raises(ValueError, match="fused training route"):
        train(_config(pc, tmp_path / "f"), device="cpu", fused_gather=True)
