"""The frozen reference against the port at tiny sizes (the only place that
imports both), and the reference's independence from the port."""

import ast
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import ROOT, tiny_config

from pdr_bench import inputs
from pdr_bench.reference import model as ref
from pdr_bench.weights import make_weights, parameter_shapes

FORBIDDEN = ("jax", "jaxlib", "flax", "point_diffusion_refinement_tpu",
             "point_diffusion_refinement_tpu_torch")


def _config(name):
    return tiny_config(json.loads((ROOT / "pdr_bench" / "configs" / f"{name}.json").read_text()))


def _both(cfg, dtype):
    from point_diffusion_refinement_tpu_torch.models import PointNet2CloudCondition

    pc = {**cfg["pointnet_config"], "compute_dtype": dtype}
    port = PointNet2CloudCondition.from_config(pc, device="cpu", seed=None)
    w = make_weights(parameter_shapes(port), 7, "cpu")
    port.load_state_dict(w)
    return port, ref.build(pc, w, dtype, "cpu"), w


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6), ("bfloat16", 2e-2)])
def test_network_matches_the_port(dtype, tol):
    cfg = _config("pdr_cgnet_mvp")
    port, net, _ = _both(cfg, dtype)
    g = inputs.generator("cpu", 3)
    items = inputs.completion_items(g, 2, cfg["npoints"], cfg["number_partial_points"], "cpu")
    ts = torch.tensor([10.0, 900.0])
    with torch.no_grad():
        a = port(items["complete"], items["partial"], ts, items["label"])
        b = net(items["complete"], items["partial"], ts, items["label"])
        cond_p = port.encode_condition(items["partial"])
        cond_r = net.encode_condition(items["partial"])
        c = port.denoise(items["complete"], ts, items["label"], cond_p, fused=True)
        d = net.denoise(items["complete"], ts, items["label"], cond_r, fused=True)
    assert _rel(a, b) <= tol and _rel(c, d) <= tol


def test_fastdpm_matches_the_port():
    from point_diffusion_refinement_tpu_torch.diffusion import (
        calc_diffusion_hyperparams,
        make_fast_sampling_plan,
    )
    from point_diffusion_refinement_tpu_torch.sample import make_coarse_sampler

    cfg = _config("pdr_cgnet_mvp")
    port, net, _ = _both(cfg, "float32")
    dc = cfg["diffusion_config"]
    sched = calc_diffusion_hyperparams(dc["T"], dc["beta_0"], dc["beta_T"])
    plan = make_fast_sampling_plan(sched, dc["T"], dc["beta_0"], dc["beta_T"], length=4,
                                   sampling_method="var", noise_schedule="quadratic", kappa=0.5)
    g = inputs.generator("cpu", 4)
    cond = inputs.conditions(g, 2, cfg["number_partial_points"], "cpu")
    label = inputs.labels(g, 2, "cpu")
    x_T = torch.randn(2, cfg["npoints"], 3, generator=g)
    noise = torch.randn(4, 2, cfg["npoints"], 3, generator=g)
    got = make_coarse_sampler(port, sched, cfg["npoints"], fast_plan=plan, segment_size=4)(
        cond, label, x_T=x_T, noise=noise)
    want = ref.sample(net, ref.fast_plan(dc, 4, "var", "quadratic", 0.5), cond, label, x_T,
                      noise, {})
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("name", ["pdr_cgnet_mvp", "pdr_rfnet_x8_mvp"])
def test_training_loss_and_gradient_match_the_port(name):
    from point_diffusion_refinement_tpu_torch.diffusion import calc_diffusion_hyperparams
    from point_diffusion_refinement_tpu_torch.train.step import (
        make_completion_loss,
        make_refine_loss,
    )

    cfg = _config(name)
    port, net, _ = _both(cfg, "float32")
    up = int(cfg["pointnet_config"].get("point_upsample_factor", 1))
    g = inputs.generator("cpu", 5)
    it = inputs.completion_items(g, 4, cfg["npoints"], cfg["number_partial_points"], "cpu",
                                 coarse_points=cfg["npoints"] // up if up > 1 else 0)
    batch = {"x0": it["complete"], "condition": it["partial"], "label": it["label"],
             "t": torch.tensor([1, 50, 400, 999]), "z": torch.randn(it["complete"].shape,
                                                                  generator=g)}
    if cfg["task"] == "completion":
        dc = cfg["diffusion_config"]
        lp = make_completion_loss(port, calc_diffusion_hyperparams(dc["T"], dc["beta_0"],
                                                                   dc["beta_T"]))(
            batch["x0"], batch["condition"], batch["label"], batch["t"], batch["z"])
        lr_ = ref.completion_loss(net, dc)(batch, slice(0, 4))
    else:
        batch["generated"], batch["output_scale_factor"] = it["generated"], 0.001
        args = dict(scale=1.0, cd_loss_type="cd_p", point_upsample_factor=up,
                    include_displacement_center=False, intermediate_loss_weight=0.0)
        lp = make_refine_loss(port, task="refine_completion", **args)(
            batch["x0"], batch["condition"], batch["label"], batch["generated"],
            torch.tensor(0.001))
        lr_ = ref.refine_loss(net, **args)(batch, slice(0, 4))
    lp.backward()
    lr_.backward()
    assert float(lp.detach()) == pytest.approx(float(lr_.detach()), rel=1e-6)
    pg = dict(port.named_parameters())
    for k, p in net.named_parameters():
        assert _rel(pg[k].grad, p.grad) <= 1e-4, k


def test_row_blocks_give_the_whole_batch_step():
    """The reference's blocks of rows sum to the whole batch's step."""
    cfg = _config("pdr_cgnet_mvp")
    _, net, w = _both(cfg, "float32")
    g = inputs.generator("cpu", 6)
    it = inputs.completion_items(g, 4, cfg["npoints"], cfg["number_partial_points"], "cpu")
    batch = {"x0": it["complete"], "condition": it["partial"], "label": it["label"],
             "t": torch.tensor([3, 70, 500, 990]),
             "z": torch.randn(it["complete"].shape, generator=g)}
    whole = ref.train_steps(net, ref.completion_loss(net, cfg["diffusion_config"]), [batch],
                            2e-4, 4)
    net2 = ref.build({**cfg["pointnet_config"], "compute_dtype": "float32"}, w, "float32", "cpu")
    blocks = ref.train_steps(net2, ref.completion_loss(net2, cfg["diffusion_config"]), [batch],
                             2e-4, 1)
    assert whole[0][0] == pytest.approx(blocks[0][0], rel=1e-6)
    # leaves whose gradient is nought but for rounding (a bias under a
    # softmax or a norm) are left out, by the check's own rule
    norms = {k: float(v.norm()) for k, v in whole[1][0].items()}
    median = sorted(norms.values())[len(norms) // 2]
    for k in whole[1][0]:
        if norms[k] >= 1e-3 * median:
            assert _rel(blocks[1][0][k], whole[1][0][k]) <= 1e-4, k


def test_the_reference_imports_nothing_of_the_port():
    code = ("import sys; import pdr_bench.reference.model, pdr_bench.work; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout
    assert not set(ast.literal_eval(out)) & set(FORBIDDEN)


@pytest.mark.parametrize("config", ["pdr_cgnet_mvp", "pdr_rfnet_x8_mvp"])
def test_rebuilt_batches_equal_the_ports(config):
    """The reference's copy of the iterator and augmentation gives the
    batches the port's gives, bit for bit, over more than one epoch."""
    from point_diffusion_refinement_tpu_torch.data import iterate_batches

    from pdr_bench.reference.data import training_batches
    from pdr_bench.traffic.train_step import Items

    cfg = _config(config)
    up = int(cfg["pointnet_config"].get("point_upsample_factor", 1))
    g = inputs.generator("cpu", 7)
    items = inputs.completion_items(g, 6, cfg["npoints"], cfg["number_partial_points"], "cpu",
                                    coarse_points=cfg["npoints"] // up if up > 1 else 0)
    arrays = {k: v.numpy() for k, v in items.items()}
    seed = 2 ** 31 + 5

    def epoch_seed(e):
        return seed * 7 + e

    dataset = Items(arrays, cfg["augmentation"], seed)
    port = [b for e in range(3) for b in iterate_batches(dataset, 4, shuffle=True,
                                                         drop_last=True, seed=epoch_seed(e))]
    rebuilt = training_batches(arrays, cfg["augmentation"], 4, seed, epoch_seed)
    for b in port:
        r = next(rebuilt)
        assert set(r) == set(b)
        for k in b:
            np.testing.assert_array_equal(r[k], b[k])
