"""The model options of ``PointNet2CloudCondition`` this slice ports,
against the JAX package with the port's seeded weights carried across:
the feature-propagation grouper (``include_grouper``) on both FP kinds (kNN
and 3-NN), and ``concate_partial_with_noisy_input`` (the config of the JAX
tests' ``test_concat_partial_mode``).  Forward and the gradient of a loss;
float32, summation order only.  The fused training routes give the same
values where the grouper takes the fused gather.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_diffusion_refinement_tpu.config import tiny_pointnet_config
from point_diffusion_refinement_tpu.models import PointNet2CloudCondition as JaxModel
from point_diffusion_refinement_tpu_torch.models import PointNet2CloudCondition
from point_diffusion_refinement_tpu_torch.utils.weights import (
    flax_to_state_dict,
    state_dict_to_flax,
)
from torch_threads import one_torch_thread  # noqa: F401

OUT_TOL = dict(rtol=1e-4, atol=2e-5)  # as tests/test_torch_network.py holds float32
GRAD_TOL = 2e-3  # of each gradient tensor's largest entry
GRAD_FLOOR = 3e-5  # of the largest gradient entry of the whole tree


def _grouper(knn: bool) -> dict:
    cfg = tiny_pointnet_config()
    for arch in ("architecture", "condition_net_architecture"):
        cfg[arch]["include_grouper"] = True
        cfg[arch]["use_knn_FP"] = knn
        if not knn:  # the class condition takes a third MLP layer
            cfg[arch]["decoder_mlp_depth"] = 3
    return cfg


def _concat() -> dict:
    cfg = tiny_pointnet_config()
    cfg["include_local_feature"] = False
    cfg["include_global_feature"] = False
    cfg["concate_partial_with_noisy_input"] = True
    return cfg


CASES = {
    "grouper_knn_fp": (_grouper(True), 4),
    "grouper_three_nn_fp": (_grouper(False), 4),
    "concat_partial": (_concat(), 3),
}


def _randomize(model, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("scale"):
                p.copy_(1.0 + 0.2 * torch.randn(p.shape, generator=g))
            elif name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
    return model


def _inputs(cond_channels: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 64, 3)).astype(np.float32)
    cond = rng.uniform(-0.5, 0.5, (2, 48, 3))
    if cond_channels == 4:
        cond = np.concatenate([cond, rng.integers(0, 2, (2, 48, 1)) * 2.0 - 1.0], -1)
    return (x, cond.astype(np.float32), np.array([3.0, 20.0], np.float32),
            np.array([1, 2], np.int32))


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """The port model, the inputs, and the JAX forward and gradient of
    mean(out^2), jitted once a case."""
    cfg, cond_channels = CASES[request.param]
    port = _randomize(PointNet2CloudCondition.from_config(cfg, device="cpu", seed=0), 0)
    jm = JaxModel.from_config(cfg)
    data = _inputs(cond_channels)

    def loss(p, *args):
        out = jm.apply(p, *args)
        return jnp.mean(out ** 2), out

    params = jax.tree_util.tree_map(jnp.asarray, state_dict_to_flax(port.state_dict()))
    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params, *map(jnp.asarray, data))
    return request.param, port, data, np.asarray(out), grads


def _args(data):
    x, cond, ts, label = map(torch.from_numpy, data)
    return x, cond, ts, label.long()


def test_forward(case):
    _, port, data, want, _ = case
    got = port(*_args(data))
    assert got.shape == (2, 64, 3)
    np.testing.assert_allclose(got.detach().numpy(), want, **OUT_TOL)


def test_gradient(case):
    _, port, data, _, grads = case
    port.zero_grad()
    torch.mean(port(*_args(data)) ** 2).backward()
    ref = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, grads))
    named = dict(port.named_parameters())
    assert set(ref) == set(named)
    top = max(float(r.abs().max()) for r in ref.values())
    for name, p in named.items():
        scale = float(ref[name].abs().max())
        err = float((p.grad - ref[name]).abs().max())
        assert err <= GRAD_TOL * scale + GRAD_FLOOR * top, (name, err, scale)


def test_fused_routes_give_the_same_values(case):
    """``fused_gather`` sends the grouper's ball query through the fused
    gather and ``fused_sa`` the eligible set abstractions through the fused
    group: on the CPU their plain versions, with the unfused values."""
    _, port, data, _, _ = case
    with torch.no_grad():
        plain = port(*_args(data))
        fused = port(*_args(data), fused_gather=True, fused_sa=True)
    np.testing.assert_allclose(fused.numpy(), plain.numpy(), rtol=1e-6, atol=1e-6)


def test_concat_partial_flags_a_three_channel_condition():
    """A 3-channel condition gets a ones flag channel: the same output as
    the 4-channel condition that carries it."""
    port = _randomize(PointNet2CloudCondition.from_config(_concat(), device="cpu", seed=0), 0)
    x, cond, ts, label = _args(_inputs(3))
    flagged = torch.cat([cond, torch.ones(cond.shape[:2] + (1,))], dim=-1)
    with torch.no_grad():
        assert torch.equal(port(x, cond, ts, label), port(x, flagged, ts, label))


def test_grouper_modules_and_widths():
    """Every FP module of both ladders groups, with the grouped width
    (features + relative + absolute xyz) as its MLP input; the fused kNN
    route stays off under the grouper."""
    port = PointNet2CloudCondition.from_config(_grouper(True), device="cpu", seed=0)
    fps = [m for n, m in port.named_children() if n.startswith("fp")]
    assert fps and all(m.include_grouper for m in fps)
    x = torch.zeros(1, 2048, 3)
    assert not any(m.fused_knn_eligible(x, x, torch.zeros(1, 2048, 8), True) for m in fps)
