"""Routing of the port's call sites to its kernels: under bf16 compute,
``denoise(fused=True)`` (as the sampler calls it) sends the encoder/decoder
feature-transfer pair of every level whose condition support has >= 1024
points, and the x_t set-abstraction grouping of levels with >= 1024 points,
through the fused ball group, and only those.  The result must agree with
the JAX package's unfused grouping to bf16 tolerance: both round the
grouped channels to bf16 before the first Dense, but a flipped bf16
rounding travels and jitted XLA may keep fused bf16 intermediates in
float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from point_diffusion_refinement_tpu.config import tiny_pointnet_config
from point_diffusion_refinement_tpu.models import PointNet2CloudCondition as JaxModel
from point_diffusion_refinement_tpu_torch.models import PointNet2CloudCondition
from point_diffusion_refinement_tpu_torch.models import condition_net, modules
from point_diffusion_refinement_tpu_torch.utils.weights import state_dict_to_flax

BF16_TOL = dict(rtol=2.0 ** -6, atol=5e-2)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _f(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _randomize(model, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("scale"):
                p.copy_(1.0 + 0.2 * torch.randn(p.shape, generator=g))
            elif name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
    return model


def test_fused_routing_matches_unfused_jax(monkeypatch):
    """bf16 at sizes where the gates open (support >= 1024, query count a
    multiple of 128): the port's denoise(fused=True) sends the level-0 FT
    pair and the x_t SA level-0 grouping through the fused ball group and
    must still agree with the JAX package's unfused grouping."""
    cfg = tiny_pointnet_config()
    cfg["compute_dtype"] = "bfloat16"
    for key in ("architecture", "condition_net_architecture"):
        cfg[key]["npoint"] = [128, 64]
    port = _randomize(PointNet2CloudCondition.from_config(cfg, device="cpu", seed=2), 2)
    jm, params = JaxModel.from_config(cfg), state_dict_to_flax(port.state_dict())
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 1024, 3)).astype(np.float32)
    cond = np.concatenate([rng.uniform(-0.5, 0.5, (2, 1024, 3)),
                           rng.integers(0, 2, (2, 1024, 1)) * 2.0 - 1.0], -1).astype(np.float32)
    ts = np.array([5.0, 31.0], np.float32)
    label = np.array([0, 7], np.int32)
    calls = []

    def spy(fn):
        def wrapped(*a, **k):
            calls.append(len(a[1]))  # number of tables
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(condition_net, "ball_group", spy(condition_net.ball_group))
    monkeypatch.setattr(modules, "ball_group", spy(modules.ball_group))
    with torch.no_grad():
        cf = port.encode_condition(_t(cond))
        assert calls == []  # the condition branch never takes the fused route
        out = port.denoise(_t(x), _t(ts), _t(label), cf, fused=True)
        plain = port.denoise(_t(x), _t(ts), _t(label), cf)
    # level 0 only: the FT pair (two tables, one launch) and SA level 0
    assert sorted(calls) == [1, 2]

    @jax.jit
    def run(p, x, cond, ts, label):
        jcf = jm.apply(p, cond, method=jm.encode_condition)
        return jm.apply(p, x, ts, label, jcf, method=jm.denoise)

    ref = _f(run(params, *map(jnp.asarray, (x, cond, ts, label))))
    np.testing.assert_allclose(out.numpy(), ref, **BF16_TOL)
    np.testing.assert_allclose(plain.numpy(), ref, **BF16_TOL)
    assert np.abs(ref).mean() > 1e-2
