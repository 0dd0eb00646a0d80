"""``GlobalSelfAttention`` and the ``ddpm_avg_max`` configuration that turns
it on, against the JAX package on the CPU.

The module is compared alone with both ``true_attention`` settings (the
reference's collapsed output, the value Dense with its norm and ReLU, and
real attention over the keys), and inside a tiny network shaped like
``ddpm_avg_max`` (avg_max pooling, global attention after set abstractions
and kNN feature propagations) whose weights are carried across by
``utils/weights.py``.  float32 throughout: the differences are summation
order only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_diffusion_refinement_tpu.config import tiny_pointnet_config
from point_diffusion_refinement_tpu.models import PointNet2CloudCondition as JaxModel
from point_diffusion_refinement_tpu.models.attention import GlobalSelfAttention as JaxGSA
from point_diffusion_refinement_tpu_torch.config import EXPERIMENTS
from point_diffusion_refinement_tpu_torch.models import GlobalSelfAttention, PointNet2CloudCondition
from point_diffusion_refinement_tpu_torch.utils.weights import flax_to_state_dict, state_dict_to_flax
from torch_threads import one_torch_thread  # noqa: F401

MODULE_TOL = dict(rtol=1e-5, atol=1e-5)
NET_TOL = dict(rtol=1e-4, atol=2e-5)  # tests/test_torch_network.py's float32 bound


def _randomize(module, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            noise = torch.randn(p.shape, generator=g)
            if name.endswith("scale"):
                p.copy_(1.0 + 0.2 * noise)
            elif name.endswith("bias"):
                p.copy_(0.1 * noise)
            else:
                p.copy_(noise / p.shape[-1] ** 0.5)
    return module.eval()


@pytest.mark.parametrize("true_attention", [False, True])
@pytest.mark.parametrize("bn,last", [(True, True), (True, False), (False, True)])
def test_module_matches_jax(true_attention, bn, last):
    x = np.random.default_rng(0).normal(size=(2, 24, 19)).astype(np.float32)
    port = _randomize(GlobalSelfAttention(19, 16, bn, last, true_attention), 1)
    jm = JaxGSA(16, attention_bn=bn, last_activation=last, true_attention=true_attention)
    tree = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.key(0), jnp.asarray(x)))
    sd = port.state_dict()
    # the same parameter tree, and the conversion is its own inverse
    assert set(flax_to_state_dict(tree)) == set(sd)
    assert all(torch.equal(v, sd[k])
               for k, v in flax_to_state_dict(state_dict_to_flax(sd)).items())
    ref = np.asarray(jm.apply(state_dict_to_flax(sd), jnp.asarray(x)))
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    assert out.shape == (2, 24, 16) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, **MODULE_TOL)
    assert np.abs(ref).mean() > 1e-2


def test_avg_max_network_matches_jax():
    """A tiny ``ddpm_avg_max``: encode + denoise against the JAX model."""
    cfg = tiny_pointnet_config()
    cfg["pooling"] = "avg_max"
    cfg["global_attention_setting"] = dict(
        EXPERIMENTS["ddpm_avg_max"]()["pointnet_config"]["global_attention_setting"],
        global_attention_layer_index=[0, 1])
    port = _randomize(PointNet2CloudCondition.from_config(cfg, device="cpu", seed=0), 0)
    names = [n for n, _ in port.named_modules() if n.endswith("GlobalSelfAttention_0")]
    assert names == ["sa_0.GlobalSelfAttention_0", "sa_1.GlobalSelfAttention_0",
                     "fp_0.GlobalSelfAttention_0", "fp_1.GlobalSelfAttention_0"]
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 64, 3)).astype(np.float32)
    cond = np.concatenate([rng.uniform(-0.5, 0.5, (2, 96, 3)),
                           rng.integers(0, 2, (2, 96, 1)) * 2.0 - 1.0], -1).astype(np.float32)
    ts, label = np.array([3.0, 17.0], np.float32), np.array([1, 5], np.int32)
    jm = JaxModel.from_config(cfg)
    ref = np.asarray(jax.jit(jm.apply)(state_dict_to_flax(port.state_dict()), *map(
        jnp.asarray, (x, cond, ts, label))))
    with torch.no_grad():
        cf = port.encode_condition(torch.from_numpy(cond))
        out = port.denoise(*map(torch.from_numpy, (x, ts, label)), cf)
    np.testing.assert_allclose(out.numpy(), ref, **NET_TOL)
    assert np.abs(ref).mean() > 1e-2


def test_ddpm_avg_max_builds():
    """The shipped experiment builds, with the module after the two coarsest
    set abstractions and kNN feature propagations."""
    pc = EXPERIMENTS["ddpm_avg_max"]()["pointnet_config"]
    port = PointNet2CloudCondition.from_config(pc, device="cpu", seed=0)
    names = [n for n, _ in port.named_modules() if n.endswith("GlobalSelfAttention_0")]
    assert names == ["sa_2.GlobalSelfAttention_0", "sa_3.GlobalSelfAttention_0",
                     "fp_2.GlobalSelfAttention_0", "fp_3.GlobalSelfAttention_0"]
    w = dict(port.named_parameters())["sa_3.GlobalSelfAttention_0.Dense_3.weight"]
    assert tuple(w.shape) == (512, 1024)  # the score MLP's (2C -> C), kept for checkpoints
