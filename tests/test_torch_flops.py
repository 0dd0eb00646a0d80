"""The port's FLOP count (``utils/flops.py``) against the JAX package's.

On ``tiny_pointnet_config`` in float32 at the same weights:

- the network forward: the port's ``dot_flops(...)["model"]`` equals the
  JAX package's exactly.  The JAX package forms no distance as a matmul
  (``ops/neighbors.py::pairwise_sqdist`` there avoids the |a|^2 - 2ab +
  |b|^2 identity), so there is no 3-wide contraction to take out, and its
  ``gather`` is 0 on this path: no one-hot gather runs on the CPU;
- the DDPM training step: the port's ``model`` equals the JAX package's
  ``model + gather``.  JAX files a product as ``gather`` when an operand
  walks back to ``eq`` / ``select_n``, and the transpose of a ReLU or a max
  is a ``select_n``: the backward products whose cotangent passed one land
  there.
  The forward above shows no one-hot gather on the path, so every
  ``gather`` FLOP of the step is a model product;
- ``gather`` is 0 in the port, and the in-kernel tally is a no-op outside
  its scope (as ``tests/test_round5_fixes.py`` holds for the JAX package);
- the multiply-adds the fused attention pool's wrapper records
  (``ops/attention_pool.py::attention_pool_kernel_macs``) plus the two
  query-path products it leaves to ``torch.matmul`` equal what
  ``FlopCounterMode`` counts for the unfused pool at the same site, at a
  shallow and a deep site of the full config: ``model + pallas`` is the same
  with ``fused_attention`` on or off.  On the CPU the wrapper takes the
  plain sweeps and records nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from point_diffusion_refinement_tpu.config import DEFAULT_POINTNET_CONFIG, tiny_pointnet_config
from point_diffusion_refinement_tpu.diffusion import calc_diffusion_hyperparams as jax_schedule
from point_diffusion_refinement_tpu.models import PointNet2CloudCondition as JaxModel
from point_diffusion_refinement_tpu.train import step as jstep
from point_diffusion_refinement_tpu.utils.flops import dot_flops as jax_dot_flops
from point_diffusion_refinement_tpu_torch import train as ptrain
from point_diffusion_refinement_tpu_torch.diffusion import calc_diffusion_hyperparams
from point_diffusion_refinement_tpu_torch.models import AttentionPool, PointNet2CloudCondition
from point_diffusion_refinement_tpu_torch.ops.attention_pool import (
    attention_pool_kernel_macs,
    fused_attention_pool,
)
from point_diffusion_refinement_tpu_torch.utils import flops
from point_diffusion_refinement_tpu_torch.utils.flops import (
    H100_BF16_PEAK_FLOPS,
    dot_flops,
    pallas_flops_tally,
    record_pallas_macs,
)
from point_diffusion_refinement_tpu_torch.utils.weights import state_dict_to_flax
from torch_threads import one_torch_thread  # noqa: F401

B, N, M, T = 2, 64, 96, 50


@pytest.fixture(scope="module")
def pair():
    cfg = {**tiny_pointnet_config(), "compute_dtype": "float32"}
    port = PointNet2CloudCondition.from_config(cfg, device="cpu", seed=0)
    rng = np.random.default_rng(0)
    x0 = rng.uniform(-0.5, 0.5, (B, N, 3)).astype(np.float32)
    cond = np.concatenate([rng.uniform(-0.5, 0.5, (B, M, 3)), np.ones((B, M, 1))],
                          axis=-1).astype(np.float32)
    t = np.array([3.0, 7.0], np.float32)
    label = np.array([1, 2], np.int32)
    return dict(port=port, jax=JaxModel.from_config(cfg),
                params=state_dict_to_flax(port.state_dict()), inputs=(x0, cond, t, label))


def _torch(x0, cond, t, label):
    return (torch.from_numpy(x0), torch.from_numpy(cond), torch.from_numpy(t),
            torch.from_numpy(label).long())


def test_forward_model_flops_match_jax(pair):
    ref = jax_dot_flops(lambda p, *a: pair["jax"].apply(p, *a), pair["params"],
                        *pair["inputs"])
    with torch.no_grad():
        got = dot_flops(pair["port"], *_torch(*pair["inputs"]))
    assert ref["gather"] == 0.0 and ref["pallas"] == 0.0
    assert got == {"model": ref["model"], "gather": 0.0, "pallas": 0.0}
    assert got["model"] > 0


def test_train_step_model_flops_match_jax(pair):
    x0, cond, _, label = pair["inputs"]
    state, tx = jstep.create_train_state(pair["params"], jax.random.key(1))
    ref = jax_dot_flops(jstep.make_completion_train_step(pair["jax"], jax_schedule(T, 1e-4, 0.02),
                                                         tx),
                        state, jnp.asarray(x0), jnp.asarray(cond), jnp.asarray(label))
    port = pair["port"]
    step = ptrain.make_completion_train_step(port, calc_diffusion_hyperparams(T, 1e-4, 0.02))
    x, c, _, lab = _torch(*pair["inputs"])
    got = dot_flops(step, ptrain.create_train_state(port), x, c, lab)
    assert got == {"model": ref["model"] + ref["gather"], "gather": 0.0, "pallas": 0.0}
    with torch.no_grad():
        forward = dot_flops(port, *_torch(*pair["inputs"]))["model"]
    assert got["model"] > 2 * forward  # the backward's products are counted


def test_tally_is_a_noop_outside_its_scope():
    before = len(flops._PALLAS_TALLY)
    record_pallas_macs(123.0)
    assert len(flops._PALLAS_TALLY) == before
    with pallas_flops_tally() as out:
        record_pallas_macs(10.0)
        with pallas_flops_tally() as inner:
            record_pallas_macs(1.0)
        assert inner["flops"] == 2.0
    assert out["flops"] == 20.0
    assert len(flops._PALLAS_TALLY) == before
    assert H100_BF16_PEAK_FLOPS == 989e12


def _sites():
    """A shallow and a deep attention pool of the full config: the first
    and the widest (by output channels) of the network."""
    cfg = {**DEFAULT_POINTNET_CONFIG, "compute_dtype": "bfloat16"}
    model = PointNet2CloudCondition.from_config(cfg, device="cpu", seed=0)
    pools = [(n, m) for n, m in model.named_modules() if isinstance(m, AttentionPool)]
    return [pools[0], max(pools, key=lambda p: p[1].widths["c_out"])]


@pytest.mark.parametrize("which", [0, 1])
def test_fused_pool_records_the_unfused_products(which):
    name, pool = _sites()[which]
    Bs, Ms, K = 2, 8, 16
    Cq, Ck = pool.Dense_0.in_features, pool.Dense_1.in_features
    Cv = pool.Dense_4.in_features
    w = pool.widths
    g = torch.Generator().manual_seed(which)
    feat = torch.randn(Bs, Ms, Cq, generator=g).to(torch.bfloat16)
    grouped = torch.randn(Bs, Ms, K, Ck, generator=g).to(torch.bfloat16)
    gfo = torch.randn(Bs, Ms, K, Cv, generator=g).to(torch.bfloat16)
    counts = torch.randint(1, K + 1, (Bs, Ms), generator=g)
    with torch.no_grad():
        with FlopCounterMode(display=False) as unfused:
            pool(feat, grouped, gfo, counts)
        # the two products the fused route leaves to torch.matmul
        with FlopCounterMode(display=False) as q_path:
            torch.matmul(feat, pool.Dense_0.weight.t().to(torch.bfloat16))
            torch.matmul(torch.zeros(Bs, Ms, w["c1"], dtype=torch.bfloat16),
                         pool.Dense_2.weight[:, :w["c1"]].t().to(torch.bfloat16))
        macs = attention_pool_kernel_macs(Bs, Ms, K, Ck, Cv, w["c2"], w["inter_c"],
                                          w["c_out"])
        assert unfused.get_total_flops() == 2 * macs + q_path.get_total_flops(), name
        # on CPU tensors the wrapper takes the plain sweeps: nothing recorded
        with pallas_flops_tally() as tally:
            fused_attention_pool(feat, grouped, gfo, counts.to(torch.int32), K=K,
                                 prepared=pool._fused_weights(), **w)
        assert tally["flops"] == 0.0
    assert macs > 0 and (which == 0 or w["c_out"] >= 256)
