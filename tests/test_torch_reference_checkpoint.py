"""Reference checkpoints: the original repo's ``model_state_dict`` into the
port (``utils/torch_interop.py``).

A synthetic reference ``state_dict`` is written from seeded port weights in
the reference's module layout, the inverse of the converter's name mapping
(``_reference_state_dict`` below; ``tests/test_torch_interop.py:24-52``
builds its blocks the same way: Conv2d (O, I, 1, 1) in the MLPs and the
residual, Linear (O, I) for the injections, Conv1d (O, I, 1) in the head,
``group_norm`` weights of shape (0,) where MyGroupNorm normalises no
channel), and saved with ``torch.save`` as the reference's
``pointnet_ckpt_*.pkl`` is.  On ``tiny_pointnet_config`` the JAX package's
``torch_state_dict_to_flax`` + Flax apply must equal the port's
``load_reference_checkpoint`` + forward at ``tests/test_torch_network.py``'s
float32 tolerance.  At ``DEFAULT_POINTNET_CONFIG`` (no forward) every key of
the port's model must be filled with its shape and values, and a missing or
extra key of the converted tree must raise (the converter, like the JAX
package's, reads only the reference modules it knows).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_diffusion_refinement_tpu.config import tiny_pointnet_config as jax_tiny
from point_diffusion_refinement_tpu.models import PointNet2CloudCondition as JaxModel
from point_diffusion_refinement_tpu.utils.torch_interop import (
    torch_state_dict_to_flax as jax_convert,
)
from point_diffusion_refinement_tpu_torch.config import (
    DEFAULT_POINTNET_CONFIG,
    tiny_pointnet_config,
)
from point_diffusion_refinement_tpu_torch.models import PointNet2CloudCondition
from point_diffusion_refinement_tpu_torch.models.attention import AttentionPool
from point_diffusion_refinement_tpu_torch.models.common import ConditionedMLP
from point_diffusion_refinement_tpu_torch.utils.torch_interop import (
    load_reference_checkpoint,
    torch_state_dict_to_flax,
)
from torch_threads import one_torch_thread  # noqa: F401

F32_TOL = dict(rtol=1e-4, atol=2e-5)  # tests/test_torch_network.py's


def _randomize(model, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("scale"):
                p.copy_(1.0 + 0.2 * torch.randn(p.shape, generator=g))
            elif name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
    return model


def _np(t):
    return t.detach().cpu().numpy().copy()


def _reference_state_dict(model) -> dict:
    """The port model's weights under the reference's module names."""
    sd = {}

    def dense(ref, mod, rank):
        w = _np(mod.weight)
        sd[f"{ref}.weight"] = w.reshape(w.shape + (1,) * (rank - 2))
        if mod.bias is not None:
            sd[f"{ref}.bias"] = _np(mod.bias)

    def norm(ref, mod):
        gn = getattr(mod, "GroupNorm_0", mod)
        if hasattr(gn, "scale"):
            sd[f"{ref}.weight"], sd[f"{ref}.bias"] = _np(gn.scale), _np(gn.bias)
        else:  # MyGroupNorm(32, C < 32) normalises no channel
            sd[f"{ref}.weight"] = sd[f"{ref}.bias"] = np.zeros(0, np.float32)

    def shared(ref, sm):
        assert not sm.bn_first  # the shipped configs' [Conv2d, MyGroupNorm, ReLU] layers
        for j in range(len(sm.features)):
            dense(f"{ref}.{3 * j}", getattr(sm, f"Dense_{j}"), 4)
            if hasattr(sm, f"PartialGroupNorm_{j}"):
                norm(f"{ref}.{3 * j + 1}.group_norm", getattr(sm, f"PartialGroupNorm_{j}"))

    def mlp(ref, cm):
        for attr, name, rank in (("first_conv", "first_conv", 4), ("t_proj", "fc", 2),
                                 ("cond_proj", "fc_condition", 2),
                                 ("second_proj", "fc_second_condition", 2),
                                 ("res_proj", "res_connect", 4)):
            if getattr(cm, attr) is not None:
                dense(f"{ref}.{name}", getattr(cm, getattr(cm, attr)), rank)
        for i, name in enumerate(("first_mlp", "second_mlp", "rest_mlp")):
            if hasattr(cm, f"SharedMLP_{i}"):
                shared(f"{ref}.{name}", getattr(cm, f"SharedMLP_{i}"))

    def attention(ref, ap):
        dense(f"{ref}.feat_conv", ap.Dense_0, 4)
        dense(f"{ref}.grouped_feat_conv", ap.Dense_1, 4)
        if ap.attention_bn:
            norm(f"{ref}.weight_conv.1.group_norm", ap.PartialGroupNorm_0)
            dense(f"{ref}.weight_conv.2", ap.Dense_2, 4)
            norm(f"{ref}.weight_conv.4.group_norm", ap.PartialGroupNorm_1)
            dense(f"{ref}.weight_conv.5", ap.Dense_3, 4)
        else:
            dense(f"{ref}.weight_conv.1", ap.Dense_2, 4)
            dense(f"{ref}.weight_conv.3", ap.Dense_3, 4)
        if hasattr(ap, "Dense_4"):
            dense(f"{ref}.feat_out_conv.0", ap.Dense_4, 4)
            if hasattr(ap, "PartialGroupNorm_2"):
                norm(f"{ref}.feat_out_conv.1.group_norm", ap.PartialGroupNorm_2)

    prefixes = {"sa": "SA_modules", "sa_cond": "SA_modules_condition", "fp": "FP_modules",
                "fp_cond": "FP_modules_condition", "enc_map": "encoder_feature_map",
                "dec_map": "decoder_feature_map"}
    for top, mod in model.named_children():
        if top == "class_emb":
            sd["class_emb.weight"] = _np(mod.embedding)
        elif top in ("fc_t1", "fc_t2"):
            dense(top, mod, 2)
        elif top == "head_mid":
            dense("fc_lyaer.0", mod, 3)
        elif top == "head_norm":
            norm("fc_lyaer.1", mod)
        elif top == "head_out":
            dense("fc_lyaer.3", mod, 3)
        elif top == "global_pnet":
            mlp("global_pnet.mlp1", mod.ConditionedMLP_0)
            mlp("global_pnet.mlp2", mod.ConditionedMLP_1)
        else:
            kind, level = top.rsplit("_", 1)
            ref = f"{prefixes[kind]}.{level}"
            knn_fp = hasattr(mod, "ConditionedMLP_1")
            for name, sub in mod.named_children():
                if isinstance(sub, ConditionedMLP):
                    if kind in ("sa", "sa_cond"):
                        mlp(f"{ref}.mlps.0", sub)
                    elif knn_fp:
                        mlp(f"{ref}.mlp{int(name[-1]) + 1}", sub)
                    else:
                        mlp(f"{ref}.mlp", sub)
                elif isinstance(sub, AttentionPool):
                    attention(f"{ref}.attention_modules.0" if kind in ("sa", "sa_cond")
                              else f"{ref}.attention_module", sub)
                else:
                    raise AssertionError(f"no reference layout for {top}.{name}")
    return sd


def _save(tmp_path, model, wrap=True):
    sd = {k: torch.from_numpy(v) for k, v in _reference_state_dict(model).items()}
    path = str(tmp_path / "pointnet_ckpt_100.pkl")
    torch.save({"model_state_dict": sd, "iter": 100} if wrap else sd, path)
    return path, sd


@pytest.mark.parametrize("include_t", [True, False])
def test_reference_checkpoint_forward_matches_jax(tmp_path, include_t):
    cfg = {**tiny_pointnet_config(include_t=include_t), "compute_dtype": "float32"}
    src = _randomize(PointNet2CloudCondition.from_config(cfg, device="cpu", seed=3), 3)
    path, sd = _save(tmp_path, src)
    port = load_reference_checkpoint(
        path, PointNet2CloudCondition.from_config(cfg, device="cpu", seed=9))
    jcfg = {**jax_tiny(include_t=include_t), "compute_dtype": "float32"}
    jmodel = JaxModel.from_config(jcfg)
    params = jax_convert({k: v.numpy() for k, v in sd.items()})

    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 64, 3)).astype(np.float32)
    cond = np.concatenate([rng.uniform(-0.5, 0.5, (2, 96, 3)),
                           rng.integers(0, 2, (2, 96, 1)) * 2.0 - 1.0], -1).astype(np.float32)
    ts = rng.integers(0, 50, (2,)).astype(np.float32) if include_t else None
    label = rng.integers(0, 16, (2,)).astype(np.int32)
    ref = jax.jit(jmodel.apply)(params, jnp.asarray(x), jnp.asarray(cond),
                                None if ts is None else jnp.asarray(ts), jnp.asarray(label))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(cond),
                   None if ts is None else torch.from_numpy(ts),
                   torch.from_numpy(label).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_TOL)


def test_port_converter_equals_jax_converter(tmp_path):
    src = _randomize(PointNet2CloudCondition.from_config(
        tiny_pointnet_config(), device="cpu", seed=4), 4)
    sd = {k: v.numpy() for k, v in _save(tmp_path, src)[1].items()}
    got = jax.tree_util.tree_leaves_with_path(torch_state_dict_to_flax(sd))
    want = jax.tree_util.tree_leaves_with_path(jax_convert(sd))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(p))


def test_default_config_fills_every_key(tmp_path):
    cfg = dict(DEFAULT_POINTNET_CONFIG)
    src = PointNet2CloudCondition.from_config(cfg, device="cpu", seed=5)
    path, _ = _save(tmp_path, src, wrap=False)  # a bare state dict loads too
    port = PointNet2CloudCondition.from_config(cfg, device="cpu", seed=6)
    loaded = load_reference_checkpoint(path, port)
    assert loaded is port
    want = src.state_dict()
    got = port.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k
    converted = load_reference_checkpoint(path)  # no model: the state dict
    assert sorted(converted) == sorted(want)


def test_missing_or_extra_key_raises(tmp_path):
    cfg = tiny_pointnet_config()
    src = PointNet2CloudCondition.from_config(cfg, device="cpu", seed=7)
    sd = {k: torch.from_numpy(v) for k, v in _reference_state_dict(src).items()}
    for broken in ({k: v for k, v in sd.items() if not k.startswith("fc_t2.")},
                   {**sd, "encoder_feature_map.3.mlp.first_mlp.0.weight": torch.ones(2, 2, 1, 1)}):
        path = str(tmp_path / "broken.pkl")
        torch.save({"model_state_dict": broken}, path)
        with pytest.raises(KeyError):
            load_reference_checkpoint(
                path, PointNet2CloudCondition.from_config(cfg, device="cpu", seed=0))
