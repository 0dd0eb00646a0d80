"""Reference checkpoints: the original repo's ``model_state_dict`` in the port.

The port's own copy of the JAX package's ``utils/torch_interop.py`` (numpy
only): ``torch_state_dict_to_flax`` renames the reference's PyTorch modules
to the Flax scope names that the port's modules carry, and
``load_reference_checkpoint`` reads a ``pointnet_ckpt_*.pkl`` and carries it
on into the port model through ``utils/weights.py::flax_to_state_dict``.

Name mapping, from the reference's module structure
(pointnet2_with_pcld_condition.py / pointnet2_modules.py / attention.py):

  torch (reference)                         Flax scope (JAX package, port)
  -----------------------------------------------------------------
  SA_modules.{i}.mlps.0.*            <->    sa_{i}.ConditionedMLP_0.*
  SA_modules.{i}.attention_modules.0 <->    sa_{i}.AttentionPool_0
  SA_modules_condition.{i}.*         <->    sa_cond_{i}.*
  FP_modules.{i}.mlp1/mlp2           <->    fp_{i}.ConditionedMLP_0/1
  FP_modules.{i}.attention_module    <->    fp_{i}.AttentionPool_0
  FP_modules_condition.{i}.*         <->    fp_cond_{i}.*
  encoder_feature_map.{i}.*          <->    enc_map_{i}.*
  decoder_feature_map.{i}.*          <->    dec_map_{i}.*
  global_pnet.mlp1/mlp2              <->    global_pnet.ConditionedMLP_0/1
  class_emb / fc_t1 / fc_t2          <->    class_emb / fc_t1 / fc_t2
  fc_lyaer.{0,1,3}                   <->    head_mid / head_norm / head_out

Weight layout: 1x1 Conv2d (O, I, 1, 1), Conv1d (O, I, 1) and Linear (O, I)
all become Dense kernels (I, O) = W.T in the Flax tree (and (O, I) again in
the port); GroupNorm weight/bias map to scale/bias unchanged; Embedding maps
unchanged.

The torch-side names inside an Mlp_plus_t_emb block with bn_first=False:
  first_mlp.0 (conv), first_mlp.1.group_norm (MyGroupNorm)
  second_mlp.0, second_mlp.1.group_norm
  rest_mlp.{3j}.*, rest_mlp.{3j+1}.group_norm   (j-th extra layer)
  fc (t embedding inject), fc_condition, fc_second_condition,
  first_conv, res_connect
Flax-side: SharedMLP_0 = first_mlp, SharedMLP_1 = second_mlp,
SharedMLP_2 = rest_mlp (Dense_j / PartialGroupNorm_j.GroupNorm_0 inside),
Dense_0.. are the injection/residual Denses in declaration order:
[first_conv?, fc(t)?, fc_condition?, fc_second_condition?, res_connect?].
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .weights import load_flax_params, flax_to_state_dict


def _dense_from_torch(w: np.ndarray, b=None) -> dict:
    """(O, I[, 1, 1]) conv/linear weight -> Dense {'kernel': (I, O), 'bias'}."""
    w = np.asarray(w)
    w = w.reshape(w.shape[0], w.shape[1])  # drop trailing 1x1
    out = {"kernel": w.T.astype(np.float32)}
    if b is not None:
        out["bias"] = np.asarray(b).astype(np.float32)
    return out


def _gn_from_torch(w, b) -> dict:
    return {"scale": np.asarray(w).astype(np.float32),
            "bias": np.asarray(b).astype(np.float32)}


class _SD:
    """Helper over a flat torch state dict."""

    def __init__(self, sd: Dict[str, np.ndarray]):
        self.sd = {k: np.asarray(v) for k, v in sd.items()}

    def has(self, key):
        return f"{key}.weight" in self.sd or key in self.sd

    def dense(self, key):
        return _dense_from_torch(
            self.sd[f"{key}.weight"], self.sd.get(f"{key}.bias")
        )

    def gn(self, key):
        return _gn_from_torch(self.sd[f"{key}.weight"], self.sd[f"{key}.bias"])


def _has_mlp(sd: _SD, prefix: str) -> bool:
    """A build_shared_mlp Sequential exists at `prefix` in any layout:
    conv-first (bn_first=False), norm-first, or act-first (bn_first=True)."""
    return (
        sd.has(f"{prefix}.0")
        or sd.has(f"{prefix}.0.group_norm")
        or sd.has(f"{prefix}.1")
    )


def _convert_shared_mlp(sd: _SD, prefix: str, bn: bool = True) -> dict:
    """torch build_shared_mlp Sequential -> flax SharedMLP params.

    Layout autodetected from the state dict: bn_first=False layers are
    [Conv2d, MyGroupNorm, ReLU]; bn_first=True layers are
    [MyGroupNorm, Act, Conv2d] (pointnet2_modules.py:48-66)."""
    out = {}
    j = 0  # flax layer index
    t = 0  # torch sequential index
    if sd.has(f"{prefix}.0"):  # conv first: bn_first=False
        while sd.has(f"{prefix}.{t}"):
            out[f"Dense_{j}"] = sd.dense(f"{prefix}.{t}")
            if bn and sd.has(f"{prefix}.{t + 1}.group_norm"):
                gn = sd.gn(f"{prefix}.{t + 1}.group_norm")
                # MyGroupNorm(32, C<32) normalizes zero channels: torch
                # stores empty (0,) weights, flax creates no params
                if gn["scale"].size > 0:
                    out[f"PartialGroupNorm_{j}"] = {"GroupNorm_0": gn}
                t += 3  # conv, norm, relu
            else:
                t += 2 if not bn else 3
            j += 1
        return out
    while True:  # bn_first=True
        if sd.has(f"{prefix}.{t}.group_norm"):
            gn = sd.gn(f"{prefix}.{t}.group_norm")
            if gn["scale"].size > 0:
                out[f"PartialGroupNorm_{j}"] = {"GroupNorm_0": gn}
            conv_t, step = t + 2, 3  # norm, act, conv
        elif sd.has(f"{prefix}.{t + 1}"):
            conv_t, step = t + 1, 2  # act, conv (bn=False)
        else:
            break
        out[f"Dense_{j}"] = sd.dense(f"{prefix}.{conv_t}")
        t += step
        j += 1
    return out


def _convert_mlp_plus_t(sd: _SD, prefix: str) -> dict:
    """torch Mlp_plus_t_emb -> flax ConditionedMLP params."""
    out = {}
    dense_i = 0
    if sd.has(f"{prefix}.first_conv"):
        out[f"Dense_{dense_i}"] = sd.dense(f"{prefix}.first_conv")
        dense_i += 1
    out["SharedMLP_0"] = _convert_shared_mlp(sd, f"{prefix}.first_mlp")
    if sd.has(f"{prefix}.fc"):
        out[f"Dense_{dense_i}"] = sd.dense(f"{prefix}.fc")
        dense_i += 1
    out["SharedMLP_1"] = _convert_shared_mlp(sd, f"{prefix}.second_mlp")
    if sd.has(f"{prefix}.fc_condition"):
        out[f"Dense_{dense_i}"] = sd.dense(f"{prefix}.fc_condition")
        dense_i += 1
    if _has_mlp(sd, f"{prefix}.rest_mlp"):
        out["SharedMLP_2"] = _convert_shared_mlp(sd, f"{prefix}.rest_mlp")
    if sd.has(f"{prefix}.fc_second_condition"):
        out[f"Dense_{dense_i}"] = sd.dense(f"{prefix}.fc_second_condition")
        dense_i += 1
    if sd.has(f"{prefix}.res_connect"):
        out[f"Dense_{dense_i}"] = sd.dense(f"{prefix}.res_connect")
        dense_i += 1
    return out


def _convert_attention(sd: _SD, prefix: str) -> dict:
    """torch AttentionModule -> flax AttentionPool.

    Flax Dense order in AttentionPool.__call__: Dense_0=q(feat_conv),
    Dense_1=k(grouped_feat_conv), Dense_2=inter(weight_conv.2),
    Dense_3=scores(weight_conv.5), Dense_4=value(feat_out_conv.0)."""
    out = {
        "Dense_0": sd.dense(f"{prefix}.feat_conv"),
        "Dense_1": sd.dense(f"{prefix}.grouped_feat_conv"),
    }
    # weight_conv (attention_bn=True): [ReLU, GN, Conv, ReLU, GN, Conv]
    if sd.has(f"{prefix}.weight_conv.2"):
        out["PartialGroupNorm_0"] = {
            "GroupNorm_0": sd.gn(f"{prefix}.weight_conv.1.group_norm")
        }
        out["Dense_2"] = sd.dense(f"{prefix}.weight_conv.2")
        out["PartialGroupNorm_1"] = {
            "GroupNorm_0": sd.gn(f"{prefix}.weight_conv.4.group_norm")
        }
        out["Dense_3"] = sd.dense(f"{prefix}.weight_conv.5")
    else:  # attention_bn=False: [ReLU, Conv, ReLU, Conv]
        out["Dense_2"] = sd.dense(f"{prefix}.weight_conv.1")
        out["Dense_3"] = sd.dense(f"{prefix}.weight_conv.3")
    if sd.has(f"{prefix}.feat_out_conv.0"):
        out["Dense_4"] = sd.dense(f"{prefix}.feat_out_conv.0")
        if sd.has(f"{prefix}.feat_out_conv.1.group_norm"):
            out["PartialGroupNorm_2"] = {
                "GroupNorm_0": sd.gn(f"{prefix}.feat_out_conv.1.group_norm")
            }
    return out


def _convert_global_attention(sd: _SD, prefix: str) -> dict:
    """torch GlobalAttentionModule (attention.py:98-154) -> flax
    GlobalSelfAttention.

    Flax call order: Dense_0=key_conv, Dense_1=query_conv,
    Dense_2=value_conv.0, [PartialGroupNorm_0=value GN], then over the
    pairwise concat [PartialGroupNorm_1, Dense_3, PartialGroupNorm_2,
    Dense_4=score]."""
    out = {
        "Dense_0": sd.dense(f"{prefix}.key_conv"),
        "Dense_1": sd.dense(f"{prefix}.query_conv"),
        "Dense_2": sd.dense(f"{prefix}.value_conv.0"),
    }
    gn_i = 0
    if sd.has(f"{prefix}.value_conv.1.group_norm"):
        out[f"PartialGroupNorm_{gn_i}"] = {
            "GroupNorm_0": sd.gn(f"{prefix}.value_conv.1.group_norm")
        }
        gn_i += 1
    if sd.has(f"{prefix}.weight_conv.2"):  # attention_bn=True layout
        out[f"PartialGroupNorm_{gn_i}"] = {
            "GroupNorm_0": sd.gn(f"{prefix}.weight_conv.1.group_norm")
        }
        out["Dense_3"] = sd.dense(f"{prefix}.weight_conv.2")
        out[f"PartialGroupNorm_{gn_i + 1}"] = {
            "GroupNorm_0": sd.gn(f"{prefix}.weight_conv.4.group_norm")
        }
        out["Dense_4"] = sd.dense(f"{prefix}.weight_conv.5")
    else:
        out["Dense_3"] = sd.dense(f"{prefix}.weight_conv.1")
        out["Dense_4"] = sd.dense(f"{prefix}.weight_conv.3")
    return out


def torch_state_dict_to_flax(state_dict: Dict[str, np.ndarray], n_levels: int = 4) -> dict:
    """Convert the reference model_state_dict to this repo's flax params.

    Returns {'params': {...}} for PointNet2CloudCondition.
    """
    sd = _SD(state_dict)
    p: dict = {}
    if sd.has("class_emb"):
        p["class_emb"] = {"embedding": np.asarray(sd.sd["class_emb.weight"])}
    if sd.has("fc_t1"):
        p["fc_t1"] = sd.dense("fc_t1")
        p["fc_t2"] = sd.dense("fc_t2")
    if _has_mlp(sd, "global_pnet.mlp1.first_mlp"):
        p["global_pnet"] = {
            "ConditionedMLP_0": _convert_mlp_plus_t(sd, "global_pnet.mlp1"),
            "ConditionedMLP_1": _convert_mlp_plus_t(sd, "global_pnet.mlp2"),
        }

    for i in range(n_levels):
        for torch_name, flax_name in (
            (f"SA_modules.{i}", f"sa_{i}"),
            (f"SA_modules_condition.{i}", f"sa_cond_{i}"),
        ):
            if not _has_mlp(sd, f"{torch_name}.mlps.0.first_mlp"):
                continue
            mod = {"ConditionedMLP_0": _convert_mlp_plus_t(sd, f"{torch_name}.mlps.0")}
            if sd.has(f"{torch_name}.attention_modules.0.feat_conv"):
                mod["AttentionPool_0"] = _convert_attention(
                    sd, f"{torch_name}.attention_modules.0"
                )
            if sd.has(f"{torch_name}.global_attention_modules.0.key_conv"):
                mod["GlobalSelfAttention_0"] = _convert_global_attention(
                    sd, f"{torch_name}.global_attention_modules.0"
                )
            p[flax_name] = mod

        for torch_name, flax_name in (
            (f"FP_modules.{i}", f"fp_{i}"),
            (f"FP_modules_condition.{i}", f"fp_cond_{i}"),
        ):
            if _has_mlp(sd, f"{torch_name}.mlp1.first_mlp"):  # KnnFP
                mod = {
                    "ConditionedMLP_0": _convert_mlp_plus_t(sd, f"{torch_name}.mlp1"),
                    "ConditionedMLP_1": _convert_mlp_plus_t(sd, f"{torch_name}.mlp2"),
                }
                if sd.has(f"{torch_name}.attention_module.feat_conv"):
                    mod["AttentionPool_0"] = _convert_attention(
                        sd, f"{torch_name}.attention_module"
                    )
                if sd.has(f"{torch_name}.global_attention_module.key_conv"):
                    mod["GlobalSelfAttention_0"] = _convert_global_attention(
                        sd, f"{torch_name}.global_attention_module"
                    )
                p[flax_name] = mod
            elif _has_mlp(sd, f"{torch_name}.mlp.first_mlp"):  # three-interp FP
                p[flax_name] = {
                    "ConditionedMLP_0": _convert_mlp_plus_t(sd, f"{torch_name}.mlp")
                }

        for torch_name, flax_name in (
            (f"encoder_feature_map.{i}", f"enc_map_{i}"),
            (f"decoder_feature_map.{i}", f"dec_map_{i}"),
        ):
            if _has_mlp(sd, f"{torch_name}.mlp.first_mlp"):
                mod = {"ConditionedMLP_0": _convert_mlp_plus_t(sd, f"{torch_name}.mlp")}
                if sd.has(f"{torch_name}.attention_module.feat_conv"):
                    mod["AttentionPool_0"] = _convert_attention(
                        sd, f"{torch_name}.attention_module"
                    )
                p[flax_name] = mod
    # the decoder map ladder has n_levels + 1 modules
    tn = f"decoder_feature_map.{n_levels}"
    if _has_mlp(sd, f"{tn}.mlp.first_mlp"):
        mod = {"ConditionedMLP_0": _convert_mlp_plus_t(sd, f"{tn}.mlp")}
        if sd.has(f"{tn}.attention_module.feat_conv"):
            mod["AttentionPool_0"] = _convert_attention(sd, f"{tn}.attention_module")
        p[f"dec_map_{n_levels}"] = mod

    # output head (bn_first=False: Conv1d, GroupNorm, ReLU, Conv1d)
    if sd.has("fc_lyaer.0"):
        if sd.has("fc_lyaer.3"):
            p["head_mid"] = sd.dense("fc_lyaer.0")
            p["head_norm"] = _gn_from_torch(
                sd.sd["fc_lyaer.1.weight"], sd.sd["fc_lyaer.1.bias"]
            )
            p["head_out"] = sd.dense("fc_lyaer.3")
        else:  # bn_first: [activation, Conv1d]
            p["head_out"] = sd.dense("fc_lyaer.1")
    return {"params": p}



def load_reference_checkpoint(path: str, model: Optional[torch.nn.Module] = None,
                              n_levels: int = 4):
    """Read a reference ``pointnet_ckpt_*.pkl`` (``torch.save`` of a dict
    with ``model_state_dict``, or the state dict itself) on the CPU and
    convert it to the port's ``state_dict``.  With ``model`` the weights are
    loaded into it strictly (a missing or unexpected key, or a shape that
    differs, raises) and the model is returned; else the state dict."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model_state_dict", ckpt)
    params = torch_state_dict_to_flax({k: v.numpy() for k, v in sd.items()},
                                      n_levels=n_levels)
    if model is None:
        return flax_to_state_dict(params)
    load_flax_params(model, params)
    return model
