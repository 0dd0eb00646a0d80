"""Experiment-config loading, schema-compatible with the reference JSONs.

The port's own copy of the JAX package's ``config/loader.py``: configs store
lists as strings (``"[1024, 256, 64, 16]"``), restored to lists on load with
``ast.literal_eval`` (never ``eval``); a refine config's ``refine_config``
keys override the same-named keys of the train, network and dataset
sections.  Also the shipped DDPM network config and the miniature one the
tests use.
"""

from __future__ import annotations

import ast
import copy
import json
import os
import re
from typing import Any, Mapping


def _maybe_list(v):
    if isinstance(v, str) and len(v) > 1 and v.strip()[:1] == "[":
        try:
            return ast.literal_eval(v)
        except (ValueError, SyntaxError):
            return v
    return v


def restore_string_to_list_in_a_dict(config: dict) -> dict:
    """Recursively restore stringified lists."""
    out = {}
    for k, v in config.items():
        if isinstance(v, dict):
            out[k] = restore_string_to_list_in_a_dict(v)
        else:
            out[k] = _maybe_list(v)
    return out


def merge_refine_config(config: dict) -> dict:
    """Overlay the ``refine_config`` keys onto ``train_config``,
    ``pointnet_config`` and ``mvp_dataset_config``: a key overrides only where
    that section already has it."""
    cfg = copy.deepcopy(config)
    refine = cfg.get("refine_config", {})
    for key, val in refine.items():
        for section in ("train_config", "pointnet_config", "mvp_dataset_config"):
            if section in cfg and key in cfg[section]:
                cfg[section][key] = val
    return cfg


def find_config_file(file_name: str) -> str:
    """Locate a config JSON: ``file_name`` itself if it is one, else the
    ``*config*.json`` in its directory (or in ``file_name`` if that is a
    directory) with the largest number in its name."""
    if "config" in file_name and file_name.endswith(".json") and os.path.isfile(file_name):
        return file_name
    file_path = file_name if os.path.isdir(file_name) else os.path.split(file_name)[0]
    files = [f for f in os.listdir(file_path) if "config" in f and f.endswith(".json")]
    if not files:
        raise FileNotFoundError(f"no config json under {file_path}")
    best, best_num = files[0], -1
    for f in files:
        nums = [int(n) for n in re.findall(r"\d+", f)]
        num = max(nums) if nums else -1
        if num > best_num:
            best, best_num = f, num
    return os.path.join(file_path, best)


def load_config(path: str) -> dict:
    """Read a JSON config, restore its lists and merge its refine keys."""
    with open(path) as f:
        config = json.load(f)
    config = restore_string_to_list_in_a_dict(config)
    if "refine_config" in config:
        config = merge_refine_config(config)
    return config


# The shipped DDPM training config (exp_configs/mvp_configs/
# config_standard_attention_real_3072_partial_points_rot_90_scale_1.2_
# translation_0.1.json), restored to native lists.
DEFAULT_POINTNET_CONFIG: Mapping[str, Any] = {
    "model_name": "shape_completion_mirror_rot_90_scale_1.2_translation_0.1",
    "in_fea_dim": 0,
    "partial_in_fea_dim": 1,
    "out_dim": 3,
    "include_t": True,
    "t_dim": 128,
    "model.use_xyz": True,
    "attach_position_to_input_feature": True,
    "include_abs_coordinate": True,
    "include_center_coordinate": True,
    "record_neighbor_stats": False,
    "bn_first": False,
    "bias": True,
    "res_connect": True,
    "include_class_condition": True,
    "num_class": 16,
    "class_condition_dim": 128,
    "bn": True,
    "include_local_feature": True,
    "include_global_feature": True,
    "global_feature_remove_last_activation": False,
    "pnet_global_feature_architecture": [[4, 128, 256], [512, 1024]],
    "attention_setting": {
        "use_attention_module": True,
        "attention_bn": True,
        "transform_grouped_feat_out": True,
        "last_activation": True,
        "add_attention_to_FeatureMapper_module": True,
    },
    "architecture": {
        "npoint": [1024, 256, 64, 16],
        "radius": [0.1, 0.2, 0.4, 0.8],
        "neighbor_definition": "radius",
        "nsample": [32, 32, 32, 32],
        "feature_dim": [32, 64, 128, 256, 512],
        "mlp_depth": 3,
        "decoder_feature_dim": [128, 128, 256, 256, 512],
        "include_grouper": False,
        "decoder_mlp_depth": 2,
        "use_knn_FP": True,
        "K": 8,
    },
    "condition_net_architecture": {
        "npoint": [1024, 256, 64, 16],
        "radius": [0.1, 0.2, 0.4, 0.8],
        "neighbor_definition": "radius",
        "nsample": [32, 32, 32, 32],
        "feature_dim": [32, 32, 64, 64, 128],
        "mlp_depth": 3,
        "decoder_feature_dim": [32, 32, 64, 64, 128],
        "include_grouper": False,
        "decoder_mlp_depth": 2,
        "use_knn_FP": True,
        "K": 8,
    },
    "feature_mapper_architecture": {
        "neighbor_definition": "radius",
        "encoder_feature_map_dim": [32, 32, 64, 64],
        "encoder_mlp_depth": 2,
        "encoder_radius": [0.1, 0.2, 0.4, 0.8],
        "encoder_nsample": [32, 32, 32, 32],
        "decoder_feature_map_dim": [32, 32, 64, 64, 128],
        "decoder_mlp_depth": 2,
        "decoder_radius": [0.1, 0.2, 0.4, 0.8, 1.6],
        "decoder_nsample": [32, 32, 32, 32, 32],
    },
}


def tiny_pointnet_config(
    include_t: bool = True, out_dim: int = 3, levels: int = 2
) -> dict:
    """A miniature config with the same structure, for fast tests."""
    cfg = copy.deepcopy(dict(DEFAULT_POINTNET_CONFIG))
    n = levels
    cfg["out_dim"] = out_dim
    cfg["include_t"] = include_t
    cfg["t_dim"] = 16
    cfg["class_condition_dim"] = 8
    cfg["pnet_global_feature_architecture"] = [[4, 8, 16], [16, 32]]
    cfg["architecture"] = {
        "npoint": [32, 16][:n],
        "radius": [0.2, 0.4][:n],
        "neighbor_definition": "radius",
        "nsample": [8, 8][:n],
        "feature_dim": [8, 16, 16][: n + 1],
        "mlp_depth": 3,
        "decoder_feature_dim": [8, 16, 16][: n + 1],
        "include_grouper": False,
        "decoder_mlp_depth": 2,
        "use_knn_FP": True,
        "K": 4,
    }
    cfg["condition_net_architecture"] = {
        "npoint": [32, 16][:n],
        "radius": [0.2, 0.4][:n],
        "neighbor_definition": "radius",
        "nsample": [8, 8][:n],
        "feature_dim": [8, 8, 16][: n + 1],
        "mlp_depth": 3,
        "decoder_feature_dim": [8, 8, 16][: n + 1],
        "include_grouper": False,
        "decoder_mlp_depth": 2,
        "use_knn_FP": True,
        "K": 4,
    }
    cfg["feature_mapper_architecture"] = {
        "neighbor_definition": "radius",
        "encoder_feature_map_dim": [8, 8][:n],
        "encoder_mlp_depth": 2,
        "encoder_radius": [0.2, 0.4][:n],
        "encoder_nsample": [8, 8][:n],
        "decoder_feature_map_dim": [8, 8, 16][: n + 1],
        "decoder_mlp_depth": 2,
        "decoder_radius": [0.2, 0.4, 0.8][: n + 1],
        "decoder_nsample": [8, 8, 8][: n + 1],
    }
    return cfg
