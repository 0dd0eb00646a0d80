"""Hparams handling for the conditional denoiser.

The model is driven by the reference JSON ``pointnet_config`` dict schema,
the same as the JAX package's.  PyTorch modules need no hashable config, so
the config stays a plain dict; this module holds the lookups the modules
share.
"""

from __future__ import annotations

import copy
from typing import Any, Mapping, Optional

import torch


def as_config(d: Mapping[str, Any]) -> dict:
    """A private deep copy of a config mapping, so later edits of the
    caller's dict cannot change a built model's hparams."""
    return copy.deepcopy(dict(d))


def compute_dtype(hp: Mapping[str, Any]) -> Optional[torch.dtype]:
    """``compute_dtype`` of the config: ``torch.bfloat16`` for "bfloat16",
    None for float32 (parameters and norms always stay float32)."""
    cd = hp.get("compute_dtype", "float32")
    if cd == "bfloat16":
        return torch.bfloat16
    if cd == "float32":
        return None
    raise ValueError(f"unsupported compute_dtype {cd!r}")


def attention_kwargs(setting, key_use: str = "use_attention_module") -> dict:
    """Attention flags of a module from an ``attention_setting`` section."""
    if setting is None:
        return dict(use_attention=False)
    return dict(
        use_attention=bool(setting[key_use]),
        attention_bn=bool(setting.get("attention_bn", True)),
        attention_transform_out=bool(setting.get("transform_grouped_feat_out", True)),
        attention_last_activation=bool(setting.get("last_activation", True)),
    )
