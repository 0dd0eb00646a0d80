"""Parameter conversion between the JAX package's Flax tree and the port.

Counterpart of the JAX package's ``utils/torch_interop.py``, for the port's
own modules: every submodule of the port carries its Flax scope name
(``sa_0.ConditionedMLP_0.SharedMLP_1.Dense_0`` ...), so a ``state_dict`` key
is the Flax parameter path joined by dots.  Dense kernels are stored (in,
out) by Flax and (out, in) by the port, so they are transposed and renamed
``kernel`` -> ``weight``; GroupNorm ``scale``/``bias``, Dense ``bias`` and
``embedding`` tables copy over unchanged.

The input is the parameter tree as nested mappings of numpy arrays (for
example ``jax.tree_util.tree_map(np.asarray, variables)``); nothing here
imports JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def flax_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax parameter tree (with or without the top-level ``params``
    collection) -> the port model's ``state_dict`` (float32 tensors)."""
    if "params" in params and isinstance(params["params"], Mapping):
        params = params["params"]
    sd = {}
    for key, arr in _flatten(params).items():
        t = torch.from_numpy(np.array(arr, dtype=np.float32))
        if key.endswith(".kernel"):
            sd[key[: -len("kernel")] + "weight"] = t.t().contiguous()
        else:
            sd[key] = t
    return sd


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of ``flax_to_state_dict``: a nested ``{"params": ...}``
    tree of float32 numpy arrays."""
    root: Dict[str, Any] = {}
    for key, t in state_dict.items():
        arr = t.detach().to("cpu", torch.float32).numpy()
        parts = key.split(".")
        if parts[-1] == "weight":
            parts[-1] = "kernel"
            arr = arr.T
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.ascontiguousarray(arr)
    return {"params": root}


def load_flax_params(model: torch.nn.Module, params: Mapping[str, Any]) -> None:
    """Copy a Flax parameter tree into ``model`` in place.  Raises on any
    missing or unexpected key and on any shape mismatch."""
    sd = flax_to_state_dict(params)
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    extra = sorted(set(sd) - set(own))
    if missing or extra:
        raise KeyError(f"parameter trees differ: missing {missing[:8]}, unexpected {extra[:8]}")
    for k, v in sd.items():
        if tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(f"{k}: shape {tuple(v.shape)} vs model {tuple(own[k].shape)}")
    model.load_state_dict(sd, strict=True)
