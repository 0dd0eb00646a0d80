"""Parameter conversion between the JAX package's Flax tree and the port.

Counterpart of the JAX package's ``utils/torch_interop.py``, for the port's
own modules: every submodule of the port carries its Flax scope name
(``sa_0.ConditionedMLP_0.SharedMLP_1.Dense_0`` ...), so a ``state_dict`` key
is the Flax parameter path joined by dots.  Dense kernels are stored (in,
out) by Flax and (out, in) by the port, so they are transposed and renamed
``kernel`` -> ``weight``; GroupNorm ``scale``/``bias``, Dense ``bias`` and
``embedding`` tables copy over unchanged.  The conversion follows the tree,
so the refine net (``include_t=False``: no ``fc_t1``/``fc_t2``, a
``head_out`` of 3*(F+1) or 3*F outputs) carries across like the denoiser.

The optimizer state carries across the same way: optax Adam's ``mu`` and
``nu`` are trees shaped like the parameters and map onto ``torch.optim.Adam``'s
``exp_avg`` and ``exp_avg_sq`` with the same key mapping and transposes, and
its ``count`` is every parameter's ``step``.

The input is the parameter tree as nested mappings of numpy arrays (for
example ``jax.tree_util.tree_map(np.asarray, variables)``); nothing here
imports JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

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


def load_adam_state(model: torch.nn.Module, optimizer: torch.optim.Adam,
                    mu: Mapping[str, Any], nu: Mapping[str, Any], count: int) -> None:
    """Copy optax Adam moments (``mu``, ``nu``: trees like the Flax
    parameters; ``count``: steps taken) into ``optimizer``'s state for
    ``model``'s parameters, in place."""
    exp_avg, exp_avg_sq = flax_to_state_dict(mu), flax_to_state_dict(nu)
    named = dict(model.named_parameters())
    if set(exp_avg) != set(named) or set(exp_avg_sq) != set(named):
        raise KeyError("optimizer moment trees and the model's parameters differ")
    for name, p in named.items():
        if tuple(exp_avg[name].shape) != tuple(p.shape):
            raise ValueError(f"{name}: moment shape {tuple(exp_avg[name].shape)} vs "
                             f"parameter {tuple(p.shape)}")
        optimizer.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": exp_avg[name].to(p.device),
            "exp_avg_sq": exp_avg_sq[name].to(p.device),
        }


def adam_state_to_flax(model: torch.nn.Module, optimizer: torch.optim.Adam
                       ) -> Tuple[Dict[str, Any], Dict[str, Any], int]:
    """The inverse of ``load_adam_state``: (mu, nu, count) with ``mu`` and
    ``nu`` as ``{"params": ...}`` trees of float32 numpy arrays.  Parameters
    that have not been stepped yet give zeros and count 0."""
    avg, sq, count = {}, {}, 0
    for name, p in model.named_parameters():
        st = optimizer.state.get(p, {})
        avg[name] = st.get("exp_avg", torch.zeros_like(p))
        sq[name] = st.get("exp_avg_sq", torch.zeros_like(p))
        count = max(count, int(st.get("step", 0)))
    return state_dict_to_flax(avg), state_dict_to_flax(sq), count
