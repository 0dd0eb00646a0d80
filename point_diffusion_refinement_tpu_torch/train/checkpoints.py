"""Checkpoint save/resume.

Counterpart of the JAX package's ``train/checkpoints.py``, on ``torch.save``
/ ``torch.load`` in place of orbax.  A checkpoint is the directory
``<path>/pointnet_ckpt_<iter>`` (the same naming, so tooling that scans for
iterations keeps working) holding ``state.pt`` (model ``state_dict``,
optimizer ``state_dict``, generator state, step) and ``meta.json`` (iter,
training_time_seconds).  ``find_max_epoch`` selects 'max' / 'all' / 'best',
where 'best' reads the gathered eval pickle and picks the lowest-CD
iteration.

A checkpoint always holds the one-process keys and shapes.  In a process
group every rank saves and rank 0 writes: a model sharded over the mesh's
``model`` axis (``parallel.shard_params``) is gathered whole to be saved, a
collective.  A loaded checkpoint is sliced to what each rank stores: one
process resumes a sharded run's checkpoint, and a sharded run resumes one
process's.
"""

from __future__ import annotations

import json
import os
import pickle
import re
from typing import Optional

import numpy as np
import torch

from ..parallel.mesh import (
    full_optimizer_state_dict,
    full_state_dict,
    shard_optimizer_state_dict,
    shard_state_dict,
)
from ..parallel.multihost import process_index
from .step import TrainState

CKPT_PREFIX = "pointnet_ckpt"
STATE_FILE = "state.pt"


def _ckpt_dir(path: str, it: int) -> str:
    return os.path.join(path, f"{CKPT_PREFIX}_{it}")


def save_checkpoint(path: str, it: int, state: TrainState,
                    training_time_seconds: float = 0.0) -> str:
    """Write a checkpoint at iteration ``it``; returns its directory.  Every
    rank of a process group calls it (a sharded model is gathered first) and
    rank 0 alone writes."""
    target = _ckpt_dir(path, it)
    blob = {
        "model_state_dict": full_state_dict(state.model),
        "optimizer_state_dict": full_optimizer_state_dict(state.model, state.optimizer),
        "generator_state": state.generator.get_state(),
        "step": int(state.step),
    }
    if process_index() != 0:
        return target
    os.makedirs(target, exist_ok=True)
    torch.save(blob, os.path.join(target, STATE_FILE))
    with open(os.path.join(target, "meta.json"), "w") as f:
        json.dump({"iter": it, "training_time_seconds": training_time_seconds}, f)
    return target


def find_max_epoch(path: str, mode: str = "max", eval_result_path: Optional[str] = None):
    """Scan for saved iterations.

    mode='max' -> latest iteration (or -1); 'all' -> sorted desc list;
    'best' -> iteration with the lowest avg test CD from the gathered eval
    results file.
    """
    if not os.path.isdir(path):
        return -1 if mode != "all" else []
    iters = []
    pat = re.compile(rf"^{CKPT_PREFIX}_(\d+)$")
    for f in os.listdir(path):
        m = pat.match(f)
        if m and "best" not in f:
            iters.append(int(m.group(1)))
    if mode == "max":
        return max(iters) if iters else -1
    if mode == "all":
        return sorted(iters, reverse=True)
    if mode == "best":
        eval_file = eval_result_path or os.path.join(
            path, "../../eval_result/gathered_eval_result.pkl"
        )
        with open(eval_file, "rb") as f:
            data = pickle.load(f)
        cd = np.asarray(data["avg_cd"])
        idx = int(np.argmin(cd))
        return int(data["iter"][idx])
    raise ValueError(f"{mode} mode is not supported")


def load_checkpoint(path: str, it: int, state: TrainState):
    """Restore the checkpoint of iteration ``it`` into ``state`` in place
    (parameters, Adam moments, generator, step), sliced to what each rank
    stores where the model is sharded.  Returns (state,
    training_time_seconds)."""
    target = _ckpt_dir(path, it)
    device = next(state.model.parameters()).device
    blob = torch.load(os.path.join(target, STATE_FILE), map_location=device,
                      weights_only=True)
    state.model.load_state_dict(shard_state_dict(state.model, blob["model_state_dict"]),
                                strict=True)
    state.optimizer.load_state_dict(shard_optimizer_state_dict(
        state.model, state.optimizer, blob["optimizer_state_dict"]))
    state.generator.set_state(blob["generator_state"].cpu())
    state.step = int(blob["step"])
    secs = 0.0
    meta = os.path.join(target, "meta.json")
    if os.path.exists(meta):
        with open(meta) as f:
            secs = json.load(f).get("training_time_seconds", 0.0)
    return state, secs


def maybe_resume(path: str, ckpt_iter, state: TrainState):
    """ckpt_iter='max' or an int; returns (state or None, iter, seconds),
    falling back to a fresh start when no valid checkpoint is found."""
    if ckpt_iter == "max":
        ckpt_iter = find_max_epoch(path, "max")
    if ckpt_iter is None or int(ckpt_iter) < 0:
        return None, -1, 0.0
    try:
        state, secs = load_checkpoint(path, int(ckpt_iter), state)
        return state, int(ckpt_iter), secs
    except (OSError, KeyError, RuntimeError, pickle.UnpicklingError) as e:
        print(f"No valid checkpoint model found ({e}); training from scratch.")
        return None, -1, 0.0
