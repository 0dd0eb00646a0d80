"""Eval-result bookkeeping: one metric pickle per evaluated iteration, and
their gather into the file that ``find_max_epoch(mode="best")`` reads.

Counterpart of the JAX package's ``cli/eval_results.py`` (``save_eval_result``
and ``gather_eval_results``; the plots are not ported yet).  Re-gathering
from disk after every eval keeps the evaluations from before a resume.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np


def save_eval_result(path: str, it: int, avg_cd: float, avg_emd: float,
                     metrics: Optional[dict] = None) -> None:
    """Write ``eval_result_ckpt_{it}.pkl`` next to the gathered file."""
    os.makedirs(path, exist_ok=True)
    payload = {"iter": it, "avg_cd": avg_cd, "avg_emd": avg_emd}
    if metrics:
        payload["metrics"] = {k: np.asarray(v) for k, v in metrics.items()}
    with open(os.path.join(path, f"eval_result_ckpt_{it}.pkl"), "wb") as f:
        pickle.dump(payload, f)


def gather_eval_results(path: str, out_name: str = "gathered_eval_result.pkl") -> dict:
    """Merge every ``eval_result_ckpt_<it>.pkl`` under ``path`` (not the
    per-rank ``..._rank_<r>...`` pickles) into ``{"iter", "avg_cd",
    "avg_emd"}`` lists in iteration order, write them to ``out_name`` and
    return them."""
    records = []
    for f in sorted(os.listdir(path)):
        if f.startswith("eval_result_ckpt_") and f.endswith(".pkl") and "_rank_" not in f:
            with open(os.path.join(path, f), "rb") as fh:
                records.append(pickle.load(fh))
    records.sort(key=lambda r: r["iter"])
    gathered = {key: [r[key] for r in records] for key in ("iter", "avg_cd", "avg_emd")}
    with open(os.path.join(path, out_name), "wb") as f:
        pickle.dump(gathered, f)
    return gathered
