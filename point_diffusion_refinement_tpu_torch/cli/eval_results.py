"""Eval-result bookkeeping: one metric pickle per evaluated iteration, their
gather into the file that ``find_max_epoch(mode="best")`` reads, and
loss-against-iteration plots.

Counterpart of the JAX package's ``cli/eval_results.py``.  Re-gathering from
disk after every eval keeps the evaluations from before a resume.  The plots
need matplotlib and do nothing without it.
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


def _pyplot():
    """matplotlib's pyplot on the file-only Agg backend, or None."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    return plt


def plot_result(gathered: dict, keys=("avg_cd", "avg_emd"),
                save_path: Optional[str] = None) -> Optional[str]:
    """Loss-against-iteration curves of a gathered result, one panel a key,
    with the minimum marked; saved to ``save_path``.  Returns ``save_path``,
    or None without matplotlib."""
    plt = _pyplot()
    if plt is None:
        return None
    iters = gathered["iter"]
    fig, axes = plt.subplots(1, len(keys), figsize=(6 * len(keys), 4))
    if len(keys) == 1:
        axes = [axes]
    for ax, key in zip(axes, keys):
        vals = np.asarray(gathered[key])
        ax.plot(iters, vals, marker="o", ms=3)
        best = int(np.argmin(vals))
        ax.scatter([iters[best]], [vals[best]], color="red")
        ax.set_title(f"{key} (min {vals[best]:.6f} @ {iters[best]})")
        ax.set_xlabel("iteration")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120)
    plt.close(fig)
    return save_path


def compare_eval_results(gathered_list: list, names: list, key: str = "avg_cd",
                         save_path: Optional[str] = None) -> Optional[str]:
    """The curves of ``key`` from several experiments in one plot.  Returns
    ``save_path``, or None without matplotlib."""
    plt = _pyplot()
    if plt is None:
        return None
    fig, ax = plt.subplots(figsize=(7, 4.5))
    for g, name in zip(gathered_list, names):
        vals = np.asarray(g[key])
        best = int(np.argmin(vals))
        ax.plot(g["iter"], vals, label=f"{name} (min {vals[best]:.6f})")
    ax.set_xlabel("iteration")
    ax.set_ylabel(key)
    ax.legend()
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120)
    plt.close(fig)
    return save_path
