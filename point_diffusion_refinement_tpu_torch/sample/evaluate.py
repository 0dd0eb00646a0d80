"""The shared inference and evaluation loop.

Counterpart of the JAX package's ``sample/evaluate.py``: per batch,
generate (a coarse sampler or one refine forward, behind ``generate_fn``),
optionally un-augment, normalize by 2 * scale, compute CD-p, CD-t and F1,
and EMD in batches of ``emd_eval_batch`` when asked; keep per-sample
metrics, and optionally rewrite an h5 of every generated cloud after each
batch (only where ``h5py`` imports).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from ..ops.chamfer import calc_cd
from ..ops.emd import earth_mover_distance
from ..utils.meters import AverageMeter
from .generate import unaugment

try:
    import h5py
except ImportError:  # pragma: no cover
    h5py = None


@dataclass
class EvalResult:
    avg_cd: float
    avg_emd: float
    labels: np.ndarray
    metrics: dict  # cd_distance, emd_distance, cd_p, f1: per-sample arrays
    total_generation_time: float = 0.0
    generated: Optional[np.ndarray] = None
    t_slices: Optional[dict] = None


def _synchronize(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def evaluate(
    generate_fn: Callable,
    batches: Iterable[dict],
    *,
    scale: float = 1.0,
    f1_threshold: float = 1e-4,
    compute_emd: bool = True,
    save_generated_samples: bool = False,
    save_dir: Optional[str] = None,
    save_name: str = "mvp_generated_data_{n}pts.h5",
    keep_generated: bool = False,
    unaugment_results: bool = False,
    print_every: int = 10,
    emd_eval_batch: int = 32,
) -> EvalResult:
    """Run generation and metrics over an iterator of host batches.

    Args:
      generate_fn: (batch dict) -> generated (B, N, 3) tensor, or
        (generated, {t: slice}) when capturing t-slices.  The metrics run
        on the generated tensor's device.
      batches: dicts of numpy arrays with 'complete' and 'label' (and
        'M_inv', 'translation' to un-augment, plus what ``generate_fn``
        reads).
    """
    cd_meter, emd_meter, f1_meter = AverageMeter(), AverageMeter(), AverageMeter()
    all_metrics = {"cd_distance": [], "emd_distance": [], "cd_p": [], "f1": []}
    labels = []
    total_generated = []
    slice_acc: dict = {}
    total_time = 0.0

    for idx, batch in enumerate(batches):
        t0 = time.time()
        out = generate_fn(batch)
        slices = None
        if isinstance(out, tuple):
            out, slices = out
        _synchronize(out)
        total_time += time.time() - t0
        dev = out.device
        out = out.to(torch.float32)
        gt = torch.as_tensor(np.asarray(batch["complete"], np.float32)).to(dev)

        if unaugment_results:
            M_inv = torch.as_tensor(np.asarray(batch["M_inv"], np.float32)).to(dev)
            translation = torch.as_tensor(np.asarray(batch["translation"], np.float32)).to(dev)
            out = unaugment(out, M_inv, translation)
            gt = unaugment(gt, M_inv, translation)
            if slices is not None:
                slices = {t: unaugment(v, M_inv, translation) for t, v in slices.items()}
        out = out / 2.0 / scale
        gt = gt / 2.0 / scale
        if slices is not None:
            slices = {t: (v / 2.0 / scale).cpu().numpy() for t, v in slices.items()}

        with torch.no_grad():
            cd_p, cd_t, f1 = calc_cd(out, gt, True, f1_threshold)
            if compute_emd:
                emd = torch.cat([
                    earth_mover_distance(out[i: i + emd_eval_batch], gt[i: i + emd_eval_batch])
                    for i in range(0, out.shape[0], emd_eval_batch)
                ])
            else:
                emd = torch.zeros_like(cd_t)

        B = int(gt.shape[0])
        cd_meter.update(float(cd_t.mean()), n=B)
        emd_meter.update(float(emd.mean()), n=B)
        f1_meter.update(float(f1.mean()), n=B)
        all_metrics["cd_distance"].append(cd_t.cpu().numpy())
        all_metrics["emd_distance"].append(emd.cpu().numpy())
        all_metrics["cd_p"].append(cd_p.cpu().numpy())
        all_metrics["f1"].append(f1.cpu().numpy())
        labels.append(np.asarray(batch["label"]))

        if save_generated_samples or keep_generated:
            total_generated.append(out.cpu().numpy())
        if slices is not None:
            for t, v in slices.items():
                slice_acc.setdefault(t, []).append(v)

        if save_generated_samples:
            _write_h5_incremental(save_dir, save_name, total_generated, slice_acc)

        if idx % max(print_every, 1) == 0:
            print(
                f"progress [{idx}] CD {cd_meter.avg:.8f} EMD {emd_meter.avg:.8f} "
                f"F1 {f1_meter.avg:.6f} total generation time {total_time:.2f}s",
                flush=True,
            )

    gen = np.concatenate(total_generated, axis=0) if total_generated else None
    return EvalResult(
        avg_cd=cd_meter.avg,
        avg_emd=emd_meter.avg,
        labels=np.concatenate(labels) if labels else np.zeros(0, np.int64),
        metrics={k: np.concatenate(v) if v else np.zeros(0) for k, v in all_metrics.items()},
        total_generation_time=total_time,
        generated=gen if keep_generated or save_generated_samples else None,
        t_slices=(
            {t: np.concatenate(v, axis=0) for t, v in slice_acc.items()}
            if slice_acc
            else None
        ),
    )


def _write_h5_incremental(save_dir, save_name, total_generated, slice_acc):
    """Rewrite the whole h5 after each batch (no-op without ``h5py``)."""
    if h5py is None or save_dir is None:
        return
    os.makedirs(save_dir, exist_ok=True)
    data = np.concatenate(total_generated, axis=0)
    n = data.shape[1]
    with h5py.File(os.path.join(save_dir, save_name.format(n=n)), "w") as f:
        f.create_dataset("data", data=data)
    for t, chunks in slice_acc.items():
        sdata = np.concatenate(chunks, axis=0)
        name = save_name.format(n=sdata.shape[1]).replace(".h5", f"_T{t}.h5")
        with h5py.File(os.path.join(save_dir, name), "w") as f:
            f.create_dataset("data", data=sdata)
