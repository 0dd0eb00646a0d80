"""Neighbour-count statistics for tuning ball-query radii.

Counterpart of the JAX package's ``utils/neighbor_stats.py``, with the same
output: min / mean / max and deciles of the per-centre in-radius neighbour
count, a line a module, so that radii can be chosen for balls that neither
starve nor saturate nsample.

Two instruments: ``NeighborStatsAccumulator`` merges the count histograms
the network's grouping modules record in training
(``models.modules.collect_neighbor_stats``; the train step's
``record_stats``), and ``model_neighbor_stats`` walks a configuration's
radius ladders once over a sample batch with FPS and the ball query (on a
GPU tensor, kernels #6 and #3).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..ops.neighbors import ball_query
from ..ops.sampling import furthest_point_sample, gather_points

QUANTILES = np.linspace(0.0, 1.0, 11)


class NeighborStatsAccumulator:
    """Per-module neighbour-count histograms summed over forwards."""

    def __init__(self):
        self.hists: dict[str, np.ndarray] = {}
        self.forwards = 0

    def update(self, collection: Mapping[str, torch.Tensor]) -> None:
        """Merge one forward's histograms, ``{"<flax path>/count_hist":
        (nsample + 1,) counts}`` as a train step returns them."""
        if not collection:
            return
        self.forwards += 1
        for name, leaf in collection.items():
            h = np.asarray(torch.as_tensor(leaf).detach().cpu(), np.float64)
            self.hists[name] = self.hists[name] + h if name in self.hists else h

    @staticmethod
    def _stats_from_hist(hist: np.ndarray) -> dict:
        total = hist.sum()
        vals = np.arange(len(hist))
        nz = np.nonzero(hist)[0]
        cum = np.cumsum(hist) / max(total, 1.0)
        quant = np.array([vals[np.searchsorted(cum, q)] for q in
                          np.clip(QUANTILES, 1e-12, 1 - 1e-12)], np.int64)
        return {
            "min": float(nz[0]) if len(nz) else 0.0,
            "mean": float((vals * hist).sum() / max(total, 1.0)),
            "max": float(nz[-1]) if len(nz) else 0.0,
            "quantiles": quant,
        }

    def stats(self) -> dict:
        return {k: self._stats_from_hist(v) for k, v in sorted(self.hists.items())}

    def report(self) -> str:
        """Print and return the per-module min / mean / max and deciles."""
        lines = [
            f"neighbor count stats over {self.forwards} forwards "
            "(min/mean/max + deciles)"
        ]
        for name, s in self.stats().items():
            lines.append(
                f"  {name}: min={s['min']:.0f} mean={s['mean']:.1f} "
                f"max={s['max']:.0f} deciles={list(s['quantiles'])}"
            )
        text = "\n".join(lines)
        print(text, flush=True)
        return text


def count_stats(counts) -> dict:
    counts = np.asarray(torch.as_tensor(counts).cpu(), np.float64).reshape(-1)
    return {
        "min": float(counts.min()),
        "mean": float(counts.mean()),
        "max": float(counts.max()),
        "quantiles": np.quantile(counts, QUANTILES).astype(np.int64),
    }


def _points(x, device=None) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return t.to(device=device or t.device, dtype=torch.float32)


def sa_ladder_neighbor_stats(xyz, npoints, radii, nsamples) -> list[dict]:
    """Count stats of each level of an SA ladder (FPS + ball query a level)
    over sample clouds ``xyz`` (B, N, 3)."""
    out = []
    cur = _points(xyz)
    for npoint, radius, nsample in zip(npoints, radii, nsamples):
        centers = gather_points(cur, furthest_point_sample(cur, int(npoint)))
        _, counts = ball_query(cur, centers, float(radius), int(nsample))
        s = count_stats(counts)
        s.update({"npoint": int(npoint), "radius": float(radius), "nsample": int(nsample)})
        out.append(s)
        cur = centers
    return out


def _fps_ladder(xyz: torch.Tensor, npoints) -> list:
    """Positions at each ladder level: [raw, after SA_0, after SA_1, ...]."""
    levels = [xyz]
    for npoint in npoints:
        levels.append(gather_points(levels[-1], furthest_point_sample(levels[-1], int(npoint))))
    return levels


def _query_stats(src, centers, radius, nsample) -> dict:
    _, counts = ball_query(src, centers, float(radius), int(nsample))
    s = count_stats(counts)
    s.update({"npoint": centers.shape[1], "radius": float(radius), "nsample": int(nsample)})
    return s


def model_neighbor_stats(pointnet_config: dict, x, condition) -> str:
    """The neighbour-count report of a configuration, a section a module
    group: both SA ladders and the encoder / decoder feature transfers, at
    the configuration's radius and nsample ladders, over a sample batch.

    Args:
      pointnet_config: the model config (architecture / condition /
        feature_mapper sections).
      x: (B, N, 3+) the x_t-branch cloud (e.g. complete shapes).
      condition: (B, M, 3+) the condition cloud (e.g. mirrored partials).
    Both are numpy arrays or tensors; the walk runs on their device.
    """
    sf = float(pointnet_config.get("scale_factor", 1.0))
    arch = pointnet_config["architecture"]
    cond_arch = pointnet_config.get("condition_net_architecture", arch)
    mapper = pointnet_config.get("feature_mapper_architecture")
    x = _points(x)
    x_l = _fps_ladder(x[..., :3] / sf, arch["npoint"])
    c_l = _fps_ladder(_points(condition, x.device)[..., :3] / sf, cond_arch["npoint"])

    sections = []

    def ladder(levels, a, name):
        stats = [
            _query_stats(levels[i], levels[i + 1], a["radius"][i], a["nsample"][i])
            for i in range(len(a["npoint"]))
        ]
        sections.append(report(stats, name))

    ladder(x_l, arch, "Input cloud SA_module")
    if pointnet_config.get("include_local_feature", True):
        ladder(c_l, cond_arch, "Condition cloud SA_module")
        if mapper is not None:
            enc = [
                _query_stats(c_l[i], x_l[i], mapper["encoder_radius"][i],
                             mapper["encoder_nsample"][i])
                for i in range(len(mapper["encoder_radius"]))
            ]
            sections.append(report(enc, "Encoder feature mapper (cond -> input)"))
            dec = [
                _query_stats(c_l[i], x_l[i], mapper["decoder_radius"][i],
                             mapper["decoder_nsample"][i])
                for i in range(len(mapper["decoder_radius"]))
            ]
            sections.append(report(dec, "Decoder feature mapper (cond -> input)"))
    return "\n".join(sections)


def report(stats: list[dict], name: str = "SA ladder") -> str:
    lines = [f"{name}: neighbor count stats (min/mean/max + deciles)"]
    for s in stats:
        lines.append(
            f"  npoint={s['npoint']:<6} r={s['radius']:<5} K={s['nsample']:<4}"
            f" min={s['min']:.0f} mean={s['mean']:.1f} max={s['max']:.0f}"
            f" deciles={list(s['quantiles'])}"
        )
    text = "\n".join(lines)
    print(text, flush=True)
    return text
