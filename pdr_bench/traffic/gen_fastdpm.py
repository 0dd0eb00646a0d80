"""Generation traffic: closed-loop batches of coarse completions through the
port's FastDPM sampler (``sample/generate.py::make_coarse_sampler``).

The mix's parameters: ``batch_size``; the FastDPM plan (``fast_length``,
``sampling_method``, ``noise_schedule``, ``kappa``); ``segment_size``
(null: the plan's length, the whole program as one chunk of replays of
the captured step); the inference routes ``fused_attention`` and
``fused_knn``; ``checked_clouds``, how many of the window's clouds the
reference recomputes.

Batch b's inputs (mirrored partial scans, labels, x_T and every step's
noise) are drawn on the device from (seed, b), so the same seed gives the
same batches; the window runs batches one after another until its time
is up and ends on a batch boundary.  The check draws ``checked_clouds``
clouds from the seed among those the window completed, makes their inputs
again and runs FastDPM on the float32 reference; it compares each
cloud's x0 with the program's.
"""

from __future__ import annotations

import time

import torch
from torch.profiler import record_function

from pdr_bench import inputs, work
from pdr_bench.reference import model as ref
from pdr_bench.weights import make_weights, parameter_shapes


class Cell:
    kind = "gen"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.device = torch.device(device)
        self.B = int(traffic["batch_size"])
        self.N = int(config["npoints"])
        self.routes = dict(fused_attention=bool(traffic["fused_attention"]),
                           fused_knn=bool(traffic["fused_knn"]))
        self.capture_s = None
        self.outputs = []

    # ---- the program ------------------------------------------------------
    def setup(self) -> None:
        from point_diffusion_refinement_tpu_torch.diffusion import (
            calc_diffusion_hyperparams,
            make_fast_sampling_plan,
        )
        from point_diffusion_refinement_tpu_torch.models import PointNet2CloudCondition
        from point_diffusion_refinement_tpu_torch.sample import make_coarse_sampler

        if self.device.type == "cuda":
            from point_diffusion_refinement_tpu_torch.ops import kernels
            kernels.build()
        tr, dc = self.traffic, self.config["diffusion_config"]
        model = PointNet2CloudCondition.from_config(self.config["pointnet_config"],
                                                    device=self.device, seed=None)
        self.weights = make_weights(parameter_shapes(model), self.seed, self.device)
        model.load_state_dict(self.weights, strict=True)
        schedule = calc_diffusion_hyperparams(dc["T"], dc["beta_0"], dc["beta_T"])
        plan = make_fast_sampling_plan(
            schedule, dc["T"], dc["beta_0"], dc["beta_T"], length=int(tr["fast_length"]),
            sampling_method=tr["sampling_method"], noise_schedule=tr["noise_schedule"],
            kappa=float(tr["kappa"]))
        self.S = int(plan.tau.shape[0])
        segment = tr.get("segment_size") or self.S
        self.sampler = make_coarse_sampler(model, schedule, self.N, fast_plan=plan,
                                           segment_size=segment, **self.routes)
        self.model = model
        # the warm-up batch (its own inputs): the step's eager warm-up, the
        # capture and the replays of one whole batch
        t = time.perf_counter()
        self._batch(-1)
        self._sync()
        self.capture_s = time.perf_counter() - t

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def inputs(self, b: int):
        """Batch b's condition, label, x_T and noise (S, B, N, 3)."""
        g = inputs.generator(self.device, self.seed, 1, b)
        cond = inputs.conditions(g, self.B, self.config["number_partial_points"], self.device)
        label = inputs.labels(g, self.B, self.device)
        x_T = torch.randn(self.B, self.N, 3, generator=g, device=self.device)
        noise = torch.randn(self.S, self.B, self.N, 3, generator=g, device=self.device)
        return cond, label, x_T, noise

    def _batch(self, b: int) -> torch.Tensor:
        with record_function("bench.inputs"):
            cond, label, x_T, noise = self.inputs(b)
        with record_function("bench.batch"):
            return self.sampler(cond, label, x_T=x_T, noise=noise)

    def window(self, seconds: float) -> dict:
        self._sync()
        t0 = time.perf_counter()
        t = t0
        while t - t0 < seconds:
            self.outputs.append(self._batch(len(self.outputs)))
            self._sync()
            t = time.perf_counter()
        failed = sum(int((~torch.isfinite(x).flatten(1).all(dim=1)).sum())
                     for x in self.outputs)
        units = len(self.outputs) * self.B
        return {"units": units, "seconds": t - t0, "steps": len(self.outputs) * self.S,
                "attempted": units, "failed": failed}

    def traced_span(self) -> dict:
        """One more batch (its inputs are the next index's)."""
        self._batch(len(self.outputs) + 1_000_000)
        return {"units": self.B, "steps": self.S}

    def release(self) -> None:
        if self.sampler.graphs is not None:
            self.sampler.graphs.release()
        self.sampler = self.model = None

    # ---- the reference ----------------------------------------------------
    def _checked(self):
        """The checked clouds: (batch, row) pairs drawn from the seed."""
        total = len(self.outputs) * self.B
        k = min(int(self.traffic["checked_clouds"]), total)
        g = torch.Generator()
        g.manual_seed(self.seed % (2 ** 63))
        picks = sorted(torch.randperm(total, generator=g)[:k].tolist())
        return [(p // self.B, p % self.B) for p in picks]

    def reference_inputs(self):
        """The checked clouds' inputs, made again, and the program's x0."""
        rows = {}
        for b, r in self._checked():
            rows.setdefault(b, []).append(r)
        parts = []
        for b, rs in rows.items():
            cond, label, x_T, noise = self.inputs(b)
            idx = torch.tensor(rs, device=self.device)
            parts.append((cond[idx], label[idx], x_T[idx], noise[:, idx],
                          self.outputs[b][idx]))
        return [torch.cat(t, dim=1 if i == 3 else 0) for i, t in enumerate(zip(*parts))]

    def reference_x0(self, precision: str, cond, label, x_T, noise) -> torch.Tensor:
        tr = self.traffic
        plan = ref.fast_plan(self.config["diffusion_config"], int(tr["fast_length"]),
                             tr["sampling_method"], tr["noise_schedule"], float(tr["kappa"]))
        net = ref.build(self.config["pointnet_config"], self.weights, precision, self.device)
        with ref.exact_float32():
            return ref.sample(net, plan, cond, label, x_T, noise, self.routes)

    def check(self) -> dict:
        cond, label, x_T, noise, got = self.reference_inputs()
        want = self.reference_x0("float32", cond, label, x_T, noise)
        return compare_clouds(got, want)

    def count_work(self) -> dict:
        """FLOPs and kernel work of one cloud, on the reference in the
        configuration's precision: the whole FastDPM sample of the checked
        clouds (the encode and every reverse step, on the x_t that the
        steps reach, which set how full the balls are)."""
        from torch.utils.flop_counter import FlopCounterMode

        cond, label, x_T, noise, _ = self.reference_inputs()
        k = cond.shape[0]
        tr = self.traffic
        plan = ref.fast_plan(self.config["diffusion_config"], int(tr["fast_length"]),
                             tr["sampling_method"], tr["noise_schedule"], float(tr["kappa"]))
        net = ref.build(self.config["pointnet_config"], self.weights, "bfloat16", self.device)
        tally = work.Tally()
        with FlopCounterMode(display=False) as fc:
            with work.spy(tally):
                ref.sample(net, plan, cond, label, x_T, noise, self.routes)
        return {"flops_per_unit": fc.get_total_flops() / k,
                "tally_per_unit": tally.scaled(1.0 / k)}


def compare_clouds(got: torch.Tensor, want: torch.Tensor) -> dict:
    """The program's clouds against the reference's, (k, N, 3) each.

    ``x0_point_gap_median``: each point's distance from its reference point
    over the reference cloud's RMS radius about its centroid, the median
    point's, the mean over clouds.  A cloud's whole-cloud gaps are also
    given: its relative L2 gap (the mean over clouds and the largest) and
    the widest gap of a coordinate over the reference's largest magnitude.
    """
    got, want = got.to(torch.float32), want.to(torch.float32)
    diff = got - want
    rel = diff.flatten(1).norm(dim=1) / want.flatten(1).norm(dim=1).clamp(min=1e-30)
    centred = want - want.mean(1, keepdim=True)
    radius = centred.square().sum(-1).mean(1).sqrt().clamp(min=1e-30)
    point = diff.norm(dim=-1) / radius[:, None]
    widest = diff.abs().amax() / want.abs().amax().clamp(min=1e-30)
    return {"x0_point_gap_median": float(point.median(dim=1).values.mean()),
            "x0_rel_l2_mean": float(rel.mean()), "x0_rel_l2": float(rel.max()),
            "x0_widest_gap": float(widest)}
