"""Training traffic: the port's batch iterator feeding its compiled training
step, as ``train/loop.py::train`` runs them.

The mix's parameters: ``batch_size``; ``items``, the size of the
synthetic training set; ``first_steps``, the steps that set-up drives and
the check compares (the update's eager warm-up, its capture, a replay);
``traced_steps``; ``reference_block``, the rows a block of the
reference's forward and backward.

The configuration's task picks the step: ``completion`` takes
``make_completion_train_step`` (DDPM epsilon-MSE, t and z drawn by the
benchmark from the seed and passed in), ``refine_completion``
``make_refine_train_step`` with the configuration's chamfer loss, upsampling
and output scale.  The items (complete clouds, mirrored partial scans,
labels and, for refinement, coarse clouds standing in for a DDPM's
output) are made on the device from the seed; ``data/batches.py::
iterate_batches`` shuffles them each epoch from the seed and assembles each
batch item by item with the configuration's augmentation
(``data/augment.py::augment_cloud``), and the batch is copied to the device
as the training loop copies it.  Set-up builds one training state and
drives it through the first steps; the window takes the same state on.

The check rebuilds the first steps' batches without the program
(``reference/data.py``: the same items, seeds and augmentation) and holds
the batches the program fed against them, runs the same first steps on the
float32 reference from the same weights, rebuilt batches, t and z, and
compares each step's loss, the first step's gradient and the last's (each
as Adam took it, from its first moments: the last is a replay of the
captured step, as the window's steps are) and each leaf's change after the
first steps.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from pdr_bench import inputs, work
from pdr_bench.reference import data as ref_data
from pdr_bench.reference import model as ref
from pdr_bench.weights import make_weights, parameter_shapes

BETA1 = 0.9


class Items:
    """The training set behind the per-item interface ``iterate_batches``
    reads: each item's clouds augmented together, and a refine item's
    coarse cloud given the configuration's noise, as ``MVPDataset`` does."""

    CLOUDS = ("partial", "complete", "generated")

    def __init__(self, arrays: dict, augmentation: dict, seed: int):
        from point_diffusion_refinement_tpu_torch.data.augment import augment_cloud

        self.arrays, self.aug = arrays, augmentation
        self.augment = augment_cloud
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.arrays["label"])

    def __getitem__(self, i: int) -> dict:
        keys = [k for k in self.CLOUDS if k in self.arrays]
        clouds = self.augment([self.arrays[k][i] for k in keys], self.aug, rng=self.rng)
        item = dict(zip(keys, clouds))
        sigma = self.aug.get("noise_magnitude_for_generated_samples", 0)
        if "generated" in item and sigma > 0:
            item["generated"] = item["generated"] + self.rng.normal(
                scale=sigma, size=item["generated"].shape).astype(np.float32)
        item["label"] = self.arrays["label"][i]
        return item


class Cell:
    kind = "train"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.device = torch.device(device)
        self.B = int(traffic["batch_size"])
        self.task = config["task"]
        self.first = int(traffic["first_steps"])
        self.capture_s = None
        self.recorded = []  # the first steps' inputs
        self.rebuilt = None
        self.losses = []

    # ---- the program ------------------------------------------------------
    def setup(self) -> None:
        from point_diffusion_refinement_tpu_torch.data import iterate_batches
        from point_diffusion_refinement_tpu_torch.diffusion import calc_diffusion_hyperparams
        from point_diffusion_refinement_tpu_torch.models import PointNet2CloudCondition
        from point_diffusion_refinement_tpu_torch.train.step import (
            create_train_state,
            make_completion_train_step,
            make_refine_train_step,
        )

        if self.device.type == "cuda":
            from point_diffusion_refinement_tpu_torch.ops import kernels
            kernels.build()
        cfg, pc, dc = self.config, self.config["pointnet_config"], self.config["diffusion_config"]
        model = PointNet2CloudCondition.from_config(pc, device=self.device, seed=None)
        self.weights = make_weights(parameter_shapes(model), self.seed, self.device)
        model.load_state_dict(self.weights, strict=True)
        self.initial = self.weights  # the model copied them; training leaves them be
        self.state = create_train_state(model, seed=0, learning_rate=cfg["learning_rate"])
        if self.task == "completion":
            self.T = int(dc["T"])
            schedule = calc_diffusion_hyperparams(dc["T"], dc["beta_0"], dc["beta_T"])
            self.step = make_completion_train_step(model, schedule, compiled=True)
        else:
            self.step = make_refine_train_step(model, compiled=True, **self._refine_args())
        self.params = dict(model.named_parameters())

        upsample = int(pc.get("point_upsample_factor", 1))
        g = inputs.generator(self.device, self.seed, 2)
        items = inputs.completion_items(
            g, int(self.traffic["items"]), cfg["npoints"], cfg["number_partial_points"],
            self.device, coarse_points=cfg["npoints"] // upsample if upsample > 1 else 0)
        self.arrays = {k: v.cpu().numpy() for k, v in items.items()}
        dataset = Items(self.arrays, cfg["augmentation"], self.seed)

        def epochs():
            e = 0
            while True:
                yield from iterate_batches(dataset, self.B, shuffle=True, drop_last=True,
                                           seed=self.epoch_seed(e))
                e += 1

        self.batches = epochs()
        self.draws = inputs.generator(self.device, self.seed, 3)
        self.osf = torch.tensor(float(cfg.get("refine", {}).get("output_scale_factor", 0.0)),
                                device=self.device)

        t = time.perf_counter()
        moments = []  # Adam's first moments after each step
        for i in range(self.first):
            batch = self._next_batch()
            loss = self._step(batch)
            self.losses.append(loss)
            self.recorded.append(batch)
            opt = self.state.optimizer.state
            moments.append({k: (opt[p]["exp_avg"].detach().clone() if "exp_avg" in opt.get(p, {})
                                else torch.zeros_like(p.detach()))
                            for k, p in self.params.items()})
            if i == 1:
                self._sync()
                self.capture_s = time.perf_counter() - t
        # each step's gradient as Adam took it: m_s = beta1 m_(s-1) + (1 - beta1) g_s
        self.grads = [{k: (m[k] - BETA1 * prev[k]) / (1.0 - BETA1) for k in m}
                      for prev, m in zip([{k: 0.0 for k in moments[0]}] + moments, moments)]
        self.after_first = {k: p.detach().clone() for k, p in self.params.items()}

    def epoch_seed(self, e: int) -> int:
        """The seed of epoch e's shuffle."""
        return (self.seed * 1_000_003 + e) % (2 ** 63)

    def _refine_args(self) -> dict:
        pc, rc = self.config["pointnet_config"], self.config["refine"]
        upsample = int(pc.get("point_upsample_factor", 1))
        return dict(
            scale=float(self.config["scale"]), cd_loss_type=rc["cd_loss_type"],
            point_upsample_factor=upsample,
            include_displacement_center=bool(
                pc.get("include_displacement_center_to_final_output", False)),
            intermediate_loss_weight=(float(pc.get("intermediate_refined_X_loss_weight", 0.0))
                                      if upsample > 1 else 0.0),
            task=self.task)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _next_batch(self) -> dict:
        """The next batch on the device, with the step's draws."""
        with record_function("bench.batch"):
            batch = next(self.batches)
            out = {"x0": self._tensor(batch["complete"]),
                   "condition": self._tensor(batch["partial"]),
                   "label": self._tensor(batch["label"], torch.int64)}
            if "generated" in batch:
                out["generated"] = self._tensor(batch["generated"])
        if self.task == "completion":
            out["t"] = torch.randint(0, self.T, (self.B,), generator=self.draws,
                                     device=self.device)
            out["z"] = torch.randn(out["x0"].shape, generator=self.draws, device=self.device)
        else:
            out["output_scale_factor"] = self.osf
        return out

    def _tensor(self, a, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a)).to(device=self.device, dtype=dtype)

    def _step(self, b: dict) -> float:
        with record_function("bench.step"):
            if self.task == "completion":
                self.state, loss = self.step(self.state, b["x0"], b["condition"], b["label"],
                                             b["t"], b["z"])
            else:
                self.state, loss = self.step(self.state, b["x0"], b["condition"], b["label"],
                                             b["generated"], b["output_scale_factor"])
        with record_function("bench.loss_to_host"):
            return float(loss)

    def window(self, seconds: float) -> dict:
        self._sync()
        t0 = time.perf_counter()
        t, steps, batch_s, failed = t0, 0, 0.0, 0
        while t - t0 < seconds:
            tb = time.perf_counter()
            batch = self._next_batch()
            batch_s += time.perf_counter() - tb
            if not np.isfinite(self._step(batch)):
                failed += self.B
            steps += 1
            t = time.perf_counter()
        return {"units": steps * self.B, "seconds": t - t0, "steps": steps,
                "batch_s": batch_s, "attempted": steps * self.B, "failed": failed}

    def traced_span(self) -> dict:
        n = int(self.traffic["traced_steps"])
        for _ in range(n):
            self._step(self._next_batch())
        return {"units": n * self.B, "steps": n}

    def release(self) -> None:
        if self.step.graphs is not None:
            self.step.graphs.release()
        self.step = self.state = self.params = self.batches = None

    # ---- the reference ----------------------------------------------------
    def loss_fn(self, net):
        if self.task == "completion":
            return ref.completion_loss(net, self.config["diffusion_config"])
        a = self._refine_args()
        return ref.refine_loss(net, scale=a["scale"], cd_loss_type=a["cd_loss_type"],
                               point_upsample_factor=a["point_upsample_factor"],
                               include_displacement_center=a["include_displacement_center"],
                               intermediate_loss_weight=a["intermediate_loss_weight"])

    def reference_batches(self, augmentation=None) -> list:
        """The first steps' batches rebuilt by the reference's copy of the
        iterator and augmentation (``augmentation``: the configuration's by
        default), with the benchmark's own draws (t and z, the output scale)
        as the program got them."""
        aug = self.config["augmentation"] if augmentation is None else augmentation
        it = ref_data.training_batches(self.arrays, aug, self.B, self.seed, self.epoch_seed)
        out = []
        for fed in self.recorded:
            b = next(it)
            made = {"x0": b["complete"], "condition": b["partial"], "label": b["label"]}
            if "generated" in b:
                made["generated"] = b["generated"]
            out.append({**fed, **{k: torch.as_tensor(v).to(fed[k]) for k, v in made.items()}})
        return out

    def reference_steps(self, precision: str, fault=None, batches=None):
        """The reference's first steps, on the rebuilt batches or on
        ``batches``."""
        if self.rebuilt is None:
            self.rebuilt = self.reference_batches()
        net = ref.build(self.config["pointnet_config"], self.initial, precision, self.device)
        with ref.exact_float32():
            return ref.train_steps(net, self.loss_fn(net), batches or self.rebuilt,
                                   self.config["learning_rate"],
                                   int(self.traffic["reference_block"]), fault=fault)

    def program_readings(self) -> tuple:
        return self.losses, self.grads, self.after_first

    def check(self) -> dict:
        out = compare_training(self.program_readings(), self.reference_steps("float32"),
                               self.initial)
        out["batch_max_gap"] = batch_gap(self.recorded, self.rebuilt)
        return out

    def count_work(self) -> dict:
        """FLOPs and kernel work of one step, on the reference in the
        configuration's precision: the forward and backward of one block of
        the first batch's rows, scaled to the batch."""
        from torch.utils.flop_counter import FlopCounterMode

        net = ref.build(self.config["pointnet_config"], self.initial, "bfloat16", self.device)
        rows = slice(0, min(int(self.traffic["reference_block"]), self.B))
        tally = work.Tally()
        with FlopCounterMode(display=False) as fc:
            with work.spy(tally):
                self.loss_fn(net)(self.recorded[0], rows).backward()
        scale = self.B / (rows.stop - rows.start)
        return {"flops_per_unit": fc.get_total_flops() * scale / self.B,
                "tally_per_unit": tally.scaled(scale / self.B)}


def _leaf_norms(tree: dict) -> dict:
    return {k: float(v.detach().to(torch.float64).norm()) for k, v in tree.items()}


def norm_gaps(got: dict, want: dict, keep=None) -> dict:
    """Each leaf's gap between the program's norm and the reference's, over
    the larger of that leaf's reference norm and the median leaf's."""
    g, w = _leaf_norms(got), _leaf_norms(want)
    keys = [k for k in w if keep is None or k in keep]
    median = float(np.median([w[k] for k in keys]))
    return {k: abs(g[k] - w[k]) / max(w[k], median, 1e-30) for k in keys}


def batch_gap(fed: list, rebuilt: list) -> float:
    """The largest absolute gap between the batches the program fed and the
    reference's rebuilt ones, over every tensor of every step."""
    return max(float((a[k].to(torch.float64) - b[k].to(torch.float64)).abs().max())
               for a, b in zip(fed, rebuilt) for k in a)


def _grad_gaps(p_grads: dict, r_grads: dict) -> tuple:
    """The worst and the median leaf's gap of gradient norms, and the median
    leaf's 1 - cosine between the two gradients."""
    gnorm = _leaf_norms(r_grads)
    grad = norm_gaps(p_grads, r_grads)
    cos = [1.0 - float(torch.nn.functional.cosine_similarity(
        p_grads[k].flatten().double(), r_grads[k].flatten().double(), dim=0))
        for k in r_grads if gnorm[k] > 0]
    return max(grad.values()), float(np.median(list(grad.values()))), float(np.median(cos))


def compare_training(program, reference, initial: dict) -> dict:
    """Numbers of the first steps: each step's loss (the largest relative
    gap) and the first step's; the first and the last step's gradient (the
    worst leaf's gap of norms, the median leaf's, and the median leaf's
    1 - cosine) and each leaf's change over the steps (the worst leaf's gap
    of norms, and the median leaf's).  A leaf whose first reference
    gradient is under a thousandth of the median leaf's moves under Adam by
    round-off alone, and is left out of the change."""
    p_losses, p_grads, p_after = program
    r_losses, r_grads, r_after = reference
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(p_losses, r_losses))
    gnorm = _leaf_norms(r_grads[0])
    median = float(np.median(list(gnorm.values())))
    moved = {k for k, n in gnorm.items() if n >= 1e-3 * median}
    change = norm_gaps({k: p_after[k] - initial[k] for k in p_after},
                       {k: r_after[k] - initial[k] for k in r_after}, keep=moved)
    first = _grad_gaps(p_grads[0], r_grads[0])
    last = _grad_gaps(p_grads[-1], r_grads[-1])
    return {"loss_rel_gap": float(loss_gap),
            "first_loss_rel_gap": abs(p_losses[0] - r_losses[0]) / max(abs(r_losses[0]), 1e-30),
            "grad_norm_gap": first[0], "grad_norm_gap_median": first[1],
            "grad_cos_gap_median": first[2],
            "last_grad_norm_gap": last[0], "last_grad_norm_gap_median": last[1],
            "last_grad_cos_gap_median": last[2],
            "change_norm_gap": max(change.values()),
            "change_norm_gap_median": float(np.median(list(change.values())))}
