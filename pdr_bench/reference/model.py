"""The reference computations: the network in a given precision, FastDPM
from given draws, and training steps from given batches and draws."""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch

from .net.diffusion import fastdpm
from .net.diffusion.schedule import calc_diffusion_hyperparams
from .net.models.common import Dense
from .net.models.condition_net import PointNet2CloudCondition
from .net.models.upsample import point_upsample
from .net.ops.chamfer import calc_cd

PRECISIONS = ("float32", "bfloat16", "fp8")


def build(pointnet_config: dict, weights: Dict[str, torch.Tensor], precision: str,
          device) -> PointNet2CloudCondition:
    """The network of ``pointnet_config`` with ``weights`` (float32
    parameters by name) on ``device``.  ``precision``: 'float32' (the
    reference), 'bfloat16' (the configuration's own compute dtype, for
    counting the work at the program's dtypes) or 'fp8' (the precision
    below bf16, for the control)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    pc = dict(pointnet_config)
    pc["compute_dtype"] = "bfloat16" if precision == "bfloat16" else "float32"
    model = PointNet2CloudCondition(pc)
    model.load_state_dict(weights, strict=True)
    for m in model.modules():
        if isinstance(m, Dense):
            m.fp8 = precision == "fp8"
    return model.to(device).eval()


@contextlib.contextmanager
def exact_float32():
    """float32 products in full float32 (no TF32) inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def fast_plan(diffusion_config: dict, length: int, sampling_method: str, noise_schedule: str,
              kappa: float) -> fastdpm.FastSamplingPlan:
    T, b0, bT = diffusion_config["T"], diffusion_config["beta_0"], diffusion_config["beta_T"]
    return fastdpm.make_fast_sampling_plan(
        calc_diffusion_hyperparams(T, b0, bT), T, b0, bT, length=length,
        sampling_method=sampling_method, noise_schedule=noise_schedule, kappa=kappa)


def encode(model, condition: torch.Tensor):
    with torch.no_grad():
        return model.encode_condition(condition.to(torch.float32))


def denoise_step(model, cond, x: torch.Tensor, ts: torch.Tensor, label: torch.Tensor,
                 routes: dict) -> torch.Tensor:
    """One reverse step's network call, routed as the program's sampler
    routes it (the routes change which functions run, not the math)."""
    with torch.no_grad():
        return model.denoise(x, ts, label, cond, fused=True, **routes)


def sample(model, plan, condition: torch.Tensor, label: torch.Tensor, x_T: torch.Tensor,
           noise: torch.Tensor, routes: dict) -> torch.Tensor:
    """FastDPM's x0 from x_T and the per-step noise (S, B, N, 3)."""
    cond = encode(model, condition)
    with torch.no_grad():
        return fastdpm.fast_sampling(
            lambda x, ts: denoise_step(model, cond, x, ts, label, routes), tuple(x_T.shape),
            plan, device=x_T.device, x_T=x_T, noise=noise)


def completion_loss(model, diffusion_config: dict):
    """loss(batch, rows) of the DDPM step: epsilon-MSE over the rows at the
    batch's t and z."""
    T, b0, bT = diffusion_config["T"], diffusion_config["beta_0"], diffusion_config["beta_T"]
    alpha_bar = calc_diffusion_hyperparams(T, b0, bT).alpha_bar
    device = next(model.parameters()).device
    alpha_bar = alpha_bar.to(device)

    def loss(batch, rows):
        x0, t, z = batch["x0"][rows], batch["t"][rows], batch["z"][rows]
        ab = alpha_bar[t.long()][:, None, None]
        x_t = torch.sqrt(ab) * x0 + torch.sqrt(1.0 - ab) * z
        eps = model(x_t, batch["condition"][rows], t.to(torch.float32), batch["label"][rows])
        return torch.mean(torch.square(eps - z))

    return loss


def refine_loss(model, *, scale: float, cd_loss_type: str, point_upsample_factor: int,
                include_displacement_center: bool, intermediate_loss_weight: float):
    """loss(batch, rows) of the refinement step: the chamfer loss of the
    upsampled cloud against the complete one."""
    idx = 1 if cd_loss_type == "cd_t" else 0

    def loss(batch, rows):
        gen = batch["generated"][rows]
        disp = model(gen, batch["condition"][rows], None, batch["label"][rows])
        refined, inter = point_upsample(gen, disp, point_upsample_factor,
                                        include_displacement_center,
                                        float(batch["output_scale_factor"]))
        x = batch["x0"][rows] / scale / 2.0
        out = calc_cd(refined / scale / 2.0, x)[idx].mean()
        if intermediate_loss_weight > 0:
            out = out + calc_cd(inter / scale / 2.0, x)[idx].mean() * intermediate_loss_weight
        return out

    return loss


def train_steps(model, loss_fn, batches: List[dict], learning_rate: float, block: int,
                fault: Optional[str] = None):
    """Adam steps (optax's defaults, as the program's) over ``batches``,
    each batch's loss and gradient taken in blocks of ``block`` rows (the
    batch's mean, summed block by block).  ``fault='half_batch'`` takes the
    mean over the first half of each batch's rows and leaves out the rest;
    ``'half_batch_replays'`` does so from the second step on (where the
    program replays its captured step).

    Returns (losses, each step's gradients, the parameters after the last
    step), the tensors by parameter name."""
    params = dict(model.named_parameters())
    opt = torch.optim.Adam(params.values(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=0.0, foreach=False)
    losses, grads = [], []
    for s, batch in enumerate(batches):
        B = batch["x0"].shape[0]
        half = fault == "half_batch" or (fault == "half_batch_replays" and s > 0)
        used = B // 2 if half else B
        opt.zero_grad(set_to_none=True)
        total = 0.0
        for a in range(0, used, block):
            rows = slice(a, min(a + block, used))
            n = rows.stop - rows.start
            part = loss_fn(batch, rows) * (n / used)
            part.backward()
            total += float(part.detach())
        losses.append(total)
        grads.append({k: (p.grad.detach().clone() if p.grad is not None
                          else torch.zeros_like(p)) for k, p in params.items()})
        opt.step()
    return losses, grads, {k: p.detach().clone() for k, p in params.items()}
