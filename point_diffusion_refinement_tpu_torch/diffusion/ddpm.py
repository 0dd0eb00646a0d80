"""DDPM forward process, training loss and ancestral sampling.

Counterpart of the JAX package's ``diffusion/ddpm.py``.  ``q_sample`` and
``training_loss`` are the forward process and the epsilon-prediction MSE of
the training step; their ``t`` and noise can be passed in, so that two
implementations can be fed the same draws.  ``sampling``: the reverse
process is a Python loop of denoiser calls (the caller encodes the
condition once and closes over it in ``denoise_fn``), with the warm start
from a precomputed ``XT`` and the noise-free t-slice capture.  The starting
noise ``x_T`` and the per-step noise can be passed in, so that two
implementations can be fed the same numbers; otherwise they are drawn from
``generator``.  ``make_segmented_sampler`` runs the same reverse steps as a
captured CUDA graph of one step (``utils/graphs.py``), replayed in chunks of
``segment_size`` steps: the counterpart of the JAX package's jitted
segments.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch

from ..utils.graphs import CapturedFunction
from .schedule import DiffusionSchedule

# denoise_fn(x: (B, N, 3), ts: (B,) float32) -> eps_hat (B, N, 3)
DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def q_sample(x0: torch.Tensor, t: torch.Tensor, noise: torch.Tensor,
             schedule: DiffusionSchedule) -> torch.Tensor:
    """Forward-process sample x_t ~ q(x_t | x_0): x0 (B, N, D), t (B,) int,
    noise (B, N, D) standard normal; ``schedule`` on x0's device."""
    ab = schedule.alpha_bar[t.long()][:, None, None]
    return torch.sqrt(ab) * x0 + torch.sqrt(1.0 - ab) * noise


def training_loss(
    denoise_fn: DenoiseFn,
    x0: torch.Tensor,
    schedule: DiffusionSchedule,
    *,
    generator: Optional[torch.Generator] = None,
    t: Optional[torch.Tensor] = None,
    z: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Epsilon-prediction MSE: t ~ U[0, T), z ~ N(0, 1), mean((eps_hat - z)^2).
    ``t`` and ``z`` are drawn from ``generator`` (on x0's device) where they
    are not given."""
    B = x0.shape[0]
    if t is None:
        t = torch.randint(0, schedule.T, (B,), generator=generator, device=x0.device)
    if z is None:
        z = torch.randn(x0.shape, generator=generator, device=x0.device, dtype=x0.dtype)
    x_t = q_sample(x0, t, z, schedule)
    eps_hat = denoise_fn(x_t, t.to(torch.float32))
    return torch.mean(torch.square(eps_hat - z))


def reverse_inputs(schedule: DiffusionSchedule, start: int, B: int, device
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-step inputs of the reverse steps t = start .. 0: ts (n, B)
    float32, row i = start - i, and coefs (n, 3) of
    [(1 - alpha_t) / sqrt(1 - alpha_bar_t), sqrt(alpha_t), sigma_t], with
    sigma_0 = 0 (the last step adds no noise).  A captured step reads its
    t from these rows, never from a Python int baked in at capture."""
    sched = schedule.to(device)
    t = torch.arange(start, -1, -1, device=device)
    one = torch.ones((), dtype=torch.float32, device=device)
    alpha = sched.alpha[t]
    coef = (one - alpha) / torch.sqrt(one - sched.alpha_bar[t])
    sigma = torch.where(t > 0, sched.sigma[t], torch.zeros_like(alpha))
    ts = t.to(torch.float32)[:, None].expand(-1, B).contiguous()
    return ts, torch.stack([coef, torch.sqrt(alpha), sigma], dim=1)


def reverse_step(denoise_fn: DenoiseFn, x: torch.Tensor, ts: torch.Tensor,
                 coefs: torch.Tensor, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ancestral step from x_t: (the noise-free mean, x_{t-1} = mean +
    sigma_t z); ``ts``, ``coefs`` a row of ``reverse_inputs``."""
    eps = denoise_fn(x, ts)
    mean = (x - coefs[0] * eps) / coefs[1]
    return mean, mean + coefs[2] * z


def _reverse(step, shape, schedule: DiffusionSchedule, *, device, generator, x_T, noise,
             t_slices, XT, warm_start_step, segment_size: Optional[int]):
    """The ancestral loop around ``step(x, ts, coefs, z) -> (mean, x)``, in
    chunks of ``segment_size`` steps (all in one without), x and the
    slices carried from chunk to chunk.  Draws x_T, then one z a step for
    t > 0, from ``generator`` where they are not given."""
    shape = tuple(shape)
    sched = schedule.to(device)
    if x_T is None:
        x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    else:
        x = x_T.to(device=device, dtype=torch.float32)
    if XT is not None:
        if warm_start_step is None:
            raise ValueError("a warm start needs warm_start_step")
        x = XT.to(device=device, dtype=torch.float32) + sched.sigma[warm_start_step] * x
        start = warm_start_step - 1
    else:
        start = sched.T - 1
    if noise is not None and tuple(noise.shape) != (start + 1,) + shape:
        raise ValueError(f"noise must be {(start + 1,) + shape}, got {tuple(noise.shape)}")
    slices_t = tuple(int(t) for t in t_slices) if t_slices else ()
    slices: Dict[int, torch.Tensor] = {}
    ts_rows, coef_rows = reverse_inputs(schedule, start, shape[0], device)
    no_noise = torch.zeros(shape, dtype=torch.float32, device=device)  # sigma_0 = 0
    n = start + 1
    seg = segment_size or n
    for first in range(0, n, seg):
        for i in range(first, min(first + seg, n)):
            t = start - i
            if t == 0:
                z = no_noise
            elif noise is not None:
                z = noise[i].to(device=device, dtype=torch.float32)
            else:
                z = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
            mean, x = step(x, ts_rows[i], coef_rows[i], z)
            if t in slices_t:
                slices[t] = mean.clone()
    x = x.clone()
    if slices_t:
        zeros = torch.zeros(shape, dtype=torch.float32, device=device)
        return x, {t: slices.get(t, zeros) for t in slices_t}
    return x


def sampling(
    denoise_fn: DenoiseFn,
    shape: Sequence[int],
    schedule: DiffusionSchedule,
    *,
    device,
    generator: Optional[torch.Generator] = None,
    x_T: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    t_slices: Optional[Sequence[int]] = None,
    XT: Optional[torch.Tensor] = None,
    warm_start_step: Optional[int] = None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, Dict[int, torch.Tensor]]]:
    """Ancestral reverse diffusion p(x_0 | x_T), from t = T-1 down to 0.

    Args:
      denoise_fn: closure over the model and condition features.
      shape: (B, N, 3).
      device: where the state lives.
      generator: draws x_T and the per-step noise when they are not given
        (a generator on ``device``).
      x_T: optional starting noise of ``shape`` (with ``XT``: the noise of
        the warm start).
      noise: optional (n, *shape) per-step noise for the n steps run, row i
        used at the i-th step (t = start-i); the row of the last step
        (t = 0) is not used.
      t_slices: optional t values at which the noise-free state (right
        after the mean update, before sigma_t z is added) is recorded.
      XT, warm_start_step: optional warm start (both or neither):
        x = XT + sigma[warm_start_step] * x_T and the loop starts at
        warm_start_step - 1.

    Returns:
      x_0 of ``shape``, float32; with ``t_slices``, (x_0, {t: slice}).
    """
    def step(x, ts, coefs, z):
        return reverse_step(denoise_fn, x, ts, coefs, z)

    return _reverse(step, shape, schedule, device=device, generator=generator, x_T=x_T,
                    noise=noise, t_slices=t_slices, XT=XT, warm_start_step=warm_start_step,
                    segment_size=None)


def make_segmented_sampler(
    denoise_apply: Callable,
    schedule: DiffusionSchedule,
    segment_size: int = 100,
    t_slices: Optional[Sequence[int]] = None,
):
    """Ancestral sampling as a captured reverse step, run in chunks.

    The math and the draws of ``sampling``, with one reverse step (the
    denoiser, the mean update and the noise term) captured as a CUDA graph
    on the card and replayed for every step, every chunk and every batch
    of a shape.  ``batch_ctx`` (the label and the pre-encoded condition
    features, any nest of tensors) is an input of the captured step, not a
    constant of it, as the JAX segment makes it a traced argument; so are
    x, t (``reverse_inputs``' rows) and z, which is drawn outside the graph
    in the eager loop's order.  The steps run in chunks of
    ``segment_size``, x and the slices carried between them as in the JAX
    package, whose segments bound one device execution; a replay is
    already one, so the size changes neither the result nor the work.
    On CPU tensors the step runs eagerly.

    Args:
      denoise_apply: fn(batch_ctx, x, ts) -> eps; it reads the model's
        parameters in place (``utils/graphs.py`` on their lifetime).
      schedule: DiffusionSchedule.
      segment_size: steps a chunk.
      t_slices: t values at which the noise-free state is recorded.

    Returns fn(batch_ctx, shape, *, device, generator=None, x_T=None,
    noise=None, XT=None, warm_start_step=None) -> x0 [, {t: slice}], with
    ``sampling``'s arguments; its ``graphs`` attribute is the
    ``CapturedFunction`` of the step (``release()`` frees its graphs).
    """
    if segment_size < 1:
        raise ValueError(f"segment_size must be at least 1, got {segment_size}")

    def one_step(x, ts, coefs, z, batch_ctx):
        return reverse_step(lambda x_, ts_: denoise_apply(batch_ctx, x_, ts_), x, ts, coefs, z)

    graphs = CapturedFunction(one_step, clone_outputs=False)

    def sampler(batch_ctx, shape, *, device, generator=None, x_T=None, noise=None, XT=None,
                warm_start_step=None):
        def step(x, ts, coefs, z):
            return graphs(x, ts, coefs, z, batch_ctx)

        return _reverse(step, shape, schedule, device=device, generator=generator, x_T=x_T,
                        noise=noise, t_slices=t_slices, XT=XT,
                        warm_start_step=warm_start_step if XT is not None else None,
                        segment_size=segment_size)

    sampler.graphs = graphs
    return sampler
