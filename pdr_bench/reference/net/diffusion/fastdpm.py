"""FastDPM accelerated sampling (VAR / STEP schedules, generalized DDIM).

Counterpart of the JAX package's ``diffusion/fastdpm.py``.  The schedule
searches (bisection for the VAR beta endpoint, continuous-step adaptation
via a Stirling log-Gamma approximation) run on the host in float64 numpy,
copied from the JAX package; they yield per-step affine coefficients
(scale, eps coefficient, sigma) and the fractional timestep tau fed to the
network.  ``fast_sampling`` is a Python loop of S denoiser calls over that
plan; ``make_segmented_fast_sampler`` replays the same step as a captured
CUDA graph (``utils/graphs.py``), the counterpart of the JAX package's
jitted sampler.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

# denoise_fn(x: (B, N, 3), ts: (B,) float32) -> eps_hat (B, N, 3)
DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
from .schedule import DiffusionSchedule


def bisearch(f, domain, target, eps=1e-8):
    """Smallest x with f(x) > target."""
    sign = -1 if target < 0 else 1
    left, right = domain
    x = (left + right) / 2
    for _ in range(1000):
        x = (left + right) / 2
        if f(x) < target:
            right = x
        elif f(x) > (1 + sign * eps) * target:
            left = x
        else:
            break
    return x


def get_VAR_noise(S: int, T: int, beta_0: float, beta_T: float, schedule="linear"):
    """VAR noise levels matching the total noise of the full schedule."""
    target = np.prod(1 - np.linspace(beta_0, beta_T, T))
    if schedule == "linear":
        g = lambda x: np.linspace(beta_0, x, S)
        domain = (beta_0, 0.99)
    elif schedule == "quadratic":
        g = lambda x: np.array([beta_0 * (1 + i * x) ** 2 for i in range(S)])
        domain = (0.0, 0.95 / np.sqrt(beta_0) / S)
    else:
        raise NotImplementedError(schedule)
    f = lambda x: np.prod(1 - g(x))
    largest_var = bisearch(f, domain, target, eps=1e-4)
    return g(largest_var)


def get_STEP_step(S: int, T: int, schedule="linear"):
    """STEP subsequence of timesteps."""
    if schedule == "linear":
        c = (T - 1.0) / (S - 1.0)
        list_tau = [np.floor(i * c) for i in range(S)]
    elif schedule == "quadratic":
        list_tau = np.linspace(0, np.sqrt(T * 0.8), S) ** 2
    else:
        raise NotImplementedError(schedule)
    return [int(s) for s in list_tau]


def _log_gamma(x):
    # Stirling: Gamma(x+1) ~= sqrt(2 pi x) (x/e)^x (1 + 1/12x)
    y = x - 1
    return np.log(2 * np.pi * y) / 2 + y * (np.log(y) - 1) + np.log(1 + 1 / (12 * y))


def _log_cont_noise(t, beta_0, beta_T, T):
    delta_beta = (beta_T - beta_0) / (T - 1)
    _c = (1.0 - beta_0) / delta_beta
    t_1 = t + 1
    return t_1 * np.log(delta_beta) + _log_gamma(_c + 1) - _log_gamma(_c - t_1 + 1)


def precompute_VAR_steps(
    alpha_bar: np.ndarray, beta_0: float, beta_T: float, user_defined_eta: np.ndarray
):
    """Map the VAR noise schedule onto fractional timesteps of the trained
    model (decreasing)."""
    T = len(alpha_bar)
    T_user = len(user_defined_eta)
    gamma_bar = np.cumprod(1 - user_defined_eta)
    # small slack: schedule arrays round-trip through float32 on device
    assert gamma_bar[0] <= alpha_bar[0] * (1 + 1e-6)
    assert gamma_bar[-1] >= alpha_bar[-1] * (1 - 1e-4)
    continuous_steps = []
    for t in range(T_user - 1, -1, -1):
        t_adapted = None
        for i in range(T - 1):
            if alpha_bar[i] >= gamma_bar[t] > alpha_bar[i + 1]:
                t_adapted = bisearch(
                    f=lambda _t: _log_cont_noise(_t, beta_0, beta_T, T),
                    domain=(i - 0.01, i + 1.01),
                    target=np.log(gamma_bar[t]),
                )
                break
        if t_adapted is None:
            t_adapted = T - 1
        continuous_steps.append(t_adapted)  # decreasing
    return continuous_steps


@dataclasses.dataclass(frozen=True)
class FastSamplingPlan:
    """Per-step coefficients of the generalized-DDIM update
    ``x <- x * scale + c * eps_theta + sigma * z``, each an (S,) float32
    tensor; tau is the (possibly fractional) timestep fed to the network."""

    tau: torch.Tensor
    scale: torch.Tensor
    c: torch.Tensor
    sigma: torch.Tensor

    @property
    def S(self) -> int:
        return int(self.tau.shape[0])


def _plan_from_gamma(taus, gamma_bar, kappa: float) -> FastSamplingPlan:
    """Shared math of VAR and STEP sampling: given the decreasing sequence
    of (tau_i, gamma_bar_i), build the per-step coefficients."""
    S = len(taus)
    scale = np.zeros(S)
    c = np.zeros(S)
    sigma = np.zeros(S)
    for i in range(S):
        cur = gamma_bar[i]
        if i == S - 1:
            alpha_next, sig = 1.0, 0.0
        else:
            alpha_next = gamma_bar[i + 1]
            sig = kappa * np.sqrt((1 - alpha_next) / (1 - cur) * (1 - cur / alpha_next))
        scale[i] = np.sqrt(alpha_next / cur)
        c[i] = np.sqrt(1 - alpha_next - sig ** 2) - np.sqrt(1 - cur) * np.sqrt(
            alpha_next / cur
        )
        sigma[i] = sig
    f32 = lambda x: torch.from_numpy(np.asarray(x, dtype=np.float32))
    return FastSamplingPlan(tau=f32(taus), scale=f32(scale), c=f32(c), sigma=f32(sigma))


def make_fast_sampling_plan(
    schedule: DiffusionSchedule,
    T: int,
    beta_0: float,
    beta_T: float,
    length: int = 100,
    sampling_method: str = "var",
    noise_schedule: str = "quadratic",
    kappa: float = 0.5,
) -> FastSamplingPlan:
    """Host-side plan builder for the VAR and STEP methods.  ``schedule`` is
    not read: alpha_bar is recomputed in float64, because the bracket
    search of the VAR method needs alpha_bar[0] == 1 - beta_0 exactly."""
    if sampling_method not in ("var", "step"):
        raise ValueError(f"sampling_method must be 'var' or 'step', got {sampling_method!r}")
    if noise_schedule not in ("linear", "quadratic"):
        raise ValueError(
            f"noise_schedule must be 'linear' or 'quadratic', got {noise_schedule!r}")
    alpha_bar = np.cumprod(1.0 - np.linspace(beta_0, beta_T, T))
    if sampling_method == "var":
        eta = get_VAR_noise(length, T, beta_0, beta_T, noise_schedule)
        taus = precompute_VAR_steps(alpha_bar, beta_0, beta_T, eta)
        # step i visits gamma_bar[length-1-i]; taus is already decreasing
        gamma = np.cumprod(1 - eta)[::-1]
    else:
        steps = sorted(get_STEP_step(length, T, noise_schedule), reverse=True)
        taus = [float(s) for s in steps]
        gamma = alpha_bar[np.asarray(steps, dtype=np.int64)]
    return _plan_from_gamma(np.asarray(taus, dtype=np.float64), np.asarray(gamma), kappa)


def fast_inputs(plan: FastSamplingPlan, B: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-step inputs of the plan's S steps: ts (S, B), row i = tau_i,
    and coefs (S, 3) of [scale_i, c_i, sigma_i].  A captured step reads its
    coefficients from these rows."""
    p = FastSamplingPlan(*(t.to(device) for t in dataclasses.astuple(plan)))
    ts = p.tau[:, None].expand(-1, B).contiguous()
    return ts, torch.stack([p.scale, p.c, p.sigma], dim=1)


def fast_step(denoise_fn: DenoiseFn, x: torch.Tensor, ts: torch.Tensor, coefs: torch.Tensor,
              z: torch.Tensor) -> torch.Tensor:
    """One generalized-DDIM step, x * scale + c * eps + sigma * z, with
    ``ts`` and ``coefs`` a row of ``fast_inputs``."""
    eps = denoise_fn(x, ts)
    return x * coefs[0] + coefs[1] * eps + coefs[2] * z


def _fast_reverse(step, shape, plan: FastSamplingPlan, *, device, generator, x_T, noise,
                  segment_size: Optional[int]) -> torch.Tensor:
    """The loop around ``step(x, ts, coefs, z) -> x`` in chunks of
    ``segment_size`` steps (all in one without).  Draws x_T, then one z a
    step, from ``generator`` where they are not given."""
    shape = tuple(shape)
    if x_T is None:
        x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    else:
        x = x_T.to(device=device, dtype=torch.float32)
    if noise is not None and tuple(noise.shape) != (plan.S,) + shape:
        raise ValueError(f"noise must be {(plan.S,) + shape}, got {tuple(noise.shape)}")
    ts_rows, coef_rows = fast_inputs(plan, shape[0], device)
    seg = segment_size or plan.S
    for first in range(0, plan.S, seg):
        for i in range(first, min(first + seg, plan.S)):
            if noise is not None:
                z = noise[i].to(device=device, dtype=torch.float32)
            else:
                z = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
            x = step(x, ts_rows[i], coef_rows[i], z)
    return x.clone()


def fast_sampling(
    denoise_fn: DenoiseFn,
    shape: Sequence[int],
    plan: FastSamplingPlan,
    *,
    device,
    generator: Optional[torch.Generator] = None,
    x_T: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The generalized-DDIM loop over a precomputed plan.

    Args:
      denoise_fn: closure over the model and condition features.
      shape: (B, N, 3).
      plan: from ``make_fast_sampling_plan``.
      device: where the state lives.
      generator: draws x_T and the per-step noise when they are not given.
      x_T: optional starting noise of ``shape``.
      noise: optional (S, *shape) per-step noise, row i used at step i (the
        last step's sigma is 0, so its row does not change the result).

    Returns:
      x_0 of ``shape``, float32.
    """
    def step(x, ts, coefs, z):
        return fast_step(denoise_fn, x, ts, coefs, z)

    return _fast_reverse(step, shape, plan, device=device, generator=generator, x_T=x_T,
                         noise=noise, segment_size=None)
