from .ddpm import q_sample, sampling, training_loss
from .fastdpm import FastSamplingPlan, fast_sampling, make_fast_sampling_plan
from .schedule import DiffusionSchedule, calc_diffusion_hyperparams, calc_t_emb

__all__ = [
    "DiffusionSchedule",
    "FastSamplingPlan",
    "calc_diffusion_hyperparams",
    "calc_t_emb",
    "fast_sampling",
    "make_fast_sampling_plan",
    "q_sample",
    "sampling",
    "training_loss",
]
