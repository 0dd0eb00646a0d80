from .ddpm import sampling
from .schedule import DiffusionSchedule, calc_diffusion_hyperparams, calc_t_emb

__all__ = ["DiffusionSchedule", "calc_diffusion_hyperparams", "calc_t_emb", "sampling"]
