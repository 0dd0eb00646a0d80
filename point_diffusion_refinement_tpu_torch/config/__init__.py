from .exp_configs import EXPERIMENTS, ddpm_config, refine_config, write_all
from .loader import DEFAULT_POINTNET_CONFIG, tiny_pointnet_config

__all__ = [
    "DEFAULT_POINTNET_CONFIG",
    "EXPERIMENTS",
    "ddpm_config",
    "refine_config",
    "tiny_pointnet_config",
    "write_all",
]
