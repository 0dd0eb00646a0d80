from .exp_configs import EXPERIMENTS, ddpm_config, refine_config, write_all
from .loader import (
    DEFAULT_POINTNET_CONFIG,
    find_config_file,
    load_config,
    merge_refine_config,
    restore_string_to_list_in_a_dict,
    tiny_pointnet_config,
)

__all__ = [
    "DEFAULT_POINTNET_CONFIG",
    "EXPERIMENTS",
    "ddpm_config",
    "find_config_file",
    "load_config",
    "merge_refine_config",
    "refine_config",
    "restore_string_to_list_in_a_dict",
    "tiny_pointnet_config",
    "write_all",
]
