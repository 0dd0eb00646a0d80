from .device import resolve_device
from .meters import AverageMeter
from .weights import (
    flax_to_state_dict,
    load_flax_params,
    state_dict_to_flax,
)

__all__ = [
    "AverageMeter",
    "flax_to_state_dict",
    "load_flax_params",
    "resolve_device",
    "state_dict_to_flax",
]
