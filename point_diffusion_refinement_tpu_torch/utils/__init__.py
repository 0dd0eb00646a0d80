from .device import resolve_device
from .logging import TensorBoardLogger
from .meters import AverageMeter
from .weights import (
    adam_state_to_flax,
    flax_to_state_dict,
    load_adam_state,
    load_flax_params,
    state_dict_to_flax,
)

__all__ = [
    "AverageMeter",
    "TensorBoardLogger",
    "adam_state_to_flax",
    "flax_to_state_dict",
    "load_adam_state",
    "load_flax_params",
    "resolve_device",
    "state_dict_to_flax",
]
