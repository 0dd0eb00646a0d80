from .device import resolve_device
from .weights import (
    flax_to_state_dict,
    load_flax_params,
    state_dict_to_flax,
)

__all__ = [
    "flax_to_state_dict",
    "load_flax_params",
    "resolve_device",
    "state_dict_to_flax",
]
