from .device import resolve_device
from .logging import TensorBoardLogger
from .meters import AverageMeter
from .profiling import StepTimer, summarize_trace, trace
from .neighbor_stats import (
    NeighborStatsAccumulator,
    count_stats,
    model_neighbor_stats,
    report as neighbor_report,
    sa_ladder_neighbor_stats,
)
from .weights import (
    adam_state_to_flax,
    flax_to_state_dict,
    load_adam_state,
    load_flax_params,
    state_dict_to_flax,
)

__all__ = [
    "AverageMeter",
    "NeighborStatsAccumulator",
    "StepTimer",
    "TensorBoardLogger",
    "adam_state_to_flax",
    "count_stats",
    "flax_to_state_dict",
    "load_adam_state",
    "load_flax_params",
    "model_neighbor_stats",
    "neighbor_report",
    "resolve_device",
    "sa_ladder_neighbor_stats",
    "state_dict_to_flax",
    "summarize_trace",
    "trace",
]
