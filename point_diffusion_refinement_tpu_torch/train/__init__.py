from .checkpoints import (
    CKPT_PREFIX,
    find_max_epoch,
    load_checkpoint,
    maybe_resume,
    save_checkpoint,
)
from .scheduler import QuantityScheduler
from .step import (
    TrainState,
    create_train_state,
    jit_step_for_mesh,
    make_completion_loss,
    make_completion_train_step,
    make_refine_loss,
    make_refine_train_step,
    mesh_step_compiled,
)

__all__ = [
    "CKPT_PREFIX",
    "QuantityScheduler",
    "TrainState",
    "create_train_state",
    "find_max_epoch",
    "jit_step_for_mesh",
    "load_checkpoint",
    "make_completion_loss",
    "make_completion_train_step",
    "make_refine_loss",
    "make_refine_train_step",
    "maybe_resume",
    "mesh_step_compiled",
    "save_checkpoint",
]
