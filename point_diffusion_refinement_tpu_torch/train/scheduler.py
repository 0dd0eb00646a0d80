"""Linear clamp scheduler for the refinement output scale factor.

The port's own copy of the JAX package's ``train/scheduler.py``
(``QuantityScheduler``).  Host-side; the value is passed to the refine step
as a plain float.
"""

from __future__ import annotations


class QuantityScheduler:
    def __init__(
        self,
        init_epoch: int,
        final_epoch: int,
        init_value: float,
        final_value: float,
        num_steps_per_epoch: int,
    ):
        self.init_step = init_epoch * num_steps_per_epoch
        self.final_step = final_epoch * num_steps_per_epoch
        self.init_value = float(init_value)
        self.final_value = float(final_value)
        assert self.final_step >= self.init_step

    def get_quantity(self, global_step: int) -> float:
        if self.init_step == self.final_step:
            return self.final_value
        rate = (global_step - self.init_step) / (self.final_step - self.init_step)
        value = rate * (self.final_value - self.init_value) + self.init_value
        lo = min(self.init_value, self.final_value)
        hi = max(self.init_value, self.final_value)
        return float(min(max(value, lo), hi))
