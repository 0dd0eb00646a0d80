"""Minimal scalar logger: TensorBoard if available, else JSONL.

The port's own copy of the JAX package's ``utils/logging.py`` logger:
torch's tensorboard writer is used when importable; otherwise scalars append
to a JSONL file so headless environments still record the training curves.
"""

from __future__ import annotations

import json
import os
import time


class TensorBoardLogger:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir)
        except Exception:
            self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")

    def add_scalar(self, tag: str, value: float, global_step=None):
        if self._tb is not None:
            self._tb.add_scalar(tag, value, global_step=global_step)
        else:
            self._jsonl.write(
                json.dumps(
                    {"tag": tag, "value": float(value), "step": global_step,
                     "time": time.time()}
                )
                + "\n"
            )
            self._jsonl.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()
        else:
            self._jsonl.close()
