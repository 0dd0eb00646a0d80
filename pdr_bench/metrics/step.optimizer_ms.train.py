"""Device ms a training step of the optimizer's step (pdr.train.optimizer)."""
from pdr_bench import spans


def read(ctx):
    return spans.device_ms(ctx, "train", "pdr.train.optimizer")
