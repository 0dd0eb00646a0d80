"""Device ms a training step of the backward (pdr.train.backward)."""
from pdr_bench import spans


def read(ctx):
    return spans.device_ms(ctx, "train", "pdr.train.backward")
