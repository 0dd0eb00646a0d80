"""Device ms a training step of the forward's attention pools (pdr.net.attention)."""
from pdr_bench import spans


def read(ctx):
    return spans.device_ms_each(ctx, "train", "pdr.net.attention", "pdr.train.forward")
