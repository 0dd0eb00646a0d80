"""Device ms a training step of the forward's groupings (pdr.net.group inside pdr.train.forward)."""
from pdr_bench import spans


def read(ctx):
    return spans.device_ms_each(ctx, "train", "pdr.net.group", "pdr.train.forward")
