"""Device ms a training step of the chamfer loss in the forward (pdr.loss.chamfer)."""
from pdr_bench import spans


def read(ctx):
    return spans.device_ms_each(ctx, "train", "pdr.loss.chamfer", "pdr.train.forward")
