"""Device ms a training step of PyTorch elementwise and reduction kernels."""
from pdr_bench import readers


def read(ctx):
    return readers.eltwise_reduce_ms(ctx, "train")
