"""The fused attention pool (#7): bound time of its 17 sites a step over its kernels device time, %."""
from pdr_bench import readers


def read(ctx):
    return readers.roofline(ctx, "gen", ("attention_pool",))
