"""The hand-written kernels of generation: bound time of their work over their device time, %."""
from pdr_bench import readers


def read(ctx):
    return readers.roofline(ctx, "gen")
