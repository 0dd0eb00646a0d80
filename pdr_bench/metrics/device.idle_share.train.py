"""Share of the traced training span in which the device ran nothing, %."""
from pdr_bench import readers


def read(ctx):
    return readers.idle_share(ctx, "train")
