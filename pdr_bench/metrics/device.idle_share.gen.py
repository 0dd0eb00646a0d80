"""Share of the traced generation span in which the device ran nothing, %."""
from pdr_bench import readers


def read(ctx):
    return readers.idle_share(ctx, "gen")
