"""Clouds completed in the window over its seconds (generation cells)."""
from pdr_bench import readers


def read(ctx):
    return readers.rate(ctx, "gen")
