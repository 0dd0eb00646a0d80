"""Samples of all steps in the window over its seconds (training cells)."""
from pdr_bench import readers


def read(ctx):
    return readers.rate(ctx, "train")
