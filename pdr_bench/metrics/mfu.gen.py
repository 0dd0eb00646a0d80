"""Model FLOPs of the generation window over its seconds, % of the bf16 peak."""
from pdr_bench import readers


def read(ctx):
    return readers.mfu(ctx, "gen")
