"""Model FLOPs of the training window over its seconds, % of the bf16 peak."""
from pdr_bench import readers


def read(ctx):
    return readers.mfu(ctx, "train")
