"""Host ms a training step assembling the batch inside the program's iterator (pdr.data.batch)."""
from pdr_bench import spans


def read(ctx):
    return spans.host_ms(ctx, "train", "pdr.data.batch")
