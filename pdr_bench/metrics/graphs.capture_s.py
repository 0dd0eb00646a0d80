"""The program's seconds capturing CUDA graphs, over every signature (the counter graphs.capture_s)."""
from pdr_bench import spans


def read(ctx):
    return spans.counter("graphs.capture_s")
