"""Device ms a batch between the marks of the condition branch (pdr.gen.encode), its stalls included."""
from pdr_bench import spans


def read(ctx):
    return spans.device_ms(ctx, "gen", "pdr.gen.encode")
