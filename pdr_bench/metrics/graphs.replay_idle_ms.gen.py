"""Device idle ms a reverse step while the host is inside the step (pdr.fastdpm.step)."""
from pdr_bench import spans


def read(ctx):
    return spans.idle_ms_each(ctx, "gen", "pdr.fastdpm.step")
