"""Device ms a reverse step of the network's groupings (the span pdr.net.group inside pdr.net.denoise)."""
from pdr_bench import spans


def read(ctx):
    return spans.device_ms_each(ctx, "gen", "pdr.net.group", "pdr.net.denoise")
