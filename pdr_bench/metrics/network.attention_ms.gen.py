"""Device ms a reverse step of the network's attention pools (pdr.net.attention)."""
from pdr_bench import spans


def read(ctx):
    return spans.device_ms_each(ctx, "gen", "pdr.net.attention", "pdr.net.denoise")
