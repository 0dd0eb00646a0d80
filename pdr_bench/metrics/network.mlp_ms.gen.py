"""Device ms a reverse step of the network's MLP blocks, pooling, embeddings and head (pdr.net.mlp)."""
from pdr_bench import spans


def read(ctx):
    return spans.device_ms_each(ctx, "gen", "pdr.net.mlp", "pdr.net.denoise")
