"""Device ms a training step of the forward's MLP blocks, pooling, embeddings and head (pdr.net.mlp)."""
from pdr_bench import spans


def read(ctx):
    return spans.device_ms_each(ctx, "train", "pdr.net.mlp", "pdr.train.forward")
