"""Host ms a step spent making the batch: the iterator, augmentation, the copy to the device."""
from pdr_bench import readers


def read(ctx):
    return readers.batch_ms(ctx, "train")
