"""Fixed-size numpy batches over an in-memory dataset.

Counterpart of the per-item branch of the JAX package's
``data/mvp.py::iterate_batches``; the h5-backed ``MVPDataset`` and its
batched collation are not ported yet.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np


def iterate_batches(
    dataset,
    batch_size: int,
    shuffle: bool = True,
    drop_last: bool = False,
    seed: Optional[int] = None,
) -> Iterator[dict]:
    """Yield dicts of stacked arrays from ``dataset`` (``len`` and per-item
    dicts), in an order shuffled from ``seed`` when ``shuffle``."""
    n = len(dataset)
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    for i in range(0, n, batch_size):
        idx = order[i: i + batch_size]
        if drop_last and len(idx) < batch_size:
            return
        items = [dataset[int(j)] for j in idx]
        yield {k: np.stack([it[k] for it in items]) for k in items[0].keys()}
