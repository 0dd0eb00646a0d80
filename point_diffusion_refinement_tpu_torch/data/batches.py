"""Fixed-size numpy batches over an in-memory dataset.

Counterpart of the JAX package's ``data/mvp.py::iterate_batches``: an
``MVPDataset`` takes the batched collation of ``get_batch_fast`` where it
can, any other dataset (and an ``MVPDataset`` whose augmentation needs the
per-item path) is assembled item by item.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from .mvp import MVPDataset, get_batch_fast


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
        batch = get_batch_fast(dataset, idx) if isinstance(dataset, MVPDataset) else None
        if batch is None:
            items = [dataset[int(j)] for j in idx]
            batch = {k: np.stack([it[k] for it in items]) for k in items[0].keys()}
        yield batch
