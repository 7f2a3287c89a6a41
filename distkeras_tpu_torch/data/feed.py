"""Host minibatch feed.

Counterpart of ``distkeras_tpu/data/feed.py`` ``minibatches`` and
``_epoch_batch_indices``: the same batch order, seed for seed. The device
prefetcher (``DeviceFeed``) belongs to the training slice.
"""

from __future__ import annotations

from collections.abc import Iterator

import numpy as np

from distkeras_tpu_torch.data.dataset import Dataset

__all__ = ["minibatches"]

Batch = dict[str, np.ndarray]


def _epoch_batch_indices(
    n: int,
    batch_size: int,
    num_epoch: int,
    seed: int | None,
    drop_remainder: bool = True,
    start_batch: int = 0,
) -> Iterator[np.ndarray]:
    """Yield per-batch row-index arrays with a per-epoch reshuffle
    (``default_rng(seed + epoch)``) and remainder handling. ``start_batch``
    fast-forwards the stream arithmetically."""
    if start_batch < 0:
        raise ValueError(f"start_batch must be >= 0, got {start_batch}")
    if n < batch_size and drop_remainder:
        raise ValueError(f"partition of {n} rows < batch_size {batch_size}")
    per_epoch = n // batch_size if drop_remainder else -(-n // batch_size)
    start_epoch = start_batch // per_epoch if per_epoch else num_epoch
    skip_in_epoch = start_batch - start_epoch * per_epoch
    for epoch in range(min(start_epoch, num_epoch), num_epoch):
        order = (
            np.random.default_rng(seed + epoch).permutation(n)
            if seed is not None
            else np.arange(n)
        )
        stop = (n // batch_size) * batch_size if drop_remainder else n
        first = skip_in_epoch * batch_size if epoch == start_epoch else 0
        for lo in range(first, stop, batch_size):
            hi = min(lo + batch_size, n)
            yield order[lo:hi].astype(np.int32)


def minibatches(
    dataset: Dataset,
    batch_size: int,
    features_col: str = "features",
    label_col: str = "label",
    num_epoch: int = 1,
    seed: int | None = None,
    drop_remainder: bool = True,
    start_batch: int = 0,
) -> Iterator[Batch]:
    """Yield ``{"features": x, "label": y}`` numpy minibatches. With ``seed``
    set, rows are re-shuffled each epoch."""
    x = np.asarray(dataset[features_col])
    y = np.asarray(dataset[label_col])
    n = x.shape[0]
    for idx in _epoch_batch_indices(n, batch_size, num_epoch, seed,
                                    drop_remainder, start_batch):
        yield {"features": x[idx], "label": y[idx]}
