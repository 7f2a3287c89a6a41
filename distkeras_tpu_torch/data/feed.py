"""Host minibatch feed and device prefetch.

Counterpart of ``distkeras_tpu/data/feed.py``: ``minibatches``,
``window_batches`` and ``index_windows`` give the same batch order as the
reference's, batch for batch and seed for seed, because they draw from the
same ``_epoch_batch_indices`` and ``_window_group``. :class:`DeviceFeed`
moves each batch to the device one step ahead of the compute.
"""

from __future__ import annotations

import collections
from collections.abc import Iterator

import numpy as np
import torch

from distkeras_tpu_torch.data.dataset import Dataset
from distkeras_tpu_torch.utils.device import resolve_device

__all__ = ["minibatches", "window_batches", "index_windows", "DeviceFeed"]

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


def _window_group(items, window: int, stack):
    """Group ``window`` consecutive items with ``stack``; the tail is emitted
    as ``stack([item])`` singles rather than one shorter group, as the
    reference does (its scanned program is compiled per leading length)."""
    buf = []
    for b in items:
        buf.append(b)
        if len(buf) == window:
            yield stack(buf)
            buf = []
    for b in buf:
        yield stack([b])


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


def window_batches(batches: Iterator[Batch], window: int) -> Iterator[Batch]:
    """Group ``window`` consecutive minibatches into one stacked batch with a
    leading window axis (``[W, B, ...]``) for the window step
    (:func:`distkeras_tpu_torch.training.step.make_window_train_step`)."""

    def _stack(buf: list[Batch]) -> Batch:
        return {k: np.stack([b[k] for b in buf]) for k in buf[0]}

    return _window_group(batches, window, _stack)


def index_windows(
    n: int,
    batch_size: int,
    window: int,
    num_epoch: int = 1,
    seed: int | None = None,
) -> Iterator[np.ndarray]:
    """Yield ``[W, B]`` int32 row-index arrays with the same cadence as
    ``window_batches(minibatches(...))``, for the device-cached window step:
    the data lives on the device whole and only these indices cross."""
    return _window_group(
        _epoch_batch_indices(n, batch_size, num_epoch, seed), window, np.stack
    )


class DeviceFeed:
    """Iterator of device batches that keeps ``buffer_size`` batches in
    flight.

    On a CUDA device each numpy batch is copied into pinned host memory and
    sent with a ``non_blocking`` copy on a side stream; the consuming stream
    waits on that copy's event before it gets the batch, so the next batch's
    transfer overlaps the current step's compute. On the CPU it only wraps
    the arrays with ``torch.from_numpy``. ``device`` is CUDA unless ``"cpu"``
    is asked for."""

    def __init__(self, batches: Iterator[Batch], device: str | torch.device | None = None,
                 buffer_size: int = 2):
        self._batches = batches
        self._device = resolve_device(device)
        self._buffer_size = max(1, buffer_size)
        self._stream = (torch.cuda.Stream(self._device)
                        if self._device.type == "cuda" else None)

    def _put(self, batch: Batch):
        host = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
        if self._stream is None:
            return host, None
        with torch.cuda.stream(self._stream):
            out = {k: v.pin_memory().to(self._device, non_blocking=True)
                   for k, v in host.items()}
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return out, ready

    def _take(self, item) -> dict[str, torch.Tensor]:
        out, ready = item
        if ready is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(ready)
            for t in out.values():
                t.record_stream(consumer)  # allocated on the side stream
        return out

    def __iter__(self):
        buffer: collections.deque = collections.deque()
        for batch in self._batches:
            buffer.append(self._put(batch))
            if len(buffer) >= self._buffer_size:
                yield self._take(buffer.popleft())
        while buffer:
            yield self._take(buffer.popleft())
