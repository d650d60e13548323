"""Host data pipeline: shuffled batching with parallel background assembly.

Torch counterpart of the JAX package's ``data/loader.py`` (reference
``torch.utils.data.DataLoader`` with worker processes, ``var_sep/main.py:111-114``):
``num_workers`` batches are assembled concurrently on a thread pool ahead
of the training loop, and ``prefetch_to_device`` keeps N batches in flight
to the device from pinned host memory, so host->device copies overlap with
the train step."""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np
import torch


class Batcher:
    """Iterate (cond, target) minibatches over a map-style dataset.

    ``dataset`` needs ``__len__`` and ``__getitem__ -> tuple of arrays``.
    Batches are stacked numpy arrays.  Training drops ragged batches so
    every step sees the same shapes."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True,
                 num_workers: int = 0, max_batches: Optional[int] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        self.num_workers = num_workers
        self.max_batches = max_batches

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            n = n // self.batch_size
        else:
            n = (n + self.batch_size - 1) // self.batch_size
        if self.max_batches is not None:
            n = min(n, self.max_batches)
        return n

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        return idx

    def _assemble(self, batch_idx: np.ndarray):
        items = [self.dataset[int(i)] for i in batch_idx]
        return tuple(np.stack(parts) for parts in zip(*items))

    def __iter__(self) -> Iterator:
        idx = self._indices()
        slices = [idx[i * self.batch_size:(i + 1) * self.batch_size]
                  for i in range(len(self))]
        if self.num_workers <= 0:
            for s in slices:
                yield self._assemble(s)
            return
        # parallel assembly: num_workers + 1 batches in flight, order kept.
        with ThreadPoolExecutor(self.num_workers) as ex:
            futures = collections.deque()
            it = iter(slices)
            for _, s in zip(range(self.num_workers + 1), it):
                futures.append(ex.submit(self._assemble, s))
            for s in it:
                yield futures.popleft().result()
                futures.append(ex.submit(self._assemble, s))
            while futures:
                yield futures.popleft().result()


def background_iter(iterable, size: int) -> Iterator:
    """Drain ``iterable`` on a daemon thread through a bounded queue so up
    to ``size`` items are produced ahead of the consumer.  A producer
    exception is re-raised at the consumer instead of silently ending."""
    q: queue.Queue = queue.Queue(maxsize=max(1, size))
    stop = object()

    def producer():
        try:
            for item in iterable:
                q.put((None, item))
        except BaseException as e:  # noqa: BLE001 -- re-raised by the consumer
            q.put((e, None))
            return
        q.put((None, stop))

    threading.Thread(target=producer, daemon=True).start()
    while True:
        err, item = q.get()
        if err is not None:
            raise err
        if item is stop:
            return
        yield item


def prefetch_to_device(iterator: Iterator, size: int = 2, device=None) -> Iterator:
    """Keep ``size`` batches (tuples of numpy arrays) in flight to ``device``.

    For a CUDA device each array is copied into pinned host memory and sent
    with a ``non_blocking`` copy, so the transfer overlaps the running step;
    the caching host allocator keeps a pinned buffer alive until its copy
    is done.  ``device`` must be given: there is no default device."""
    if device is None:
        raise ValueError("prefetch_to_device needs an explicit device")
    device = torch.device(device)

    def put(batch):
        tensors = (torch.from_numpy(np.ascontiguousarray(x)) for x in batch)
        if device.type == "cuda":
            return tuple(t.pin_memory().to(device, non_blocking=True) for t in tensors)
        return tuple(t.to(device) for t in tensors)

    buf = collections.deque()
    for batch in iterator:
        buf.append(put(batch))
        if len(buf) >= size:
            yield buf.popleft()
    while buf:
        yield buf.popleft()
