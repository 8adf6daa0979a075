"""DataSetIterators — port of deeplearning4j_tpu/datasets/iterators.py:
`DataSetIterator`, `ListDataSetIterator`, `INDArrayDataSetIterator`,
`MultipleEpochsIterator`, `SamplingDataSetIterator`,
`AsyncDataSetIterator` (a background prefetch thread) and
`IteratorDataSetIterator`.

The facades' ``fit(iterator)`` reads through `prefetched`: an
`AsyncDataSetIterator` whose worker, for a net on the card, stages each
batch's arrays into pinned host memory, so the step copies them to the
device without a host sync while the worker readies the next ones.
"""
from __future__ import annotations

import copy
import queue
import threading
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from .dataset import DataSet


class DataSetIterator:
    """Iterator SPI. Subclasses implement next_batch() and reset();
    iterating resets first."""

    def __iter__(self) -> Iterator[DataSet]:
        self.reset()
        return self

    def __next__(self) -> DataSet:
        ds = self.next_batch()
        if ds is None:
            raise StopIteration
        return ds

    def next_batch(self) -> Optional[DataSet]:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def batch_size(self) -> int:
        raise NotImplementedError


class ListDataSetIterator(DataSetIterator):
    """Minibatches of one in-memory DataSet, in order. ``pad_last`` pads
    the final partial batch with zero rows to a full one."""

    def __init__(self, data: DataSet, batch: int = 10,
                 pad_last: bool = False):
        self._data = data
        self._batch = batch
        self._pos = 0
        self._pad_last = pad_last
        # where the data came from (the fetchers' ``source`` label)
        self.source = getattr(data, "source", None)

    def batch_size(self) -> int:
        return self._batch

    def reset(self) -> None:
        self._pos = 0

    def next_batch(self) -> Optional[DataSet]:
        n = self._data.num_examples()
        if self._pos >= n:
            return None
        end = min(self._pos + self._batch, n)
        ds = self._data._slice(slice(self._pos, end))
        self._pos = end
        if self._pad_last and ds.num_examples() < self._batch:
            pad = self._batch - ds.num_examples()

            def padded(a):
                return np.concatenate(
                    [a, np.zeros((pad,) + a.shape[1:], a.dtype)])
            ds = DataSet(padded(ds.features), padded(ds.labels))
        return ds


class INDArrayDataSetIterator(ListDataSetIterator):
    """Minibatches of a (features, labels) array pair."""

    def __init__(self, features, labels, batch: int = 10):
        super().__init__(DataSet(features, labels), batch)


class MultipleEpochsIterator(DataSetIterator):
    """Replay an underlying iterator for ``epochs`` passes."""

    def __init__(self, epochs: int, underlying: DataSetIterator):
        self._epochs = epochs
        self._under = underlying
        self._epoch = 0

    def batch_size(self) -> int:
        return self._under.batch_size()

    def reset(self) -> None:
        self._epoch = 0
        self._under.reset()

    def next_batch(self) -> Optional[DataSet]:
        ds = self._under.next_batch()
        if ds is not None:
            return ds
        self._epoch += 1
        if self._epoch >= self._epochs:
            return None
        self._under.reset()
        return self._under.next_batch()


class SamplingDataSetIterator(DataSetIterator):
    """``total_batches`` minibatches sampled with replacement, the indices
    from ``np.random.default_rng(seed)`` (restarted by reset)."""

    def __init__(self, data: DataSet, batch: int, total_batches: int,
                 seed: int = 42):
        self._data = data
        self._batch = batch
        self._total = total_batches
        self._seed = seed
        self._count = 0
        self._rng = np.random.default_rng(seed)

    def batch_size(self) -> int:
        return self._batch

    def reset(self) -> None:
        self._count = 0
        self._rng = np.random.default_rng(self._seed)

    def next_batch(self) -> Optional[DataSet]:
        if self._count >= self._total:
            return None
        idx = self._rng.integers(0, self._data.num_examples(), self._batch)
        self._count += 1
        return DataSet(self._data.features[idx], self._data.labels[idx])


def pinned(ds):
    """A shallow copy of a DataSet or MultiDataSet whose arrays are
    pinned host tensors (the copy to the card then needs no host sync)."""
    def pin(a):
        if a is None:
            return None
        if isinstance(a, (list, tuple)):
            return [pin(b) for b in a]
        return torch.as_tensor(np.asarray(a)).pin_memory()
    out = copy.copy(ds)
    for name in ("features", "labels", "features_mask", "labels_mask",
                 "features_masks", "labels_masks"):
        if hasattr(out, name):
            setattr(out, name, pin(getattr(out, name)))
    return out


class AsyncDataSetIterator(DataSetIterator):
    """Background prefetch: a worker thread pulls batches from the
    underlying iterator into a queue of ``queue_size`` (pinned first when
    ``pin``), so the host side of the next batches overlaps the device's
    steps. ``reset`` stops the worker (it never consumes the underlying
    iterator again), resets the underlying iterator and starts anew."""

    _SENTINEL = object()

    def __init__(self, underlying: DataSetIterator, queue_size: int = 2,
                 pin: bool = False):
        self._under = underlying
        self._size = max(1, queue_size)
        self._pin = pin
        self._queue: "queue.Queue" = queue.Queue(self._size)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._gen = 0  # the worker generation (see reset)
        self._start()

    def _start(self):
        # each worker belongs to one generation and touches only that
        # generation's queue: a worker back from a blocking next_batch
        # after reset() superseded it drops what it got
        self._gen += 1
        gen = self._gen
        q = queue.Queue(self._size)
        self._queue = q
        self._error = None
        self._stop.clear()

        def worker():
            try:
                while not self._stop.is_set() and gen == self._gen:
                    ds = self._under.next_batch()
                    if self._stop.is_set() or gen != self._gen:
                        return
                    if ds is not None and self._pin:
                        ds = pinned(ds)
                    q.put(self._SENTINEL if ds is None else ds)
                    if ds is None:
                        return
            except BaseException as e:  # raised again on the consumer
                if gen == self._gen:
                    self._error = e
                    q.put(self._SENTINEL)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def batch_size(self) -> int:
        return self._under.batch_size()

    def reset(self) -> None:
        t = self._thread
        if t is not None and t.is_alive():
            self._stop.set()
            self._gen += 1
            while t.is_alive():  # drain, so a blocked put() wakes
                try:
                    self._queue.get(timeout=0.01)
                except queue.Empty:
                    pass
                t.join(timeout=0.01)
            t.join()
        self._under.reset()
        self._start()

    def next_batch(self) -> Optional[DataSet]:
        item = self._queue.get()
        if item is self._SENTINEL:
            if self._error is not None:
                raise self._error
            return None
        return item


def prefetched(iterator, queue_size: int, pin: bool = False):
    """The batches of ``iterator`` for a fit: a `DataSetIterator` is reset
    and read through an `AsyncDataSetIterator` of ``queue_size`` (JAX
    multilayer.py :616-635: resetting the wrapper right after making it
    would drop what its worker fetched already); anything else, an
    `AsyncDataSetIterator` included, is iterated as it is."""
    if (isinstance(iterator, DataSetIterator)
            and not isinstance(iterator, AsyncDataSetIterator)):
        iterator.reset()
        it = AsyncDataSetIterator(iterator, queue_size=queue_size, pin=pin)

        def batches():
            while True:
                ds = it.next_batch()
                if ds is None:
                    return
                yield ds
        return batches()
    return iter(iterator)


class IteratorDataSetIterator(DataSetIterator):
    """Rebatch a sequence of DataSets to minibatches of ``batch``
    examples (the last may be shorter)."""

    def __init__(self, source: Sequence[DataSet], batch: int):
        self._source = list(source)
        self._batch = batch
        self._pos = 0
        self._buffer: List[DataSet] = []

    def batch_size(self) -> int:
        return self._batch

    def reset(self) -> None:
        self._pos = 0
        self._buffer = []

    def next_batch(self) -> Optional[DataSet]:
        have = sum(d.num_examples() for d in self._buffer)
        while have < self._batch and self._pos < len(self._source):
            d = self._source[self._pos]
            self._pos += 1
            self._buffer.append(d)
            have += d.num_examples()
        if not self._buffer:
            return None
        merged = DataSet.merge(self._buffer)
        if merged.num_examples() <= self._batch:
            self._buffer = []
            return merged
        out, rest = merged.split_test_and_train(self._batch)
        self._buffer = [rest]
        return out
