"""DataSetIterators — port of `DataSetIterator`, `ListDataSetIterator` and
`MultipleEpochsIterator` from deeplearning4j_tpu/datasets/iterators.py.

The JAX package's `AsyncDataSetIterator` (a background prefetch thread)
has no counterpart yet: `MultiLayerNetwork.fit` pulls one minibatch at a
time.
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

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
