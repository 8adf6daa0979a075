"""Streaming pipelines: record conversion, train-from-stream and the
queue-fed inference route — a port of `RecordToDataSetConverter`,
`QueueDataSetIterator`, `StreamingTrainingPipeline` and `ServeRoute` from
deeplearning4j_tpu/serving/streaming.py, on the port's `datasets/`.

  - `RecordToDataSetConverter` vectorizes CSV-style records into a
    DataSet (the server's ``/predict/csv`` path);
  - `QueueDataSetIterator` is a DataSetIterator fed from a live stream;
  - `StreamingTrainingPipeline` runs ``net.fit_batch`` in a consumer
    thread over that iterator while producers push records;
  - `ServeRoute` is the queue-fed inference route: records in, converter,
    batched ``net.output``, predictions out to a callback.

Arrays stay numpy on the host; the net moves each batch to its device and
`ServeRoute` copies each batch's predictions back once.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..datasets.dataset import DataSet
from ..datasets.iterators import DataSetIterator


class RecordToDataSetConverter:
    """Vectorize CSV-style records (lists of str/float) into a DataSet."""

    def __init__(self, label_index: Optional[int] = None,
                 num_classes: Optional[int] = None,
                 regression: bool = False):
        self.label_index = label_index
        self.num_classes = num_classes
        self.regression = regression
        self._inferred: Optional[int] = None  # locked on the first batch

    def convert(self, records: Sequence[Sequence]) -> DataSet:
        rows = [[float(v) for v in r] for r in records]
        arr = np.asarray(rows, np.float32)
        if self.label_index is None:
            return DataSet(arr, np.zeros((arr.shape[0], 0), np.float32))
        li = self.label_index if self.label_index >= 0 else arr.shape[1] - 1
        labels = arr[:, li]
        feats = np.delete(arr, li, axis=1)
        if self.regression:
            y = labels[:, None]
        else:
            # the class count is locked to the FIRST batch, so streamed
            # batches all get the same one-hot width
            n = self.num_classes or self._inferred
            if n is None:
                n = self._inferred = int(labels.max()) + 1
            if labels.max() >= n:
                raise ValueError(
                    f"label {int(labels.max())} >= num_classes {n}; pass "
                    "num_classes explicitly for streamed data")
            y = np.eye(n, dtype=np.float32)[labels.astype(np.int64)]
        return DataSet(feats, y)


class QueueDataSetIterator(DataSetIterator):
    """DataSetIterator fed from a live stream. Producers push DataSets (or
    records through `push_records`); the training loop consumes until
    `end()` or an idle timeout."""

    def __init__(self, converter: Optional[RecordToDataSetConverter] = None,
                 batch_size: int = 32, poll_timeout: float = 0.5,
                 idle_timeout: Optional[float] = None, maxsize: int = 1024):
        self._queue: "queue.Queue" = queue.Queue(maxsize)
        self._converter = converter
        self._batch = batch_size
        self._timeout = poll_timeout
        # None = wait for data until end(): a producer gap must not be
        # mistaken for the end of the stream
        self._idle_timeout = idle_timeout
        self._closed = False

    def push(self, ds: DataSet) -> None:
        self._queue.put(ds)

    def push_records(self, records: Sequence[Sequence]) -> None:
        if self._converter is None:
            raise ValueError("push_records requires a converter")
        self._queue.put(self._converter.convert(records))

    def end(self) -> None:
        """Signal the end of the stream: consumers drain and stop."""
        self._closed = True
        self._queue.put(None)

    def batch_size(self) -> int:
        return self._batch

    def reset(self) -> None:  # a stream has no beginning to return to
        pass

    def next_batch(self) -> Optional[DataSet]:
        """Blocks for data; returns None only at the end of the stream
        (end() was called and the queue is drained) or after
        ``idle_timeout`` seconds without data (when set)."""
        deadline = (None if self._idle_timeout is None
                    else time.monotonic() + self._idle_timeout)
        while True:
            try:
                return self._queue.get(timeout=self._timeout)
            except queue.Empty:
                if self._closed:
                    return None
                if deadline is not None and time.monotonic() >= deadline:
                    return None


class StreamingTrainingPipeline:
    """Train from a stream: a consumer thread runs ``net.fit_batch``
    over a QueueDataSetIterator while producers push records live."""

    def __init__(self, net, converter: Optional[RecordToDataSetConverter] = None,
                 batch_size: int = 32):
        self.net = net
        self.iterator = QueueDataSetIterator(converter, batch_size)
        self._thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None

    def start(self) -> "StreamingTrainingPipeline":
        def run():
            try:
                while True:
                    ds = self.iterator.next_batch()
                    if ds is None:
                        return
                    self.net.fit_batch(ds.features, ds.labels)
            except Exception as e:  # reported by finish()
                self.error = e

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="streaming-train")
        self._thread.start()
        return self

    def push_records(self, records: Sequence[Sequence]) -> None:
        self.iterator.push_records(records)

    def push(self, ds: DataSet) -> None:
        self.iterator.push(ds)

    def finish(self, timeout: float = 60.0) -> None:
        self.iterator.end()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError("the training consumer did not finish")
        if self.error is not None:
            raise self.error


class ServeRoute:
    """Queue-fed inference route: records in -> converter -> batched
    ``net.output`` -> ``on_prediction`` callback (the final processor).
    Batches greedily up to ``max_batch`` records to amortize the device
    dispatch; each batch's predictions reach ``on_prediction`` as one
    numpy array (one device->host copy a batch)."""

    def __init__(self, net, converter: RecordToDataSetConverter,
                 on_prediction: Callable[[np.ndarray], None],
                 max_batch: int = 256, poll_timeout: float = 2.0):
        self.net = net
        self.converter = converter
        self.on_prediction = on_prediction
        self.max_batch = max_batch
        self._queue: "queue.Queue" = queue.Queue()
        self._timeout = poll_timeout
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self.error: Optional[BaseException] = None

    def start(self) -> "ServeRoute":
        from ..inference.batcher import _to_host

        def run():
            try:
                while not self._stop:
                    try:
                        first = self._queue.get(timeout=self._timeout)
                    except queue.Empty:
                        continue
                    if first is None:
                        return
                    batch = [first]
                    while len(batch) < self.max_batch:
                        try:
                            nxt = self._queue.get_nowait()
                        except queue.Empty:
                            break
                        if nxt is None:
                            self._stop = True
                            break
                        batch.append(nxt)
                    ds = self.converter.convert(batch)
                    with torch.no_grad():
                        out = self.net.output(ds.features)
                    if isinstance(out, (list, tuple)):
                        out = out[0]  # a ComputationGraph's first output
                    self.on_prediction(_to_host(out))
            except BaseException as e:  # reported by send() and stop()
                self.error = e

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="serve-route")
        self._thread.start()
        return self

    def send(self, record: Sequence) -> None:
        if self.error is not None:  # fail fast: a dead route takes nothing
            raise RuntimeError("ServeRoute consumer died") from self.error
        self._queue.put(list(record))

    def stop(self, timeout: float = 30.0) -> None:
        self._queue.put(None)
        if self._thread is not None:
            self._thread.join(timeout)
        if self.error is not None:
            raise self.error
