"""CSV records into DataSets — port of `CSVRecordReader` and
`RecordReaderDataSetIterator` from deeplearning4j_tpu/datasets/records.py,
the path behind the CLI's ``train --input data.csv``.
"""
from __future__ import annotations

import csv
import io
from pathlib import Path
from typing import List, Optional, Union

import numpy as np

from .dataset import DataSet
from .iterators import DataSetIterator


def one_hot(labels: np.ndarray, n_classes: int) -> np.ndarray:
    out = np.zeros((labels.shape[0], n_classes), np.float32)
    out[np.arange(labels.shape[0]), labels.astype(int)] = 1.0
    return out


class CSVRecordReader:
    """Rows of a CSV file, after ``skip_lines`` header lines; empty rows
    are dropped."""

    def __init__(self, skip_lines: int = 0, delimiter: str = ","):
        self.skip_lines = skip_lines
        self.delimiter = delimiter
        self._rows: List[List[str]] = []
        self._pos = 0

    def initialize(self, source: Union[str, Path]) -> "CSVRecordReader":
        rows = list(csv.reader(io.StringIO(Path(source).read_text()),
                               delimiter=self.delimiter))
        self._rows = [r for r in rows[self.skip_lines:] if r]
        self._pos = 0
        return self

    def next_record(self) -> Optional[List[str]]:
        if self._pos >= len(self._rows):
            return None
        r = self._rows[self._pos]
        self._pos += 1
        return r

    def has_next(self) -> bool:
        return self._pos < len(self._rows)

    def reset(self) -> None:
        self._pos = 0


class RecordReaderDataSetIterator(DataSetIterator):
    """Records as minibatches: the ``label_index`` column (-1: the last)
    becomes a one-hot label over ``num_classes`` (default: the largest
    label in the batch + 1), or a [B, 1] target with ``regression``; the
    other columns are the features, f32."""

    def __init__(self, reader: CSVRecordReader, batch_size: int,
                 label_index: int = -1, num_classes: Optional[int] = None,
                 regression: bool = False):
        self.reader = reader
        self._batch = batch_size
        self.label_index = label_index
        self.num_classes = num_classes
        self.regression = regression

    def batch_size(self) -> int:
        return self._batch

    def reset(self) -> None:
        self.reader.reset()

    def next_batch(self) -> Optional[DataSet]:
        feats, labs = [], []
        while len(feats) < self._batch and self.reader.has_next():
            vals = [float(v) for v in self.reader.next_record()]
            li = self.label_index if self.label_index >= 0 else len(vals) - 1
            labs.append(vals[li])
            feats.append([v for i, v in enumerate(vals) if i != li])
        if not feats:
            return None
        x = np.asarray(feats, np.float32)
        if self.regression:
            return DataSet(x, np.asarray(labs, np.float32).reshape(-1, 1))
        return DataSet(x, one_hot(np.asarray(labs),
                                  self.num_classes or int(max(labs)) + 1))
