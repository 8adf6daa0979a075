"""Record readers — port of deeplearning4j_tpu/datasets/records.py: the
`RecordReader` SPI, CSV records, CSV sequences (one file per sequence),
in-memory string lists and image directories, and the iterators that
vectorise records into DataSets (`RecordReaderDataSetIterator`, the path
behind the CLI's ``train --input data.csv``), padded and masked sequence
DataSets (`SequenceRecordReaderDataSetIterator`) and MultiDataSets
routed from named readers (`RecordReaderMultiDataSetIterator`).
Arrays stay numpy on the host; the net moves each minibatch to its
device. `ImageRecordReader` reads images with PIL where PIL imports,
and ``.npy`` arrays without it.
"""
from __future__ import annotations

import csv
import io
from pathlib import Path
from typing import List, Optional, Sequence, Union

import numpy as np

from .dataset import DataSet, MultiDataSet
from .fetchers import one_hot
from .iterators import DataSetIterator


class RecordReader:
    """Reader SPI: iterate records (lists of values); iterating resets
    first."""

    def initialize(self, source) -> "RecordReader":
        raise NotImplementedError

    def next_record(self) -> Optional[List]:
        raise NotImplementedError

    def has_next(self) -> bool:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def __iter__(self):
        self.reset()
        while self.has_next():
            yield self.next_record()


class CSVRecordReader(RecordReader):
    """Rows of a CSV file, after ``skip_lines`` header lines; empty rows
    are dropped."""

    def __init__(self, skip_lines: int = 0, delimiter: str = ","):
        self.skip_lines = skip_lines
        self.delimiter = delimiter
        self._rows: List[List[str]] = []
        self._pos = 0

    def initialize(self, source: Union[str, Path]) -> "CSVRecordReader":
        text = Path(source).read_text()
        rows = list(csv.reader(io.StringIO(text), delimiter=self.delimiter))
        self._rows = [r for r in rows[self.skip_lines:] if r]
        self._pos = 0
        return self

    def next_record(self):
        if self._pos >= len(self._rows):
            return None
        r = self._rows[self._pos]
        self._pos += 1
        return r

    def has_next(self):
        return self._pos < len(self._rows)

    def reset(self):
        self._pos = 0


class ListStringRecordReader(RecordReader):
    """In-memory records."""

    def __init__(self):
        self._rows: List[List[str]] = []
        self._pos = 0

    def initialize(self, rows: Sequence[Sequence[str]]) -> "ListStringRecordReader":
        self._rows = [list(r) for r in rows]
        self._pos = 0
        return self

    def next_record(self):
        if self._pos >= len(self._rows):
            return None
        r = self._rows[self._pos]
        self._pos += 1
        return r

    def has_next(self):
        return self._pos < len(self._rows)

    def reset(self):
        self._pos = 0


class CSVSequenceRecordReader:
    """One CSV file per sequence: ``next_sequence`` gives a file's rows
    after ``skip_lines``."""

    def __init__(self, skip_lines: int = 0, delimiter: str = ","):
        self.skip_lines = skip_lines
        self.delimiter = delimiter
        self._files: List[Path] = []
        self._pos = 0

    def initialize(self, files: Sequence[Union[str, Path]]) -> "CSVSequenceRecordReader":
        self._files = [Path(f) for f in files]
        self._pos = 0
        return self

    def next_sequence(self) -> Optional[List[List[str]]]:
        if self._pos >= len(self._files):
            return None
        text = self._files[self._pos].read_text()
        self._pos += 1
        rows = list(csv.reader(io.StringIO(text), delimiter=self.delimiter))
        return [r for r in rows[self.skip_lines:] if r]

    def has_next(self):
        return self._pos < len(self._files)

    def reset(self):
        self._pos = 0


class ImageRecordReader(RecordReader):
    """Images under a directory tree, each labelled by its parent
    directory's index among the sorted directory names; [h, w, c] f32
    (images scaled to [0, 1]). PIL reads images; ``.npy`` files need no
    PIL."""

    def __init__(self, height: int, width: int, channels: int = 3):
        self.height = height
        self.width = width
        self.channels = channels
        self._files: List[Path] = []
        self.labels: List[str] = []
        self._pos = 0

    def initialize(self, root: Union[str, Path]) -> "ImageRecordReader":
        root = Path(root)
        exts = {".png", ".jpg", ".jpeg", ".bmp", ".npy"}
        self._files = sorted(p for p in root.rglob("*") if p.suffix.lower() in exts)
        self.labels = sorted({p.parent.name for p in self._files})
        self._pos = 0
        return self

    def _load(self, path: Path) -> np.ndarray:
        if path.suffix == ".npy":
            arr = np.load(path)
        else:
            from PIL import Image
            img = Image.open(path).convert("RGB" if self.channels == 3 else "L")
            img = img.resize((self.width, self.height))
            arr = np.asarray(img, np.float32) / 255.0
        arr = np.asarray(arr, np.float32)
        if arr.ndim == 2:
            arr = arr[..., None]
        return arr.reshape(self.height, self.width, self.channels)

    def next_record(self):
        if self._pos >= len(self._files):
            return None
        p = self._files[self._pos]
        self._pos += 1
        return [self._load(p), self.labels.index(p.parent.name)]

    def has_next(self):
        return self._pos < len(self._files)

    def reset(self):
        self._pos = 0


class RecordReaderDataSetIterator(DataSetIterator):
    """Records as minibatches: the ``label_index`` column (-1: the last)
    becomes a one-hot label over ``num_classes`` (default: the largest
    label in the batch + 1), or a [B, 1] target with ``regression``; the
    other columns are the features, f32. An image record gives its
    flattened pixels and its label."""

    def __init__(self, reader: RecordReader, batch_size: int,
                 label_index: int = -1, num_classes: Optional[int] = None,
                 regression: bool = False):
        self.reader = reader
        self._batch = batch_size
        self.label_index = label_index
        self.num_classes = num_classes
        self.regression = regression

    def batch_size(self) -> int:
        return self._batch

    def reset(self):
        self.reader.reset()

    def next_batch(self) -> Optional[DataSet]:
        feats, labs = [], []
        while len(feats) < self._batch and self.reader.has_next():
            rec = self.reader.next_record()
            if rec is None:
                break
            if isinstance(rec[0], np.ndarray):  # image record
                feats.append(rec[0].reshape(-1))
                labs.append(rec[1])
                continue
            vals = [float(v) for v in rec]
            li = self.label_index if self.label_index >= 0 else len(vals) - 1
            labs.append(vals[li])
            feats.append([v for i, v in enumerate(vals) if i != li])
        if not feats:
            return None
        x = np.asarray(feats, np.float32)
        if self.regression:
            y = np.asarray(labs, np.float32).reshape(-1, 1)
        else:
            y = one_hot(np.asarray(labs), self.num_classes
                        or int(max(labs)) + 1)
        return DataSet(x, y)


class SequenceRecordReaderDataSetIterator(DataSetIterator):
    """Sequences as [B, T, F] DataSets padded to the batch's longest, with
    [B, T] masks; labels one-hot per step from a label reader (or
    regression targets), or the features themselves without one."""

    def __init__(self, feature_reader: CSVSequenceRecordReader,
                 label_reader: Optional[CSVSequenceRecordReader],
                 batch_size: int, num_classes: Optional[int] = None,
                 regression: bool = False):
        self.feature_reader = feature_reader
        self.label_reader = label_reader
        self._batch = batch_size
        self.num_classes = num_classes
        self.regression = regression

    def batch_size(self) -> int:
        return self._batch

    def reset(self):
        self.feature_reader.reset()
        if self.label_reader is not None:
            self.label_reader.reset()

    def next_batch(self) -> Optional[DataSet]:
        seqs, labseqs = [], []
        while len(seqs) < self._batch and self.feature_reader.has_next():
            frows = self.feature_reader.next_sequence()
            seqs.append(np.asarray(frows, np.float32))
            if self.label_reader is not None and self.label_reader.has_next():
                lrows = self.label_reader.next_sequence()
                labseqs.append(np.asarray(lrows, np.float32))
        if not seqs:
            return None
        max_t = max(s.shape[0] for s in seqs)
        B = len(seqs)
        F = seqs[0].shape[1]
        x = np.zeros((B, max_t, F), np.float32)
        mask = np.zeros((B, max_t), np.float32)
        for i, s in enumerate(seqs):
            x[i, :s.shape[0]] = s
            mask[i, :s.shape[0]] = 1.0
        if not labseqs:
            return DataSet(x, x, features_mask=mask, labels_mask=mask)
        if self.regression:
            L = labseqs[0].shape[1]
            y = np.zeros((B, max_t, L), np.float32)
            for i, l in enumerate(labseqs):
                y[i, :l.shape[0]] = l
        else:
            C = self.num_classes or int(max(l.max() for l in labseqs)) + 1
            y = np.zeros((B, max_t, C), np.float32)
            for i, l in enumerate(labseqs):
                idx = l.reshape(-1).astype(int)
                y[i, np.arange(len(idx)), idx] = 1.0
        return DataSet(x, y, features_mask=mask, labels_mask=mask)


class RecordReaderMultiDataSetIterator(DataSetIterator):
    """Multi-input / multi-output vectorisation for ComputationGraph
    training: named record readers advance in lockstep, and column
    ranges route each record's slices into the MultiDataSet's inputs and
    outputs (one-hot or regression)::

        it = (RecordReaderMultiDataSetIterator.builder(batch_size=16)
              .add_reader("csv", reader)
              .add_input("csv", 0, 3)                 # cols 0..3 inclusive
              .add_output_one_hot("csv", 4, 3)        # col 4 -> 3 classes
              .build())
    """

    def __init__(self, batch_size: int, readers, inputs, outputs):
        self._batch = batch_size
        self._readers = readers            # name -> RecordReader
        self._inputs = inputs              # [(reader, first, last)]
        self._outputs = outputs            # [(reader, first, last, n_cls)]

    class Builder:
        def __init__(self, batch_size: int):
            self._batch = batch_size
            self._readers = {}
            self._inputs = []
            self._outputs = []

        def add_reader(self, name: str, reader: RecordReader):
            self._readers[name] = reader
            return self

        def add_input(self, name: str, first_col: Optional[int] = None,
                      last_col: Optional[int] = None):
            self._inputs.append((name, first_col, last_col))
            return self

        def add_output(self, name: str, first_col: Optional[int] = None,
                       last_col: Optional[int] = None):
            self._outputs.append((name, first_col, last_col, None))
            return self

        def add_output_one_hot(self, name: str, col: int, num_classes: int):
            self._outputs.append((name, col, col, num_classes))
            return self

        def build(self) -> "RecordReaderMultiDataSetIterator":
            missing = {n for n, *_ in self._inputs + self._outputs} \
                - set(self._readers)
            if missing:
                raise ValueError(f"specs reference unknown readers {missing}")
            return RecordReaderMultiDataSetIterator(
                self._batch, self._readers, self._inputs, self._outputs)

    @staticmethod
    def builder(batch_size: int) -> "RecordReaderMultiDataSetIterator.Builder":
        return RecordReaderMultiDataSetIterator.Builder(batch_size)

    def batch_size(self) -> int:
        return self._batch

    def reset(self):
        for r in self._readers.values():
            r.reset()

    def _pull_rows(self):
        """One row from EVERY reader, or None when any is exhausted. Values
        stay raw here — only the columns a spec routes get float-converted,
        so unreferenced columns (string ids, free text) are legal."""
        rows = {}
        for name, r in self._readers.items():
            if not r.has_next():
                return None
            rec = r.next_record()
            if rec is None:
                return None
            rows[name] = list(rec)
        return rows

    def next_batch(self):
        batch_rows = []
        while len(batch_rows) < self._batch:
            rows = self._pull_rows()
            if rows is None:
                break
            batch_rows.append(rows)
        if not batch_rows:
            return None

        def slice_cols(spec_rows, name, first, last):
            row0 = spec_rows[0][name]
            f = 0 if first is None else first
            l = len(row0) - 1 if last is None else last
            return np.asarray([[float(v) for v in r[name][f:l + 1]]
                               for r in spec_rows], np.float32)

        inputs = [slice_cols(batch_rows, n, f, l) for n, f, l in self._inputs]
        outputs = []
        for n, f, l, n_cls in self._outputs:
            arr = slice_cols(batch_rows, n, f, l)
            if n_cls is not None:
                arr = one_hot(arr.reshape(-1), n_cls)
            outputs.append(arr)
        return MultiDataSet(inputs, outputs)

    def __iter__(self):
        self.reset()
        return self

    def __next__(self):
        mds = self.next_batch()
        if mds is None:
            raise StopIteration
        return mds
