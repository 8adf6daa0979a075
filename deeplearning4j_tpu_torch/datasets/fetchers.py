"""Dataset fetchers — port of the Iris part of
deeplearning4j_tpu/datasets/fetchers.py (MNIST, CIFAR, LFW and Curves
come with ROADMAP A6).

The JAX package reads Iris through scikit-learn's `load_iris`. The port
keeps its own byte-for-byte copy of that 150-row CSV
(``datasets/data/iris.csv``: a header ``150,4,<class names>``, then four
features and the class index per row) and parses it as scikit-learn
does (float64 features, int classes), so `load_iris_dataset` gives the
JAX package's arrays bit for bit with nothing else installed.
"""
from __future__ import annotations

import csv
from pathlib import Path
from typing import Optional

import numpy as np

from .dataset import DataSet
from .iterators import ListDataSetIterator

IRIS_CSV = Path(__file__).with_name("data") / "iris.csv"


def one_hot(labels: np.ndarray, n_classes: int) -> np.ndarray:
    out = np.zeros((labels.shape[0], n_classes), np.float32)
    out[np.arange(labels.shape[0]), labels.astype(int)] = 1.0
    return out


def _read_iris():
    """(features [150, 4] float64, classes [150] int) of the CSV."""
    with open(IRIS_CSV, newline="") as f:
        rows = csv.reader(f)
        head = next(rows)
        n, n_features = int(head[0]), int(head[1])
        data = np.empty((n, n_features), np.float64)
        target = np.empty((n,), int)
        for i, row in enumerate(rows):
            data[i] = np.asarray(row[:-1], dtype=np.float64)
            target[i] = np.asarray(row[-1], dtype=int)
    return data, target


def load_iris_dataset(shuffle_seed: Optional[int] = 12345) -> DataSet:
    """Iris with each feature standardised (f32) and one-hot classes,
    shuffled by ``shuffle_seed`` (None: file order) — JAX :84."""
    data, target = _read_iris()
    x = data.astype(np.float32)
    x = (x - x.mean(axis=0)) / x.std(axis=0)
    ds = DataSet(x, one_hot(target, 3))
    if shuffle_seed is not None:
        ds.shuffle(shuffle_seed)
    return ds


class IrisDataSetIterator(ListDataSetIterator):
    """Minibatches of the first ``num_examples`` shuffled Iris rows (JAX
    :98)."""

    def __init__(self, batch: int = 150, num_examples: int = 150,
                 seed: int = 12345):
        ds = load_iris_dataset(seed)
        ds = DataSet(ds.features[:num_examples], ds.labels[:num_examples])
        super().__init__(ds, batch)
