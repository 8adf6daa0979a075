"""DataSet and MultiDataSet containers — port of
deeplearning4j_tpu/datasets/dataset.py (the single-input DataSet that
`MultiLayerNetwork.fit` and the CLI consume, and the multi-input /
multi-output MultiDataSet that `ComputationGraph.fit` takes).

Arrays stay numpy on the host; the net moves each minibatch to its
device in `fit_batch`.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _opt(a) -> Optional[np.ndarray]:
    return None if a is None else np.asarray(a)


class DataSet:
    def __init__(self, features, labels, features_mask=None,
                 labels_mask=None):
        self.features = np.asarray(features)
        self.labels = np.asarray(labels)
        self.features_mask = _opt(features_mask)
        self.labels_mask = _opt(labels_mask)

    def num_examples(self) -> int:
        return int(self.features.shape[0])

    def shuffle(self, seed: Optional[int] = None):
        """Permute the examples in place with ``np.random.default_rng(seed)``
        (JAX dataset.py :33: the same seed gives the same order)."""
        idx = np.random.default_rng(seed).permutation(self.num_examples())
        self.features = self.features[idx]
        self.labels = self.labels[idx]
        if self.features_mask is not None:
            self.features_mask = self.features_mask[idx]
        if self.labels_mask is not None:
            self.labels_mask = self.labels_mask[idx]

    def split_test_and_train(self, n_train: int):
        """(the first ``n_train`` examples, the rest)."""
        return self._slice(slice(0, n_train)), self._slice(slice(n_train, None))

    @staticmethod
    def merge(datasets: Sequence["DataSet"]) -> "DataSet":
        """One DataSet of ``datasets`` end to end (masks where the first
        has them)."""
        first = datasets[0]

        def cat(name):
            if getattr(first, name) is None:
                return None
            return np.concatenate([getattr(d, name) for d in datasets])
        return DataSet(cat("features"), cat("labels"), cat("features_mask"),
                       cat("labels_mask"))

    def _slice(self, sl) -> "DataSet":
        return DataSet(
            self.features[sl], self.labels[sl],
            None if self.features_mask is None else self.features_mask[sl],
            None if self.labels_mask is None else self.labels_mask[sl])


class MultiDataSet:
    """One array per network input and per network output, each with an
    optional mask (JAX datasets/dataset.py :69)."""

    def __init__(self, features: Sequence, labels: Sequence,
                 features_masks=None, labels_masks=None):
        self.features = [np.asarray(f) for f in features]
        self.labels = [np.asarray(l) for l in labels]
        self.features_masks = (None if features_masks is None
                               else [_opt(m) for m in features_masks])
        self.labels_masks = (None if labels_masks is None
                             else [_opt(m) for m in labels_masks])
