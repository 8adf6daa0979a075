"""DataSet container — port of deeplearning4j_tpu/datasets/dataset.py
(the single-input DataSet that `MultiLayerNetwork.fit` and the CLI
consume).

Arrays stay numpy on the host; the net moves each minibatch to its
device in `fit_batch`.
"""
from __future__ import annotations

from typing import Optional

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

    def _slice(self, sl) -> "DataSet":
        return DataSet(
            self.features[sl], self.labels[sl],
            None if self.features_mask is None else self.features_mask[sl],
            None if self.labels_mask is None else self.labels_mask[sl])
