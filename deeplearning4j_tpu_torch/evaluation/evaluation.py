"""Classification and regression evaluation — the port's own copy of
deeplearning4j_tpu/evaluation/evaluation.py (host-only numpy; the port
imports nothing of the JAX package).

  - `Evaluation`: the confusion matrix of argmax(labels) against
    argmax(predictions), accuracy, top-n accuracy, precision, recall, f1
    (macro over the classes present), false-positive rate and `stats()`;
    time series [B, T, C] with a [B, T] mask, or [N, C] with a
    per-example mask;
  - `ConfusionMatrix`;
  - `RegressionEvaluation`: MSE, MAE, RMSE, R2 and Pearson correlation
    per column.

The nets' `evaluate` feeds predictions read back to the host; the same
arrays give the same numbers and the same `stats()` text as the JAX
package's.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np


class ConfusionMatrix:
    def __init__(self, n_classes: int):
        self.n = n_classes
        self.matrix = np.zeros((n_classes, n_classes), np.int64)

    def add(self, actual: int, predicted: int, count: int = 1):
        self.matrix[actual, predicted] += count

    def add_batch(self, actual: np.ndarray, predicted: np.ndarray):
        np.add.at(self.matrix, (actual, predicted), 1)

    def get_count(self, actual: int, predicted: int) -> int:
        return int(self.matrix[actual, predicted])

    def __str__(self):
        return str(self.matrix)


class Evaluation:
    """Streaming classification metrics (reference eval/Evaluation.java)."""

    def __init__(self, n_classes: Optional[int] = None,
                 labels: Optional[List[str]] = None, top_n: int = 1):
        self.n_classes = n_classes
        self.label_names = labels
        self.confusion: Optional[ConfusionMatrix] = None
        # top-N accuracy (Evaluation(topN) in post-reference DL4J): counted
        # from the full prediction rows since the confusion matrix can't
        # recover "was the true class in the N best"
        self.top_n = max(1, int(top_n))
        self._top_n_correct = 0
        self._top_n_total = 0

    def _ensure(self, n: int):
        if self.confusion is None:
            self.n_classes = self.n_classes or n
            self.confusion = ConfusionMatrix(self.n_classes)

    def eval(self, labels, predictions, mask=None):
        """labels/predictions: [N, C] (or [B, T, C] time series with [B, T] mask,
        reference evalTimeSeries:278)."""
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if labels.ndim == 3:
            c = labels.shape[-1]
            labels = labels.reshape(-1, c)
            predictions = predictions.reshape(-1, c)
            if mask is not None:
                m = np.asarray(mask).reshape(-1) > 0
                labels, predictions = labels[m], predictions[m]
        elif mask is not None:  # [N, C] with a per-example mask
            m = np.asarray(mask).reshape(-1) > 0
            labels, predictions = labels[m], predictions[m]
        self._ensure(labels.shape[-1])
        actual = np.argmax(labels, axis=-1)
        guess = np.argmax(predictions, axis=-1)
        self.confusion.add_batch(actual, guess)
        if self.top_n > 1 and len(actual):
            n = min(self.top_n, predictions.shape[-1])
            top = np.argpartition(predictions, -n, axis=-1)[:, -n:]
            self._top_n_correct += int((top == actual[:, None]).any(-1).sum())
            self._top_n_total += len(actual)

    # -- metrics ---------------------------------------------------------------
    def _tp(self, i):
        return self.confusion.matrix[i, i]

    def _fp(self, i):
        return self.confusion.matrix[:, i].sum() - self._tp(i)

    def _fn(self, i):
        return self.confusion.matrix[i, :].sum() - self._tp(i)

    def accuracy(self) -> float:
        m = self.confusion.matrix
        total = m.sum()
        return float(np.trace(m) / total) if total else 0.0

    def top_n_accuracy(self) -> float:
        """Fraction of examples whose true class was among the top_n
        predicted (== accuracy() when top_n == 1)."""
        if self.top_n <= 1:
            return self.accuracy()
        return (self._top_n_correct / self._top_n_total
                if self._top_n_total else 0.0)

    def precision(self, cls: Optional[int] = None) -> float:
        if cls is not None:
            denom = self._tp(cls) + self._fp(cls)
            return float(self._tp(cls) / denom) if denom else 0.0
        vals = [self.precision(i) for i in range(self.n_classes)
                if (self._tp(i) + self._fn(i)) > 0]
        return float(np.mean(vals)) if vals else 0.0

    def recall(self, cls: Optional[int] = None) -> float:
        if cls is not None:
            denom = self._tp(cls) + self._fn(cls)
            return float(self._tp(cls) / denom) if denom else 0.0
        vals = [self.recall(i) for i in range(self.n_classes)
                if (self._tp(i) + self._fn(i)) > 0]
        return float(np.mean(vals)) if vals else 0.0

    def f1(self, cls: Optional[int] = None) -> float:
        p, r = self.precision(cls), self.recall(cls)
        return 2 * p * r / (p + r) if (p + r) else 0.0

    def false_positive_rate(self, cls: int) -> float:
        m = self.confusion.matrix
        neg = m.sum() - m[cls, :].sum()
        return float(self._fp(cls) / neg) if neg else 0.0

    def stats(self) -> str:
        """Human-readable report (reference Evaluation.stats():343)."""
        lines = ["==========================Scores========================================"]
        lines.append(f" Accuracy:  {self.accuracy():.4f}")
        lines.append(f" Precision: {self.precision():.4f}")
        lines.append(f" Recall:    {self.recall():.4f}")
        lines.append(f" F1 Score:  {self.f1():.4f}")
        lines.append("========================================================================")
        lines.append("Confusion matrix:")
        lines.append(str(self.confusion))
        return "\n".join(lines)


class RegressionEvaluation:
    """Per-column regression metrics (reference eval/RegressionEvaluation.java)."""

    def __init__(self, n_columns: Optional[int] = None):
        self.n_columns = n_columns
        self._sum_sq = None
        self._sum_abs = None
        self._n = 0
        self._label_sum = None
        self._label_sq_sum = None
        self._pred_sum = None
        self._pred_sq_sum = None
        self._cross_sum = None

    def _ensure(self, c):
        if self._sum_sq is None:
            self.n_columns = self.n_columns or c
            z = np.zeros(self.n_columns, np.float64)
            self._sum_sq = z.copy()
            self._sum_abs = z.copy()
            self._label_sum = z.copy()
            self._label_sq_sum = z.copy()
            self._pred_sum = z.copy()
            self._pred_sq_sum = z.copy()
            self._cross_sum = z.copy()

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels, np.float64)
        predictions = np.asarray(predictions, np.float64)
        if labels.ndim == 3:
            c = labels.shape[-1]
            labels = labels.reshape(-1, c)
            predictions = predictions.reshape(-1, c)
            if mask is not None:
                m = np.asarray(mask).reshape(-1) > 0
                labels, predictions = labels[m], predictions[m]
        elif mask is not None:  # [N, C] with a per-example mask
            m = np.asarray(mask).reshape(-1) > 0
            labels, predictions = labels[m], predictions[m]
        self._ensure(labels.shape[-1])
        err = labels - predictions
        self._sum_sq += (err ** 2).sum(axis=0)
        self._sum_abs += np.abs(err).sum(axis=0)
        self._label_sum += labels.sum(axis=0)
        self._label_sq_sum += (labels ** 2).sum(axis=0)
        self._pred_sum += predictions.sum(axis=0)
        self._pred_sq_sum += (predictions ** 2).sum(axis=0)
        self._cross_sum += (labels * predictions).sum(axis=0)
        self._n += labels.shape[0]

    def mean_squared_error(self, col: int) -> float:
        return float(self._sum_sq[col] / self._n)

    def mean_absolute_error(self, col: int) -> float:
        return float(self._sum_abs[col] / self._n)

    def root_mean_squared_error(self, col: int) -> float:
        return float(np.sqrt(self.mean_squared_error(col)))

    def r_squared(self, col: int) -> float:
        mean = self._label_sum[col] / self._n
        ss_tot = self._label_sq_sum[col] - self._n * mean ** 2
        return float(1.0 - self._sum_sq[col] / ss_tot) if ss_tot else 0.0

    def pearson_correlation(self, col: int) -> float:
        n = self._n
        num = n * self._cross_sum[col] - self._label_sum[col] * self._pred_sum[col]
        d1 = n * self._label_sq_sum[col] - self._label_sum[col] ** 2
        d2 = n * self._pred_sq_sum[col] - self._pred_sum[col] ** 2
        denom = np.sqrt(d1 * d2)
        return float(num / denom) if denom else 0.0

    def stats(self) -> str:
        lines = ["column  MSE        MAE        RMSE       R2         corr"]
        for c in range(self.n_columns):
            lines.append(f"{c:5d}  {self.mean_squared_error(c):<10.5f} "
                         f"{self.mean_absolute_error(c):<10.5f} "
                         f"{self.root_mean_squared_error(c):<10.5f} "
                         f"{self.r_squared(c):<10.5f} {self.pearson_correlation(c):<10.5f}")
        return "\n".join(lines)
