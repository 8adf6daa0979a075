"""Early stopping — port of deeplearning4j_tpu/earlystopping/earlystopping.py:
the score calculator, the epoch and iteration termination conditions,
the in-memory and zip-file model savers, the configuration, the result
and the per-epoch trainer, for a MultiLayerNetwork or a
ComputationGraph.

The trainer fits one minibatch at a time (``net.fit(ds)``); it reads the
score of each step (a host read that makes the step wait for the device)
only when an iteration termination condition is configured, as the JAX
loop does. `DataSetLossCalculator` reads one score per held-out
minibatch. `InMemoryModelSaver` keeps ``net.clone()``s (fresh tensors on
the net's device). `LocalFileModelSaver` writes zips with
`util.model_serializer.write_model` and reads them back onto the device
of the net it saved through the type-dispatching `restore_model`, so a
ComputationGraph's best model restores as a graph; the JAX saver reads
every zip as a MultiLayerNetwork (JAX :165, :169).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, List


# -- score calculators ---------------------------------------------------------

class ScoreCalculator:
    def calculate_score(self, net) -> float:
        raise NotImplementedError


class DataSetLossCalculator(ScoreCalculator):
    """The loss over an iterator's minibatches, weighted by their sizes:
    the mean per example (``average``) or the sum."""

    def __init__(self, iterator, average: bool = True):
        self.iterator = iterator
        self.average = average

    def calculate_score(self, net) -> float:
        total, n = 0.0, 0
        self.iterator.reset()
        for ds in self.iterator:
            total += net.score(ds) * ds.num_examples()
            n += ds.num_examples()
        if n == 0:
            return float("nan")
        return total / n if self.average else total


# -- termination conditions ----------------------------------------------------

class EpochTerminationCondition:
    def terminate(self, epoch: int, score: float) -> bool:
        raise NotImplementedError


class IterationTerminationCondition:
    def terminate(self, last_score: float) -> bool:
        raise NotImplementedError


class MaxEpochsTerminationCondition(EpochTerminationCondition):
    """Stop after ``max_epochs`` epochs (epochs count from 0)."""

    def __init__(self, max_epochs: int):
        self.max_epochs = max_epochs

    def terminate(self, epoch, score):
        return epoch >= self.max_epochs - 1


class ScoreImprovementEpochTerminationCondition(EpochTerminationCondition):
    """Stop once more than ``max_epochs_without_improvement`` epochs in a
    row have not beaten the best score by ``min_improvement``."""

    def __init__(self, max_epochs_without_improvement: int,
                 min_improvement: float = 0.0):
        self.patience = max_epochs_without_improvement
        self.min_improvement = min_improvement
        self._best = float("inf")
        self._bad_epochs = 0

    def terminate(self, epoch, score):
        if score < self._best - self.min_improvement:
            self._best = score
            self._bad_epochs = 0
        else:
            self._bad_epochs += 1
        return self._bad_epochs > self.patience


class BestScoreEpochTerminationCondition(EpochTerminationCondition):
    """Stop once the score is below ``best_expected_score``."""

    def __init__(self, best_expected_score: float):
        self.best = best_expected_score

    def terminate(self, epoch, score):
        return score < self.best


class MaxTimeIterationTerminationCondition(IterationTerminationCondition):
    """Stop once ``max_seconds`` have passed since construction."""

    def __init__(self, max_seconds: float):
        self.max_seconds = max_seconds
        self._start = time.time()

    def terminate(self, last_score):
        return (time.time() - self._start) > self.max_seconds


class MaxScoreIterationTerminationCondition(IterationTerminationCondition):
    """Stop when a step's score exceeds ``max_score`` or is NaN."""

    def __init__(self, max_score: float):
        self.max_score = max_score

    def terminate(self, last_score):
        return last_score > self.max_score or last_score != last_score


# -- model savers --------------------------------------------------------------

class EarlyStoppingModelSaver:
    def save_best_model(self, net, score: float) -> None:
        raise NotImplementedError

    def save_latest_model(self, net, score: float) -> None:
        raise NotImplementedError

    def get_best_model(self):
        raise NotImplementedError

    def get_latest_model(self):
        raise NotImplementedError


class InMemoryModelSaver(EarlyStoppingModelSaver):
    def __init__(self):
        self._best = None
        self._latest = None

    def save_best_model(self, net, score):
        self._best = net.clone()

    def save_latest_model(self, net, score):
        self._latest = net.clone()

    def get_best_model(self):
        return self._best

    def get_latest_model(self):
        return self._latest


class LocalFileModelSaver(EarlyStoppingModelSaver):
    """``bestModel.zip`` and ``latestModel.zip`` in ``directory``."""

    def __init__(self, directory: str):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._device = None

    def _best_path(self):
        return self.dir / "bestModel.zip"

    def _latest_path(self):
        return self.dir / "latestModel.zip"

    def _write(self, net, path):
        from ..util import model_serializer
        self._device = net.device
        model_serializer.write_model(net, path)

    def _read(self, path):
        from ..util import model_serializer
        return model_serializer.restore_model(
            path, device=self._device or "cuda")

    def save_best_model(self, net, score):
        self._write(net, self._best_path())

    def save_latest_model(self, net, score):
        self._write(net, self._latest_path())

    def get_best_model(self):
        return self._read(self._best_path())

    def get_latest_model(self):
        return self._read(self._latest_path())


# -- configuration + result ----------------------------------------------------

@dataclass
class EarlyStoppingConfiguration:
    score_calculator: ScoreCalculator = None
    model_saver: EarlyStoppingModelSaver = field(
        default_factory=InMemoryModelSaver)
    epoch_termination_conditions: List[EpochTerminationCondition] = field(
        default_factory=list)
    iteration_termination_conditions: List[IterationTerminationCondition] = \
        field(default_factory=list)
    evaluate_every_n_epochs: int = 1
    save_last_model: bool = False


@dataclass
class EarlyStoppingResult:
    termination_reason: str = ""
    termination_details: str = ""
    total_epochs: int = 0
    best_model_epoch: int = -1
    best_model_score: float = float("inf")
    score_vs_epoch: dict = field(default_factory=dict)
    best_model: Any = None


class EarlyStoppingTrainer:
    """The per-epoch early-stopping loop (JAX :196): fit an epoch, score
    it every ``evaluate_every_n_epochs``, keep the best model, stop on
    the first condition that fires."""

    def __init__(self, config: EarlyStoppingConfiguration, net,
                 train_iterator):
        self.config = config
        self.net = net
        self.iterator = train_iterator

    def _fit_epoch(self, result: EarlyStoppingResult) -> bool:
        """One training epoch; True if an iteration termination condition
        fired."""
        conds = self.config.iteration_termination_conditions
        for ds in self.iterator:
            self.net.fit(ds)
            for cond in conds:
                if cond.terminate(self.net.score_):
                    result.termination_reason = \
                        "IterationTerminationCondition"
                    result.termination_details = type(cond).__name__
                    return True
        return False

    def fit(self) -> EarlyStoppingResult:
        cfg = self.config
        result = EarlyStoppingResult()
        epoch = 0
        while True:
            self.iterator.reset()
            if self._fit_epoch(result):
                break
            if epoch % cfg.evaluate_every_n_epochs == 0:
                score = cfg.score_calculator.calculate_score(self.net)
                result.score_vs_epoch[epoch] = score
                if score < result.best_model_score:
                    result.best_model_score = score
                    result.best_model_epoch = epoch
                    cfg.model_saver.save_best_model(self.net, score)
                if cfg.save_last_model:
                    cfg.model_saver.save_latest_model(self.net, score)
                stop = False
                for cond in cfg.epoch_termination_conditions:
                    if cond.terminate(epoch, score):
                        result.termination_reason = \
                            "EpochTerminationCondition"
                        result.termination_details = type(cond).__name__
                        stop = True
                        break
                if stop:
                    break
            epoch += 1
        result.total_epochs = epoch + 1
        result.best_model = cfg.model_saver.get_best_model()
        return result
