"""Distributed evaluation, scoring and early stopping — port of
deeplearning4j_tpu/parallel/evaluation.py.

The reference's Spark evaluation stack (EvaluateFlatMapFunction +
EvaluationReduceFunction, SparkEarlyStoppingTrainer and
SparkDataSetLossCalculator). As in the JAX package, each batch is padded
(zero-weight fill rows) and split over the mesh's ranks; each rank builds
its shard's confusion counts as one product — one_hot(actual)^T
(weighted) @ one_hot(predicted) — and one all-reduce sums them; a score
is each rank's weighted loss over the global weight, summed, plus the
regularization once. Both facades are served. The ranks are the
processes of a `parallel.mesh.ProcessMesh` (`parallel/trainer.py`'s
replicas, handed rank 0's state first).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..earlystopping.earlystopping import (EarlyStoppingResult,
                                           EarlyStoppingTrainer,
                                           ScoreCalculator)
from ..evaluation.evaluation import Evaluation
from .mesh import ProcessMesh
from .trainer import (OP_EVAL, OP_SCORE, TrainingMaster, _as_lists, _mesh_for,
                      _np, _pad_ragged, _Ranks, _eval_counts, _score)


def _padded(ds, n_dev: int):
    """(inputs, labels, fmasks, lmasks, real rows) of one batch, padded to
    the rank count, every output with loss weights (ones where it has no
    mask; zero on fill rows)."""
    inputs, labels, fms, lms = _as_lists(ds)
    inputs = [_np(a) for a in inputs]
    labels = [_np(a) for a in labels]
    fms = [_np(m) for m in fms] if fms is not None else None
    lms = [_np(m) for m in lms] if lms is not None else None
    orig = inputs[0].shape[0]
    inputs, labels, fms, lms = _pad_ragged(inputs, labels, fms, lms, n_dev)
    if lms is None:
        lms = [None] * len(labels)
    lms = [np.asarray(m, np.float32) if m is not None
           else np.ones((y.shape[0],) if y.ndim == 2 else y.shape[:2],
                        np.float32)
           for m, y in zip(lms, labels)]
    fms = ([np.asarray(m, np.float32) if m is not None else None
            for m in fms] if fms is not None else None)
    return (inputs, labels, fms, lms), orig


class _Session:
    """Replicas of ``net`` on ``mesh`` for one evaluation pass (followers
    started for it are stopped after it)."""

    def __init__(self, net, mesh):
        net._check_init()
        self.ranks = _Ranks(_mesh_for(mesh, net))

    def __enter__(self) -> _Ranks:
        return self.ranks

    def __exit__(self, *exc) -> None:
        self.ranks.close()


def distributed_evaluate(net, iterator, mesh: Optional[ProcessMesh] = None,
                         n_classes: Optional[int] = None) -> Evaluation:
    """Mesh-split classification evaluation; equals local evaluate()."""
    ev: Optional[Evaluation] = None
    with _Session(net, mesh) as ranks:
        ranks.prepare(net)
        comm = ranks.mesh
        for ds in iterator:
            batch, _ = _padded(ds, comm.size)
            if ev is None:
                n_classes = n_classes or batch[1][0].shape[-1]
                ev = Evaluation(n_classes)
                ev._ensure(n_classes)
            counts = ranks.run(
                OP_EVAL, batch,
                lambda: _eval_counts(net, comm, batch, n_classes),
                arg=n_classes)
            ev.confusion.matrix += np.rint(
                counts.cpu().numpy()).astype(np.int64)
    if ev is None:
        ev = Evaluation(n_classes or 2)
        ev._ensure(n_classes or 2)
    return ev


def distributed_score(net, iterator, mesh: Optional[ProcessMesh] = None,
                      average: bool = True) -> float:
    """Mesh-split dataset loss; equals local DataSetLossCalculator."""
    total, n = 0.0, 0
    with _Session(net, mesh) as ranks:
        ranks.prepare(net)
        comm = ranks.mesh
        for ds in iterator:
            batch, orig = _padded(ds, comm.size)
            loss = float(ranks.run(OP_SCORE, batch,
                                   lambda: _score(net, comm, batch)))
            total += loss * orig
            n += orig
    if n == 0:
        return float("nan")
    return total / n if average else total


class DistributedDataSetLossCalculator(ScoreCalculator):
    """Early-stopping score calculator on the mesh (reference
    SparkDataSetLossCalculator)."""

    def __init__(self, iterator, mesh: Optional[ProcessMesh] = None,
                 average: bool = True):
        self.iterator = iterator
        self.mesh = mesh
        self.average = average

    def calculate_score(self, net) -> float:
        self.iterator.reset()
        return distributed_score(net, self.iterator, self.mesh, self.average)


class DistributedEarlyStoppingTrainer(EarlyStoppingTrainer):
    """Early stopping with each epoch trained through a TrainingMaster
    (reference SparkEarlyStoppingTrainer.java:37)."""

    def __init__(self, config, net, train_iterator, master: TrainingMaster):
        super().__init__(config, net, train_iterator)
        self.master = master

    def _fit_epoch(self, result: EarlyStoppingResult) -> bool:
        self.master.execute_training(self.net, self.iterator)
        for cond in self.config.iteration_termination_conditions:
            if cond.terminate(self.net.score_):
                result.termination_reason = "IterationTerminationCondition"
                result.termination_details = type(cond).__name__
                return True
        return False
