"""Iteration listeners — port of `IterationListener`,
`ScoreIterationListener` and `CollectScoresIterationListener` from
deeplearning4j_tpu/optimize/listeners.py.

A net calls ``iteration_done(net, iteration)`` after each parameter
update. Reading ``net.score_`` copies the loss to the host, so a listener
that reads it every step makes every step wait for the device.
"""
from __future__ import annotations

import logging
from typing import Callable, List, Optional

logger = logging.getLogger("deeplearning4j_tpu_torch")


class IterationListener:
    def iteration_done(self, model, iteration: int) -> None:
        raise NotImplementedError


class ScoreIterationListener(IterationListener):
    """Log the score every ``print_iterations`` iterations."""

    def __init__(self, print_iterations: int = 10,
                 log_fn: Optional[Callable[[str], None]] = None):
        self.n = max(1, print_iterations)
        self._log = log_fn or logger.info

    def iteration_done(self, model, iteration):
        if iteration % self.n == 0:
            self._log(f"Score at iteration {iteration} is {model.score_}")


class CollectScoresIterationListener(IterationListener):
    """Keep (iteration, score) every ``frequency`` iterations."""

    def __init__(self, frequency: int = 1):
        self.frequency = max(1, frequency)
        self.scores: List[tuple] = []

    def iteration_done(self, model, iteration):
        if iteration % self.frequency == 0:
            self.scores.append((iteration, model.score_))
