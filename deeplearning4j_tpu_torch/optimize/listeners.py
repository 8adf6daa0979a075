"""Iteration listeners — port of deeplearning4j_tpu/optimize/listeners.py:
`IterationListener`, `ScoreIterationListener`,
`CollectScoresIterationListener`, `ParamAndGradientIterationListener`,
`ComposableIterationListener`, `TimeIterationListener` and
`PolyakAveragingListener`.

A net calls ``iteration_done(net, iteration)`` after each parameter
update. Reading ``net.score_`` copies the loss to the host, and so do
the parameter statistics of `ParamAndGradientIterationListener`: a
listener that reads them every step makes every step wait for the
device. `PolyakAveragingListener` reads nothing back: its average is
updated on the device.
"""
from __future__ import annotations

import contextlib
import logging
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ..nn.step_graph import _flatten, _map, copy_into

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


def _layers(params):
    """(label, {name: tensor}) of a MultiLayerNetwork's list or a
    ComputationGraph's dict of per-layer params."""
    return params.items() if isinstance(params, dict) else enumerate(params)


class ParamAndGradientIterationListener(IterationListener):
    """Log the score and each parameter's mean, largest magnitude and L2
    norm every ``iterations`` iterations."""

    def __init__(self, iterations: int = 1,
                 log_fn: Optional[Callable[[str], None]] = None):
        self.n = max(1, iterations)
        self._log = log_fn or logger.info

    def iteration_done(self, model, iteration):
        if iteration % self.n != 0:
            return
        lines = [f"iter {iteration} score {model.score_}"]
        for i, lp in _layers(model.params):
            for name, arr in lp.items():
                a = arr.detach().float().cpu().numpy()
                lines.append(f"  L{i}.{name}: mean={a.mean():.3e} "
                             f"absmax={np.abs(a).max():.3e} "
                             f"l2={np.linalg.norm(a):.3e}")
        self._log("\n".join(lines))


class ComposableIterationListener(IterationListener):
    """Fan one call out to several listeners, in order."""

    def __init__(self, *listeners: IterationListener):
        self.listeners = list(listeners)

    def iteration_done(self, model, iteration):
        for listener in self.listeners:
            listener.iteration_done(model, iteration)


class TimeIterationListener(IterationListener):
    """Host wall time between consecutive calls (the first from
    construction)."""

    def __init__(self, frequency: int = 1):
        self.frequency = max(1, frequency)
        self.times: List[float] = []
        self._last = time.perf_counter()

    def iteration_done(self, model, iteration):
        now = time.perf_counter()
        self.times.append(now - self._last)
        self._last = now

    def mean_iteration_seconds(self) -> float:
        return float(np.mean(self.times)) if self.times else 0.0


def _clone(tree):
    return _map(tree, lambda t: t.detach().clone())


def _tensors(tree):
    leaves = []
    _flatten(tree, leaves)
    return leaves


class PolyakAveragingListener(IterationListener):
    """Exponential moving average of the parameters, ``ema = decay * ema
    + (1 - decay) * params``, seeded with the first params it sees (JAX
    :104), on the device with no host read.

    One update per observable snapshot: ``fit_scan`` calls
    ``iteration_done`` K times after its chunk with the chunk's final
    params, so the listener updates once per value of the net's ``step``
    (once per step under ``fit_batch``, once per chunk under
    ``fit_scan``). The JAX package dedupes on the params' identity, which
    a port that updates its params in place cannot use.

    Usage::

        ema = PolyakAveragingListener(decay=0.999)
        net.set_listeners(ema)
        ... fit ...
        with ema.swapped_in(net):      # evaluate with the averaged weights
            acc = net.evaluate(it).accuracy()
    """

    def __init__(self, decay: float = 0.999):
        if not 0.0 < decay < 1.0:
            raise ValueError(f"decay must be in (0, 1), got {decay}")
        self.decay = decay
        self.ema = None
        self._last = None

    @torch.no_grad()
    def iteration_done(self, model, iteration):
        snapshot = (id(model), model.step)
        if snapshot == self._last:
            return
        self._last = snapshot
        if self.ema is None:
            self.ema = _clone(model.params)
            return
        d = self.decay
        for e, p in zip(_tensors(self.ema), _tensors(model.params)):
            e.copy_(d * e + (1.0 - d) * p)

    def ema_params(self):
        """The averaged params, in the net's layout."""
        if self.ema is None:
            raise ValueError("no updates observed yet")
        return self.ema

    def swap_in(self, model):
        """Copy the averaged params into the net's own tensors (so its
        captured steps stay valid) and return a copy of the trained
        ones."""
        trained = _clone(model.params)
        copy_into(model.params, self.ema_params())
        return trained

    @contextlib.contextmanager
    def swapped_in(self, model):
        """Evaluate under the averaged params; the trained ones are copied
        back after."""
        trained = self.swap_in(model)
        try:
            yield model
        finally:
            copy_into(model.params, trained)
