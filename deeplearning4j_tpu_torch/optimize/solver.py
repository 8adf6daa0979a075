"""Classic optimizers: SGD, line-search gradient descent, conjugate
gradient and LBFGS over a flat parameter vector — port of
deeplearning4j_tpu/optimize/solver.py (terminations :29-58,
`BackTrackLineSearch` :59, the optimizers :106-235, `Solver` :238).

The objective is any function f(flat tensor) -> scalar tensor; its
gradient comes from autograd (JAX takes ``jax.value_and_grad`` and jits
both). Everything runs eagerly, on the device of the vector: the line
search branches on the host every iteration, each branch reading one
scalar back, as JAX's does. The facades drive them when
``optimization_algo`` names one (`MultiLayerNetwork._fit_batch_solver`).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor
Objective = Callable[[Tensor], Tensor]


def _dot(a: Tensor, b: Tensor) -> float:
    return float(torch.dot(a.reshape(-1), b.reshape(-1)))


# -- termination conditions ---------------------------------------------------

class TerminationCondition:
    def terminate(self, cost: float, old_cost: float, direction: Tensor
                  ) -> bool:
        raise NotImplementedError


class EpsTermination(TerminationCondition):
    def __init__(self, eps: float = 1e-10, tolerance: float = 1e-5):
        self.eps = eps
        self.tolerance = tolerance

    def terminate(self, cost, old_cost, direction):
        return abs(old_cost - cost) <= self.tolerance * max(
            abs(old_cost) + abs(cost), self.eps)


class Norm2Termination(TerminationCondition):
    def __init__(self, gradient_tolerance: float = 1e-8):
        self.tol = gradient_tolerance

    def terminate(self, cost, old_cost, direction):
        return float(torch.linalg.vector_norm(direction)) < self.tol


class ZeroDirection(TerminationCondition):
    def terminate(self, cost, old_cost, direction):
        return float(direction.abs().max()) == 0.0


# -- line search --------------------------------------------------------------

class BackTrackLineSearch:
    """Armijo backtracking from ``initial_step``, shrinking by ``shrink``
    up to ``max_iterations`` times."""

    def __init__(self, objective: Objective, max_iterations: int = 20,
                 c1: float = 1e-4, shrink: float = 0.5,
                 initial_step: float = 1.0):
        self.objective = objective
        self.max_iterations = max_iterations
        self.c1 = c1
        self.shrink = shrink
        self.initial_step = initial_step

    @torch.no_grad()
    def optimize(self, params: Tensor, gradient: Tensor,
                 direction: Tensor) -> float:
        """The accepted step size (0.0: none, or not a descent
        direction)."""
        f0 = float(self.objective(params))
        slope = _dot(gradient, direction)
        if slope >= 0:
            return 0.0
        step = self.initial_step
        for _ in range(self.max_iterations):
            f1 = float(self.objective(params + step * direction))
            if f1 <= f0 + self.c1 * step * slope:
                return step
            step *= self.shrink
        return 0.0


# -- optimizers ---------------------------------------------------------------

class BaseOptimizer:
    def __init__(self, objective: Objective, max_iterations: int = 100,
                 terminations: Optional[List[TerminationCondition]] = None,
                 learning_rate: float = 0.1):
        self.objective = objective
        self.max_iterations = max_iterations
        self.terminations = terminations or [EpsTermination(),
                                             ZeroDirection()]
        self.learning_rate = learning_rate
        self.score_ = float("nan")

    def _vg(self, p: Tensor) -> Tuple[Tensor, Tensor]:
        """(f(p), grad f(p)), both detached."""
        with torch.enable_grad():
            q = p.detach().requires_grad_(True)
            v = self.objective(q)
            g, = torch.autograd.grad(v, q)
        return v.detach(), g

    def optimize(self, params: Tensor) -> Tensor:
        raise NotImplementedError

    def _terminate(self, cost, old_cost, direction) -> bool:
        if old_cost is None or not np.isfinite(old_cost):
            return False  # no previous cost yet
        return any(t.terminate(cost, old_cost, direction)
                   for t in self.terminations)


class StochasticGradientDescent(BaseOptimizer):
    def optimize(self, params):
        p = params.detach()
        old_cost = None
        for _ in range(self.max_iterations):
            cost, grad = self._vg(p)
            p = p - self.learning_rate * grad
            cost = float(cost)
            if self._terminate(cost, old_cost, grad):
                break
            old_cost = cost
        self.score_ = float(self._vg(p)[0])
        return p


class LineGradientDescent(BaseOptimizer):
    """Steepest descent with the Armijo line search."""

    def optimize(self, params):
        p = params.detach()
        ls = BackTrackLineSearch(self.objective)
        old_cost = None
        for _ in range(self.max_iterations):
            cost, grad = self._vg(p)
            direction = -grad
            step = ls.optimize(p, grad, direction)
            if step == 0.0:
                break
            p = p + step * direction
            cost = float(cost)
            if self._terminate(cost, old_cost, direction):
                break
            old_cost = cost
        self.score_ = float(self._vg(p)[0])
        return p


class ConjugateGradient(BaseOptimizer):
    """Polak-Ribiere nonlinear CG, restarted along steepest descent when
    the direction stops descending."""

    def optimize(self, params):
        p = params.detach()
        ls = BackTrackLineSearch(self.objective)
        cost, grad = self._vg(p)
        direction = -grad
        old_cost = float(cost)
        for _ in range(self.max_iterations):
            step = ls.optimize(p, grad, direction)
            if step == 0.0:
                break
            p = p + step * direction
            new_cost, new_grad = self._vg(p)
            denom = _dot(grad, grad)
            beta = _dot(new_grad, new_grad - grad) / max(denom, 1e-12)
            beta = max(0.0, beta)
            direction = -new_grad + beta * direction
            if _dot(direction, new_grad) >= 0:
                direction = -new_grad
            if self._terminate(float(new_cost), old_cost, direction):
                break
            old_cost = float(new_cost)
            grad = new_grad
        self.score_ = float(self._vg(p)[0])
        return p


class LBFGS(BaseOptimizer):
    """Limited-memory BFGS, two-loop recursion over ``memory`` pairs."""

    def __init__(self, objective: Objective, max_iterations: int = 100,
                 memory: int = 10, **kw):
        super().__init__(objective, max_iterations, **kw)
        self.memory = memory

    def optimize(self, params):
        p = params.detach()
        ls = BackTrackLineSearch(self.objective)
        s_hist: List[Tensor] = []
        y_hist: List[Tensor] = []
        cost, grad = self._vg(p)
        old_cost = float(cost)
        for _ in range(self.max_iterations):
            q = grad
            alphas = []
            for s, y in zip(reversed(s_hist), reversed(y_hist)):
                rho = 1.0 / _dot(y, s)
                a = rho * _dot(s, q)
                alphas.append((a, rho, s, y))
                q = q - a * y
            if y_hist:
                s, y = s_hist[-1], y_hist[-1]
                q = q * (_dot(s, y) / max(_dot(y, y), 1e-12))
            for a, rho, s, y in reversed(alphas):
                b = rho * _dot(y, q)
                q = q + (a - b) * s
            direction = -q
            step = ls.optimize(p, grad, direction)
            if step == 0.0:
                break
            p_new = p + step * direction
            new_cost, new_grad = self._vg(p_new)
            s_vec = p_new - p
            y_vec = new_grad - grad
            if _dot(s_vec, y_vec) > 1e-10:
                s_hist.append(s_vec)
                y_hist.append(y_vec)
                if len(s_hist) > self.memory:
                    s_hist.pop(0)
                    y_hist.pop(0)
            p, grad = p_new, new_grad
            if self._terminate(float(new_cost), old_cost, direction):
                break
            old_cost = float(new_cost)
        self.score_ = float(self._vg(p)[0])
        return p


OPTIMIZERS = {
    "stochastic_gradient_descent": StochasticGradientDescent,
    "sgd": StochasticGradientDescent,
    "line_gradient_descent": LineGradientDescent,
    "conjugate_gradient": ConjugateGradient,
    "lbfgs": LBFGS,
}


class Solver:
    """Builder facade (JAX solver.py :238)."""

    def __init__(self):
        self._objective: Optional[Objective] = None
        self._algo = "stochastic_gradient_descent"
        self._max_iterations = 100
        self._learning_rate = 0.1

    def objective(self, f: Objective) -> "Solver":
        self._objective = f
        return self

    def optimization_algo(self, name: str) -> "Solver":
        self._algo = name.lower()
        return self

    def max_iterations(self, n: int) -> "Solver":
        self._max_iterations = n
        return self

    def learning_rate(self, lr: float) -> "Solver":
        self._learning_rate = lr
        return self

    def build(self) -> BaseOptimizer:
        if self._objective is None:
            raise ValueError("Solver needs an objective")
        cls = OPTIMIZERS.get(self._algo)
        if cls is None:
            raise ValueError(f"Unknown algorithm '{self._algo}'. "
                             f"Available: {sorted(OPTIMIZERS)}")
        return cls(self._objective, self._max_iterations,
                   learning_rate=self._learning_rate)
