"""Updater (learning-rule) configs and their update math — port of
deeplearning4j_tpu/nn/updater/updaters.py.

Same class and field names as the JAX package, so a config's ``updater``
round-trips. Each updater is a pure (state, grad, lr, step) -> (delta,
state) function; ``delta`` is ADDED to the parameter. The math is the JAX
package's, written out by hand: DL4J's Nesterov look-ahead and Adam are
not `torch.optim`'s. State is kept in float32 whatever the parameter
dtype, and the scalar constants (1 - beta1, 1 + mu, beta ** t) are
rounded to float32 as JAX computes them.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np
import torch

from ..conf.serde import register

Tensor = torch.Tensor
State = Dict[str, Tensor]

_EPS_DEFAULT = 1e-8


def _f32(v) -> float:
    """``v`` rounded to float32, as a Python float."""
    return float(np.float32(v))


def _zeros(param: Tensor, names) -> State:
    return {n: torch.zeros(param.shape, dtype=torch.float32,
                           device=param.device) for n in names}


@dataclass
class UpdaterConfig:
    """Base updater config. learning_rate < 0 means inherit the net-level lr."""

    def init_state(self, param: Tensor) -> State:
        return {}

    def apply(self, state: State, grad: Tensor, lr: float, step: int
              ) -> Tuple[Tensor, State]:
        raise NotImplementedError


@register
@dataclass
class Sgd(UpdaterConfig):
    learning_rate: float = -1.0

    def apply(self, state, grad, lr, step):
        return -_f32(lr) * grad, state


@register
@dataclass
class NoOp(UpdaterConfig):
    """Gradient applied raw (reference NoOpUpdater)."""

    def apply(self, state, grad, lr, step):
        return -grad, state


@register
@dataclass
class Nesterovs(UpdaterConfig):
    learning_rate: float = -1.0
    momentum: float = 0.9
    # iteration -> momentum overrides (reference momentumAfter schedule)
    momentum_schedule: Dict[str, float] = field(default_factory=dict)

    def init_state(self, param):
        return _zeros(param, ("v",))

    def _momentum(self, step: int) -> np.float32:
        mu = np.float32(self.momentum)
        for it, m in sorted((int(k), v)
                            for k, v in self.momentum_schedule.items()):
            if step >= it:
                mu = np.float32(m)
        return mu

    def apply(self, state, grad, lr, step):
        g = grad.float()
        mu = self._momentum(step)
        v = state["v"]
        v_new = float(mu) * v - _f32(lr) * g
        # Nesterov look-ahead: params += -mu * v + (1 + mu) * v_new
        delta = float(np.float32(1.0) + mu) * v_new - float(mu) * v
        return delta.to(grad.dtype), {"v": v_new}


@register
@dataclass
class Adam(UpdaterConfig):
    """Adam; with ``weight_decay > 0`` AdamW: the decay is applied to the
    parameter at the update site (nn/multilayer._apply_updaters), never to
    the moments."""

    learning_rate: float = -1.0
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = _EPS_DEFAULT
    weight_decay: float = 0.0

    def init_state(self, param):
        return _zeros(param, ("m", "u"))

    def apply(self, state, grad, lr, step):
        g = grad.float()
        t = np.float32(step + 1)
        b1, b2 = np.float32(self.beta1), np.float32(self.beta2)
        m = float(b1) * state["m"] + float(np.float32(1.0) - b1) * g
        u = float(b2) * state["u"] + float(np.float32(1.0) - b2) * g * g
        mhat = m / float(np.float32(1.0) - np.power(b1, t))
        uhat = u / float(np.float32(1.0) - np.power(b2, t))
        delta = -_f32(lr) * mhat / (torch.sqrt(uhat) + self.epsilon)
        return delta.to(grad.dtype), {"m": m, "u": u}


@register
@dataclass
class AdaGrad(UpdaterConfig):
    learning_rate: float = -1.0
    epsilon: float = _EPS_DEFAULT

    def init_state(self, param):
        return _zeros(param, ("h",))

    def apply(self, state, grad, lr, step):
        g = grad.float()
        h = state["h"] + g * g
        delta = -_f32(lr) * g / (torch.sqrt(h) + self.epsilon)
        return delta.to(grad.dtype), {"h": h}


@register
@dataclass
class AdaDelta(UpdaterConfig):
    rho: float = 0.95
    epsilon: float = 1e-6

    def init_state(self, param):
        return _zeros(param, ("eg", "edx"))

    def apply(self, state, grad, lr, step):
        g = grad.float()
        rho = np.float32(self.rho)
        one_m = float(np.float32(1.0) - rho)
        eg = float(rho) * state["eg"] + one_m * g * g
        dx = (-torch.sqrt(state["edx"] + self.epsilon)
              / torch.sqrt(eg + self.epsilon) * g)
        edx = float(rho) * state["edx"] + one_m * dx * dx
        return dx.to(grad.dtype), {"eg": eg, "edx": edx}


@register
@dataclass
class RmsProp(UpdaterConfig):
    learning_rate: float = -1.0
    rms_decay: float = 0.95
    epsilon: float = _EPS_DEFAULT

    def init_state(self, param):
        return _zeros(param, ("eg",))

    def apply(self, state, grad, lr, step):
        g = grad.float()
        d = np.float32(self.rms_decay)
        eg = float(d) * state["eg"] + float(np.float32(1.0) - d) * g * g
        delta = -_f32(lr) * g / torch.sqrt(eg + self.epsilon)
        return delta.to(grad.dtype), {"eg": eg}


@register
@dataclass
class AdaMax(UpdaterConfig):
    learning_rate: float = -1.0
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = _EPS_DEFAULT

    def init_state(self, param):
        return _zeros(param, ("m", "u"))

    def apply(self, state, grad, lr, step):
        g = grad.float()
        t = np.float32(step + 1)
        b1 = np.float32(self.beta1)
        m = float(b1) * state["m"] + float(np.float32(1.0) - b1) * g
        u = torch.maximum(_f32(self.beta2) * state["u"], torch.abs(g))
        scale = float(np.float32(-_f32(lr))
                      / (np.float32(1.0) - np.power(b1, t)))
        delta = scale * m / (u + self.epsilon)
        return delta.to(grad.dtype), {"m": m, "u": u}


UPDATERS = {
    "sgd": Sgd,
    "noop": NoOp,
    "nesterovs": Nesterovs,
    "adam": Adam,
    "adagrad": AdaGrad,
    "adadelta": AdaDelta,
    "rmsprop": RmsProp,
    "adamax": AdaMax,
}


def resolve_updater(u) -> UpdaterConfig:
    """Accept an UpdaterConfig instance or a string name."""
    if isinstance(u, UpdaterConfig):
        return u
    if isinstance(u, str):
        try:
            return UPDATERS[u.lower()]()
        except KeyError:
            raise ValueError(f"Unknown updater '{u}'. Available: "
                             f"{sorted(UPDATERS)}") from None
    raise TypeError(f"Cannot resolve updater from {type(u)}")
