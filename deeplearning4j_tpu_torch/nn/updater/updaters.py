"""Updater configs — the serializable half of
deeplearning4j_tpu/nn/updater/updaters.py.

A network config names its updater (``transformer_lm`` uses Adam), so
reading a ``configuration.json`` needs these dataclasses, with the JAX
package's class and field names. This slice serves and does not train:
the update rules themselves come with the training slice.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

from ..conf.serde import register

_EPS_DEFAULT = 1e-8


@dataclass
class UpdaterConfig:
    """Base updater config. learning_rate < 0 means inherit the net-level lr."""


@register
@dataclass
class Sgd(UpdaterConfig):
    learning_rate: float = -1.0


@register
@dataclass
class NoOp(UpdaterConfig):
    """Gradient applied raw (reference NoOpUpdater)."""


@register
@dataclass
class Nesterovs(UpdaterConfig):
    learning_rate: float = -1.0
    momentum: float = 0.9
    momentum_schedule: Dict[str, float] = field(default_factory=dict)


@register
@dataclass
class Adam(UpdaterConfig):
    learning_rate: float = -1.0
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = _EPS_DEFAULT
    weight_decay: float = 0.0


@register
@dataclass
class AdaGrad(UpdaterConfig):
    learning_rate: float = -1.0
    epsilon: float = _EPS_DEFAULT


@register
@dataclass
class AdaDelta(UpdaterConfig):
    rho: float = 0.95
    epsilon: float = 1e-6


@register
@dataclass
class RmsProp(UpdaterConfig):
    learning_rate: float = -1.0
    rms_decay: float = 0.95
    epsilon: float = _EPS_DEFAULT


@register
@dataclass
class AdaMax(UpdaterConfig):
    learning_rate: float = -1.0
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = _EPS_DEFAULT


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
