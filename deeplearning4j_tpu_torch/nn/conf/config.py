"""NeuralNetConfiguration: net-level hyperparameters and the builder DSL.

Port of the graph-building half of deeplearning4j_tpu/nn/conf/config.py:
`NeuralNetConfiguration` (same fields, so its JSON round-trips), its
fluent builder, and `resolve_layer_defaults`. The sequential
`MultiLayerConfiguration` / `ListBuilder` come with the training slice.
"""
from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from . import serde
from .layers import Layer
from ..updater.updaters import Sgd, UpdaterConfig, resolve_updater

BACKPROP_STANDARD = "standard"
BACKPROP_TBPTT = "truncated_bptt"


@serde.register
@dataclass
class NeuralNetConfiguration:
    """Net-level hyperparameters (reference NeuralNetConfiguration.java:55)."""

    seed: int = 123
    optimization_algo: str = "stochastic_gradient_descent"
    iterations: int = 1
    learning_rate: float = 1e-1
    bias_learning_rate: Optional[float] = None
    lr_policy: str = "none"
    lr_policy_decay_rate: float = 0.0
    lr_policy_power: float = 1.0
    lr_policy_steps: float = 1.0
    lr_schedule: Dict[str, float] = field(default_factory=dict)
    max_num_iterations: int = 1
    updater: UpdaterConfig = field(default_factory=Sgd)
    use_regularization: bool = False
    l1: float = 0.0
    l2: float = 0.0
    dropout: float = 0.0
    use_drop_connect: bool = False
    weight_init: str = "xavier"
    dist: Optional[Any] = None
    activation: str = "sigmoid"
    bias_init: float = 0.0
    gradient_normalization: str = "none"
    gradient_normalization_threshold: float = 1.0
    minibatch: bool = True
    mini_batch: Optional[bool] = None
    max_num_line_search_iterations: int = 5
    step_function: str = "negative_gradient"
    dtype: str = "float32"
    compute_dtype: Optional[str] = None
    remat: bool = False

    @staticmethod
    def builder() -> "NeuralNetConfigurationBuilder":
        return NeuralNetConfigurationBuilder()

    def to_json(self) -> str:
        return serde.to_json(self)

    @staticmethod
    def from_json(s: str) -> "NeuralNetConfiguration":
        return serde.from_json(s)


class NeuralNetConfigurationBuilder:
    """Fluent builder: one setter per config field."""

    def __init__(self):
        self._conf = NeuralNetConfiguration()

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        fields = {f.name for f in dataclasses.fields(NeuralNetConfiguration)}
        if name in fields:
            def setter(value):
                setattr(self._conf, name, value)
                return self
            return setter
        raise AttributeError(f"No config field '{name}'")

    def updater(self, u):
        self._conf.updater = resolve_updater(u)
        return self

    def build(self) -> NeuralNetConfiguration:
        return copy.deepcopy(self._conf)

    def graph_builder(self):
        from .graph import GraphBuilder
        return GraphBuilder(self.build())


def resolve_layer_defaults(layer: Layer, conf: NeuralNetConfiguration) -> Layer:
    """Fill unset layer fields from net-level defaults (reference Builder.layer)."""
    layer = layer.clone()
    defaults = {
        "activation": conf.activation,
        "weight_init": conf.weight_init,
        "dist": conf.dist,
        "dropout": conf.dropout,
        "l1": conf.l1 if conf.use_regularization else 0.0,
        "l2": conf.l2 if conf.use_regularization else 0.0,
        "bias_init": conf.bias_init,
        "learning_rate": conf.learning_rate,
        "bias_learning_rate": (conf.bias_learning_rate
                               if conf.bias_learning_rate is not None
                               else conf.learning_rate),
        "updater": conf.updater,
        "gradient_normalization": conf.gradient_normalization,
        "gradient_normalization_threshold": conf.gradient_normalization_threshold,
    }
    for name, value in defaults.items():
        if getattr(layer, name, None) is None:
            setattr(layer, name, copy.deepcopy(value))
    return layer
