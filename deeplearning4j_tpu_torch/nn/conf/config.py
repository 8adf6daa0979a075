"""NeuralNetConfiguration: net-level hyperparameters, the builder DSL and
MultiLayerConfiguration.

Port of deeplearning4j_tpu/nn/conf/config.py: `NeuralNetConfiguration`
(same fields, so its JSON round-trips), its fluent builder,
`MultiLayerConfiguration` with the `.list()` builder, and the shape
inference of `set_input_type`, which wires each layer's n_in and inserts
the preprocessors between layer kinds as the JAX package does. Both
configurations write and read JSON and YAML (nn/conf/serde.py).
"""
from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from . import distributions as _distributions  # noqa: F401 (registers)
from . import serde
from .inputs import (ConvolutionalFlatInputType, ConvolutionalInputType,
                     FeedForwardInputType, InputType, RecurrentInputType)
from .layers import (ActivationLayer, BaseRecurrentLayer, BatchNormalization,
                     ConvolutionLayer, DropoutLayer, FeedForwardLayer,
                     GlobalPoolingLayer, Layer, LayerNormalization,
                     LocalResponseNormalization, RnnOutputLayer,
                     SelfAttentionLayer, SubsamplingLayer)
from .preprocessors import (CnnToFeedForwardPreProcessor,
                            CnnToRnnPreProcessor,
                            FeedForwardToCnnPreProcessor,
                            FeedForwardToRnnPreProcessor, InputPreProcessor,
                            RnnToCnnPreProcessor,
                            RnnToFeedForwardPreProcessor)
from ..updater.updaters import (Nesterovs, Sgd, UpdaterConfig,
                                resolve_updater)

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

    def to_yaml(self) -> str:
        return serde.to_yaml(self)

    @staticmethod
    def from_yaml(s: str) -> "NeuralNetConfiguration":
        return serde.from_yaml(s)


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

    def regularization(self, flag: bool = True):
        self._conf.use_regularization = flag
        return self

    def momentum(self, m: float):
        if isinstance(self._conf.updater, Nesterovs):
            self._conf.updater.momentum = m
        else:
            self._conf.updater = Nesterovs(momentum=m)
        return self

    def build(self) -> NeuralNetConfiguration:
        return copy.deepcopy(self._conf)

    def list(self) -> "ListBuilder":
        return ListBuilder(self.build())

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


@serde.register
@dataclass
class MultiLayerConfiguration:
    """Full sequential-net configuration (JAX config.py :152)."""

    conf: NeuralNetConfiguration = field(default_factory=NeuralNetConfiguration)
    layers: List[Layer] = field(default_factory=list)
    input_preprocessors: Dict[str, InputPreProcessor] = field(
        default_factory=dict)
    backprop: bool = True
    pretrain: bool = False
    backprop_type: str = BACKPROP_STANDARD
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20
    input_type: Optional[InputType] = None

    def preprocessor(self, idx: int) -> Optional[InputPreProcessor]:
        return self.input_preprocessors.get(str(idx))

    def to_json(self) -> str:
        return serde.to_json(self)

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        return serde.from_json(s)

    def to_yaml(self) -> str:
        return serde.to_yaml(self)

    @staticmethod
    def from_yaml(s: str) -> "MultiLayerConfiguration":
        return serde.from_yaml(s)


class ListBuilder:
    """Builds a MultiLayerConfiguration from an ordered layer list."""

    def __init__(self, conf: NeuralNetConfiguration):
        self._conf = conf
        self._layers: Dict[int, Layer] = {}
        self._preprocessors: Dict[int, InputPreProcessor] = {}
        self._backprop = True
        self._pretrain = False
        self._backprop_type = BACKPROP_STANDARD
        self._tbptt_fwd = 20
        self._tbptt_back = 20
        self._input_type: Optional[InputType] = None

    def layer(self, idx_or_layer, maybe_layer: Optional[Layer] = None
              ) -> "ListBuilder":
        if maybe_layer is None:
            idx, layer = len(self._layers), idx_or_layer
        else:
            idx, layer = idx_or_layer, maybe_layer
        self._layers[int(idx)] = layer
        return self

    def input_pre_processor(self, idx: int, proc: InputPreProcessor
                            ) -> "ListBuilder":
        self._preprocessors[int(idx)] = proc
        return self

    def backprop(self, flag: bool) -> "ListBuilder":
        self._backprop = flag
        return self

    def pretrain(self, flag: bool) -> "ListBuilder":
        self._pretrain = flag
        return self

    def backprop_type(self, t: str) -> "ListBuilder":
        self._backprop_type = t
        return self

    def t_bptt_forward_length(self, n: int) -> "ListBuilder":
        self._tbptt_fwd = n
        return self

    def t_bptt_backward_length(self, n: int) -> "ListBuilder":
        self._tbptt_back = n
        return self

    def set_input_type(self, t: InputType) -> "ListBuilder":
        self._input_type = t
        return self

    input_type = set_input_type

    def build(self) -> MultiLayerConfiguration:
        n = len(self._layers)
        if sorted(self._layers) != list(range(n)):
            raise ValueError(f"Layer indices must be contiguous 0..{n - 1}, "
                             f"got {sorted(self._layers)}")
        layers = [resolve_layer_defaults(self._layers[i], self._conf)
                  for i in range(n)]
        preprocessors = dict(self._preprocessors)
        if self._input_type is not None:
            _infer_shapes(layers, preprocessors, self._input_type)
        else:
            _chain_nin_from_nout(layers)
        return MultiLayerConfiguration(
            conf=self._conf, layers=layers,
            input_preprocessors={str(k): v for k, v in preprocessors.items()},
            backprop=self._backprop, pretrain=self._pretrain,
            backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_back_length=self._tbptt_back,
            input_type=self._input_type)


def _chain_nin_from_nout(layers: List[Layer]) -> None:
    """Without an InputType, wire missing n_in from the previous layer's
    n_out; conv and subsampling layers break the chain."""
    prev = None
    for layer in layers:
        if (isinstance(layer, (ConvolutionLayer, SubsamplingLayer))
                or not isinstance(layer, FeedForwardLayer)):
            prev = None
            continue
        if layer.n_in is None and prev is not None:
            layer.set_n_in(InputType.feed_forward(prev))
        if layer.n_out is not None:
            prev = layer.n_out
        elif not isinstance(layer, BatchNormalization):
            prev = None


_CNN_LAYERS = (ConvolutionLayer, SubsamplingLayer, LocalResponseNormalization)


def _layer_wants(layer: Layer) -> str:
    """What input kind a layer consumes (JAX config.py :306-320)."""
    if isinstance(layer, _CNN_LAYERS):
        return "convolutional"
    if isinstance(layer, (BaseRecurrentLayer, RnnOutputLayer,
                          SelfAttentionLayer)):
        return "recurrent"
    if isinstance(layer, (ActivationLayer, DropoutLayer, BatchNormalization,
                          LayerNormalization, GlobalPoolingLayer)):
        return "any"
    return "feedforward"


def _default_preprocessor(cur: InputType, wants: str
                          ) -> Optional[InputPreProcessor]:
    if wants == "any":
        return None
    if isinstance(cur, ConvolutionalFlatInputType):
        if wants == "convolutional":
            return FeedForwardToCnnPreProcessor(cur.height, cur.width,
                                                cur.channels)
        if wants == "recurrent":
            return FeedForwardToRnnPreProcessor()
        return None
    if isinstance(cur, ConvolutionalInputType):
        if wants == "feedforward":
            return CnnToFeedForwardPreProcessor(cur.height, cur.width,
                                                cur.channels)
        if wants == "recurrent":
            return CnnToRnnPreProcessor(cur.height, cur.width, cur.channels)
        return None
    if isinstance(cur, FeedForwardInputType):
        if wants == "recurrent":
            return FeedForwardToRnnPreProcessor()
        if wants == "convolutional":
            raise ValueError("Cannot infer CNN dims from a plain feedforward "
                             "input; use InputType.convolutional_flat or an "
                             "explicit preprocessor")
        return None
    if isinstance(cur, RecurrentInputType):
        if wants == "feedforward":
            return RnnToFeedForwardPreProcessor()
        if wants == "convolutional":
            raise ValueError("RnnToCnn requires explicit dims; add "
                             "RnnToCnnPreProcessor manually")
    return None


def _apply_preprocessor_type(proc: InputPreProcessor, cur: InputType
                             ) -> InputType:
    """Output InputType of a preprocessor given its input type."""
    if isinstance(proc, (CnnToFeedForwardPreProcessor,
                         RnnToFeedForwardPreProcessor)):
        return InputType.feed_forward(cur.flat_size())
    if isinstance(proc, (FeedForwardToCnnPreProcessor, RnnToCnnPreProcessor)):
        return InputType.convolutional(proc.height, proc.width, proc.channels)
    if isinstance(proc, (FeedForwardToRnnPreProcessor, CnnToRnnPreProcessor)):
        return InputType.recurrent(cur.flat_size())
    return cur


def _infer_shapes(layers: List[Layer],
                  preprocessors: Dict[int, InputPreProcessor],
                  input_type: InputType) -> None:
    """Walk layers, inserting preprocessors and wiring n_in (JAX config.py
    :376)."""
    cur = input_type
    for i, layer in enumerate(layers):
        wants = _layer_wants(layer)
        if i in preprocessors:
            cur = _apply_preprocessor_type(preprocessors[i], cur)
        else:
            proc = _default_preprocessor(cur, wants)
            if proc is not None:
                preprocessors[i] = proc
                cur = _apply_preprocessor_type(proc, cur)
            elif (isinstance(cur, ConvolutionalFlatInputType)
                  and wants == "feedforward"):
                cur = InputType.feed_forward(cur.flat_size())
        layer.set_n_in(cur)
        cur = layer.get_output_type(cur)
