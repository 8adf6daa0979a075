"""Layer configs — port of deeplearning4j_tpu/nn/conf/layers.py: Dense,
Output, RnnOutput, Loss, Convolution, Subsampling, BatchNormalization,
LayerNormalization, LocalResponseNormalization, the recurrent layers
(GravesLSTM, LSTM, GravesBidirectionalLSTM, GRU), Embedding, Activation,
Dropout, GlobalPooling, SelfAttention and the pretrain layers RBM and
AutoEncoder. Same class names, fields and defaults as the JAX package, so
configs round-trip between the two.

Configs are pure data. Unset fields (None) inherit net-level defaults at
build time (`config.resolve_layer_defaults`). Each config implements
`set_n_in` and `get_output_type` for the shape inference of
`ListBuilder.set_input_type`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Tuple

from .inputs import ConvolutionalInputType, InputType, RecurrentInputType
from .serde import register
from ..updater.updaters import UpdaterConfig


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (list, tuple)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


@dataclass
class Layer:
    """Abstract base layer config; every field may be None = inherit."""

    name: Optional[str] = None
    activation: Optional[str] = None
    weight_init: Optional[str] = None
    dist: Optional[Any] = None
    dropout: Optional[float] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    bias_init: Optional[float] = None
    learning_rate: Optional[float] = None
    bias_learning_rate: Optional[float] = None
    updater: Optional[UpdaterConfig] = None
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: Optional[float] = None

    def set_n_in(self, input_type: InputType) -> None:
        """Set this layer's fan-in from the upstream output type."""

    def get_output_type(self, input_type: InputType) -> InputType:
        return input_type

    def is_pretrain_layer(self) -> bool:
        return False

    def clone(self) -> "Layer":
        return dataclasses.replace(self)


@dataclass
class FeedForwardLayer(Layer):
    n_in: Optional[int] = None
    n_out: Optional[int] = None

    def set_n_in(self, input_type: InputType) -> None:
        if self.n_in is None:
            self.n_in = input_type.flat_size()

    def get_output_type(self, input_type: InputType) -> InputType:
        if isinstance(input_type, RecurrentInputType):
            return InputType.recurrent(self.n_out, input_type.timesteps)
        return InputType.feed_forward(self.n_out)


@register
@dataclass
class DenseLayer(FeedForwardLayer):
    """Fully connected layer: y = act(x @ W + b), W [n_in, n_out]."""


@register
@dataclass
class OutputLayer(FeedForwardLayer):
    """Output layer; the network computes the loss named by ``loss``."""

    loss: str = "negativeloglikelihood"


@register
@dataclass
class RnnOutputLayer(FeedForwardLayer):
    """Per-timestep output layer: [B, T, n_in] -> [B, T, n_out]."""

    loss: str = "mcxent"

    def get_output_type(self, input_type: InputType) -> InputType:
        ts = (input_type.timesteps
              if isinstance(input_type, RecurrentInputType) else None)
        return InputType.recurrent(self.n_out, ts)


@register
@dataclass
class LossLayer(Layer):
    """Loss-only layer, no params."""

    loss: str = "mse"


@register
@dataclass
class ConvolutionLayer(FeedForwardLayer):
    """2D convolution, NHWC; n_in = input channels, n_out = output
    channels; weights HWIO [kh, kw, n_in, n_out]."""

    kernel_size: Tuple[int, int] = (5, 5)
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)
    convolution_mode: str = "truncate"  # truncate | same
    dilation: Tuple[int, int] = (1, 1)

    def __post_init__(self):
        self.kernel_size = _pair(self.kernel_size)
        self.stride = _pair(self.stride)
        self.padding = _pair(self.padding)
        self.dilation = _pair(self.dilation)

    def set_n_in(self, input_type: InputType) -> None:
        if self.n_in is None:
            if not isinstance(input_type, ConvolutionalInputType):
                raise ValueError(f"ConvolutionLayer expects convolutional "
                                 f"input, got {input_type}")
            self.n_in = input_type.channels

    def get_output_type(self, input_type: InputType) -> InputType:
        if not isinstance(input_type, ConvolutionalInputType):
            raise ValueError(f"ConvolutionLayer expects convolutional input, "
                             f"got {input_type}")
        h, w = _conv_out_hw(input_type.height, input_type.width,
                            self.kernel_size, self.stride, self.padding,
                            self.convolution_mode, self.dilation)
        return InputType.convolutional(h, w, self.n_out)


@register
@dataclass
class SubsamplingLayer(Layer):
    """Pooling layer: max | avg | sum | pnorm."""

    pooling_type: str = "max"
    kernel_size: Tuple[int, int] = (2, 2)
    stride: Tuple[int, int] = (2, 2)
    padding: Tuple[int, int] = (0, 0)
    convolution_mode: str = "truncate"
    pnorm: int = 2

    def __post_init__(self):
        self.kernel_size = _pair(self.kernel_size)
        self.stride = _pair(self.stride)
        self.padding = _pair(self.padding)

    def get_output_type(self, input_type: InputType) -> InputType:
        if not isinstance(input_type, ConvolutionalInputType):
            raise ValueError(f"SubsamplingLayer expects convolutional input, "
                             f"got {input_type}")
        h, w = _conv_out_hw(input_type.height, input_type.width,
                            self.kernel_size, self.stride, self.padding,
                            self.convolution_mode, (1, 1))
        return InputType.convolutional(h, w, input_type.channels)


@register
@dataclass
class BatchNormalization(FeedForwardLayer):
    """Batch norm over the feature axis: [B, F] and NHWC [B, H, W, C]
    inputs (per-channel statistics)."""

    decay: float = 0.9
    eps: float = 1e-5
    gamma: float = 1.0
    beta: float = 0.0
    lock_gamma_beta: bool = False
    use_global_stats: bool = False

    def set_n_in(self, input_type: InputType) -> None:
        if self.n_in is None:
            if isinstance(input_type, ConvolutionalInputType):
                self.n_in = input_type.channels
            else:
                self.n_in = input_type.flat_size()
        if self.n_out is None:
            self.n_out = self.n_in

    def get_output_type(self, input_type: InputType) -> InputType:
        return input_type


@register
@dataclass
class LayerNormalization(FeedForwardLayer):
    """Layer norm over the trailing feature axis (population variance)."""

    eps: float = 1e-5

    def set_n_in(self, input_type: InputType) -> None:
        if self.n_in is None:
            if isinstance(input_type, ConvolutionalInputType):
                self.n_in = input_type.channels
            else:
                self.n_in = input_type.flat_size()
        if self.n_out is None:
            self.n_out = self.n_in

    def get_output_type(self, input_type: InputType) -> InputType:
        return input_type


@register
@dataclass
class LocalResponseNormalization(Layer):
    """LRN across channels, NHWC: x / (k + alpha * sum x^2)^beta over a
    window of 2 * (n // 2) + 1 channels."""

    k: float = 2.0
    n: float = 5.0
    alpha: float = 1e-4
    beta: float = 0.75


@dataclass
class BaseRecurrentLayer(FeedForwardLayer):
    def get_output_type(self, input_type: InputType) -> InputType:
        ts = (input_type.timesteps
              if isinstance(input_type, RecurrentInputType) else None)
        return InputType.recurrent(self.n_out, ts)


@register
@dataclass
class GravesLSTM(BaseRecurrentLayer):
    """LSTM with peephole connections (Graves 2013)."""

    forget_gate_bias_init: float = 1.0


@register
@dataclass
class LSTM(BaseRecurrentLayer):
    """Standard (non-peephole) LSTM."""

    forget_gate_bias_init: float = 1.0


@register
@dataclass
class GravesBidirectionalLSTM(BaseRecurrentLayer):
    """Bidirectional Graves LSTM; the two directions' outputs summed."""

    forget_gate_bias_init: float = 1.0


@register
@dataclass
class GRU(BaseRecurrentLayer):
    """Gated recurrent unit."""


@register
@dataclass
class EmbeddingLayer(FeedForwardLayer):
    """Index -> dense vector lookup. Input: [batch] or [batch, 1] integer
    indices (or one-hot [batch, n_in])."""

    has_bias: bool = True


@register
@dataclass
class ActivationLayer(Layer):
    """Parameterless activation."""


@register
@dataclass
class DropoutLayer(Layer):
    """Standalone dropout layer."""


@register
@dataclass
class GlobalPoolingLayer(Layer):
    """Pool over time (RNN) or space (CNN): max | avg | sum | pnorm (the
    impl reads ``pnorm`` where a config carries one, else 2)."""

    pooling_type: str = "max"

    def get_output_type(self, input_type: InputType) -> InputType:
        if isinstance(input_type, RecurrentInputType):
            return InputType.feed_forward(input_type.size)
        if isinstance(input_type, ConvolutionalInputType):
            return InputType.feed_forward(input_type.channels)
        return input_type


@register
@dataclass
class SelfAttentionLayer(FeedForwardLayer):
    """Multi-head self-attention (nn/layers/attention.py). n_out must be a
    multiple of n_heads; n_kv_heads (grouped-query attention) must divide
    n_heads."""

    n_heads: int = 4
    causal: bool = False
    max_cache_len: int = 1024
    rope: bool = False
    rope_base: float = 10000.0
    n_kv_heads: Optional[int] = None

    def get_output_type(self, input_type: InputType) -> InputType:
        ts = (input_type.timesteps
              if isinstance(input_type, RecurrentInputType) else None)
        return InputType.recurrent(self.n_out, ts)


def _conv_out_hw(h: int, w: int, kernel, stride, padding, mode: str,
                 dilation) -> Tuple[int, int]:
    kh, kw = kernel
    sh, sw = stride
    ph, pw = padding
    dh, dw = dilation
    if mode == "same":
        return ((h + sh - 1) // sh, (w + sw - 1) // sw)
    oh = (h + 2 * ph - ((kh - 1) * dh + 1)) // sh + 1
    ow = (w + 2 * pw - ((kw - 1) * dw + 1)) // sw + 1
    if oh <= 0 or ow <= 0:
        raise ValueError(f"Invalid conv geometry: input {h}x{w}, kernel "
                         f"{kernel}, stride {stride}, padding {padding}")
    return (oh, ow)


@dataclass
class BasePretrainNetwork(FeedForwardLayer):
    loss: str = "reconstruction_crossentropy"

    def is_pretrain_layer(self) -> bool:
        return True


@register
@dataclass
class RBM(BasePretrainNetwork):
    """Restricted Boltzmann machine trained with CD-k (JAX
    nn/conf/layers.py :360; impl nn/layers/pretrain.RBMImpl)."""

    hidden_unit: str = "binary"  # binary | gaussian | rectified | softmax
    visible_unit: str = "binary"  # binary | gaussian | linear | softmax
    k: int = 1
    sparsity: float = 0.0


@register
@dataclass
class AutoEncoder(BasePretrainNetwork):
    """Denoising autoencoder (JAX nn/conf/layers.py :374)."""

    corruption_level: float = 0.3
    sparsity: float = 0.0
