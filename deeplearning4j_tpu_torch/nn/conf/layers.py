"""Layer configs — the part of deeplearning4j_tpu/nn/conf/layers.py that
``transformer_lm`` is built from (Dense, RnnOutput, LayerNormalization,
SelfAttention). Same class names, fields and
defaults as the JAX package, so configs round-trip between the two.

Configs are pure data. Unset fields (None) inherit net-level defaults at
build time (`config.resolve_layer_defaults`).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

from .serde import register
from ..updater.updaters import UpdaterConfig


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

    def clone(self) -> "Layer":
        return dataclasses.replace(self)


@dataclass
class FeedForwardLayer(Layer):
    n_in: Optional[int] = None
    n_out: Optional[int] = None


@register
@dataclass
class DenseLayer(FeedForwardLayer):
    """Fully connected layer: y = act(x @ W + b), W [n_in, n_out]."""


@register
@dataclass
class RnnOutputLayer(FeedForwardLayer):
    """Per-timestep output layer: [B, T, n_in] -> [B, T, n_out]."""

    loss: str = "mcxent"


@register
@dataclass
class LayerNormalization(FeedForwardLayer):
    """Layer norm over the trailing feature axis (population variance)."""

    eps: float = 1e-5


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
