"""Layer implementation SPI + registry — port of
deeplearning4j_tpu/nn/layers/base.py.

A layer impl is a thin stateless object bound to its resolved config;
params live outside it in a dict name -> tensor (the JAX package's
pytree, in the same layout: a Dense ``W`` is [n_in, n_out] and computes
``x @ W + b``), and ``forward`` is a plain function on tensors. This
slice runs inference only: no dropout, no regularization terms.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Type

import torch

Tensor = torch.Tensor
Params = Dict[str, Tensor]

LAYER_IMPLS: Dict[str, Type["LayerImpl"]] = {}


def register_impl(conf_cls_name: str):
    def deco(cls):
        LAYER_IMPLS[conf_cls_name] = cls
        return cls
    return deco


def impl_for(conf) -> "LayerImpl":
    name = type(conf).__name__
    if name not in LAYER_IMPLS:
        raise ValueError(f"No layer implementation registered for config {name}")
    return LAYER_IMPLS[name](conf)


class LayerImpl:
    """Stateless functional layer bound to a resolved config."""

    def __init__(self, conf):
        self.conf = conf

    def init_params(self, gen: torch.Generator, dtype=torch.float32,
                    device=torch.device("cpu")) -> Params:
        return {}

    def forward(self, params: Params, x: Tensor, *,
                mask: Optional[Tensor] = None) -> Tensor:
        raise NotImplementedError

    def activation_fn(self):
        from ...ops import activations
        return activations.get(self.conf.activation or "identity")


class BaseRecurrentImpl(LayerImpl):
    """Layers that carry inference state between calls (the attention KV
    cache). ``forward_with_state(params, x, state0)`` returns (y, state);
    state0 None runs the stateless full-sequence forward."""

    def forward_with_state(self, params: Params, x: Tensor, state0, *,
                           mask: Optional[Tensor] = None
                           ) -> Tuple[Tensor, Optional[dict]]:
        raise NotImplementedError
