"""Layer implementation SPI + registry — port of
deeplearning4j_tpu/nn/layers/base.py.

A layer impl is a thin stateless object bound to its resolved config;
params live outside it in a dict name -> tensor (the JAX package's
pytree, in the same layout: a Dense ``W`` is [n_in, n_out] and computes
``x @ W + b``; a conv ``W`` is HWIO), and ``forward`` is a plain function
on tensors whose backward autograd derives. Non-trainable state (the
BatchNorm running stats) rides in ``variables``; `forward_with_variables`
returns the updated dict.

Randomness (dropout) takes an explicit `torch.Generator` on the tensor's
device: the port's masks are not the JAX package's, so tests that
compare the two set dropout to 0.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Type

import torch

Tensor = torch.Tensor
Params = Dict[str, Tensor]
Variables = Dict[str, Tensor]

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

    # weight params regularized by l1/l2 (biases excluded, as the JAX
    # package and the reference's BaseLayer.calcL2 do)
    WEIGHT_KEYS = ("W",)

    def __init__(self, conf):
        self.conf = conf

    def init_params(self, gen: torch.Generator, dtype=torch.float32,
                    device=torch.device("cpu")) -> Params:
        return {}

    def init_variables(self, dtype=torch.float32,
                       device=torch.device("cpu")) -> Variables:
        return {}

    def forward(self, params: Params, x: Tensor, *, train: bool = False,
                gen: Optional[torch.Generator] = None,
                mask: Optional[Tensor] = None) -> Tensor:
        raise NotImplementedError

    def forward_with_variables(self, params: Params, x: Tensor,
                               variables: Variables, *, train: bool = False,
                               gen: Optional[torch.Generator] = None,
                               mask: Optional[Tensor] = None
                               ) -> Tuple[Tensor, Variables]:
        """(activations, updated variables); a layer without variables
        returns its input dict."""
        return self.forward(params, x, train=train, gen=gen,
                            mask=mask), variables

    def reg_loss(self, params: Params) -> Tensor:
        """0.5 * l2 * sum(W^2) + l1 * sum(|W|) over WEIGHT_KEYS, in f32 or
        wider (JAX base.py :103)."""
        l1 = float(getattr(self.conf, "l1", 0.0) or 0.0)
        l2 = float(getattr(self.conf, "l2", 0.0) or 0.0)
        acc_dtype = torch.float32
        for k in self.WEIGHT_KEYS:
            if k in params:
                acc_dtype = torch.promote_types(params[k].dtype, torch.float32)
                break
        dev = next(iter(params.values())).device if params else None
        total = torch.zeros((), dtype=acc_dtype, device=dev)
        if l1 == 0.0 and l2 == 0.0:
            return total
        for k in self.WEIGHT_KEYS:
            if k in params:
                w = params[k].to(acc_dtype)
                if l2:
                    total = total + 0.5 * l2 * torch.sum(w * w)
                if l1:
                    total = total + l1 * torch.sum(torch.abs(w))
        return total

    def _dropout(self, x: Tensor, train: bool,
                 gen: Optional[torch.Generator]) -> Tensor:
        """Inverted input dropout (JAX base.py :124): at train time keep
        each unit with probability 1 - p, scaled by 1 / (1 - p)."""
        p = float(getattr(self.conf, "dropout", 0.0) or 0.0)
        if not train or p <= 0.0:
            return x
        if gen is None:
            raise ValueError("dropout requires a generator at train time")
        keep = 1.0 - p
        mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))

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
