"""Activation functions, named to match the reference's string-keyed registry.

Port of deeplearning4j_tpu/ops/activations.py. Each entry computes the
same function as its JAX counterpart; where PyTorch's default differs
from JAX's, the JAX definition wins:

  - ``gelu``: `jax.nn.gelu` defaults to the tanh approximation, so this
    is ``F.gelu(x, approximate="tanh")`` (torch's default erf form is a
    different function);
  - ``leakyrelu``: slope 0.01, as the JAX package fixes it, and slope 1
    at x = 0 (`jax.nn.leaky_relu`'s ``where(x >= 0, ...)``);
  - the clips (``hardtanh``, ``hardsigmoid``, ``rectifiedtanh``): binary
    ``maximum``/``minimum`` against a 0-d tensor, which split the
    gradient of a tie 0.5/0.5 as ``jnp.clip``/``jnp.maximum`` do
    (``torch.clamp`` gives the whole slope at the bound);
  - ``softmax``: over the last axis.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def identity(x: Tensor) -> Tensor:
    return x


def sigmoid(x: Tensor) -> Tensor:
    return torch.sigmoid(x)


def tanh(x: Tensor) -> Tensor:
    return torch.tanh(x)


def relu(x: Tensor) -> Tensor:
    return torch.relu(x)


def leakyrelu(x: Tensor) -> Tensor:
    return torch.where(x >= 0, x, 0.01 * x)


def elu(x: Tensor) -> Tensor:
    return F.elu(x)


def selu(x: Tensor) -> Tensor:
    return F.selu(x)


def softplus(x: Tensor) -> Tensor:
    return F.softplus(x)


def softsign(x: Tensor) -> Tensor:
    return F.softsign(x)


def _clip(x: Tensor, lo: float, hi: float) -> Tensor:
    # `x.new_full` fills on x's device (no host copy), so this captures
    return torch.minimum(torch.maximum(x, x.new_full((), lo)),
                         x.new_full((), hi))


def hardtanh(x: Tensor) -> Tensor:
    return _clip(x, -1.0, 1.0)


def hardsigmoid(x: Tensor) -> Tensor:
    return _clip(0.2 * x + 0.5, 0.0, 1.0)


def cube(x: Tensor) -> Tensor:
    return x * x * x


def rationaltanh(x: Tensor) -> Tensor:
    # 1.7159 * tanh(2x/3) approximation used by ND4J's RationalTanh
    ax = torch.abs(2.0 * x / 3.0)
    approx = torch.sign(x) * (1.0 - 1.0 / (1.0 + ax + ax * ax
                                           + 1.41645 * ax ** 4))
    return 1.7159 * approx


def rectifiedtanh(x: Tensor) -> Tensor:
    t = torch.tanh(x)
    return torch.maximum(t, t.new_full((), 0.0))


def softmax(x: Tensor) -> Tensor:
    return torch.softmax(x, dim=-1)


def gelu(x: Tensor) -> Tensor:
    return F.gelu(x, approximate="tanh")


def swish(x: Tensor) -> Tensor:
    return F.silu(x)


ACTIVATIONS: dict[str, Callable[[Tensor], Tensor]] = {
    "identity": identity,
    "linear": identity,
    "sigmoid": sigmoid,
    "tanh": tanh,
    "relu": relu,
    "leakyrelu": leakyrelu,
    "elu": elu,
    "selu": selu,
    "softplus": softplus,
    "softsign": softsign,
    "hardtanh": hardtanh,
    "hardsigmoid": hardsigmoid,
    "cube": cube,
    "rationaltanh": rationaltanh,
    "rectifiedtanh": rectifiedtanh,
    "softmax": softmax,
    "gelu": gelu,
    "swish": swish,
}


def get(name: str) -> Callable[[Tensor], Tensor]:
    try:
        return ACTIVATIONS[name.lower()]
    except KeyError:
        raise ValueError(
            f"Unknown activation '{name}'. Available: {sorted(ACTIVATIONS)}"
        ) from None
