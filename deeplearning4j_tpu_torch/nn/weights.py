"""Weight initialization — port of deeplearning4j_tpu/nn/weights.py: the
same schemes, fans and distributions.

fan_in/fan_out follow the JAX package: for a [n_in, n_out] matrix
fan_in = n_in, fan_out = n_out; for an HWIO conv kernel [kh, kw, c_in,
c_out] fan_in = kh*kw*c_in, fan_out = kh*kw*c_out.

Every draw takes an explicit `torch.Generator` and is made on the CPU,
then moved to the caller's device, so a seed gives the same weights on
the CPU and on the card. The port's draws are not the JAX package's
(threefry and torch's generator differ): tests that compare the two
packages copy parameters across (`util/model_serializer.params_from_jax`)
and compare the schemes by distribution only.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

ZERO = "zero"
ONES = "ones"
SIZE = "size"
UNIFORM = "uniform"
NORMALIZED = "normalized"
VI = "vi"
XAVIER = "xavier"
XAVIER_UNIFORM = "xavier_uniform"
RELU = "relu"
RELU_UNIFORM = "relu_uniform"
LECUN = "lecun"
DISTRIBUTION = "distribution"

ALL = (ZERO, ONES, SIZE, UNIFORM, NORMALIZED, VI, XAVIER, XAVIER_UNIFORM,
       RELU, RELU_UNIFORM, LECUN, DISTRIBUTION)


def _fans(shape: Sequence[int]) -> Tuple[float, float]:
    if len(shape) == 1:
        return float(shape[0]), float(shape[0])
    if len(shape) == 2:
        return float(shape[0]), float(shape[1])
    receptive = 1.0
    for d in shape[:-2]:
        receptive *= d
    return receptive * shape[-2], receptive * shape[-1]


def _uniform(gen, shape, lo, hi):
    return torch.rand(shape, generator=gen) * (hi - lo) + lo


def _draw(gen: torch.Generator, shape, scheme: str,
          distribution: Optional[dict]) -> torch.Tensor:
    fan_in, fan_out = _fans(shape)
    if scheme == ZERO:
        return torch.zeros(shape)
    if scheme == ONES:
        return torch.ones(shape)
    if scheme == SIZE:
        b = 1.0 / math.sqrt(fan_in + fan_out)
        return _uniform(gen, shape, -b, b)
    if scheme == UNIFORM:
        a = 1.0 / math.sqrt(fan_in)
        return _uniform(gen, shape, -a, a)
    if scheme == NORMALIZED:
        return (torch.rand(shape, generator=gen) - 0.5) / fan_in
    if scheme == VI:
        r = math.sqrt(6.0 / (fan_in + fan_out))
        return torch.rand(shape, generator=gen) * 2.0 * r - r
    if scheme == XAVIER:
        return torch.randn(shape, generator=gen) * math.sqrt(
            2.0 / (fan_in + fan_out))
    if scheme == XAVIER_UNIFORM:
        r = math.sqrt(6.0 / (fan_in + fan_out))
        return _uniform(gen, shape, -r, r)
    if scheme == RELU:
        return torch.randn(shape, generator=gen) * math.sqrt(2.0 / fan_in)
    if scheme == RELU_UNIFORM:
        r = math.sqrt(6.0 / fan_in)
        return _uniform(gen, shape, -r, r)
    if scheme == LECUN:
        return torch.randn(shape, generator=gen) * math.sqrt(1.0 / fan_in)
    if scheme == DISTRIBUTION:
        return _sample_distribution(gen, shape, distribution or {})
    raise ValueError(f"Unknown weight init scheme '{scheme}'. Available: {ALL}")


def _sample_distribution(gen, shape, dist: dict) -> torch.Tensor:
    kind = dist.get("type", "normal").lower()
    if kind in ("normal", "gaussian"):
        return (torch.randn(shape, generator=gen) * dist.get("std", 1.0)
                + dist.get("mean", 0.0))
    if kind == "uniform":
        return _uniform(gen, shape, dist.get("lower", -1.0),
                        dist.get("upper", 1.0))
    if kind == "binomial":
        p = torch.full((int(dist.get("n", 1)),) + tuple(shape),
                       float(dist.get("p", 0.5)))
        return torch.bernoulli(p, generator=gen).sum(dim=0)
    raise ValueError(f"Unknown distribution '{kind}'")


def init_weights(gen: torch.Generator, shape: Sequence[int],
                 scheme: str = XAVIER, dtype: torch.dtype = torch.float32,
                 device: torch.device = torch.device("cpu"), *,
                 distribution: Optional[dict] = None) -> torch.Tensor:
    """Draw a weight tensor from ``gen`` (a CPU generator).
    ``distribution`` is a distribution config's ``spec()``, used when
    ``scheme`` is "distribution"."""
    shape = tuple(int(s) for s in shape)
    w = _draw(gen, shape, scheme.lower(), distribution)
    return w.to(device=device, dtype=dtype)
