"""Weight-init distribution configs — the port's own copy of
deeplearning4j_tpu/nn/conf/distributions.py, used when a layer's
``weight_init`` is "distribution". Same class and field names, so the
``dist`` field of a config round-trips.
"""
from __future__ import annotations

from dataclasses import dataclass

from .serde import register


@register
@dataclass
class NormalDistribution:
    mean: float = 0.0
    std: float = 1.0

    def spec(self) -> dict:
        return {"type": "normal", "mean": self.mean, "std": self.std}


@register
@dataclass
class UniformDistribution:
    lower: float = -1.0
    upper: float = 1.0

    def spec(self) -> dict:
        return {"type": "uniform", "lower": self.lower, "upper": self.upper}


@register
@dataclass
class BinomialDistribution:
    n: int = 1
    p: float = 0.5

    def spec(self) -> dict:
        return {"type": "binomial", "n": self.n, "p": self.p}
