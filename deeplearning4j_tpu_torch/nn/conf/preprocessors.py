"""Input preprocessors — port of deeplearning4j_tpu/nn/conf/preprocessors.py:
the shape adapters shape inference inserts (CnnToFeedForward,
FeedForwardToCnn, FeedForwardToRnn, RnnToFeedForward, CnnToRnn,
RnnToCnn) and the value adapters a graph vertex or a layer list may name
(Composable, UnitVariance, ZeroMean, BinomialSampling). Same class and
field names, so a config's preprocessors round-trip between the
packages; the layouts are NHWC and [B, T, F], and the flatten order of
NHWC is the JAX package's (h, w, c). Autograd derives each backward.

A network calls ``preprocess_train(x, gen)`` in a train-mode forward,
with its own generator, and ``preprocess(x)`` otherwise; the two differ
only for BinomialSamplingPreProcessor, which samples {0, 1} units at
train time (the reference's behaviour) where the JAX package clips
deterministically (JAX :146-153).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .serde import register

Tensor = torch.Tensor


@dataclass
class InputPreProcessor:
    def preprocess(self, x: Tensor) -> Tensor:
        raise NotImplementedError

    def preprocess_train(self, x: Tensor,
                         gen: Optional[torch.Generator]) -> Tensor:
        """The train-mode transform, drawing from ``gen`` where it
        samples; the inference transform for every other preprocessor."""
        return self.preprocess(x)


@register
@dataclass
class CnnToFeedForwardPreProcessor(InputPreProcessor):
    """[B, H, W, C] -> [B, H*W*C]."""

    height: int = 0
    width: int = 0
    channels: int = 0

    def preprocess(self, x: Tensor) -> Tensor:
        return x.reshape(x.shape[0], -1)


@register
@dataclass
class FeedForwardToCnnPreProcessor(InputPreProcessor):
    """[B, H*W*C] -> [B, H, W, C]."""

    height: int = 0
    width: int = 0
    channels: int = 1

    def preprocess(self, x: Tensor) -> Tensor:
        if x.ndim == 4:
            return x
        return x.reshape(x.shape[0], self.height, self.width, self.channels)


@register
@dataclass
class FeedForwardToRnnPreProcessor(InputPreProcessor):
    """[B*T, F] -> [B, T, F]; the network passes the minibatch's T."""

    def preprocess(self, x: Tensor) -> Tensor:
        raise RuntimeError("FeedForwardToRnn requires timesteps; the "
                           "network uses preprocess_with_time")

    def preprocess_with_time(self, x: Tensor, timesteps: int) -> Tensor:
        return x.reshape(x.shape[0] // timesteps, timesteps, x.shape[-1])


@register
@dataclass
class RnnToFeedForwardPreProcessor(InputPreProcessor):
    """[B, T, F] -> [B*T, F]."""

    def preprocess(self, x: Tensor) -> Tensor:
        return x.reshape(-1, x.shape[-1])


@register
@dataclass
class CnnToRnnPreProcessor(InputPreProcessor):
    """[B*T, H, W, C] -> [B, T, H*W*C]."""

    height: int = 0
    width: int = 0
    channels: int = 0

    def preprocess(self, x: Tensor) -> Tensor:
        raise RuntimeError("CnnToRnn requires timesteps; the network uses "
                           "preprocess_with_time")

    def preprocess_with_time(self, x: Tensor, timesteps: int) -> Tensor:
        return x.reshape(x.shape[0] // timesteps, timesteps, -1)


@register
@dataclass
class RnnToCnnPreProcessor(InputPreProcessor):
    """[B, T, H*W*C] -> [B*T, H, W, C]."""

    height: int = 0
    width: int = 0
    channels: int = 1

    def preprocess(self, x: Tensor) -> Tensor:
        return x.reshape(x.shape[0] * x.shape[1], self.height, self.width,
                         self.channels)


@register
@dataclass
class ComposableInputPreProcessor(InputPreProcessor):
    """A chain of preprocessors, applied in order."""

    processors: Optional[list] = None

    def preprocess(self, x: Tensor) -> Tensor:
        for p in self.processors or []:
            x = p.preprocess(x)
        return x

    def preprocess_train(self, x, gen):
        for p in self.processors or []:
            x = p.preprocess_train(x, gen)
        return x


def _example_axes(x: Tensor):
    return tuple(range(1, x.ndim))


@register
@dataclass
class UnitVarianceProcessor(InputPreProcessor):
    """Each example divided by its (population) standard deviation, at
    least 1e-8."""

    def preprocess(self, x: Tensor) -> Tensor:
        std = torch.std(x, dim=_example_axes(x), keepdim=True, correction=0)
        return x / torch.clamp(std, min=1e-8)


@register
@dataclass
class ZeroMeanPrePreProcessor(InputPreProcessor):
    """Each example minus its mean."""

    def preprocess(self, x: Tensor) -> Tensor:
        return x - torch.mean(x, dim=_example_axes(x), keepdim=True)


@register
@dataclass
class BinomialSamplingPreProcessor(InputPreProcessor):
    """Activations read as Bernoulli probabilities. Inference clips them
    to [0, 1], as the JAX package does at all times; a train-mode forward
    draws each unit as 1 with its clipped probability (a uniform from the
    network's generator below it), else 0, with no gradient through the
    draw."""

    def preprocess(self, x: Tensor) -> Tensor:
        return torch.clamp(x, 0.0, 1.0)

    def preprocess_train(self, x, gen):
        if gen is None:
            return self.preprocess(x)
        u = torch.rand(x.shape, generator=gen, device=x.device)
        return (u < torch.clamp(x.detach(), 0.0, 1.0)).to(x.dtype)
