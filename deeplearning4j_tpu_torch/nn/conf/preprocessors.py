"""Input preprocessors: shape adapters between layer kinds — port of the
adapters of deeplearning4j_tpu/nn/conf/preprocessors.py that shape
inference inserts (CnnToFeedForward, FeedForwardToCnn, FeedForwardToRnn,
RnnToFeedForward, CnnToRnn, RnnToCnn). Same class and field names, so a
config's ``input_preprocessors`` round-trip; the layouts are NHWC and
[B, T, F], and the flatten order of NHWC is the JAX package's (h, w, c).
Autograd derives each backward.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .serde import register

Tensor = torch.Tensor


@dataclass
class InputPreProcessor:
    def preprocess(self, x: Tensor) -> Tensor:
        raise NotImplementedError


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
